"""BENCHMARK.json against the contract, and every name found by its file."""

import copy
import hashlib
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import manifest  # noqa: E402


@pytest.fixture
def bench():
    return manifest.load()


def test_benchmark_json_meets_the_schema(bench):
    assert manifest.validate(bench) == []
    assert list(bench) == list(manifest.TOP_KEYS)
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024


@pytest.mark.parametrize("edit, needle", [
    (lambda m, cfg: m["workloads"][0].update(name="bad name"), "is not a name"),
    (lambda m, cfg: m["workloads"][0].update(name="x" * 65), "is not a name"),
    (lambda m, cfg: m["end_to_end"][0].update(unit="datapoints per second"), "unit"),
    (lambda m, cfg: m["end_to_end"][0].update(unit="d" * 17), "unit"),
    (lambda m, cfg: m["end_to_end"][0].update(unit="µs"), "unit"),
    (lambda m, cfg: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m, cfg: m["end_to_end"][0].update(why="no"), "keys must be"),
    (lambda m, cfg: m["configs"][0]["reduced"].append("clauses_per_class"), "width"),
    (lambda m, cfg: m["workloads"][1].update(config="tm-mnist", traffic="infer-64k"),
     "used twice"),
    (lambda m, cfg: m.update(run_seconds=52), "run_seconds"),
    (lambda m, cfg: m["end_to_end"].pop(), "setup_s"),
    (lambda m, cfg: m["per_layer"][0].update(moves="train_rate"), "does not report"),
    (lambda m, cfg: m["command"].append("/tmp/x"), "leaves the repository"),
    (lambda m, cfg: cfg.update(held={"n_experts": 4}, published={"n_experts": 16}),
     "is not in reduced"),
    (lambda m, cfg: (m["configs"][0]["reduced"].append("n_experts"),
                     cfg.update(held={"n_experts": 4})), "held without published"),
    (lambda m, cfg: cfg.update(published={"n_features": 785}), "unlike its published"),
    (lambda m, cfg: (m["configs"][0]["reduced"].append("n_experts"),
                     cfg.update(held={"n_experts": 32}, published={"n_experts": 16})),
     "at most its published"),
    (lambda m, cfg: (m["configs"][0]["reduced"].append("n_experts"),
                     cfg.update(held={"n_experts": 0}, published={"n_experts": 16})),
     "at most its published"),
    (lambda m, cfg: (m["configs"][0]["reduced"].append("n_experts"),
                     cfg.update(held={"n_experts": 4}, published={})),
     "has no published value"),
    (lambda m, cfg: (m["configs"][0]["reduced"].append("n_experts"),
                     cfg.update(n_experts=16, held={"n_experts": 4},
                                published={"n_experts": 16})), "not its held"),
])
def test_contract_breaches_are_named(bench, tmp_path, edit, needle):
    """Each breach, made in a copy of the manifest and of the first
    configuration's file, is named by ``validate``."""
    m = copy.deepcopy(bench)
    cfgs = {}
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfgs[c["file"]] = json.load(f)
    edit(m, cfgs[m["configs"][0]["file"]])
    for rel, cfg in cfgs.items():
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        with open(tmp_path / rel, "w") as f:
            json.dump(cfg, f)
    errors = manifest.validate(m, str(tmp_path))
    assert any(needle in e for e in errors), errors


def files_found_by_name(bench, root):
    """Assert that every cell finds its files by name under ``root``; return
    the ``(config, key)`` pairs of the files its kind declares."""
    checked = set()
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        with open(cell["config_file"]) as f:
            config = json.load(f)
        with open(cell["traffic_file"]) as f:
            traffic = json.load(f)
        assert config["name"] == w["config"]
        assert os.path.isfile(os.path.join(root, config["reference"]))
        kind = manifest.kind(traffic["kind"])
        assert hasattr(kind, "Cell")
        for key in kind.CONFIG_FILES:
            assert os.path.isfile(os.path.join(root, config[key])), (w["name"], key)
            checked.add((w["config"], key))
        names = [m["name"] for m in cell["end_to_end"] + cell["per_layer"]]
        assert "setup_s" in names
        for n in names:
            assert callable(manifest.reader(n))
    return checked


def test_every_cell_finds_its_files_by_name(bench):
    checked = files_found_by_name(bench, ROOT)
    # both artifacts and their banks, through the inference cells
    assert {(c, k) for c in ("tm-mnist", "tm-cifar2")
            for k in ("serve_artifact", "serve_bank")} <= checked


def test_a_file_the_kind_declares_is_checked(bench, tmp_path, monkeypatch):
    """A configuration that names a missing file of its cell's kind fails."""
    real = manifest.cell

    def missing_bank(m, name):
        got = real(m, name)
        with open(got["config_file"]) as f:
            cfg = json.load(f)
        cfg["serve_bank"] = "tmbench/assets/no_such_bank.npz"
        path = tmp_path / (name + ".json")
        path.write_text(json.dumps(cfg))
        return dict(got, config_file=str(path))

    monkeypatch.setattr(manifest, "cell", missing_bank)
    with pytest.raises(AssertionError, match="serve_bank"):
        files_found_by_name(bench, ROOT)


def test_per_layer_metrics_only_where_their_end_to_end_metric_is(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        for p in cell["per_layer"]:
            assert p["moves"] in e2e


def test_unknown_cell_raises(bench):
    with pytest.raises(KeyError):
        manifest.cell(bench, "no-such-cell")


# the paper's Table II: n_features, n_classes, clauses_per_class, threshold, s
PINNED = {"tm-mnist": (784, 10, 200, 50, 10.0), "tm-cifar2": (1024, 2, 1000, 200, 15.0)}


def published_widths_kept(bench, root):
    """Assert that each configuration keeps its source's widths: the pinned
    ones against Table II, any other by its ``published`` block, which
    names every key of its ``model`` not listed as ``assumed``."""
    for c in bench["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        if c["name"] in PINNED:
            m = cfg["model"]
            got = (m["n_features"], m["n_classes"], m["clauses_per_class"], m["threshold"],
                   m["s"])
            assert got == PINNED[c["name"]]
        else:
            assert "published" in cfg, c["name"]
            assert manifest.config_errors(c, cfg) == []
            assert set(cfg["model"]) <= set(cfg["published"]) | set(cfg.get("assumed", []))


def test_configurations_keep_the_published_widths(bench):
    published_widths_kept(bench, ROOT)


def tree_hashes(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


# a configuration of another family, cut to one chip's share: its files and
# its entries are all that a model_config change would bring
STUB_CONFIG = {
    "name": "lm-stub",
    "source": "https://example.org/lm-stub/config.json",
    "source_part": "a stub of a sparse-expert language model, for the harness's tests",
    "model": {"hidden_size": 64, "moe_intermediate_size": 32, "num_attention_heads": 4,
              "num_experts_per_tok": 2},
    "held": {"num_hidden_layers": 2, "n_routed_experts": 4, "vocab_size": 256},
    "published": {"hidden_size": 64, "moe_intermediate_size": 32, "num_attention_heads": 4,
                  "num_experts_per_tok": 2, "num_hidden_layers": 8, "n_routed_experts": 16,
                  "vocab_size": 2048},
    "num_hidden_layers": 2, "n_routed_experts": 4, "vocab_size": 256, "hidden_size": 64,
    "reduced": ["num_hidden_layers", "n_routed_experts", "vocab_size"],
    "assumed": [],
    "reference": "tmbench/reference/lm_stub_reference.py",
}
STUB_KIND = '''"""A stub traffic kind of another family."""

CONFIG_FILES = ()


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
'''
STUB_REFERENCE = '''"""A stub plain reference."""


def forward(x):
    return x
'''


def test_a_second_family_needs_new_files_only(tmp_path, monkeypatch):
    """A configuration of another family, with its traffic, kind and
    reference, is accepted and found by name after only new files and new
    entries: no file of the benchmark changes."""
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "tmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = tree_hashes(tmp_path / "tmbench")
    assert before == tree_hashes(manifest.HERE)
    new = {"configs/lm-stub.json": json.dumps(STUB_CONFIG),
           "traffic/prefill-stub.json": json.dumps({"kind": "prefill_stub", "batch": 4}),
           "kinds/prefill_stub.py": STUB_KIND,
           "reference/lm_stub_reference.py": STUB_REFERENCE}
    for rel, text in new.items():
        (tmp_path / "tmbench" / rel).write_text(text)
    old = manifest.load(str(tmp_path / "BENCHMARK.json"))
    m = copy.deepcopy(old)
    m["configs"].append({"name": "lm-stub", "source": STUB_CONFIG["source"],
                         "file": "tmbench/configs/lm-stub.json",
                         "reduced": STUB_CONFIG["reduced"],
                         "why": "another family: sparse experts cut to one chip's share"})
    m["workloads"].append({"name": "lm-stub.prefill", "config": "lm-stub",
                           "traffic": "prefill-stub", "chips": 1,
                           "why": "prompts of 1,024 tokens, batch 4, prefill only"})
    reported = ("infer_rate", "infer_p95_ms", "infer_mfu", "idle_share.infer")
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] in reported:
            e["workloads"].append("lm-stub.prefill")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(m, f)

    monkeypatch.setattr(manifest, "ROOT", str(tmp_path))
    monkeypatch.setattr(manifest, "HERE", str(tmp_path / "tmbench"))
    monkeypatch.setattr(manifest, "MANIFEST", str(tmp_path / "BENCHMARK.json"))
    bench = manifest.load(manifest.MANIFEST)
    assert manifest.validate(bench, manifest.ROOT) == []
    files_found_by_name(bench, manifest.ROOT)
    published_widths_kept(bench, manifest.ROOT)
    assert manifest.cell(bench, "lm-stub.prefill")["traffic_file"].startswith(str(tmp_path))

    after = tree_hashes(tmp_path / "tmbench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(new)
    # the manifest only gained entries, and cells in existing metrics' lists
    for key in ("configs", "workloads"):
        assert bench[key][:len(old[key])] == old[key]
    for key in ("end_to_end", "per_layer"):
        for was, now in zip(old[key], bench[key]):
            assert {k: v for k, v in now.items() if k != "workloads"} == \
                {k: v for k, v in was.items() if k != "workloads"}
            assert now.get("workloads", [])[:len(was.get("workloads", []))] == \
                was.get("workloads", [])
