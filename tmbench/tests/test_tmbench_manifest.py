"""BENCHMARK.json against the contract, and every name found by its file."""

import copy
import json
import os
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
    (lambda m: m["workloads"][0].update(name="bad name"), "is not a name"),
    (lambda m: m["workloads"][0].update(name="x" * 65), "is not a name"),
    (lambda m: m["end_to_end"][0].update(unit="datapoints per second"), "unit"),
    (lambda m: m["end_to_end"][0].update(unit="d" * 17), "unit"),
    (lambda m: m["end_to_end"][0].update(unit="µs"), "unit"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["end_to_end"][0].update(why="no"), "keys must be"),
    (lambda m: m["configs"][0]["reduced"].append("clauses_per_class"), "width"),
    (lambda m: m["workloads"][1].update(config="tm-mnist", traffic="infer-64k"),
     "used twice"),
    (lambda m: m.update(run_seconds=52), "run_seconds"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
    (lambda m: m["per_layer"][0].update(moves="train_rate"), "does not report"),
    (lambda m: m["command"].append("/tmp/x"), "leaves the repository"),
])
def test_contract_breaches_are_named(bench, edit, needle):
    m = copy.deepcopy(bench)
    edit(m)
    errors = manifest.validate(m)
    assert any(needle in e for e in errors), errors


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        with open(cell["config_file"]) as f:
            config = json.load(f)
        with open(cell["traffic_file"]) as f:
            traffic = json.load(f)
        assert config["name"] == w["config"]
        assert os.path.isfile(os.path.join(ROOT, config["serve_artifact"]))
        assert os.path.isfile(os.path.join(ROOT, config["reference"]))
        assert hasattr(manifest.kind(traffic["kind"]), "Cell")
        names = [m["name"] for m in cell["end_to_end"] + cell["per_layer"]]
        assert "setup_s" in names
        for n in names:
            assert callable(manifest.reader(n))


def test_per_layer_metrics_only_where_their_end_to_end_metric_is(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        for p in cell["per_layer"]:
            assert p["moves"] in e2e


def test_unknown_cell_raises(bench):
    with pytest.raises(KeyError):
        manifest.cell(bench, "no-such-cell")


def test_configurations_keep_the_published_widths(bench):
    widths = {"tm-mnist": (784, 10, 200, 50, 10.0), "tm-cifar2": (1024, 2, 1000, 200, 15.0)}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            m = json.load(f)["model"]
        got = (m["n_features"], m["n_classes"], m["clauses_per_class"], m["threshold"], m["s"])
        assert got == widths[c["name"]]
