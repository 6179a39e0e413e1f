"""The LongCat-Flash configuration, its prefill kind, work counts and
metric reader, on the CPU at small shapes (the cell itself runs on the
card)."""

import copy
import json
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import lm_work, longcat_work, manifest, trace, work  # noqa: E402
from tmbench.reference import longcat_flash_reference as reference  # noqa: E402

CELL = "longcat-flash.prefill-16k-zipf"
# the catalog's LongCat-Flash-Chat config, as
# https://huggingface.co/meituan-longcat/LongCat-Flash-Chat/blob/main/config.json gives it
CATALOG = {
    "attention_bias": False, "vocab_size": 131072, "hidden_size": 6144,
    "ffn_hidden_size": 12288, "expert_ffn_hidden_size": 2048, "num_layers": 28,
    "num_attention_heads": 64, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "mla_scale_q_lora": True, "mla_scale_kv_lora": True, "routed_scaling_factor": 6,
    "n_routed_experts": 512, "max_position_embeddings": 131072, "rms_norm_eps": 1e-05,
    "rope_theta": 10000000, "attention_method": "MLA", "zero_expert_num": 256,
    "zero_expert_type": "identity", "moe_topk": 12,
}
HELD = {"num_layers": 8, "n_routed_experts": 64, "vocab_size": 16384}
CONTROLS = ("control_sequential_moe", "control_zero_dropped", "control_bias_in_gate",
            "control_no_lora_scale", "fault_fp8_weights")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


@pytest.fixture(scope="module")
def config(bench):
    with open(manifest.cell(bench, CELL)["config_file"]) as f:
        return json.load(f)


def test_configuration_keeps_the_catalog_numbers(bench, config):
    """Every key of the catalog's config at the top level, held keys at
    their held values; ``published`` the catalog's values; ``model`` the
    published widths; the cut, what was assumed and the deployment stated."""
    for k, v in CATALOG.items():
        assert config[k] == HELD.get(k, v), k
    assert config["held"] == HELD
    for k, v in config["published"].items():
        assert v == CATALOG[k], k
    assert set(config["published"]) == set(config["model"]) | set(HELD)
    assert config["model"] == {k: CATALOG[k] for k in (
        "hidden_size", "ffn_hidden_size", "expert_ffn_hidden_size", "num_attention_heads",
        "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "moe_topk", "zero_expert_num")}
    entry = next(c for c in bench["configs"] if c["name"] == "longcat-flash")
    assert entry["source"] == config["source"] == \
        "https://huggingface.co/meituan-longcat/LongCat-Flash-Chat/blob/main/config.json"
    assert entry["reduced"] == config["reduced"] == list(HELD) + ["weights"]
    assert not set(entry["reduced"]) & set(config["model"])
    assert config["assumed"] == ["torch_dtype", "e_score_correction_bias",
                                 "latent_up_projection_std"]
    assert config["torch_dtype"] == "bfloat16"
    dep = config["deployment"]
    assert (dep["chips_per_layer"], dep["experts"], dep["layers"], dep["vocab_rows"]) == \
        (8, [0, 64], [0, 8], [0, 16384])
    assert dep["chips_per_layer"] * HELD["n_routed_experts"] == CATALOG["n_routed_experts"]
    assert dep["chips_per_layer"] * HELD["vocab_size"] == CATALOG["vocab_size"]
    assert manifest.config_errors(entry, config) == []


def test_manifest_validates_with_the_cell(bench):
    assert manifest.validate(bench) == []
    cell = manifest.cell(bench, CELL)
    assert cell["cell"]["chips"] == 1
    names = {m["name"] for m in cell["end_to_end"] + cell["per_layer"]}
    assert names == {"setup_s", "infer_rate", "infer_p95_ms", "infer_mfu", "idle_share.infer",
                     "flash_mla_roofline", "prefill_step_ms.infer", "moe_route_ms.infer",
                     "moe_experts_ms.infer", "moe_pad_share.infer", "moe_zero_share.infer"}
    zero = next(m for m in bench["per_layer"] if m["name"] == "moe_zero_share.infer")
    assert (zero["unit"], zero["better"], zero["source"], zero["layer"], zero["moves"],
            zero["workloads"]) == ("%", "higher", "program_counter", "expert layer",
                                   "infer_rate", [CELL])


def test_configuration_builds_this_model(config):
    """The published values with the deployment build the model the cut
    states: 8 double layers of 3.05 B parameters and 1/8 of the
    vocabulary, 24.6 B parameters."""
    from repro_torch.configs.longcat_flash_560b import from_config_json
    from repro_torch.models.config import held_experts

    hf = dict(config, **config["published"])
    m = from_config_json(hf, experts=range(*config["deployment"]["experts"]),
                         n_layers=HELD["num_layers"], vocab_rows=HELD["vocab_size"])
    assert held_experts(m) == range(0, 64)
    assert (m.n_layers, m.vocab_size, m.n_experts, m.router_width) == (8, 16384, 512, 768)
    per_layer = (m.param_count() - 2 * 16384 * 6144 - 6144) / 8
    assert 3.04e9 < per_layer < 3.06e9
    assert 24.5e9 < m.param_count() < 24.7e9


def small_config(config):
    """The configuration at small widths, cut the same way: 16 FFN experts
    (4 held, 4-7) beside 8 identity experts, top-4, 2 double layers, a
    128-row vocabulary, bf16."""
    small = copy.deepcopy(config)
    widths = dict(hidden_size=64, ffn_hidden_size=96, expert_ffn_hidden_size=32,
                  num_attention_heads=4, q_lora_rank=16, kv_lora_rank=24, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, moe_topk=4, zero_expert_num=8)
    held = {"num_layers": 2, "n_routed_experts": 4, "vocab_size": 128}
    small.update(widths, **held)
    small["model"] = dict(widths)
    small["held"] = held
    small["published"] = dict(widths, num_layers=2, n_routed_experts=16, vocab_size=128)
    small["deployment"] = dict(small["deployment"], experts=[4, 8])
    return small


def new_small_cell(config, seed=2 ** 31 + 17):
    traffic = {"kind": "longcat_prefill", "shapes": [[16, 3], [48, 1]], "pool_per_shape": 2,
               "reference_block": 8, "zipf_exponent": 1.0}
    ctx = types.SimpleNamespace(root=ROOT, config=small_config(config), traffic=traffic,
                                seed=seed, device=torch.device("cpu"),
                                tracer=trace.Tracer(False))
    return manifest.kind("longcat_prefill").Cell(ctx)


@pytest.fixture(scope="module")
def small_cell(config):
    kind = manifest.kind("longcat_prefill")
    cell = new_small_cell(config)
    cell.setup()
    held = {k: v.clone() for k, v in cell.model.state_dict().items()}
    rec = cell.window(0.0)
    return kind, cell, rec, cell.check(), held


def test_small_cell_runs_and_checks(small_cell):
    kind, cell, rec, checks, _ = small_cell
    assert rec["kind"] == "infer" and rec["batches"] == 2
    assert rec["items"] == 16 * 3 + 48 and len(rec["latencies_s"]) == 2
    assert [n for n, _, _ in checks] == ["logits_err", "cache_err", "moe_err"]
    for n, v, lim in checks:
        assert lim == kind.LIMITS[n]
        assert v <= lim, (n, v)
    # the check freed the program; its kept caches are the 4 MLA sublayers'
    assert not hasattr(cell, "model")
    assert all(len(cache) == 4 for _, _, cache in cell.kept.values())


def test_each_control_is_caught(small_cell):
    """Each control, put in the program's place, exceeds a limit of the
    check."""
    kind, cell, _, _, _ = small_cell
    got = cell.controls()
    assert set(got) == {f"{c}.{n}" for c in CONTROLS for n in kind.LIMITS}
    for name in CONTROLS:
        assert any(got[f"{name}.{n}"] > lim for n, lim in kind.LIMITS.items()), (name, got)


def test_bounds_sum_the_pool_batches(small_cell):
    kind, cell, rec, _, _ = small_cell
    b = cell.bounds()
    want = {"step": 0.0, "flash": 0.0}
    for i in range(rec["batches"]):
        j = cell.pool[i % len(cell.pool)][0]
        S, B = cell.shapes[j]
        for k, v in longcat_work.prefill_bounds(cell.dims, B, S,
                                                cell.pairs[i % len(cell.pool)]).items():
            want[k] += v
    assert b == pytest.approx(want)
    # the held experts' pairs from the reference's routing, in every layer
    assert len(cell.pairs) == len(cell.pool)
    assert all(len(p) == 2 and min(p) > 0 for p in cell.pairs.values())


def test_weights_are_the_benchmarks_draw(small_cell):
    """The model held the benchmark's draw from the seed under the
    reference's names, rounded to bf16, each weight from its own stream;
    the reference's float32 weights are the same values, drawn again, one
    name at a time."""
    _, cell, _, _, held = small_cell
    names = list(reference.weight_shapes(cell.spec))
    assert set(held) == set(names)
    w = cell._weights(names)
    for k, v in w.items():
        assert torch.equal(held[k].to(torch.float32), v), k
        assert v.dim() == 1 and "score_bias" not in k or float(v.std()) > 0, k
    bias = w["blocks.0.moe.score_bias"]
    assert bias.dtype == torch.float32 and abs(float(bias.std()) * 24 - 1) < 0.5
    for k in ("blocks.1.moe.gate", "blocks.0.mix.1.wo"):
        assert torch.equal(cell._weights([k])[k], w[k])
    assert not torch.equal(w["blocks.0.ff.0.up"], w["blocks.0.ff.1.up"])


def test_prompts_follow_zipf(config):
    """The pool's ids: a permutation of ranks drawn by Zipf's law, the same
    for the same seed; another seed maps the ranks to other rows."""
    cells = [new_small_cell(config, seed) for seed in (5, 5, 6)]
    for c in cells:
        c.setup()
    pools = [torch.cat([ids.reshape(-1) for _, ids in c.pool]) for c in cells]
    assert torch.equal(pools[0], pools[1]) and not torch.equal(pools[0], pools[2])
    counts = torch.bincount(pools[0], minlength=128).sort(descending=True).values
    # 192 ids over 128 rows: the most frequent rank takes ~1/H(128) = 18%
    assert counts[0] >= 15 and counts[0] > 4 * counts[20]


@pytest.mark.parametrize("fault", ["one_layer_fewer", "other_experts", "another_vocab"])
def test_a_program_off_the_stated_share_is_caught(config, monkeypatch, fault):
    """A program that builds fewer layers or fewer vocabulary rows fails
    its set-up (the weights do not load); one that holds other experts
    loads them and fails the check."""
    from repro_torch.configs import longcat_flash_560b

    real = longcat_flash_560b.from_config_json

    def off(hf, *, experts, n_layers, vocab_rows, dtype):
        n_layers -= fault == "one_layer_fewer"
        vocab_rows //= 1 + (fault == "another_vocab")
        if fault == "other_experts":
            experts = range(experts.start + 4, experts.stop + 4)
        return real(hf, experts=experts, n_layers=n_layers, vocab_rows=vocab_rows, dtype=dtype)

    monkeypatch.setattr(longcat_flash_560b, "from_config_json", off)
    cell = new_small_cell(config)
    if fault != "other_experts":
        with pytest.raises(RuntimeError, match="state_dict"):
            cell.setup()
        return
    cell.setup()
    cell.window(0.0)
    assert any(v > lim for _, v, lim in cell.check())


def test_a_program_with_the_bias_in_its_gates_is_caught(config, monkeypatch):
    """A program whose router adds the selection bias to its gates too: the
    caches and logits can miss it, the first double layer's expert layer,
    run in float32 on the reference's input, does not."""
    from repro_torch.models import moe

    real = moe._top_experts

    def biased(cfg, router_w, x_flat, bias=None):
        gates, idx = real(cfg, router_w, x_flat, bias)
        return gates + bias[idx] * cfg.routed_scaling_factor, idx

    monkeypatch.setattr(moe, "_top_experts", biased)
    cell = new_small_cell(config)
    cell.setup()
    cell.window(0.0)
    checks = {n: (v, lim) for n, v, lim in cell.check()}
    assert checks["moe_err"][0] > checks["moe_err"][1], checks


def test_a_program_without_the_configuration_exits_with_2(config, monkeypatch):
    """A program without ``configs/longcat_flash_560b.py`` (this cell's
    parent): the set-up exits with 2 at once."""
    monkeypatch.setitem(sys.modules, "repro_torch.configs.longcat_flash_560b", None)
    cell = new_small_cell(config)
    with pytest.raises(SystemExit) as e:
        cell.setup()
    assert e.value.code == 2


def test_counts_equal_a_hand_count(config):
    """At the configuration's widths, B 1, S 2,048 and held pairs 1,900,
    2,000, ..., 2,600 a double layer, every term counted by hand."""
    m = longcat_work.dims(config)
    mla = (6144 * 1536 + 1536 * 64 * 192 + 6144 * 576 + 512 * 64 * 128 * 2 + 64 * 128 * 6144)
    assert lm_work.mla_params(m) == mla == 90_570_752
    core = 64 * 2048 * 2049 // 2 * 320 * 2
    assert lm_work.attention_core_flops(m, 1, 2048) == core == 85_941_288_960
    pairs = [1900, 2000, 2100, 2200, 2300, 2400, 2500, 2600]
    T = 2048
    hand = (8 * (2 * (2 * T * mla + core + 2 * T * 3 * 6144 * 12288) + 2 * T * 6144 * 768)
            + 2 * 18000 * 3 * 6144 * 2048
            + 2 * 6144 * 16384)
    assert longcat_work.prefill_flops(m, 1, T, pairs) == hand
    layer = (2 * (mla + 2 * 6144 + 1536 + 512 + 3 * 6144 * 12288) + 6145 * 768 * 2
             + 3 * 6144 * 2048 * 64)
    params = 8 * layer + 6144 * 16384 + 6144
    assert longcat_work.prefill_bytes(m, 1, T) == \
        2 * (params + T * 8 * 2 * 576 + T * 6144) + 8 * T + 4 * 16384
    # ~3.05 B parameters a double layer, as the configuration states
    assert 3.04e9 < layer < 3.06e9
    pk = work.peaks()
    b = longcat_work.prefill_bounds(m, 1, T, pairs, pk)
    assert b["step"] == hand / pk["bf16_dense_flops_per_s"]
    assert b["flash"] == 16 * core / pk["bf16_dense_flops_per_s"]


def _run(**kw):
    return dict(dict(kind="infer", batches=4, trace=None, bounds=None), **kw)


def test_zero_share_reader(monkeypatch):
    from repro_torch import spans

    read = manifest.reader("moe_zero_share.infer")
    monkeypatch.setattr(spans, "counts", lambda: {"moe.pairs": 400, "moe.zero_pairs": 132})
    assert read(_run()) == 33.0
    assert read(_run(kind="train")) is None
    monkeypatch.setattr(spans, "counts", lambda: {})
    assert read(_run()) is None
    # a program without the counters (the parent's) gives nothing and raises nothing
    monkeypatch.delattr(spans, "counts")
    assert read(_run()) is None


def test_zero_share_reader_reads_the_programs_counters(small_cell):
    """Under a profiler the program's prefill counts every routed pair and
    the identity experts' pairs, which the reader divides."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.models import steps, transformer

    _, cell, _, _, held = small_cell
    model = transformer.Transformer(cell.cfg, None, device="meta")
    model.load_state_dict({k: v.clone() for k, v in held.items()}, strict=True, assign=True)
    ids = cell.pool[0][1]
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        steps.make_prefill_step(cell.cfg)(model, {"tokens": ids}, model.init_caches(*ids.shape))
    got = spans.counts()
    spans.reset()
    assert got["moe.pairs"] == 2 * ids.numel() * 4
    assert 0 < got["moe.zero_pairs"] < got["moe.pairs"]
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(spans, "counts", lambda: got)
    try:
        assert manifest.reader("moe_zero_share.infer")(_run()) == \
            100.0 * got["moe.zero_pairs"] / got["moe.pairs"]
    finally:
        monkeypatch.undo()
