"""The DeepSeek-V2 configuration, its prefill kind, work counts and metric
readers, on the CPU at small shapes (the cell itself runs on the card)."""

import copy
import json
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import lm_work, manifest, trace, work  # noqa: E402
from tmbench.reference import deepseek_v2_reference as reference  # noqa: E402

CELL = "deepseek-v2.prefill-16k"
# the catalog's DeepSeek-V2 config, as
# https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json gives it
CATALOG = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 5120, "intermediate_size": 12288, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1536, "moe_layer_freq": 1, "n_group": 8, "n_routed_experts": 160,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 128,
    "num_experts_per_tok": 6, "num_hidden_layers": 60, "num_key_value_heads": 128,
    "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 16, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 3,
    "topk_method": "group_limited_greedy", "v_head_dim": 128, "vocab_size": 102400,
}
HELD = {"num_hidden_layers": 5, "n_routed_experts": 20, "vocab_size": 12800}


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
    published widths; the cut and the deployment stated."""
    for k, v in CATALOG.items():
        assert config[k] == HELD.get(k, v), k
    assert config["held"] == HELD
    for k, v in config["published"].items():
        assert v == CATALOG[k], k
    assert set(config["published"]) == set(config["model"]) | set(HELD)
    for k, v in config["model"].items():
        assert v == CATALOG[k], k
    entry = next(c for c in bench["configs"] if c["name"] == "deepseek-v2")
    assert entry["source"] == config["source"] == \
        "https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json"
    assert set(HELD) <= set(entry["reduced"]) and entry["reduced"] == config["reduced"]
    assert not set(entry["reduced"]) & set(config["model"])
    assert config["assumed"] == ["torch_dtype"] and config["torch_dtype"] == "bfloat16"
    dep = config["deployment"]
    assert (dep["chips_per_layer"], dep["group"]) == (8, 0)
    assert dep["chips_per_layer"] * HELD["n_routed_experts"] == CATALOG["n_routed_experts"]
    assert dep["chips_per_layer"] * HELD["vocab_size"] == CATALOG["vocab_size"]
    assert dep["chips_per_layer"] == CATALOG["n_group"]
    assert manifest.config_errors(entry, config) == []


def test_manifest_validates_with_the_cell(bench):
    assert manifest.validate(bench) == []
    cell = manifest.cell(bench, CELL)
    assert cell["cell"]["chips"] == 1
    names = {m["name"] for m in cell["end_to_end"] + cell["per_layer"]}
    assert {"setup_s", "infer_rate", "infer_p95_ms", "infer_mfu", "idle_share.infer",
            "flash_mla_roofline", "prefill_step_ms.infer", "moe_route_ms.infer",
            "moe_experts_ms.infer", "moe_pad_share.infer"} <= names
    assert "train_rate" not in names and "term_infer_roofline" not in names


def small_config(config):
    """The configuration at small widths, cut the same way: 16 experts in 4
    groups (4 held), top-3, 3 layers, a 128-row vocabulary, bf16."""
    small = copy.deepcopy(config)
    widths = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                  num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
                  kv_lora_rank=24, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  num_experts_per_tok=3, n_shared_experts=1, n_group=4, topk_group=2)
    held = {"num_hidden_layers": 3, "n_routed_experts": 4, "vocab_size": 128}
    small.update(widths, **held)
    small["rope_scaling"] = dict(small["rope_scaling"], original_max_position_embeddings=16)
    small["model"] = dict(widths)
    small["held"] = held
    small["published"] = dict(widths, num_hidden_layers=3, n_routed_experts=16, vocab_size=128)
    return small


def new_small_cell(config):
    traffic = {"kind": "lm_prefill", "shapes": [[16, 3], [48, 1]], "pool_per_shape": 2,
               "reference_block": 8}
    ctx = types.SimpleNamespace(root=ROOT, config=small_config(config), traffic=traffic,
                                seed=2 ** 31 + 17, device=torch.device("cpu"),
                                tracer=trace.Tracer(False))
    return manifest.kind("lm_prefill").Cell(ctx)


@pytest.fixture(scope="module")
def small_cell(config):
    kind = manifest.kind("lm_prefill")
    cell = new_small_cell(config)
    cell.setup()
    rec = cell.window(0.0)
    return kind, cell, rec, cell.check()


def test_small_cell_runs_and_checks(small_cell):
    kind, cell, rec, checks = small_cell
    assert rec["kind"] == "infer" and rec["batches"] == 2
    assert rec["items"] == 16 * 3 + 48 and len(rec["latencies_s"]) == 2
    assert [n for n, _, _ in checks] == ["logits_err", "cache_err"]
    for n, v, lim in checks:
        assert lim == kind.LIMITS[n]
        assert v <= lim, (n, v)


def test_each_control_is_caught(small_cell):
    """Each control, put in the program's place, exceeds a limit of the
    check."""
    kind, cell, _, _ = small_cell
    got = cell.controls()
    for name in ("control_no_group_limit", "control_plain_rope", "fault_fp8_weights"):
        assert any(got[f"{name}.{n}"] > lim for n, lim in kind.LIMITS.items()), (name, got)


def test_bounds_sum_the_pool_batches(small_cell):
    kind, cell, rec, _ = small_cell
    b = cell.bounds()
    dims = cell.dims
    want = {"step": 0.0, "flash": 0.0}
    for i in range(rec["batches"]):
        j = cell.pool[i % len(cell.pool)][0]
        S, B = cell.shapes[j]
        for k, v in lm_work.prefill_bounds(dims, B, S, cell.pairs[i % len(cell.pool)]).items():
            want[k] += v
    assert b == pytest.approx(want)
    # the held group's pairs from the reference's routing, none in the dense layer
    assert all(p[0] == 0 and min(p[1:]) > 0 for p in cell.pairs.values())


def test_weights_are_the_benchmarks_draw(small_cell):
    """The model holds the benchmark's draw from the seed under the
    reference's names, rounded to bf16; the reference's float32 weights are
    the same values, drawn again."""
    _, cell, _, _ = small_cell
    held = cell.model.state_dict()
    w = cell._weights()
    assert list(w) == list(reference.weight_shapes(cell.spec))
    assert set(held) == set(w)
    for k, v in w.items():
        assert torch.equal(held[k].to(torch.float32), v), k
        assert v.dim() == 1 or float(v.std()) > 0, k
    again = cell._draw(lambda _: torch.float32)
    assert all(torch.equal(again[k], v) for k, v in w.items())


@pytest.mark.parametrize("fault", ["one_layer_fewer", "another_group", "another_vocab"])
def test_a_program_off_the_stated_share_is_caught(config, monkeypatch, fault):
    """A program that builds fewer layers or fewer vocabulary rows fails
    its set-up (the weights do not load); one that holds another group's
    experts loads them and fails the check."""
    from repro_torch.configs import deepseek_v2_236b

    real = deepseek_v2_236b.from_config_json

    def off(hf, *, group, n_layers, vocab_rows, dtype):
        n_layers -= fault == "one_layer_fewer"
        vocab_rows //= 1 + (fault == "another_vocab")
        group += fault == "another_group"
        return real(hf, group=group, n_layers=n_layers, vocab_rows=vocab_rows, dtype=dtype)

    monkeypatch.setattr(deepseek_v2_236b, "from_config_json", off)
    cell = new_small_cell(config)
    if fault != "another_group":
        with pytest.raises(RuntimeError, match="state_dict"):
            cell.setup()
        return
    cell.setup()
    cell.window(0.0)
    assert any(v > lim for _, v, lim in cell.check())


def test_counts_equal_a_hand_count(config):
    """At the configuration's widths, B 1, S 2,048 and held pairs 0, 300,
    310, 320, 330 a layer, every term of ``prefill_flops`` counted by hand."""
    m = lm_work.dims(config)
    assert lm_work.mla_params(m) == (5120 * 1536 + 1536 * 128 * 192 + 5120 * 576
                                     + 512 * 128 * 128 * 2 + 128 * 128 * 5120) == 149_225_472
    assert lm_work.attention_core_flops(m, 1, 2048) == 171_882_577_920
    pairs = [0, 300, 310, 320, 330]
    T = 2048
    hand = (5 * (2 * T * 149_225_472 + 171_882_577_920)
            + 2 * T * 3 * 5120 * 12288
            + 4 * 2 * T * (5120 * 160 + 3 * 5120 * 2 * 1536)
            + 2 * 1260 * 3 * 5120 * 1536
            + 2 * 5120 * 12800)
    assert lm_work.prefill_flops(m, 1, T, pairs) == hand
    pk = work.peaks()
    b = lm_work.prefill_bounds(m, 1, T, pairs, pk)
    assert b["step"] == hand / pk["bf16_dense_flops_per_s"]
    assert b["flash"] == 5 * 171_882_577_920 / pk["bf16_dense_flops_per_s"]


def _run(**kw):
    return dict(dict(kind="infer", batches=4, trace=None, bounds=None), **kw)


def test_readers(monkeypatch):
    from repro_torch import spans

    read = {n: manifest.reader(n) for n in ("flash_mla_roofline", "prefill_step_ms.infer",
                                            "moe_route_ms.infer", "moe_experts_ms.infer",
                                            "moe_pad_share.infer")}
    tr = {"by_name": {"void flash_fwd_wgmma_kernel<192, 128>(...)": 2.0, "gemm": 5.0}}
    assert read["flash_mla_roofline"](_run(trace=tr, bounds={"flash": 0.5})) == 25.0
    assert read["flash_mla_roofline"](_run(trace={"by_name": {"gemm": 1.0}},
                                           bounds={"flash": 0.5})) is None
    monkeypatch.setattr(spans, "totals", lambda: {"prefill_step": (4, 8_000_000),
                                                  "moe_route": (16, 4_000_000),
                                                  "moe_experts": (15, 4_000_000)})
    monkeypatch.setattr(spans, "counts", lambda: {"moe_experts.rows": 400,
                                                  "moe_experts.pad_rows": 0})
    assert read["prefill_step_ms.infer"](_run()) == 2.0
    assert read["moe_route_ms.infer"](_run()) == 1.0
    assert read["moe_experts_ms.infer"](_run()) is None     # 15 calls: not the window's
    assert read["moe_pad_share.infer"](_run()) == 0.0
    # a program without the counters (the parent's) gives nothing and raises nothing
    monkeypatch.delattr(spans, "counts")
    assert read["moe_pad_share.infer"](_run()) is None
