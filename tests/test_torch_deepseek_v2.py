"""DeepSeek-V2 as published, on the port's serving path, against the plain
reference (``tests/plain_deepseek_v2.py``) at a small size in float32.

The configuration is built by ``configs.deepseek_v2_236b.from_config_json``
from a config.json of DeepSeek-V2's form at small widths: group-limited
routing over 4 groups of 4 experts, unnormalized gates x 16, dropless
dispatch of one held group, YaRN and the mscale^2 attention scale.  Both
sides compute in float32 with other summation orders, so each comparison
holds the relative Frobenius error to 1e-5, some ten times the error the
orders give here, far below what a wrong rule gives (each wrong rule is
checked to miss by more).
"""

import dataclasses
import filecmp
import json
import math
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_deepseek_v2 as ref
from repro_torch import spans
from repro_torch.configs.deepseek_v2_236b import from_config_json
from repro_torch.models import layers, mla, moe, steps, transformer
from repro_torch.models.config import held_experts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG_CONFIG = {
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
# DeepSeek-V2's config.json at small widths: 16 experts in 4 groups, top-3
SMALL = dict(CATALOG_CONFIG, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32, kv_lora_rank=24,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=16,
             n_group=4, topk_group=2, num_experts_per_tok=3, n_shared_experts=1,
             num_hidden_layers=3, vocab_size=128,
             rope_scaling=dict(CATALOG_CONFIG["rope_scaling"],
                               original_max_position_embeddings=64))
TOL = 1e-5


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def small_cfg(group=0, **kw):
    hf = dict(SMALL, **kw)
    return hf, from_config_json(hf, group=group, n_layers=hf["num_hidden_layers"],
                                vocab_rows=hf["vocab_size"], dtype="float32")


def small_model(cfg, seed=0):
    """Random weights, norms included (the draw leaves them 0)."""
    model = transformer.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def weights(model) -> dict:
    return {k: v.detach().to(torch.float32) for k, v in model.state_dict().items()}


def spec(hf, group=0):
    return dict(hf, held_group=group)


def tokens(B, S, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SMALL["vocab_size"], (B, S), generator=g)


def test_from_config_json_reads_the_published_settings():
    cfg = from_config_json(CATALOG_CONFIG, group=0, n_layers=5, vocab_rows=12800)
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.d_ff_expert) == (160, 6, 2, 1536)
    assert (cfg.topk_method, cfg.n_group, cfg.topk_group) == ("group_limited_greedy", 8, 3)
    assert (cfg.norm_topk_prob, cfg.routed_scaling_factor, cfg.dropless) == (False, 16.0, True)
    assert held_experts(cfg) == range(0, 20)
    assert (cfg.n_layers, cfg.vocab_size, cfg.d_model, cfg.d_ff) == (5, 12800, 5120, 12288)
    assert (cfg.q_lora, cfg.kv_lora, cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim) == \
        (1536, 512, 128, 64, 128)
    assert cfg.yarn.factor == 40 and cfg.yarn.original_max_position_embeddings == 4096
    # ~3.15 B parameters held, as the cut states
    assert 3.1e9 < cfg.param_count() < 3.2e9
    with pytest.raises(ValueError):
        from_config_json(CATALOG_CONFIG, group=8, n_layers=5, vocab_rows=12800)


def test_group_limited_router_matches_the_reference():
    hf, cfg = small_cfg()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((256, 64), generator=g)
    router = torch.randn((64, 16), generator=g) * 64 ** -0.5
    gates, idx = moe._top_experts(cfg, router, x)
    r_gates, r_idx = ref.route(x, router, spec(hf))
    assert torch.equal(idx, r_idx)
    assert rel(gates, r_gates) < TOL
    # at most topk_group groups a token; gates are the probabilities x 16
    assert all(len(set((row // 4).tolist())) <= 2 for row in idx)
    probs = torch.softmax(x @ router, dim=-1)
    assert rel(gates, 16 * probs.gather(1, idx)) < TOL
    # the group limit decides: plain top-3 picks other experts for many tokens
    _, plain = moe._top_experts(dataclasses.replace(cfg, topk_method="greedy"), router, x)
    assert (plain != idx).any(1).float().mean() > 0.1


def test_yarn_frequencies_hand_values():
    y = from_config_json(CATALOG_CONFIG, group=0, n_layers=5, vocab_rows=12800).yarn
    assert layers.yarn_correction_range(64, 10000.0, y) == (10, 23)
    got = layers.yarn_frequencies(64, 10000.0, y).double()
    for i in range(32):
        f = 10000.0 ** (-2 * i / 64)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want = f / 40 * ramp + f * (1 - ramp)
        # float32 rounding of the powers
        assert abs(float(got[i]) - want) <= 2e-6 * want, i
    assert float(got[10]) == pytest.approx(10000.0 ** (-20 / 64), rel=2e-6)
    assert float(got[23]) == pytest.approx(10000.0 ** (-46 / 64) / 40, rel=2e-6)
    spec64 = dict(CATALOG_CONFIG)
    assert torch.equal(ref.rope_inv_freq(spec64), layers.yarn_frequencies(64, 10000.0, y))


def test_softmax_scale_is_mscale_squared():
    cfg = from_config_json(CATALOG_CONFIG, group=0, n_layers=5, vocab_rows=12800)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.26080, abs=1e-5)
    assert mla.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert mla.softmax_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    assert mla.softmax_scale(cfg) == ref.softmax_scale(CATALOG_CONFIG)


@pytest.mark.parametrize("route", ["prefill", "decode"])
def test_mla_scale_in_prefill_and_decode(route):
    """One MLA layer: the prefill (flash route) and one decoded token
    (``_mla_decode``) equal the reference at the mscale^2 scale, and miss it
    at qk width^-0.5."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    S = 10
    x = torch.randn((1, S, 64), generator=torch.Generator().manual_seed(4))
    want, _, _ = ref.mla(w, "blocks.0.mix.", x[0], torch.arange(S), spec(hf), block=4)
    params = model.blocks[0].mix
    pos = torch.arange(S)[None]

    def port(c):
        with torch.no_grad():
            if route == "prefill":
                return mla.mla_block(c, params, x, pos)[0][0]
            cache = mla.init_mla_cache(c, 1, S, torch.float32, "cpu")
            mla.mla_block(c, params, x[:, :-1], pos[:, :-1], cache=cache)
            return mla.mla_block(c, params, x[:, -1:], pos[:, -1:], cache=cache)[0][0]

    rows = slice(None) if route == "prefill" else slice(-1, None)
    assert rel(port(cfg), want[rows]) < TOL
    # the same layer at qk width^-0.5 (YaRN's frequencies kept) misses
    plain = dataclasses.replace(cfg, yarn=dataclasses.replace(cfg.yarn, mscale_all_dim=0.0,
                                                              mscale=0.0))
    assert mla.softmax_scale(plain) == 24 ** -0.5
    assert rel(port(plain), want[rows]) > 100 * TOL


def test_prefill_then_decode_matches_the_full_forward():
    """``make_prefill_step`` with the caches of ``init_caches``, then 4
    ``make_decode_step`` steps: each step's logits against the reference's
    forward over the prompt so far, and the latent caches at every
    position."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    B, S, n_dec = 2, 12, 4
    toks = tokens(B, S + n_dec)
    caches = model.init_caches(B, S + n_dec)
    logits, caches = steps.make_prefill_step(cfg)(model, {"tokens": toks[:, :S]}, caches)
    got = [logits]
    decode = steps.make_decode_step(cfg)
    for t in range(n_dec):
        logits, caches = decode(model, caches, {"tokens": toks[:, S + t:S + t + 1]}, S + t)
        got.append(logits)
    for t, lg in enumerate(got):
        want = ref.forward(w, toks[:, :S + t], spec(hf), block=5)
        assert rel(lg, want["logits"]) < TOL, t
    for layer, (c_kv, k_rope) in zip(caches, want["cache"]):
        assert rel(layer["c_kv"], c_kv) < TOL
        assert rel(layer["k_rope"], k_rope) < TOL
    assert want["held_pairs"][0] == 0 and min(want["held_pairs"][1:]) > 0


def test_held_groups_sum_to_the_uncut_layer():
    """Each of the 4 groups' held layer, with the shared expert counted
    once, adds up to the reference's layer over all 16 experts."""
    hf, cfg = small_cfg()
    full = small_model(dataclasses.replace(cfg, held_group=None))
    params = {k: v for k, v in full.blocks[1].ff.items()}
    x = torch.randn((2, 20, 64), generator=torch.Generator().manual_seed(5))
    want, _ = ref.moe(weights(full), "blocks.1.ff.", x.reshape(-1, 64), spec(hf, None))
    total = torch.zeros_like(want)
    with torch.no_grad():
        for g in range(4):
            cg = dataclasses.replace(cfg, held_group=g)
            held = held_experts(cg)
            pg = dict(params, **{k: params[k][held.start:held.stop]
                                 for k in ("gate", "up", "down")})
            total += moe.moe_ff(cg, pg, x).reshape(-1, 64)
        shared = layers.mlp(params["shared"], x).reshape(-1, 64)
    assert rel(total - 3 * shared, want) < TOL
    # one group alone is not the layer
    assert rel(moe.moe_ff(cfg, dict(params, **{k: params[k][:4] for k in ("gate", "up", "down")}),
                          x).reshape(-1, 64).detach(), want) > 0.1


def test_dropless_under_a_skewed_router():
    """Every token routed to expert 0: far past a 1.25 capacity, still
    equal to the reference; the capacity rule on the same router drops."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    params = {k: v for k, v in model.blocks[1].ff.items()}
    with torch.no_grad():
        params["router"] = params["router"].clone()
        params["router"][:, 0] = 1.0
    x = 3.0 + torch.randn((1, 64, 64), generator=torch.Generator().manual_seed(6))
    w = dict(weights(model), **{"blocks.1.ff.router": params["router"]})
    _, idx = moe._top_experts(cfg, params["router"], x.reshape(-1, 64))
    assert bool((idx == 0).any(1).all())
    # the capacity rule at these sizes would keep fewer than the 64 tokens
    assert moe.capacity(cfg, 64) < 64
    want, pairs = ref.moe(w, "blocks.1.ff.", x.reshape(-1, 64), spec(hf))
    assert pairs >= 64
    with torch.no_grad():
        got = moe.moe_ff(cfg, params, x).reshape(-1, 64)
    assert rel(got, want) < TOL


def test_dropless_counters_and_prefill_span():
    """Under a profiler the held experts' products count every routed pair
    of the held group as a row and none as padding, and a prefill step is
    one ``prefill_step`` span; with no profiler nothing is counted."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    toks = tokens(2, 16)
    step = steps.make_prefill_step(cfg)
    spans.reset()
    step(model, {"tokens": toks}, model.init_caches(2, 16))
    assert spans.counts() == {} and spans.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        step(model, {"tokens": toks}, model.init_caches(2, 16))
    want = ref.forward(weights(model), toks, spec(hf), block=8)["held_pairs"]
    got, tot = spans.counts(), spans.totals()
    spans.reset()
    assert got[moe.ROWS_COUNTER] == sum(want) > 0
    assert got[moe.PAD_COUNTER] == 0
    assert tot[steps.PREFILL_RANGE][0] == 1
    assert tot[moe.ROUTE_RANGE][0] == tot[moe.EXPERTS_RANGE][0] == 2


def test_reference_takes_the_share_from_the_spec():
    """The reference's layers, held experts and vocabulary rows come from
    the spec, and it refuses weights of another share: a layer fewer, or
    every expert where one group is held."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    shapes = ref.weight_shapes(spec(hf))
    assert {k: tuple(v.shape) for k, v in w.items()} == {k: s for k, (s, _) in shapes.items()}
    assert ref.held_range(spec(hf, 2)) == range(8, 12) and ref.held_range(spec(hf, None)) == \
        range(16)
    toks = tokens(1, 6)
    short = {k: v for k, v in w.items() if not k.startswith("blocks.2.")}
    with pytest.raises(ValueError):
        ref.forward(short, toks, spec(hf))
    assert ref.forward(short, toks, dict(spec(hf), held_layers=2))["logits"].shape == (1, 128)
    full = weights(small_model(dataclasses.replace(cfg, held_group=None)))
    with pytest.raises(ValueError):
        ref.forward(full, toks, spec(hf))
    with pytest.raises(ValueError):
        ref.forward(w, toks, dict(spec(hf), held_vocab=64))


def test_reference_copies_are_identical():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "plain_deepseek_v2.py"),
                       os.path.join(ROOT, "tmbench", "reference", "deepseek_v2_reference.py"),
                       shallow=False)


def test_benchmark_configuration_builds_this_model():
    """``tmbench/configs/deepseek-v2.json`` keeps the catalog's config at its
    top level, held keys at their held values, and its published values
    with the deployment build the model the cut states."""
    with open(os.path.join(ROOT, "tmbench", "configs", "deepseek-v2.json")) as f:
        cfg = json.load(f)
    held = cfg["held"]
    for k, v in CATALOG_CONFIG.items():
        assert cfg[k] == held.get(k, v), k
        assert cfg["published"].get(k, v) == v, k
    hf = dict(cfg, **cfg["published"])
    dep = cfg["deployment"]
    m = from_config_json(hf, group=dep["group"], n_layers=held["num_hidden_layers"],
                         vocab_rows=held["vocab_size"])
    assert len(held_experts(m)) == held["n_routed_experts"] == 20
    assert (m.n_layers, m.vocab_size, m.n_experts) == (5, 12800, 160)
