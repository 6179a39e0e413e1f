"""LongCat-Flash as published, on the port's serving path, against the
plain reference (``tests/plain_longcat_flash.py``) at a small size in
float32.

The configuration is built by ``configs.longcat_flash_560b.from_config_json``
from a config.json of LongCat-Flash's form at small widths: 16 FFN experts
beside 8 identity experts, top-4, gates the scores x 6 chosen with a
selection bias, MLA with both LoRA scales, dropless dispatch of a held
range of experts.  Both sides compute in float32 with other summation
orders, so each comparison holds the relative Frobenius error to 1e-5,
some ten times the error the orders give here (1e-7 to 1e-6), far below
what a wrong rule gives: each wrong rule, and weights rounded through
float8, are checked to miss by more.
"""

import dataclasses
import filecmp
import os

import pytest
import torch

import plain_longcat_flash as ref
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.longcat_flash_560b import SMOKE, from_config_json
from repro_torch.models import mla, moe, steps, transformer
from repro_torch.models.config import held_experts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the catalog's LongCat-Flash-Chat config, as
# https://huggingface.co/meituan-longcat/LongCat-Flash-Chat/blob/main/config.json gives it
CATALOG_CONFIG = {
    "attention_bias": False, "vocab_size": 131072, "hidden_size": 6144,
    "ffn_hidden_size": 12288, "expert_ffn_hidden_size": 2048, "num_layers": 28,
    "num_attention_heads": 64, "kv_lora_rank": 512, "q_lora_rank": 1536,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "mla_scale_q_lora": True, "mla_scale_kv_lora": True, "routed_scaling_factor": 6,
    "n_routed_experts": 512, "max_position_embeddings": 131072, "rms_norm_eps": 1e-05,
    "rope_theta": 10000000, "attention_method": "MLA", "zero_expert_num": 256,
    "zero_expert_type": "identity", "moe_topk": 12, "model_type": "longcat_flash",
}
# LongCat-Flash's config.json at SMOKE's widths: 16 FFN experts, 8 identity, top-4
SMALL = dict(CATALOG_CONFIG, hidden_size=64, ffn_hidden_size=96, expert_ffn_hidden_size=32,
             num_attention_heads=4, q_lora_rank=16, kv_lora_rank=24, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=16, zero_expert_num=8,
             moe_topk=4, num_layers=2, vocab_size=128)
HELD = range(4, 12)
TOL = 1e-5
FP8_MAX = 448.0


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def small_cfg(experts=HELD, **kw):
    hf = dict(SMALL, **kw)
    return hf, from_config_json(hf, experts=experts, n_layers=hf["num_layers"],
                                vocab_rows=hf["vocab_size"], dtype="float32")


def small_model(cfg, seed=0):
    """Random weights; the norms' offsets N(0, 0.1^2) and the router's bias
    N(0, (1/24)^2), about one mean score (the draw leaves both 0)."""
    model = transformer.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif "score_bias" in name:
                p.copy_(torch.randn(p.shape, generator=g) / cfg.router_width)
    return model


def weights(model) -> dict:
    return {k: v.detach().to(torch.float32) for k, v in model.state_dict().items()}


def spec(hf, experts=HELD, **kw):
    return dict(hf, held_experts=(experts.start, experts.stop), **kw)


def tokens(B, S, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SMALL["vocab_size"], (B, S), generator=g)


def fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded through float8 e4m3 with a per-tensor scale."""
    s = FP8_MAX / w.abs().amax().clamp(min=1e-30)
    return (w * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def test_from_config_json_reads_the_published_settings():
    cfg = from_config_json(CATALOG_CONFIG, experts=range(0, 64), n_layers=4, vocab_rows=16384)
    assert (cfg.n_experts, cfg.zero_experts, cfg.router_width, cfg.top_k, cfg.d_ff_expert) == \
        (512, 256, 768, 12, 2048)
    assert (cfg.norm_topk_prob, cfg.routed_scaling_factor, cfg.dropless, cfg.score_bias) == \
        (False, 6.0, True, True)
    assert held_experts(cfg) == range(0, 64) and cfg.n_shared_experts == 0
    assert (cfg.n_layers, cfg.vocab_size, cfg.d_model, cfg.d_ff, cfg.n_heads) == \
        (4, 16384, 6144, 12288, 64)
    assert (cfg.q_lora, cfg.kv_lora, cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim) == \
        (1536, 512, 128, 64, 128)
    assert (cfg.rope_theta, cfg.norm_eps, cfg.yarn, cfg.layer_kinds) == \
        (1e7, 1e-5, None, ("scmoe",) * 4)
    assert mla.lora_scales(cfg) == (2.0, 12 ** 0.5)
    assert mla.softmax_scale(cfg) == 192 ** -0.5
    # ~3.05 B parameters a double layer, 12.4 B held with the vocabulary slice
    assert 12.3e9 < cfg.param_count() < 12.5e9
    # the whole model: 560 B
    assert 560e9 < get_config("longcat-flash-560b").param_count() < 562e9
    assert get_smoke_config("longcat-flash-560b") is SMOKE
    for bad in (dict(model_type="deepseek_v3"), dict(zero_expert_type="zero"),
                dict(rope_scaling={"type": "yarn"})):
        with pytest.raises(ValueError):
            from_config_json(dict(CATALOG_CONFIG, **bad), experts=range(0, 64), n_layers=4,
                             vocab_rows=16384)
    with pytest.raises(ValueError):
        from_config_json(CATALOG_CONFIG, experts=range(500, 520), n_layers=4, vocab_rows=16384)


def test_router_chooses_with_the_bias_and_gates_without_it():
    hf, cfg = small_cfg()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((256, 64), generator=g)
    router = torch.randn((64, 24), generator=g) * 64 ** -0.5
    bias = torch.randn((24,), generator=g) / 24
    gates, idx = moe._top_experts(cfg, router, x, bias)
    r_gates, r_idx = ref.route(x, router, bias, spec(hf))
    assert torch.equal(idx, r_idx)
    assert rel(gates, r_gates) < TOL
    probs = torch.softmax(x @ router, dim=-1)
    # the choice is the top-4 of the scores plus the bias ...
    assert torch.equal(idx, torch.sort(probs + bias, dim=-1, descending=True, stable=True)[1][:, :4])
    # ... the gates the chosen scores x 6, not renormalized
    assert rel(gates, 6 * probs.gather(1, idx)) < TOL
    assert float(gates.sum(-1).max()) < 6 - 0.1
    # the bias decides: without it many tokens pick other experts
    _, plain = moe._top_experts(cfg, router, x)
    assert (plain != idx).any(1).float().mean() > 0.1
    # the bias in the gates misses
    biased, _ = ref.route(x, router, bias, spec(hf, variant="bias_in_gate"))
    assert rel(biased, r_gates) > 100 * TOL


def test_identity_pairs_add_gate_times_token():
    """A router that picks only identity experts: the layer is the sum of
    the gates times the token; the held FFN experts compute no row."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    params = dict(model.blocks[0].moe.items())
    with torch.no_grad():
        params["router"] = torch.zeros_like(params["router"])
        params["score_bias"] = torch.zeros(24).index_fill(0, torch.arange(16, 24), 1.0)
    x = torch.randn((1, 20, 64), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = moe.moe_ff(cfg, params, x)
    # equal scores 1/24 each; the top-4 of the biased ones are identity experts 16-19
    assert torch.allclose(got, x * 4 * 6 / 24, rtol=1e-6, atol=0)
    w = dict(weights(model), **{f"blocks.0.moe.{k}": params[k] for k in ("router", "score_bias")})
    want, pairs, zero = ref.moe(w, "blocks.0.moe.", x[0], spec(hf))
    assert (pairs, zero) == (0, 80) and rel(got[0], want) < TOL
    # the reference's zero_dropped variant adds nothing
    assert float(ref.moe(w, "blocks.0.moe.", x[0], spec(hf, variant="zero_dropped"))[0]
                 .abs().max()) == 0


def test_held_ranges_sum_to_the_uncut_layer():
    """Each of the 4 held ranges' layers, with the identity term (computed
    alike by every share) counted once, adds up to the reference's layer
    over all 16 FFN experts."""
    hf, cfg = small_cfg()
    full = small_model(dataclasses.replace(cfg, held_range=None))
    params = dict(full.blocks[0].moe.items())
    x = torch.randn((2, 20, 64), generator=torch.Generator().manual_seed(5))
    u = x.reshape(-1, 64)
    w = weights(full)
    want, _, _ = ref.moe(w, "blocks.0.moe.", u, spec(hf, range(16)))
    total = torch.zeros_like(want)
    with torch.no_grad():
        for r in range(4):
            held = range(4 * r, 4 * r + 4)
            c = dataclasses.replace(cfg, held_range=(held.start, held.stop))
            p = dict(params, **{k: params[k][held.start:held.stop] for k in ("gate", "up", "down")})
            total += moe.moe_ff(c, p, x).reshape(-1, 64)
    gates, idx = ref.route(u, w["blocks.0.moe.router"], w["blocks.0.moe.score_bias"], spec(hf))
    identity = u * torch.where(idx >= 16, gates, 0.0).sum(-1, keepdim=True)
    assert float(identity.abs().max()) > 0
    assert rel(total - 3 * identity, want) < TOL
    # one range alone is not the layer
    one = dict(params, **{k: params[k][:4] for k in ("gate", "up", "down")})
    with torch.no_grad():
        got = moe.moe_ff(dataclasses.replace(cfg, held_range=(0, 4)), one, x).reshape(-1, 64)
    assert rel(got, want) > 0.1


def test_shortcut_joins_after_sublayer_1():
    """One double layer: the port's block equals the reference's ScMoE
    layer, and misses the MoE added after sublayer 0 (no shortcut)."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    S = 12
    x = torch.randn((1, S, 64), generator=torch.Generator().manual_seed(6))
    pos = torch.arange(S)
    with torch.no_grad():
        got, _ = model.blocks[0](x, pos[None].expand(1, S))
    want, _, _, _, _ = ref.double_layer(w, "blocks.0.", x[0], pos, spec(hf), block=5)
    assert rel(got[0], want) < TOL
    seq, _, _, _, _ = ref.double_layer(w, "blocks.0.", x[0], pos,
                                       spec(hf, variant="sequential_moe"), block=5)
    assert rel(seq, want) > 100 * TOL


@pytest.mark.parametrize("route", ["prefill", "decode"])
def test_mla_lora_scales_in_prefill_and_decode(route):
    """One MLA sublayer: the prefill (flash route) and one decoded token
    (``_mla_decode``) equal the reference with both LoRA scales, and miss
    it without them; the cache holds the unscaled latent."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    S = 10
    x = torch.randn((1, S, 64), generator=torch.Generator().manual_seed(7))
    want, c_kv, _ = ref.mla(w, "blocks.0.mix.1.", x[0], torch.arange(S), spec(hf), block=4)
    params = model.blocks[0].mix[1]
    pos = torch.arange(S)[None]

    def port(c):
        with torch.no_grad():
            if route == "prefill":
                return mla.mla_block(c, params, x, pos)[0][0], None
            cache = mla.init_mla_cache(c, 1, S, torch.float32, "cpu")
            mla.mla_block(c, params, x[:, :-1], pos[:, :-1], cache=cache)
            return mla.mla_block(c, params, x[:, -1:], pos[:, -1:], cache=cache)[0][0], cache

    rows = slice(None) if route == "prefill" else slice(-1, None)
    got, cache = port(cfg)
    assert rel(got, want[rows]) < TOL
    if cache is not None:
        assert rel(cache["c_kv"][0], c_kv) < TOL
    for off in (dict(mla_scale_q_lora=False), dict(mla_scale_kv_lora=False)):
        assert rel(port(dataclasses.replace(cfg, **off))[0], want[rows]) > 100 * TOL


def test_logits_and_both_caches_match_the_reference():
    """A prefill through ``make_prefill_step`` with ``init_caches``: the
    last logits and every double layer's two latent caches; the same
    model's weights rounded through float8 miss by far more than the
    tolerance."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    B, S = 2, 16
    toks = tokens(B, S)
    caches = model.init_caches(B, S)
    assert [len(c) for c in caches] == [2, 2]
    logits, caches = steps.make_prefill_step(cfg)(model, {"tokens": toks}, caches)
    want = ref.forward(w, toks, spec(hf), block=5)
    assert rel(logits, want["logits"]) < TOL
    flat = [c for block in caches for c in block]
    assert len(flat) == len(want["cache"]) == 4
    for c, (c_kv, k_rope) in zip(flat, want["cache"]):
        assert rel(c["c_kv"], c_kv) < TOL and rel(c["k_rope"], k_rope) < TOL
    assert min(want["held_pairs"]) > 0 and min(want["zero_pairs"]) > 0
    low = {k: fp8(v) if v.dim() >= 2 and k != "embed" else v for k, v in w.items()}
    assert rel(ref.forward(low, toks, spec(hf), block=5)["logits"], want["logits"]) > 100 * TOL


def test_prefill_then_decode_matches_the_full_forward():
    """``make_prefill_step``, then 2 ``make_decode_step`` steps through the
    caches: each step's logits against the reference's forward over the
    prompt so far, and the latent caches at every position."""
    hf, cfg = small_cfg()
    model = small_model(cfg)
    w = weights(model)
    B, S, n_dec = 2, 12, 2
    toks = tokens(B, S + n_dec, seed=8)
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
    for c, (c_kv, k_rope) in zip([c for block in caches for c in block], want["cache"]):
        assert rel(c["c_kv"], c_kv) < TOL and rel(c["k_rope"], k_rope) < TOL


def test_reference_draws_a_layer_at_a_time():
    """The reference's weights given as a function: the same result as the
    dict, each double layer's names asked for once, alone; weights of
    another share are refused."""
    hf, cfg = small_cfg()
    w = weights(small_model(cfg))
    toks = tokens(1, 9)
    asked = []

    def load(names):
        asked.append(list(names))
        return {k: w[k] for k in names}

    want = ref.forward(w, toks, spec(hf), block=4)
    got = ref.forward(load, toks, spec(hf), block=4)
    assert torch.equal(got["logits"], want["logits"])
    assert asked == [["embed"], ref.layer_names(spec(hf), 0), ref.layer_names(spec(hf), 1),
                     ["final_norm", "unembed"]]
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: s for k, (s, _) in ref.weight_shapes(spec(hf)).items()}
    with pytest.raises(ValueError):
        ref.forward(w, toks, spec(hf, range(0, 4)))
    with pytest.raises(ValueError):
        ref.forward(lambda names: {k: w[k][..., :1] for k in names}, toks, spec(hf))
    with pytest.raises(ValueError):
        ref.forward(w, toks, spec(hf, variant="other"))


def test_deepseek_v2_keeps_its_rules():
    """The settings LongCat-Flash brings are off for every other
    configuration: no identity experts, no router bias, no LoRA scales."""
    from repro_torch.configs import deepseek_v2_236b

    for c in (deepseek_v2_236b.CONFIG, get_config("deepseek-v2-236b")):
        assert (c.zero_experts, c.score_bias, c.router_width) == (0, False, c.n_experts)
        assert mla.lora_scales(c) == (1.0, 1.0)


def test_reference_copies_are_identical():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "plain_longcat_flash.py"),
                       os.path.join(ROOT, "tmbench", "reference", "longcat_flash_reference.py"),
                       shallow=False)
