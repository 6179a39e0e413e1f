"""Port: the four LM families added last (MoE, MLA, RG-LRU with local
windows and the ring cache, xLSTM) against the reference on the CPU.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; every other input is made with numpy from a
seed.  Everything is float32 at the smoke configs.  The reference runs its
jnp code (its Pallas flash kernel in interpret mode, as
``tests/test_kernels.py`` runs it).  Tolerances: flash functions at atol
2e-5 (the reference's own kernel-vs-oracle tolerance); module outputs at
atol 1e-5 and states at 1e-5 + rtol 1e-5 (the same float32 arithmetic
summed in other orders by XLA and torch); model logits at 1e-4 (over a few
layers); gradients and train steps as ``tests/test_torch_lm_train.py``
states them.  Prefill-then-decode logits and every gradient leaf of these
families are cases of ``test_torch_lm.py::test_prefill_decode_logits_match_reference``
and ``test_torch_lm_train.py::test_loss_and_every_gradient_leaf_equal_reference``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro import configs as r_configs
from repro.kernels.flash_attention import flash_forward as r_flash_forward
from repro.models import attention as r_attn
from repro.models import mla as r_mla
from repro.models import moe as r_moe
from repro.models import rglru as r_rglru
from repro.models import steps as r_steps
from repro.models import transformer as r_tr
from repro.models import xlstm as r_xlstm
from repro.optim import adamw as r_adamw
from repro_torch import configs as t_configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import mla as t_mla
from repro_torch.models import moe as t_moe
from repro_torch.models import rglru as t_rglru
from repro_torch.models import steps as t_steps
from repro_torch.models import transformer as t_tr
from repro_torch.models import xlstm as t_xlstm
from repro_torch.optim import adamw as t_adamw

FAMILIES = ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "recurrentgemma-2b", "xlstm-1.3b")
# xlstm-smoke is ill-conditioned in float32: the sLSTM's exponential gates
# amplify differences of their inputs (a 1e-7 relative perturbation of the
# input moves its normalizer n by 7e-6 over 24 steps, the port against
# itself), and its embedding gradient reaches ~40 (test_torch_lm_train.
# LEAF_SCALE_ATOL).  The reference's own jit and eager runs of three train
# steps differ by 3.3e-5 in grad_norm and by up to 1.5e-4 of a leaf's
# largest magnitude in params, m and v; the port and the reference by
# 1.7e-4 and up to 9.8e-4, and the third step's loss by 2.1e-5.  So its
# sLSTM states are held to XLSTM_STATE_SCALE of their largest magnitude
# beside the atol, its train steps' params, m and v to XLSTM_STEP_SCALE
# of each leaf's, its grad_norm to rtol 5e-4 and its loss to atol 1e-4.
XLSTM_STATE_SCALE = 1e-4
XLSTM_STEP_SCALE = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _carried(arch):
    rcfg, tcfg = r_configs.get_smoke_config(arch), t_configs.get_smoke_config(arch)
    params = r_tr.init_params(rcfg, jax.random.PRNGKey(0))
    model = t_tr.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


def _block_params(params, group, li=0, r=0):
    """One layer's reference parameter tree (numpy), from its group's
    stacked leaves."""
    return jax.tree.map(lambda a: np.asarray(a)[r], params["groups"][group][li])


def _torch_tree(tree):
    return jax.tree.map(_t, tree)


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_params_tree_round_trip_and_grouping(arch):
    """``layer_specs`` and ``group_layers`` equal the reference's (deepseek's
    dense layer 0 is a group of its own); the reference tree goes across
    and back leaf for leaf, float32 router and ``lam`` included; a random
    ``init_params`` has the reference's parameter count."""
    rcfg, tcfg, params, model = _carried(arch)
    assert t_tr.layer_specs(tcfg) == r_tr.layer_specs(rcfg)
    assert t_tr.group_layers(tcfg) == r_tr.group_layers(rcfg)
    tree = jax.tree.map(np.asarray, params)
    back = t_tr.params_to_numpy(tcfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    fresh = t_tr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: a.shape, t_tr.params_to_numpy(tcfg, fresh))
    assert shapes == jax.tree.map(lambda a: a.shape, tree)


def test_float32_leaves_stay_float32_in_bf16_models():
    """The reference keeps MoE's router and the RG-LRU's ``lam`` float32 in
    a bf16 model; so does the port."""
    import dataclasses
    for arch, leaf in (("deepseek-v2-236b", "ff.router"), ("recurrentgemma-2b", "mix.lam")):
        cfg = dataclasses.replace(t_configs.get_smoke_config(arch), dtype="bfloat16")
        model = t_tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        dtypes = {n.split(".", 2)[2]: p.dtype for n, p in model.named_parameters()
                  if n.startswith("blocks.")}
        assert dtypes[leaf] == torch.float32
        assert {d for n, d in dtypes.items() if n != leaf} == {torch.bfloat16}


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_reference(arch):
    """forward without a cache (the training and scoring path) -> logits
    over the vocabulary, atol 1e-4."""
    rcfg, tcfg, params, model = _carried(arch)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 40))
    hidden, _ = r_tr.forward(rcfg, params, tokens=jnp.asarray(toks, jnp.int32))
    want = hidden @ r_tr.unembed_matrix(rcfg, params)
    with torch.no_grad():
        got, caches = model(torch.from_numpy(toks))
        got = got @ model.unembed_matrix()
    assert caches is None
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_three_steps_equal_reference(arch):
    """Three AdamW steps from the same weights and batches, the tolerances
    and optimizer settings of ``test_torch_lm_train.py``'s train-step test
    (eps 1e-3): loss atol 1e-5, grad_norm rtol 1e-5, m and v atol 1e-6,
    params atol 5e-6; xlstm-smoke as ``XLSTM_STEP_SCALE`` states."""
    rcfg, tcfg, params, model = _carried(arch)
    scale = XLSTM_STEP_SCALE if arch == "xlstm-1.3b" else 0.0
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)
    r_step = jax.jit(r_steps.make_train_step(rcfg, opt_cfg=r_adamw.AdamWConfig(**kw)))
    t_step = t_steps.make_train_step(tcfg, opt_cfg=t_adamw.AdamWConfig(**kw))
    r_opt, t_opt = r_adamw.adamw_init(params), t_adamw.adamw_init(model.parameters())
    nprng = np.random.default_rng(5)

    def within(got, want, atol):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0,
            atol=atol + scale * float(np.abs(np.asarray(b)).max())), got, want)

    for _ in range(3):
        batch = t_train.lm_batch(tcfg, nprng, 4, 16)
        params, r_opt, r_info = r_step(params, r_opt,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        t_opt, t_info = t_step(model, t_opt, {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(t_info["loss"]), float(r_info["loss"]),
                                   atol=1e-4 if scale else 1e-5)
        np.testing.assert_allclose(float(t_info["grad_norm"]), float(r_info["grad_norm"]),
                                   rtol=5e-4 if scale else 1e-5)
        within(t_tr.params_to_numpy(tcfg, model, t_opt.m), r_opt.m, 1e-6)
        within(t_tr.params_to_numpy(tcfg, model, t_opt.v), r_opt.v, 1e-6)
        within(t_tr.params_to_numpy(tcfg, model), params, 5e-6)


# -- MoE -----------------------------------------------------------------------

@pytest.mark.parametrize("arch,T,dup", [("qwen3-moe-235b-a22b", 64, False),
                                        ("deepseek-v2-236b", 64, False),
                                        ("qwen3-moe-235b-a22b", 40, True),
                                        ("deepseek-v2-236b", 7, False)])
def test_route_and_expert_compute_equal_reference(arch, T, dup):
    """``_route`` (gates at atol 1e-6 and the same experts chosen) and
    ``_expert_compute`` (atol 1e-5) on one MoE layer's weights.  At T 64
    capacity (20 a expert) drops tokens, asserted; ``dup`` repeats tokens,
    so capacity picks among equal gates (the lower token first, as
    ``jax.lax.top_k`` ties); T 7 takes capacity's floor min(T, 8)."""
    rcfg, tcfg, params, _ = _carried(arch)
    layer = r_tr.group_layers(rcfg)
    g = next(i for i, (unit, _) in enumerate(layer) if unit[0][1] == "moe")
    p = _block_params(params, g)["ff"]
    rng = np.random.default_rng(T)
    x = rng.normal(size=(T, rcfg.d_model)).astype(np.float32)
    if dup:
        x[T // 2:] = x[:T - T // 2]
    want = np.asarray(r_moe._route(rcfg, jnp.asarray(p["router"]), jnp.asarray(x)))
    got = t_moe._route(tcfg, _t(p["router"]), _t(x))
    _close(got, want, atol=1e-6)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    cap = t_moe.capacity(tcfg, T)
    if T == 64:
        assert cap == 20 and int((want > 0).sum(0).max()) > cap     # tokens dropped
    w = [jnp.asarray(p[k]) for k in ("gate", "up", "down")]
    want_out = r_moe._expert_compute(rcfg, jnp.asarray(want), jnp.asarray(x), *w)
    got_out = t_moe._expert_compute(tcfg, _t(want), _t(x), *map(_t, (p["gate"], p["up"],
                                                                      p["down"])))
    _close(got_out, want_out, atol=1e-5)
    full = np.asarray(r_moe.moe_ff(rcfg, jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x.reshape(1, T, -1))))
    _close(t_moe.moe_ff(tcfg, _torch_tree(p), _t(x).view(1, T, -1)), full, atol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.0, 0.5, 0.5, 0.0, 0.5, 0.0]])
    vals, idx = t_moe.top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


# -- MLA -------------------------------------------------------------------------

def test_mla_latent_decode_equals_reference_and_the_expanded_forward():
    """``_mla_decode`` against the reference's (atol 1e-5), and one MLA
    layer's prefill of 12 tokens then a decoded one against the layer over
    all 13 without a cache: the last position at atol 1e-5."""
    rcfg, tcfg, params, model = _carried("deepseek-v2-236b")
    p = _block_params(params, 0)["mix"]
    rng = np.random.default_rng(4)
    B, T, H = 2, 24, rcfg.n_heads
    qd = rcfg.resolved_head_dim + rcfg.rope_head_dim
    q = rng.normal(size=(B, 1, H, qd)).astype(np.float32)
    c_kv = rng.normal(size=(B, T, rcfg.kv_lora)).astype(np.float32)
    k_rope = rng.normal(size=(B, T, rcfg.rope_head_dim)).astype(np.float32)
    pos = np.full((B, 1), 17, np.int32)
    want = r_mla._mla_decode(rcfg, jax.tree.map(jnp.asarray, p), *map(
        jnp.asarray, (q, c_kv, k_rope, pos)))
    got = t_mla._mla_decode(tcfg, _torch_tree(p), *map(_t, (q, c_kv, k_rope, pos)))
    _close(got, want, atol=1e-5)

    # one MLA layer: a prefill of 12 tokens then one decoded token (the
    # latent route) against the layer without a cache over all 13 (expanded
    # k and v); the whole model would differ, as MoE's capacity depends on
    # the number of tokens routed together
    x = torch.from_numpy(rng.normal(size=(B, 13, rcfg.d_model)).astype(np.float32))
    pos = torch.arange(13, dtype=torch.int32)[None].expand(B, 13)
    mix = model.blocks[0].mix
    with torch.no_grad():
        full, _ = t_mla.mla_block(tcfg, mix, x, pos, arange=True)
        cache = t_mla.init_mla_cache(tcfg, B, 16, torch.float32, "cpu")
        t_mla.mla_block(tcfg, mix, x[:, :12], pos[:, :12], cache=cache)
        step, _ = t_mla.mla_block(tcfg, mix, x[:, 12:], pos[:, 12:], cache=cache)
    assert cache["pos"] == 13
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=1e-5, rtol=0)


def test_mla_chunked_prefill_through_the_cache_equals_reference():
    """A second prefill chunk at pos > 0 expands the whole latent cache and
    masks its empty slots, as the reference does: atol 1e-4."""
    rcfg, tcfg, params, model = _carried("deepseek-v2-236b")
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size, (2, 16))
    rc, tc = r_tr.init_caches(rcfg, 2, 32), model.init_caches(2, 32)
    _, rc = r_steps.make_prefill_step(rcfg)(params, {"tokens": jnp.asarray(toks[:, :8])}, rc)
    _, tc = t_steps.make_prefill_step(tcfg)(model, {"tokens": _t(toks[:, :8])}, tc)
    pos = np.broadcast_to(np.arange(8, 16, dtype=np.int32)[None], (2, 8))
    want, _ = r_tr.forward(rcfg, params, tokens=jnp.asarray(toks[:, 8:], jnp.int32),
                           positions=jnp.asarray(pos), caches=rc)
    with torch.no_grad():
        got, _ = model(_t(toks[:, 8:]), positions=_t(pos), caches=tc)
    _close(got, want, atol=1e-4)


# -- flash at qk width != v width ------------------------------------------------

@pytest.mark.parametrize("B,S,H,KH,hd,dv", [(2, 64, 4, 4, 24, 16), (1, 32, 2, 1, 48, 32),
                                            (1, 64, 2, 2, 40, 24)])
def test_flash_plain_at_dv_not_hd_equals_reference(B, S, H, KH, hd, dv):
    """The plain version with v narrower than q and k (MLA: 24 over 16 at
    the smoke width) against the reference's Pallas kernel in interpret
    mode (kv repeated to H heads) at atol 2e-5; its lse against the
    reference's jnp route's at 2e-5; ``takes`` accepts these widths, and
    MLA's 192 over 128, and refuses dv > hd and widths past the tiles."""
    rng = np.random.default_rng(hd + dv)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, dv)).astype(np.float32)
    G = H // KH
    jk, jv = jnp.repeat(jnp.asarray(k), G, axis=2), jnp.repeat(jnp.asarray(v), G, axis=2)
    want = np.asarray(r_flash_forward(jnp.asarray(q), jk, jv, causal=True, block_q=16,
                                      block_kv=16, interpret=True))
    got = t_fa.flash_forward(_t(q), _t(k), _t(v))
    assert got.shape == (B, S, H, dv)
    _close(got, want, atol=2e-5)
    out, lse = t_fa.flash_forward_plain(_t(q), _t(k), _t(v), return_lse=True)
    pos = jnp.asarray(np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)))
    r_out, r_lse = r_attn._flash_fwd(jnp.asarray(q), jk, jv, pos, pos, 0, 16, 16)
    _close(out, r_out, atol=2e-5)
    _close(lse, r_lse, atol=2e-5)
    assert t_fa.takes(hd, dv) and t_fa.takes(192, 128) and t_fa.takes(128, 128)
    assert not t_fa.takes(16, 24) and not t_fa.takes(256, 256) and not t_fa.takes(192, 160)


def test_mla_prefill_takes_the_kernel_route_by_shape():
    """On the card the MLA prefill (qk width 24 over v width 16 at the smoke
    width) is a shape the kernel takes, so ``flash_attention`` routes it
    there; here, on CPU tensors, the same call is the chunked route.  A
    head width past the kernel's tiles (recurrentgemma's 256) is not."""
    assert t_fa.takes(24, 16) and t_fa.takes(128 + 64, 128)
    assert not t_fa.takes(256, 256)
    calls = []
    real = t_fa.flash_forward
    try:
        t_fa.flash_forward = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        q = torch.zeros(1, 8, 2, 24)
        k, v = torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 16)
        pos = torch.arange(8)[None]
        out = t_attn.flash_attention(q, k, v, pos, pos, arange=True)
    finally:
        t_fa.flash_forward = real
    assert out.shape == (1, 8, 2, 16) and calls == []


# -- RG-LRU and the ring cache -----------------------------------------------------

@pytest.mark.parametrize("S", [1, 7, 64])
def test_linear_scan_equals_associative_scan(S):
    """``linear_scan`` (log2 S doubling steps) against the reference's
    ``jax.lax.associative_scan`` with its combine, atol 1e-5."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(2, S, 5)).astype(np.float32)
    b = rng.normal(size=(2, S, 5)).astype(np.float32)
    _, want = jax.lax.associative_scan(lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
                                       (jnp.asarray(a), jnp.asarray(b)), axis=1)
    _close(t_rglru.linear_scan(_t(a), _t(b)), want, atol=1e-5)


def test_rglru_block_with_a_carried_state_equals_reference():
    """A prefill chunk onto a carried (h, conv) state, then one decode step:
    outputs at atol 1e-5, h and conv at 1e-5."""
    rcfg, tcfg, params, _ = _carried("recurrentgemma-2b")
    p = _block_params(params, 0)["mix"]
    rng = np.random.default_rng(8)
    B, w = 2, rcfg.rnn_width
    x = rng.normal(size=(B, 9, rcfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(B, w)).astype(np.float32)
    conv0 = rng.normal(size=(B, rcfg.conv_width - 1, w)).astype(np.float32)
    rp = jax.tree.map(jnp.asarray, p)
    r_cache = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0), "pos": jnp.int32(5)}
    t_cache = {"h": _t(h0), "conv": _t(conv0), "pos": 5}
    for xs in (x[:, :8], x[:, 8:]):
        want, r_cache = r_rglru.rglru_block(rcfg, rp, jnp.asarray(xs), cache=r_cache)
        got, t_cache = t_rglru.rglru_block(tcfg, _torch_tree(p), _t(xs), cache=t_cache)
        _close(got, want, atol=1e-5)
        for key in ("h", "conv"):
            _close(t_cache[key], r_cache[key], atol=1e-5, rtol=1e-5)
    assert t_cache["pos"] == int(r_cache["pos"]) == 14


def test_ring_cache_past_the_window_equals_reference():
    """recurrentgemma-smoke (window 16) prefills 24 tokens, more than its
    ring of 16 slots, and decodes 12: every step's logits at atol 1e-4 and
    greedy tokens equal; each local layer's ring (k, v at 1e-5, kv_pos
    exactly) equal to the reference's after the prefill and at the end."""
    rcfg, tcfg, params, model = _carried("recurrentgemma-2b")
    B, S_max, P = 2, 48, 24
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (B, P))
    r_logits, rc = jax.jit(r_steps.make_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)}, r_tr.init_caches(rcfg, B, S_max))
    tc = model.init_caches(B, S_max)
    t_logits, tc = t_steps.make_prefill_step(tcfg)(model, {"tokens": _t(toks)}, tc)
    specs = t_tr.layer_specs(tcfg)
    local = [i for i, (kind, _) in enumerate(specs) if kind == "local"]
    assert local and all(tc[i]["k"].shape[1] == rcfg.window for i in local)

    def rings_equal():
        i = 0
        for g, (unit, repeats) in enumerate(r_tr.group_layers(rcfg)):
            for r in range(repeats):
                for li, (kind, _) in enumerate(unit):
                    if kind == "local":
                        want = jax.tree.map(lambda a: np.asarray(a)[r], rc[g][li])
                        _close(tc[i]["k"], want["k"], atol=1e-5)
                        _close(tc[i]["v"], want["v"], atol=1e-5)
                        np.testing.assert_array_equal(tc[i]["kv_pos"].numpy(), want["kv_pos"])
                    i += 1

    rings_equal()
    _close(t_logits, r_logits, atol=1e-4)
    r_decode = jax.jit(r_steps.make_decode_step(rcfg))
    d_step = t_steps.make_decode_step(tcfg)
    r_tok = jnp.argmax(r_logits, -1)[:, None].astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)[:, None]
    for i in range(12):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))
        r_logits, rc = r_decode(params, rc, {"tokens": r_tok}, jnp.int32(P + i))
        t_logits, tc = d_step(model, tc, {"tokens": t_tok}, P + i)
        _close(t_logits, r_logits, atol=1e-4)
        r_tok = jnp.argmax(r_logits, -1)[:, None].astype(jnp.int32)
        t_tok = torch.argmax(t_logits, -1)[:, None]
    rings_equal()


# -- xLSTM ----------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [512, 16, 8])
def test_mlstm_core_chunked_with_a_carried_state_equals_reference(chunk):
    """``_mlstm_core_chunked`` over S 48 from a carried (S, n) state at
    chunk 512 (one chunk of 48), 16 and 8: outputs and final states at atol
    1e-5 + rtol 1e-5."""
    rng = np.random.default_rng(chunk)
    B, S, H, dh = 2, 48, 2, 8
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32) for _ in range(3))
    log_f = np.log(rng.uniform(0.8, 1.0, size=(B, S, H))).astype(np.float32)
    i_g = rng.uniform(0.0, 1.0, size=(B, S, H)).astype(np.float32)
    st = (rng.normal(size=(B, H, dh, dh)).astype(np.float32),
          rng.normal(size=(B, H, dh)).astype(np.float32))
    want, (w_S, w_n) = r_xlstm._mlstm_core_chunked(
        *map(jnp.asarray, (q, k, v, log_f, i_g)), chunk=chunk,
        state=tuple(map(jnp.asarray, st)))
    got, (g_S, g_n) = t_xlstm._mlstm_core_chunked(*map(_t, (q, k, v, log_f, i_g)),
                                                  chunk=chunk, state=tuple(map(_t, st)))
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(g_S, w_S, atol=1e-5, rtol=1e-5)
    _close(g_n, w_n, atol=1e-5, rtol=1e-5)


def test_mlstm_gradient_stays_finite_past_the_exp_range():
    """A chunk whose decay passes float32's exp range (log_f -2 over 64
    steps: exp(126) above the diagonal): the outputs equal the reference's
    (atol 1e-5 + rtol 1e-5), the port's gradients of the forget gates are
    finite, and the reference's are NaN (it masks after exp: 0 x inf), as
    in a full-length xlstm-1.3b training step."""
    rng = np.random.default_rng(11)
    B, S, H, dh = 1, 64, 2, 8
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32) for _ in range(3))
    log_f = np.full((B, S, H), -2.0, np.float32)
    i_g = rng.uniform(0.0, 1.0, size=(B, S, H)).astype(np.float32)

    def r_loss(lf):
        return jnp.sum(r_xlstm._mlstm_core_chunked(*map(jnp.asarray, (q, k, v)), lf,
                                                   jnp.asarray(i_g), chunk=64)[0])

    want = r_xlstm._mlstm_core_chunked(*map(jnp.asarray, (q, k, v, log_f, i_g)), chunk=64)[0]
    tlf = _t(log_f).requires_grad_()
    got, _ = t_xlstm._mlstm_core_chunked(*map(_t, (q, k, v)), tlf, _t(i_g), chunk=64)
    _close(got, want, atol=1e-5, rtol=1e-5)
    got.sum().backward()
    assert bool(torch.isfinite(tlf.grad).all())
    assert np.isnan(np.asarray(jax.grad(r_loss)(jnp.asarray(log_f)))).any()


@pytest.mark.parametrize("S", [64, 96, 160])
def test_slstm_across_chunk_boundaries_equals_reference(S):
    """The sLSTM scan from a carried state over S 64 (one chunk), 96 (three
    of 32) and 160 (five of 32): outputs and the final c, n, h, m at atol
    1e-5 + rtol 1e-5; then the gradients of a sum of the outputs through
    the per-chunk checkpoints against ``jax.grad`` (atol 2e-5 + rtol
    1e-4, and 1e-6 of the leaf's largest magnitude: 160 steps of the
    exponential gates carry float32 noise of ~4e-5 to gradients of ~75)."""
    rcfg, tcfg, params, _ = _carried("xlstm-1.3b")
    specs = r_tr.layer_specs(rcfg)
    g = next(i for i, (unit, _) in enumerate(r_tr.group_layers(rcfg))
             if any(kind == "slstm" for kind, _ in unit))
    li = [kind for kind, _ in r_tr.group_layers(rcfg)[g][0]].index("slstm")
    assert ("slstm", "dense43") in specs
    p = _block_params(params, g, li)["mix"]
    rng = np.random.default_rng(S)
    B, H, dh = 2, rcfg.n_heads, rcfg.d_model // rcfg.n_heads
    x = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    state = {k: rng.normal(size=(B, H, dh)).astype(np.float32) for k in ("c", "n", "h")}
    state["n"] = np.abs(state["n"]) + 0.5
    state["m"] = np.full((B, H, dh), -30.0, np.float32)
    rp = jax.tree.map(jnp.asarray, p)
    want, w_st = r_xlstm._slstm_scan(rcfg, rp, jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, state))
    tp = {k: v.requires_grad_() for k, v in _torch_tree(p).items()}
    tx = _t(x).requires_grad_()
    got, g_st = t_xlstm._slstm_scan(tcfg, tp, tx, _torch_tree(state))
    _close(got, want, atol=1e-5, rtol=1e-5)
    for key in ("c", "n", "h", "m"):
        _close(g_st[key], w_st[key], atol=1e-5, rtol=1e-5)
    r_gx, r_gp = jax.grad(lambda xx, pp: jnp.sum(r_xlstm._slstm_scan(
        rcfg, pp, xx, jax.tree.map(jnp.asarray, state))[0]), argnums=(0, 1))(
            jnp.asarray(x), rp)
    got.sum().backward()
    for g, want in ((tx.grad, r_gx), *((tp[k].grad, r_gp[k]) for k in ("w_z", "r_f", "w_o"))):
        _close(g, want, atol=2e-5 + 1e-6 * float(np.abs(np.asarray(want)).max()), rtol=1e-4)


def test_xlstm_prefill_state_and_decode_equal_reference():
    """mLSTM and sLSTM caches after a prefill of 20 tokens (the chunked
    form's final state) and 4 decode steps (the recurrent step): the mLSTM
    states at atol 1e-5 + rtol 1e-5; the sLSTM's c, n, h and m (m from -30)
    at 1e-5 + ``XLSTM_STATE_SCALE`` of each one's largest magnitude, as its
    gates amplify the mLSTM layers' float32 differences."""
    rcfg, tcfg, params, model = _carried("xlstm-1.3b")
    B = 2
    toks = np.random.default_rng(7).integers(0, rcfg.vocab_size, (B, 20))
    _, rc = jax.jit(r_steps.make_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)}, r_tr.init_caches(rcfg, B, 32))
    _, tc = t_steps.make_prefill_step(tcfg)(model, {"tokens": _t(toks)},
                                            model.init_caches(B, 32))
    r_dec, t_dec = jax.jit(r_steps.make_decode_step(rcfg)), t_steps.make_decode_step(tcfg)
    for i in range(4):
        tok = toks[:, i:i + 1]
        _, rc = r_dec(params, rc, {"tokens": jnp.asarray(tok, jnp.int32)}, jnp.int32(20 + i))
        _, tc = t_dec(model, tc, {"tokens": _t(tok)}, 20 + i)
    i = 0
    for g, (unit, repeats) in enumerate(r_tr.group_layers(rcfg)):
        for r in range(repeats):
            for li, (kind, _) in enumerate(unit):
                want = jax.tree.map(lambda a: np.asarray(a)[r], rc[g][li])
                assert sorted(want) == sorted(tc[i])
                for key, val in want.items():
                    if key == "pos":
                        assert tc[i]["pos"] == int(val) == 24
                    elif kind == "slstm":
                        _close(tc[i][key], val, atol=1e-5 + XLSTM_STATE_SCALE * np.abs(val).max())
                    else:
                        _close(tc[i][key], val, atol=1e-5, rtol=1e-5)
                i += 1


# -- the launchers and checkpoints ----------------------------------------------

def test_serve_and_train_cli_on_cpu(capsys):
    """``serve_lm`` and ``train_lm`` through main for deepseek-v2's smoke
    config (MLA + MoE): the timing line, no flash launches off the card,
    finite logits and losses, the same tokens from the same seed."""
    argv = ["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu",
            "--batch-size", "2", "--seq-len", "24", "--new-tokens", "4"]
    t_serve.main(argv)
    out = capsys.readouterr().out
    assert "prefill 12 tok x 2:" in out and "flash kernel launches in the prefill: 0" in out
    a = t_serve.serve_lm(t_serve.build_parser().parse_args(argv))
    b = t_serve.serve_lm(t_serve.build_parser().parse_args(argv))
    assert torch.equal(a["tokens"], b["tokens"]) and tuple(a["tokens"].shape) == (2, 5)
    assert torch.isfinite(a["prefill_logits"]).all()
    targv = ["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu", "--steps", "2",
             "--batch-size", "2", "--seq-len", "16"]
    t_train.main(targv)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert [l.split(":")[0] for l in lines] == ["step 1", "step 2"]
    res = t_train.train_lm(t_train.build_parser().parse_args(targv))
    assert np.isfinite(res["losses"]).all() and res["flash_launches"] == [0, 0]


def test_deepseek_checkpoint_from_train_lm_restores_in_reference(tmp_path):
    """``train_lm --ckpt-dir`` on the float32 deepseek-v2 smoke config (MLA;
    a dense layer 0 then MoE layers with ``ff.shared.{gate,up,down}`` three
    levels deep and the float32 router) writes the reference's keys;
    ``repro.checkpoint.load_checkpoint`` restores them into the reference's
    ``init_params`` tree, equal leaf for leaf to the trained model, and the
    port's ``params_from_numpy`` takes that tree back."""
    cfg = t_configs.get_smoke_config("deepseek-v2-236b")
    args = types.SimpleNamespace(arch="deepseek-v2-236b", smoke=True, device="cpu", seed=0,
                                 steps=2, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path),
                                 ckpt_every=2)
    res = t_train.train_lm(args)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    with np.load(tmp_path / "step_0000000002" / "arrays.npz") as z:
        assert "params/groups/1/0/ff/shared/gate" in z.files
        assert z["params/groups/1/0/ff/router"].dtype == np.float32
    rcfg = r_configs.get_smoke_config("deepseek-v2-236b")
    tree, extra = r_ckpt.load_checkpoint(str(tmp_path),
                                         {"params": r_tr.init_params(rcfg, jax.random.PRNGKey(1))})
    assert extra == {"step": 2}
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 tree["params"], t_tr.params_to_numpy(cfg, res["model"]))
    back = t_tr.params_from_numpy(cfg, jax.tree.map(np.asarray, tree["params"]), "cpu")
    for (n, p), q in zip(back.named_parameters(), res["model"].parameters()):
        assert torch.equal(p, q.detach()), n
