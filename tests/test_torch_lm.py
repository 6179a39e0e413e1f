"""Port: the LM substrate's serving path against the reference.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; prompts and attention inputs are made with
numpy from a seed.  The reference runs its jnp route and, for the flash
kernel, its Pallas kernel in interpret mode (as ``tests/test_kernels.py``
runs it).  Everything is float32.  Tolerances: the flash functions at atol
2e-5 (the reference's own kernel-vs-oracle tolerance); layers at 1e-5 and
model logits at 1e-4 (the same arithmetic summed in other orders by XLA
and torch, over a few layers); greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.kernels import ref as r_ref
from repro.kernels.flash_attention import flash_forward as r_flash_forward
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import steps as r_steps
from repro.models import transformer as r_tr
from repro_torch import configs as t_configs
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import steps as t_steps
from repro_torch.models import transformer as t_tr

SERVED = r_configs.ARCH_IDS


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
    for getter in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(r_configs, getter)(arch))
        got = dataclasses.asdict(getattr(t_configs, getter)(arch))
        assert got == want
    cfg = t_configs.get_config(arch)
    assert cfg.param_count() == r_configs.get_config(arch).param_count()


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(t_layers.rms_norm(_t(x), _t(scale), 1e-6).numpy(),
                               np.asarray(r_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_layers.rope_frequencies(16, 1e6).numpy(),
                               np.asarray(r_layers.rope_frequencies(16, 1e6)), rtol=1e-6)
    np.testing.assert_allclose(t_layers.apply_rope(_t(x), _t(pos), 10000.0).numpy(),
                               np.asarray(r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                                              10000.0)),
                               atol=1e-5, rtol=0)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    for gated in (True, False):
        p = r_layers.init_mlp(jax.random.PRNGKey(1), 16, 24, jnp.float32, gated=gated)
        got = t_layers.mlp({k: _t(v) for k, v in p.items()}, _t(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(r_layers.mlp(p, jnp.asarray(h))),
                                   atol=1e-5, rtol=0)


# the shapes of tests/test_kernels.py::test_flash_attention_kernel
@pytest.mark.parametrize("B,S,H,hd,bq,bkv", [(2, 64, 3, 16, 16, 16), (1, 128, 2, 32, 32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_plain_equals_reference(B, S, H, hd, bq, bkv, causal):
    rng = np.random.default_rng(S + hd)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = np.asarray(r_flash_forward(jq, jk, jv, causal=causal, block_q=bq,
                                        block_kv=bkv, interpret=True))
    oracle = np.asarray(r_ref.flash_ref(jq, jk, jv, causal))
    got = t_fa.flash_forward(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=0)


def test_flash_forward_plain_groups_kv_heads():
    """Grouped kv heads equal the reference's pre-expanded ones (atol 2e-5);
    bf16 inputs give a bf16 output."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 48, 6, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 48, 2, 16)).astype(np.float32) for _ in range(2))
    want = np.asarray(r_ref.flash_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 3, axis=2),
                                      jnp.repeat(jnp.asarray(v), 3, axis=2)))
    np.testing.assert_allclose(t_fa.flash_forward_plain(_t(q), _t(k), _t(v)).numpy(), want,
                               atol=2e-5, rtol=0)
    out = t_fa.flash_forward_plain(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.flash_forward_cuda(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="kv heads"):
        t_fa.flash_forward_plain(_t(q), _t(k[:, :, :1]).repeat(1, 1, 4, 1),
                                 _t(v[:, :, :1]).repeat(1, 1, 4, 1))


@pytest.mark.parametrize("B,S,H,KH,hd,blk", [(2, 128, 8, 2, 64, 32), (2, 64, 6, 2, 16, 16)])
def test_flash_forward_plain_bf16_equals_reference(B, S, H, KH, hd, blk):
    """bf16, grouped kv heads: the plain version (the yardstick the card's
    tensor-core kernel is held to) against the reference's Pallas kernel in
    interpret mode on kv repeated to H heads, at the bf16 tolerance
    2^-7 x (max|v| + max|out|): the two round p to bf16 against different
    running maxima and round the output to bf16.  Per element: 2^-7 x
    (|out| + the p-weighted mean of |v|), with 2^-6 of that for the float32
    sums."""
    rng = np.random.default_rng(S + hd)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KH, hd)).astype(np.float32) for _ in range(2))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    G = H // KH
    want = np.asarray(r_flash_forward(jq, jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2),
                                      causal=True, block_q=blk, block_kv=blk,
                                      interpret=True).astype(jnp.float32))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = t_fa.flash_forward_plain(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    tol = 2 ** -7 * (float(tv.float().abs().max()) + float(np.abs(want).max()))
    diff = np.abs(got.float().numpy() - want)
    assert float(diff.max()) <= tol
    w = t_fa.flash_forward_plain(tq.float(), tk.float(), tv.float().abs(), causal=True)
    assert (diff <= 2 ** -7 * (1 + 2 ** -6) * (np.abs(want) + w.numpy())).all()


@pytest.mark.parametrize("S,T,pos,window", [(8, 32, 10, 0), (16, 64, 16, 0), (8, 8, 0, 0),
                                            (32, 32, 0, 6)])
def test_flash_attention_routes_equal_reference(S, T, pos, window):
    """The port's flash_attention with a cache (S != T, positions from
    ``pos``, empty slots at 2**30), the plain S == T route, and a window."""
    rng = np.random.default_rng(S + T + pos)
    B, H, K, hd = 2, 4, 2, 16
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, K, hd)).astype(np.float32) for _ in range(2))
    q_pos = np.broadcast_to(np.arange(pos, pos + S, dtype=np.int32)[None], (B, S))
    kv_pos = np.arange(T, dtype=np.int32)
    kv_pos = np.broadcast_to(np.where(kv_pos < pos + S, kv_pos, 2 ** 30)[None], (B, T))
    args = (q, k, v, q_pos, kv_pos.astype(np.int32))
    want = np.asarray(r_attn.flash_attention(*map(jnp.asarray, args), window=window,
                                             q_chunk=8, kv_chunk=16))
    got = t_attn.flash_attention(*map(_t, args), window=window, q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_decode_attention_equals_reference():
    rng = np.random.default_rng(9)
    cfg = t_configs.get_smoke_config("tinyllama-1.1b")
    B, T, H, K, hd = 3, 24, 4, 2, 16
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, K, hd)).astype(np.float32) for _ in range(2))
    positions = np.full((B, 1), 13, np.int32)
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    want = np.asarray(r_attn._decode_attention(cfg, *map(jnp.asarray, (q, k, v, positions,
                                                                        kv_pos)), 0))
    got = t_attn._decode_attention(cfg, *map(_t, (q, k, v, positions, kv_pos)), 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _carried(arch):
    rcfg, tcfg = r_configs.get_smoke_config(arch), t_configs.get_smoke_config(arch)
    params = r_tr.init_params(rcfg, jax.random.PRNGKey(0))
    model = t_tr.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_logits_match_reference(arch):
    """Prefill (from position 0: the port attends over the prompt's own q,
    k, v) and eight greedy decode steps, for every config; logits atol
    1e-4, tokens equal.
    smollm-smoke ties its embeddings and has 3 heads over 1 kv head,
    qwen3-smoke has qk-norm, starcoder2-smoke the GELU MLP; pixtral-smoke
    serves text tokens on its vision_stub backbone; musicgen-smoke
    (audio_stub, 4 codebook heads) prefills normal frame embeddings,
    decodes zero embeds and takes the argmax over the first codebook's
    logits, as the reference's ``serve_lm`` does."""
    rcfg, tcfg, params, model = _carried(arch)
    B, S_max, P = 2, 32, 12
    V = rcfg.vocab_size
    if rcfg.frontend == "audio_stub":
        emb = np.random.default_rng(1).normal(size=(B, P, rcfg.d_model)).astype(np.float32)
        zeros = np.zeros((B, 1, rcfg.d_model), np.float32)
        r_batch, t_batch = {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)}
        r_inp = lambda tok: {"embeds": jnp.asarray(zeros)}
        t_inp = lambda tok: {"embeds": torch.from_numpy(zeros)}
    else:
        toks = np.random.default_rng(1).integers(0, V, (B, P))
        r_batch = {"tokens": jnp.asarray(toks, jnp.int32)}
        t_batch = {"tokens": torch.from_numpy(toks)}
        r_inp = lambda tok: {"tokens": tok}
        t_inp = lambda tok: {"tokens": tok}
    r_logits, r_caches = jax.jit(r_steps.make_prefill_step(rcfg))(
        params, r_batch, r_tr.init_caches(rcfg, B, S_max))
    t_logits, t_caches = t_steps.make_prefill_step(tcfg)(
        model, t_batch, model.init_caches(B, S_max))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=0)
    r_decode = jax.jit(r_steps.make_decode_step(rcfg))
    t_decode = t_steps.make_decode_step(tcfg)
    r_tok = jnp.argmax(r_logits[:, :V], -1)[:, None].astype(jnp.int32)
    t_tok = torch.argmax(t_logits[:, :V], -1)[:, None]
    for i in range(8):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))
        r_logits, r_caches = r_decode(params, r_caches, r_inp(r_tok), jnp.int32(P + i))
        t_logits, t_caches = t_decode(model, t_caches, t_inp(t_tok), P + i)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=0)
        r_tok = jnp.argmax(r_logits[:, :V], -1)[:, None].astype(jnp.int32)
        t_tok = torch.argmax(t_logits[:, :V], -1)[:, None]
    assert t_caches[0]["pos"] == P + 8


def test_forward_without_cache_and_chunked_prefill_match_reference():
    """forward(caches=None) and a second prefill chunk at pos > 0 (the
    cache branch over S_max slots), atol 1e-4."""
    rcfg, tcfg, params, model = _carried("tinyllama-1.1b")
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 16))
    want, _ = r_tr.forward(rcfg, params, tokens=jnp.asarray(toks, jnp.int32))
    with torch.no_grad():       # the parameters are trainable
        got, caches = model(torch.from_numpy(toks))
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    rp, tp = r_steps.make_prefill_step(rcfg), t_steps.make_prefill_step(tcfg)
    rc, tc = r_tr.init_caches(rcfg, 2, 32), model.init_caches(2, 32)
    _, rc = rp(params, {"tokens": jnp.asarray(toks[:, :8], jnp.int32)}, rc)
    _, tc = tp(model, {"tokens": torch.from_numpy(toks[:, :8])}, tc)
    # the reference's prefill step numbers a chunk's positions from 0
    # (forward without positions) while the cache sits at pos 8
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8))
    r_h, _ = r_tr.forward(rcfg, params, tokens=jnp.asarray(toks[:, 8:], jnp.int32),
                          positions=jnp.asarray(pos), caches=rc)
    with torch.no_grad():
        t_h, _ = model(torch.from_numpy(toks[:, 8:]), positions=torch.from_numpy(pos.copy()),
                       caches=tc)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(r_h), atol=1e-4, rtol=0)


def test_params_from_numpy_rejects_a_mismatched_tree():
    rcfg, tcfg, params, _ = _carried("qwen3-32b")
    tree = jax.tree.map(np.asarray, params)
    del tree["groups"][0][0]["mix"]["q_norm"]
    with pytest.raises(ValueError, match="q_norm"):
        t_tr.params_from_numpy(tcfg, tree, "cpu")


def test_init_params_shapes_and_scales():
    cfg = t_configs.get_smoke_config("smollm-360m")
    model = t_tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not hasattr(model, "unembed") and model.unembed_matrix().shape == (60, 512)
    blk = model.blocks[0]
    assert tuple(blk.mix["wq"].shape) == (60, 3, 20) and tuple(blk.mix["wk"].shape) == (60, 1, 20)
    assert abs(float(model.embed.std()) - 0.02) < 0.002
    assert abs(float(blk.ff["up"].std()) - 60 ** -0.5) < 0.01
    assert float(blk.norm1.abs().sum()) == 0.0
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + cfg.d_model          # + the final norm
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_tr.init_params(cfg, torch.Generator().manual_seed(0))


def test_serve_lm_cli_on_cpu(capsys):
    """``--arch tinyllama-1.1b --smoke --device cpu`` through main: the
    reference's timing line, no flash launches off the card, greedy tokens
    equal to a second run (the same seed); the MoE family serves too."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--batch-size", "2", "--seq-len", "24", "--new-tokens", "5"]
    t_serve.main(argv)
    out = capsys.readouterr().out
    assert "prefill 12 tok x 2:" in out and "ms/step" in out and "tok/s" in out
    assert "flash kernel launches in the prefill: 0" in out
    res = t_serve.serve_lm(t_serve.build_parser().parse_args(argv))
    res2 = t_serve.serve_lm(t_serve.build_parser().parse_args(argv))
    assert tuple(res["tokens"].shape) == (2, 6) and res["flash_launches"] == 0
    assert torch.equal(res["tokens"], res2["tokens"])
    assert torch.isfinite(res["prefill_logits"]).all()
    t_serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu"])
    assert "flash kernel launches in the prefill: 0 (3 layers, qwen3-moe-smoke" in \
        capsys.readouterr().out
