"""Port: LM training (``train_lm``) against the reference on the CPU.

The reference runs its jnp code: ``jax.value_and_grad`` through its
recomputing flash VJP, ``jax.jit(make_train_step(cfg))``.  Inputs are
numpy arrays from a seed; weights are carried across with
``params_from_numpy`` and back with ``params_to_numpy``.  Everything is
float32 at the smoke configs.  Tolerances, each for the same arithmetic
summed in another order by XLA and by torch: the optimizer on the same
gradients rtol 1e-6 (a few float32 roundings an element); the flash VJP
atol 2e-5 (the reference's own kernel-vs-oracle tolerance); the loss atol
1e-5 and gradient leaves atol 2e-5 + rtol 1e-4 (sums over a few layers
and a vocabulary); three train steps as each test states.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro import configs as r_configs
from repro.launch import train as r_train
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import steps as r_steps
from repro.models import transformer as r_tr
from repro.optim import adamw as r_adamw
from repro_torch import configs as t_configs
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import steps as t_steps
from repro_torch.models import transformer as t_tr
from repro_torch.optim import adamw as t_adamw

FAMILIES = r_configs.ARCH_IDS


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_diff(a, b) -> float:
    return max(jax.tree.leaves(jax.tree.map(
        lambda x, y: float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max()),
        a, b)))


def _carried(arch, cfg_fn=lambda c: c):
    rcfg = cfg_fn(r_configs.get_smoke_config(arch))
    tcfg = cfg_fn(t_configs.get_smoke_config(arch))
    params = r_tr.init_params(rcfg, jax.random.PRNGKey(0))
    model = t_tr.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


# -- optimizer -------------------------------------------------------------

def test_schedule_and_global_norm_equal_reference():
    cfg = t_adamw.AdamWConfig(warmup_steps=5, decay_steps=30)
    rcfg = r_adamw.AdamWConfig(warmup_steps=5, decay_steps=30)
    for step in range(0, 40):
        got = t_adamw._schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = r_adamw._schedule(rcfg, jnp.int32(step))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 3, 5))]
    np.testing.assert_allclose(float(t_adamw.global_norm(map(_t, leaves))),
                               float(r_adamw.global_norm(leaves)), rtol=1e-6)


@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clipped", "unclipped"])
def test_adamw_update_equals_reference(clip):
    """Three updates of a random tree from the same gradients: params, m,
    v, grad_norm and lr at rtol 1e-6, atol 1e-7."""
    rng = np.random.default_rng(1)
    shapes = ((4, 6), (6,), (3, 2, 5))
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=6, clip_norm=clip)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    r_params, r_state = list(map(jnp.asarray, params)), r_adamw.adamw_init(list(params))
    t_params = [_t(p) for p in params]
    t_state = t_adamw.adamw_init(t_params)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        r_params, r_state, r_info = r_adamw.adamw_update(
            r_adamw.AdamWConfig(**kw), list(map(jnp.asarray, grads)), r_params, r_state)
        t_state, t_info = t_adamw.adamw_update(
            t_adamw.AdamWConfig(**kw), map(_t, grads), t_params, t_state)
        for a, b in ((r_params, t_params), (r_state.m, t_state.m), (r_state.v, t_state.v)):
            for x, y in zip(a, b):
                np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6, atol=1e-7)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(t_info[key]), float(r_info[key]), rtol=1e-6)
        assert int(t_state.step) == int(r_state.step)
    assert (clip < 1) == (float(t_info["grad_norm"]) > clip)


def test_adamw_update_is_in_place_and_keeps_bf16():
    p = torch.ones(4, dtype=torch.bfloat16)
    ptr = p.data_ptr()
    state = t_adamw.adamw_init([p])
    m_ptr = state.m[0].data_ptr()
    state, _ = t_adamw.adamw_update(t_adamw.AdamWConfig(lr=0.1, warmup_steps=1),
                                    [torch.full((4,), 0.5, dtype=torch.bfloat16)], [p], state)
    assert p.data_ptr() == ptr and p.dtype == torch.bfloat16
    assert state.m[0].data_ptr() == m_ptr and state.m[0].dtype == torch.float32
    assert float(p[0]) < 1.0 and int(state.step) == 1


# -- the loss --------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_chunked_ce_loss_value_and_grads_equal_reference(n_chunks):
    """Masked labels (-1) and chunk counts that halve until they divide S
    (3 -> 1, 8 -> 4 at S 12); the value at atol 1e-6, the gradients of x
    and w at atol 1e-6."""
    rng = np.random.default_rng(n_chunks)
    B, S, d, V = 2, 12, 8, 40
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, ::3] = -1
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: r_layers.chunked_ce_loss(x, w, jnp.asarray(labels), n_chunks),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = t_layers.chunked_ce_loss(tx, tw, _t(labels), n_chunks)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=1e-6, rtol=0)
    masked = t_layers.chunked_ce_loss(_t(x), _t(w), torch.full((B, S), -1), n_chunks)
    assert float(masked) == 0.0


def test_init_mlp_shapes():
    p = t_layers.init_mlp(torch.Generator().manual_seed(0), 16, 24, torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "gate": (16, 24), "up": (16, 24), "down": (24, 16)}
    assert set(t_layers.init_mlp(None, 16, 24, torch.float32, gated=False)) == {"up", "down"}


# -- the flash VJP ---------------------------------------------------------

@pytest.mark.parametrize("S,T,pos,H,K,window,q_chunk,kv_chunk", [
    (16, 16, 0, 4, 2, 0, 8, 4),      # GQA, chunks smaller than S
    (16, 16, 0, 4, 2, 3, 4, 8),      # a local window
    (16, 16, 0, 6, 2, 0, 16, 16),    # one tile, 3 query heads a kv head
    (8, 16, 8, 4, 1, 0, 4, 8),       # a later chunk against a longer kv
    (12, 12, 0, 2, 2, 5, 4, 4),      # kv = H, window
])
def test_flash_vjp_equals_reference(S, T, pos, H, K, window, q_chunk, kv_chunk):
    """out, lse (the reference's ``_flash_fwd`` on expanded kv), dq, dk and
    dv (``jax.vjp`` through ``repro.models.attention.flash_attention``,
    whose kv expansion sums dk and dv over each group) at atol 2e-5."""
    rng = np.random.default_rng(S + T + H + window)
    B, hd = 2, 8
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, K, hd)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(pos, pos + S, dtype=np.int32)[None], (B, S)).copy()
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    kw = dict(window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    r_out, r_lse = r_attn._flash_fwd(jq, r_attn._expand_kv(jk, H), r_attn._expand_kv(jv, H),
                                     jnp.asarray(q_pos), jnp.asarray(kv_pos), window,
                                     q_chunk, kv_chunk)
    out, vjp = jax.vjp(lambda a, b, c: r_attn.flash_attention(
        a, b, c, jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw), jq, jk, jv)
    r_dq, r_dk, r_dv = vjp(jnp.asarray(do))

    t_out, t_lse = t_attn._flash_fwd(_t(q), t_attn._expand_kv(_t(k), H),
                                     t_attn._expand_kv(_t(v), H), _t(q_pos), _t(kv_pos),
                                     window, q_chunk, kv_chunk)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), atol=2e-5, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(r_lse), atol=2e-5, rtol=0)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    got = t_attn.flash_attention(tq, tk, tv, _t(q_pos), _t(kv_pos), **kw)
    got.backward(_t(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=2e-5, rtol=0)
    for g, want in ((tq.grad, r_dq), (tk.grad, r_dk), (tv.grad, r_dv)):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_flash_vjp_kernel_route_equals_chunked_route():
    """The VJP with the kernel's forward (here its plain version, with its
    ``lse``: the card's route at positions 0..S-1) against the chunked
    route, at atol 2e-5; the plain version's lse against the reference's."""
    rng = np.random.default_rng(7)
    B, S, H, K, hd = 2, 32, 4, 2, 16
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, K, hd)).astype(np.float32) for _ in range(2))
    do = _t(rng.normal(size=(B, S, H, hd)).astype(np.float32))
    pos = _t(np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy())
    _, lse = t_fa.flash_forward_plain(_t(q), _t(k), _t(v), return_lse=True)
    _, r_lse = r_attn._flash_fwd(*(jnp.asarray(a) for a in (
        q, np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2), pos.numpy(), pos.numpy())),
        0, 8, 8)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), atol=2e-5, rtol=0)
    grads = []
    for kernel in (True, False):
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        out = t_attn._FlashAttention.apply(tq, tk, tv, pos, pos, 0, 8, 8, kernel)
        out.backward(do)
        grads.append([out.detach(), tq.grad, tk.grad, tv.grad])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)


# -- the model's loss and gradients ---------------------------------------

def _batch(cfg, seed, B=2, S=16):
    b = t_train.lm_batch(cfg, np.random.default_rng(seed), B, S)
    b["labels"] = b["labels"].copy()
    b["labels"][0, 3] = -1                          # a masked position
    return b


# xlstm-smoke: layer 0's rms_norm divides the 0.02-scale embeddings by their
# rms (x ~50), so its embedding gradient reaches ~40 and float32 noise from
# the backward ~6e-4 there (against a float64 run of the port, the
# reference's float32 gradient is off by 6.3e-4 and the port's by 1.8e-4):
# that family's leaves also get 5e-5 of the leaf's largest magnitude
LEAF_SCALE_ATOL = {"xlstm-1.3b": 5e-5}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_leaf_equal_reference(arch):
    """``loss_fn`` (remat on, as the reference's default) at atol 1e-5 and
    every gradient leaf, laid out by ``params_to_numpy``, at atol 2e-5 +
    rtol 1e-4 (xlstm-smoke: ``LEAF_SCALE_ATOL``).  pixtral-smoke prepends
    patch embeds (only the trailing label positions are scored),
    musicgen-smoke is audio_stub with 4 codebook heads (the mean over
    codebooks); the MoE, MLA, RG-LRU and xLSTM families are the rest."""
    rcfg, tcfg, params, model = _carried(arch)
    batch = _batch(tcfg, 3)
    want, r_grads = jax.value_and_grad(lambda p: r_tr.loss_fn(
        rcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    got = t_tr.loss_fn(tcfg, model, {k: _t(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5, rtol=0)
    t_grads = t_tr.params_to_numpy(tcfg, model, [p.grad for p in model.parameters()])
    assert jax.tree.structure(t_grads) == jax.tree.structure(jax.tree.map(np.asarray, r_grads))
    scale = LEAF_SCALE_ATOL.get(arch, 0.0)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=2e-5 + scale * float(np.abs(np.asarray(b)).max()), rtol=1e-4),
        t_grads, r_grads)


def test_loss_without_remat_and_params_round_trip():
    rcfg, tcfg, params, model = _carried("qwen3-32b")
    tree = jax.tree.map(np.asarray, params)
    jax.tree.map(np.testing.assert_array_equal, t_tr.params_to_numpy(tcfg, model), tree)
    batch = _batch(tcfg, 4)
    want = r_tr.loss_fn(rcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
                        remat=False)
    got = t_tr.loss_fn(tcfg, model, {k: _t(v) for k, v in batch.items()}, remat=False)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5, rtol=0)


# -- the train step --------------------------------------------------------

@pytest.mark.parametrize("arch,microbatches", [("tinyllama-1.1b", 1), ("tinyllama-1.1b", 2),
                                               ("musicgen-large", 2), ("pixtral-12b", 1)])
def test_train_step_three_steps_equal_reference(arch, microbatches):
    """Three steps from the same weights and batches: loss atol 1e-5,
    grad_norm rtol 1e-5, lr rtol 1e-6, m and v atol 1e-6, params atol 5e-6.
    The optimizer's eps is 1e-3 here: AdamW divides each element's moment
    by sqrt(v) + eps, so with the default 1e-8 an element whose gradient is
    within float32 noise (~4e-6 here) of zero can step by up to lr in
    either direction; eps 1e-3 bounds that to ~lr x 4e-3 and leaves every
    code path the same."""
    rcfg, tcfg, params, model = _carried(arch)
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)
    r_step = jax.jit(r_steps.make_train_step(rcfg, opt_cfg=r_adamw.AdamWConfig(**kw),
                                             microbatches=microbatches))
    t_step = t_steps.make_train_step(tcfg, opt_cfg=t_adamw.AdamWConfig(**kw),
                                     microbatches=microbatches)
    r_opt, t_opt = r_adamw.adamw_init(params), t_adamw.adamw_init(model.parameters())
    nprng = np.random.default_rng(5)
    for _ in range(3):
        batch = t_train.lm_batch(tcfg, nprng, 4, 16)
        params, r_opt, r_info = r_step(params, r_opt,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        t_opt, t_info = t_step(model, t_opt, {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(t_info["loss"]), float(r_info["loss"]), atol=1e-5)
        np.testing.assert_allclose(float(t_info["grad_norm"]), float(r_info["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(t_info["lr"]), float(r_info["lr"]), rtol=1e-6)
        assert _max_diff(t_tr.params_to_numpy(tcfg, model, t_opt.m), r_opt.m) <= 1e-6
        assert _max_diff(t_tr.params_to_numpy(tcfg, model, t_opt.v), r_opt.v) <= 1e-6
        assert _max_diff(t_tr.params_to_numpy(tcfg, model), params) <= 5e-6
    assert int(t_opt.step) == 3


# -- the launcher ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "pixtral-12b", "musicgen-large"])
def test_lm_batch_equals_reference_draws(arch, monkeypatch):
    """The reference's ``train_lm`` draws its batches inline; run it for
    three steps with a step function that records what it is given (and
    ``jax.jit`` as the identity), and hold ``lm_batch`` to those arrays
    from the same seed, exactly."""
    seen = []

    def fake_step(cfg):
        def step(params, opt, batch):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return params, opt, {"loss": jnp.float32(0), "grad_norm": jnp.float32(0)}
        return step

    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(r_steps, "make_train_step", fake_step)
    args = types.SimpleNamespace(arch=arch, smoke=True, seed=11, batch_size=3, seq_len=20,
                                 steps=3, ckpt_dir=None, ckpt_every=50)
    r_train.train_lm(args)
    cfg = t_configs.get_smoke_config(arch)
    nprng = np.random.default_rng(11)
    assert len(seen) == 3
    for want in seen:
        got = t_train.lm_batch(cfg, nprng, 3, 20)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_train_lm_cli_on_cpu(capsys, tmp_path):
    """``--arch tinyllama-1.1b --smoke --device cpu --steps 3`` through
    main: three ``step k: loss=... gnorm=...`` lines with finite values, no
    flash launches off the card, the same losses from the same seed, and a
    checkpoint in the reference's layout."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch-size", "4", "--seq-len", "32"]
    t_train.main(argv)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert [l.split(":")[0] for l in lines] == ["step 1", "step 2", "step 3"]
    assert all("loss=" in l and "gnorm=" in l for l in lines)
    args = t_train.build_parser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    res = t_train.train_lm(args)
    assert np.isfinite(res["losses"]).all() and np.isfinite(res["grad_norms"]).all()
    assert res["flash_launches"] == [0, 0, 0] and res["step_event_ms"] == [None] * 3
    assert [f"{x:.4f}" for x in res["losses"]] == [l.split("loss=")[1].split()[0]
                                                   for l in lines]
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_port_checkpoint_restores_in_reference(tmp_path):
    """A reference tree -> the port's model -> the port's checkpoint ->
    ``repro.checkpoint.load_checkpoint`` into the reference's
    ``init_params`` tree: equal leaf for leaf (float32 smoke, stub frontend
    and codebook heads included)."""
    for arch in ("tinyllama-1.1b", "musicgen-large"):
        rcfg, tcfg, params, model = _carried(arch)
        d = str(tmp_path / arch)
        CheckpointManager(d).save(7, t_train.lm_checkpoint_arrays(tcfg, model),
                                  extra={"step": 7})
        target = r_tr.init_params(rcfg, jax.random.PRNGKey(1))
        tree, extra = r_ckpt.load_checkpoint(d, {"params": target})
        assert extra == {"step": 7}
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     tree["params"], params)


def test_bf16_checkpoint_is_the_reference_bytes(tmp_path):
    """bf16 parameters are written as numpy's 2-byte void, with the bits of
    the reference's ml_dtypes bfloat16 arrays, and restore into bf16
    tensors bit for bit."""
    bf16 = lambda c: dataclasses.replace(c, dtype="bfloat16")
    rcfg, tcfg, params, model = _carried("smollm-360m", bf16)
    arrays = t_train.lm_checkpoint_arrays(tcfg, model)
    CheckpointManager(str(tmp_path)).save(1, arrays)
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as z:
        want = np.asarray(params["groups"][0][0]["mix"]["wq"])
        got = z["params/groups/0/0/mix/wq"]
        assert got.dtype.kind == "V" and got.dtype.itemsize == 2
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    like = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in arrays.items()}
    back, _ = load_checkpoint(str(tmp_path), like)
    wq = torch.stack([b.mix["wq"].detach() for b in model.blocks])
    assert back["params/groups/0/0/mix/wq"].dtype == torch.bfloat16
    assert torch.equal(back["params/groups/0/0/mix/wq"], wq)
    assert torch.equal(t_tr._tensor(arrays["params/embed"]), model.embed.detach())
