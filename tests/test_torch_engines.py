"""Port parity: every inference engine and each kernel module against the
JAX reference, exact (tolerance 0).

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (which the card's kernels are held to, bit
for bit, by ``chip_smoke.py`` and the ``cuda`` tests) against the
reference: its Pallas kernels in interpret mode at small sizes, its oracle
at tm-mnist width.
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import packetizer as ref_pk  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.kernels import fused_infer as ref_fused  # noqa: E402
from repro.kernels import sparse_infer as ref_sparse  # noqa: E402
from repro.kernels import term_infer as ref_term  # noqa: E402
from repro_torch.core import compiler as port_compiler  # noqa: E402
from repro_torch.core import packetizer as port_pk  # noqa: E402
from repro_torch.core import tm as port_tm  # noqa: E402
from repro_torch.data.synthetic import make_boolean_classification  # noqa: E402
from repro_torch.kernels import fused_infer, sparse_infer, term_infer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "src", "repro_torch", "assets", "tm_mnist_e1.npz")
ENGINES = ("auto", "factorized", "sparse", "dense", "oracle")


def _random_tm(n_features, n_classes, cpc, include_density, seed):
    rng = np.random.default_rng(seed)
    C = n_classes * cpc
    ta = np.where(
        rng.random((C, 2 * n_features)) < include_density,
        rng.integers(0, 127, (C, 2 * n_features)),
        rng.integers(-128, 0, (C, 2 * n_features)),
    ).astype(np.int8)
    kw = dict(n_features=n_features, n_classes=n_classes, clauses_per_class=cpc)
    return ref_tm.TMConfig(**kw), port_tm.TMConfig(**kw), ta


def _pair(rcfg, pcfg, ta, dedup=True):
    return (ref_compiler.compile_tm(rcfg, ta, dedup=dedup),
            port_compiler.compile_tm(pcfg, ta, dedup=dedup))


def _inputs(n_features, batch, seed):
    x = np.random.default_rng(seed).integers(0, 2, (batch, n_features), dtype=np.uint8)
    return ref_pk.pack_literals(jnp.asarray(x)), port_pk.pack_literals(torch.from_numpy(x))


def _check_all_engines(a, b, n_features, batch, seed):
    xr, xt = _inputs(n_features, batch, seed)
    want = np.asarray(ref_compiler.run_compiled(a, xr, engine="oracle"))
    for eng in ENGINES:
        got = port_compiler.run_compiled(b, xt, engine=eng)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=eng)
    return xt, want


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("batch", [1, 31, 32, 33, 97])
def test_run_compiled_every_engine_ragged(dedup, batch):
    rcfg, pcfg, ta = _random_tm(24, 3, 6, 0.12, batch)
    a, b = _pair(rcfg, pcfg, ta, dedup=dedup)
    _check_all_engines(a, b, 24, batch, seed=batch + 1)


def _zero_sharing_bank():
    kw = dict(n_features=64, n_classes=2, clauses_per_class=8)
    ta = np.full((16, 128), -5, np.int8)
    for c in range(16):
        ta[c, (c * 8) % 128] = 3
        ta[c, (c * 8 + 1) % 128] = 3
    return ref_tm.TMConfig(**kw), port_tm.TMConfig(**kw), ta


def _full_sharing_bank():
    kw = dict(n_features=64, n_classes=2, clauses_per_class=8)
    ta = np.full((16, 128), -5, np.int8)
    ta[:, 3] = 3
    ta[:, 5] = 3
    for c in range(16):
        ta[c, 64 + ((c * 4) % 64)] = 3
    return ref_tm.TMConfig(**kw), port_tm.TMConfig(**kw), ta


@pytest.mark.parametrize("bank, dedup", [(_zero_sharing_bank, True),
                                         (_full_sharing_bank, True),
                                         (_full_sharing_bank, False)])
def test_zero_and_full_sharing(bank, dedup):
    rcfg, pcfg, ta = bank()
    a, b = _pair(rcfg, pcfg, ta, dedup=dedup)
    fs = b.default_factorized_schedule
    assert fs.realized_term_sharing == a.default_factorized_schedule.realized_term_sharing
    _check_all_engines(a, b, 64, 11, seed=3)


def test_all_empty_artifact():
    rcfg, pcfg, ta = _random_tm(16, 2, 4, 0.0, 3)
    a, b = _pair(rcfg, pcfg, ta)
    assert b.default_schedule.n_tiles == 0
    xt, want = _check_all_engines(a, b, 16, 9, seed=4)
    assert not want.any()
    for eng in ("sparse", "factorized"):
        got = port_compiler.run_compiled(b, xt, engine=eng, early_exit=True, quality=0)
        assert not got.numpy().any()


@pytest.mark.parametrize("seed, density", [(0, 0.12), (1, 0.05), (2, 0.2)])
def test_early_exit_argmax_identical(seed, density):
    rcfg, pcfg, ta = _random_tm(48, 4, 16, density, seed)
    a, b = _pair(rcfg, pcfg, ta)
    xr, xt = _inputs(48, 70, seed + 10)
    for eng in ("sparse", "factorized"):
        want = np.asarray(ref_compiler.run_compiled(
            a, xr, engine=eng, early_exit=True, interpret=True))
        got = port_compiler.run_compiled(b, xt, engine=eng, early_exit=True).numpy()
        full = port_compiler.run_compiled(b, xt, engine=eng).numpy()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_array_equal(got.argmax(-1), full.argmax(-1))


def _confident_pair():
    """The reference's canonical early-exit artifact (tests/test_anytime.py
    ``_confident_setup``): a dominant always-firing clause in the first
    block decides every sample, and a tail clause with a small vote shows
    whether its fold was skipped.  Returns both packages' artifacts over the
    same arrays and the packed inputs."""
    rcfg, _, ta = _random_tm(48, 4, 16, 0.1, 7)
    comp = ref_compiler.compile_tm(rcfg, ta)
    F = rcfg.n_features
    inc, wid = comp.include_words, comp.word_ids

    def lits(r):
        return [int(wid[w]) * 32 + b for w in range(inc.shape[1])
                for b in range(32) if int(inc[r, w]) >> b & 1]

    row = want = None
    for r in range(inc.shape[0]):
        feats, ok = {}, bool(lits(r))
        for j in lits(r):
            f, pos = (j, 1) if j < F else (j - F, 0)
            if feats.setdefault(f, pos) != pos:
                ok = False
                break
        if ok:
            row, want = r, feats
            break
    for arr in (comp.include_words, comp.votes):
        arr[[0, row]] = arr[[row, 0]]
    comp.votes[0] = 0
    comp.votes[0, 0], comp.votes[0, 1] = 4000, -4000
    comp.include_words[20] = comp.include_words[0]
    comp.votes[20] = 0
    comp.votes[20, 2], comp.votes[20, 3] = 5, -5
    for memo in (comp._margins, comp._fmargins, comp._schedules,
                 comp._fschedules, comp._prefix_schedules):
        memo.clear()
    port = port_compiler.CompiledTM(
        include_words=comp.include_words.copy(), word_ids=comp.word_ids.copy(),
        votes=comp.votes.copy(), n_features=comp.n_features,
        n_classes=comp.n_classes,
        stats=port_compiler.CompileStats(**dataclasses.asdict(comp.stats)))
    x = np.random.default_rng(3).integers(0, 2, (40, F), dtype=np.uint8)
    for f, pos in want.items():
        x[:, f] = pos
    return comp, port, ref_pk.pack_literals(jnp.asarray(x)), \
        port_pk.pack_literals(torch.from_numpy(x))


@pytest.mark.parametrize("engine", ["sparse", "factorized"])
def test_early_exit_truncates_like_reference(engine):
    """With the reference's slab cut to one 32-sample word (block_s=1, the
    port's early-exit slab) both walks stop at the same folds: identical
    truncated sums, different from the full walk, same argmax."""
    a, b, xr, xt = _confident_pair()
    tiling = dict(block_c=8, block_j=8)
    full = port_compiler.run_compiled(b, xt, engine=engine, **tiling).numpy()
    ee = port_compiler.run_compiled(b, xt, engine=engine, early_exit=True,
                                    **tiling).numpy()
    want = np.asarray(ref_compiler.run_compiled(
        a, xr, engine=engine, early_exit=True, interpret=True, block_s=1, **tiling))
    np.testing.assert_array_equal(ee, want)
    np.testing.assert_array_equal(ee.argmax(-1), full.argmax(-1))
    assert not np.array_equal(ee, full), "early exit never fired"


@pytest.mark.parametrize("engine", ["sparse", "factorized"])
@pytest.mark.parametrize("tiling", [dict(), dict(block_c=8, block_j=4)])
def test_quality_tiers_within_bound(engine, tiling):
    rcfg, pcfg, ta = _random_tm(48, 4, 16, 0.12, 5)
    a, b = _pair(rcfg, pcfg, ta)
    xr, xt = _inputs(48, 64, 6)
    exact = np.asarray(ref_compiler.run_compiled(a, xr, engine="oracle"))
    levels = b.quality_levels(engine, **tiling)
    assert levels == a.quality_levels(engine, **tiling)
    for q in levels[1:]:
        got = port_compiler.run_compiled(b, xt, engine=engine, quality=q["level"],
                                         **tiling).numpy()
        want = np.asarray(ref_compiler.run_compiled(
            a, xr, engine=engine, quality=q["level"], interpret=True, **tiling))
        np.testing.assert_array_equal(got, want)      # same prefix, same sums
        served = got.argmax(-1)
        gap = exact.max(-1) - exact[np.arange(len(served)), served]
        assert (gap <= q["bound"]).all()


def test_committed_asset_every_engine():
    a = ref_compiler.CompiledTM.load(ASSET)
    b = port_compiler.CompiledTM.load(ASSET)
    X, _ = make_boolean_classification(97, 784, 10, seed=2)
    xr = ref_pk.pack_literals(jnp.asarray(X))
    xt = port_pk.pack_literals(torch.from_numpy(X))
    want = np.asarray(ref_compiler.run_compiled(a, xr, engine="oracle"))
    for eng in ENGINES:
        got = port_compiler.run_compiled(b, xt, engine=eng).numpy()
        np.testing.assert_array_equal(got, want, err_msg=eng)
    for eng in ("sparse", "factorized"):
        ee = port_compiler.run_compiled(b, xt, engine=eng, early_exit=True).numpy()
        np.testing.assert_array_equal(ee.argmax(-1), want.argmax(-1))
    assert port_compiler.predict_compiled(b, torch.from_numpy(X)).tolist() == \
        want.argmax(-1).tolist()


def test_run_compiled_rejects_unknown_and_mismatched_tilings():
    _, pcfg, ta = _random_tm(16, 2, 4, 0.1, 1)
    b = port_compiler.compile_tm(pcfg, ta)
    xt = port_pk.pack_literals(torch.zeros((2, 16), dtype=torch.uint8))
    with pytest.raises(TypeError, match="unknown block kwargs"):
        port_compiler.run_compiled(b, xt, block_ww=8)
    # the reference's dense keys are known; a launch the kernel cannot make
    # is refused, never clamped
    with pytest.raises(ValueError, match="fused_infer launches"):
        port_compiler.run_compiled(b, xt, engine="dense", block_b=8)
    with pytest.raises(TypeError, match="factorized-only"):
        port_compiler.run_compiled(b, xt, engine="sparse", term_w=2)
    with pytest.raises(ValueError, match="unknown engine"):
        port_compiler.run_compiled(b, xt, engine="pallas")


# -- each kernel module against the reference's Pallas kernel (interpret) --

@pytest.mark.parametrize("B, C, W, K", [(1, 5, 1, 2), (33, 40, 3, 4), (70, 130, 5, 3),
                                        (64, 2048, 49, 10)])   # tm-mnist's training step
def test_fused_infer_module_matches_pallas(B, C, W, K):
    rng = np.random.default_rng(B + C)
    lit = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint32)
    inc = (rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
           & rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
           & rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32))
    inc[::3] = 0                                  # empty clauses
    votes = rng.integers(-3, 4, (C, K)).astype(np.int32)
    nonempty = (inc != 0).any(1).astype(np.uint8)
    for ne in (nonempty, None):
        want = np.asarray(ref_fused.fused_tm_forward(
            jnp.asarray(lit), jnp.asarray(inc), jnp.asarray(votes),
            None if ne is None else jnp.asarray(ne), interpret=True))
        got = fused_infer.fused_tm_forward(
            port_pk.words_to_tensor(lit, "cpu"), port_pk.words_to_tensor(inc, "cpu"),
            torch.from_numpy(votes), None if ne is None else torch.from_numpy(ne))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch, margin", [(5, False), (40, False), (40, True)])
def test_schedule_modules_match_pallas(batch, margin):
    rcfg, pcfg, ta = _random_tm(40, 3, 12, 0.1, batch)
    a, b = _pair(rcfg, pcfg, ta)
    xr, xt = _inputs(40, batch, 2)
    xw_r = xr[:, jnp.asarray(a.word_ids)]
    xw_t = xt[:, b.tensors("cpu")["word_ids"]]
    votes_t = b.tensors("cpu")["votes"]
    tiling = dict(block_c=8, block_j=4)
    s_r, s_t = a.schedule(**tiling), b.schedule(**tiling)
    m_np = a.tile_margins(**tiling) if margin else None
    want = np.asarray(ref_sparse.sparse_tm_forward(
        xw_r, jnp.asarray(a.votes), s_r, block_s=1, interpret=True,
        tile_margin=None if m_np is None else jnp.asarray(m_np, jnp.int32)))
    got = sparse_infer.sparse_tm_forward(
        xw_t, sparse_infer.place(s_t, votes_t, tile_margin=m_np))
    # with a one-word slab on both sides the early-exit walks stop alike
    np.testing.assert_array_equal(got.numpy(), want)
    ftiling = dict(block_c=8, block_j=4, block_t=16, term_w=2)
    f_r, f_t = a.factorized_schedule(**ftiling), b.factorized_schedule(**ftiling)
    fm_np = a.factorized_tile_margins(**ftiling) if margin else None
    want = np.asarray(ref_term.factorized_tm_forward(
        xw_r, jnp.asarray(a.votes), f_r, block_s=1, interpret=True,
        tile_margin=None if fm_np is None else jnp.asarray(fm_np, jnp.int32)))
    got = term_infer.factorized_tm_forward(
        xw_t, term_infer.place(f_t, votes_t, tile_margin=fm_np))
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_oracles_match_reference():
    rcfg, pcfg, ta = _random_tm(30, 3, 10, 0.1, 9)
    a, b = _pair(rcfg, pcfg, ta)
    xr, xt = _inputs(30, 21, 4)
    xw_r = xr[:, jnp.asarray(a.word_ids)]
    xw_t = xt[:, b.tensors("cpu")["word_ids"]]
    s = b.default_schedule
    vp = np.pad(a.votes, ((0, s.chain_ids.shape[0] - a.votes.shape[0]), (0, 0)))
    want = np.asarray(ref_sparse.schedule_class_sums_ref(
        xw_r, jnp.asarray(s.chain_ids), jnp.asarray(vp)))
    got = sparse_infer.schedule_class_sums_ref(
        xw_t, torch.from_numpy(s.chain_ids), torch.from_numpy(vp))
    np.testing.assert_array_equal(got.numpy(), want)
    f = b.default_factorized_schedule
    vp = np.pad(a.votes, ((0, f.clause_chain.shape[0] - a.votes.shape[0]), (0, 0)))
    want = np.asarray(ref_term.factorized_class_sums_ref(
        xw_r, jnp.asarray(f.term_chain), jnp.asarray(f.clause_chain), jnp.asarray(vp)))
    got = term_infer.factorized_class_sums_ref(
        xw_t, torch.from_numpy(f.term_chain), torch.from_numpy(f.clause_chain),
        torch.from_numpy(vp))
    np.testing.assert_array_equal(got.numpy(), want)
    lit_t = sparse_infer.bit_transpose_literals(xw_t, xw_t.shape[1] * 32)
    np.testing.assert_array_equal(
        lit_t.numpy().view(np.uint32),
        np.asarray(ref_sparse.bit_transpose_literals(xw_r, xw_r.shape[1] * 32)))


def test_ops_forward_over_given_schedules_and_margin_memo():
    """``ops.tm_forward_schedule``/``tm_forward_factorized`` run the placed
    schedule they are given, and early exit puts each margin table on the
    device once per (engine, tiling, device), in the placement."""
    from repro_torch.kernels import ops

    rcfg, pcfg, ta = _random_tm(30, 3, 10, 0.1, 4)
    a, b = _pair(rcfg, pcfg, ta)
    xr, xt = _inputs(30, 37, 5)
    want = np.asarray(ref_compiler.run_compiled(a, xr, engine="oracle"))
    xw = xt[:, b.tensors("cpu")["word_ids"]]
    votes = b.tensors("cpu")["votes"]
    for fn, mod, sched in ((ops.tm_forward_schedule, sparse_infer,
                            b.schedule(block_c=8, block_j=4)),
                           (ops.tm_forward_factorized, term_infer,
                            b.factorized_schedule(block_c=8, term_w=2))):
        got = fn(xw, mod.place(sched, votes))
        np.testing.assert_array_equal(got.numpy(), want)
    for eng in ("sparse", "factorized"):
        for _ in range(2):
            ee = port_compiler.run_compiled(b, xt, engine=eng, early_exit=True,
                                            block_c=8)
            np.testing.assert_array_equal(ee.numpy().argmax(-1), want.argmax(-1))
        (key,) = [k for k in b._placements if k[0] == eng]
        m = b.placement(key)[1].tile_margin
        ref_m = a.factorized_tile_margins(block_c=8) if eng == "factorized" \
            else a.tile_margins(block_c=8)
        np.testing.assert_array_equal(m.numpy(), ref_m)
    assert len(b._placements) == 2
