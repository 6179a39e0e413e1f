"""Port: the training slice against the reference, bit for bit.

Every input is made with numpy from a seed and handed to both packages;
the reference runs its jnp oracles and, where a Pallas kernel exists, the
kernel in interpret mode (``use_kernel=True, interpret=True``, as
``tests/test_fused_train.py`` runs it).  Tolerance 0 throughout: training
is integer arithmetic over the same hash draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packetizer as r_pk
from repro.core import tm as r_tm
from repro.kernels import fused_train as r_fused_train
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.core import packetizer as t_pk
from repro_torch.core import prng as t_prng
from repro_torch.core import tm as t_tm
from repro_torch.kernels import class_sum as t_class_sum
from repro_torch.kernels import clause_eval as t_clause_eval
from repro_torch.kernels import fused_train as t_fused_train
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import ta_update as t_ta_update

KW = dict(use_kernel=True, interpret=True)


def _cfgs(**kw):
    return r_tm.TMConfig(**kw), t_tm.TMConfig(**kw)


def _problem(B=13, F=17, K=3, cpc=7, threshold=9, s=4.0, seed=0):
    rng = np.random.default_rng(seed)
    rc, tc = _cfgs(n_features=F, n_classes=K, clauses_per_class=cpc,
                   threshold=threshold, s=s)
    ta = rng.integers(-30, 30, (rc.n_clauses_total, rc.n_literals), dtype=np.int8)
    x = rng.integers(0, 2, (B, F), dtype=np.uint8)
    y = rng.integers(0, K, B, dtype=np.int32)
    return rc, tc, ta, x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(a):
    """uint32 words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _eq(port, reference):
    np.testing.assert_array_equal(
        port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port),
        np.asarray(reference))


# -- hash RNG -----------------------------------------------------------------

def test_hash_and_thresholds_on_edge_words():
    edge = np.array([0, 1, 2, 0xFFFF, 0x10000, 2 ** 31 - 1, 2 ** 31,
                     2 ** 32 - 2, 2 ** 32 - 1, 0x9E3779B1, 0x85EBCA6B],
                    dtype=np.uint32)
    rnd = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    idx = np.concatenate([edge, rnd.astype(np.uint32)])
    for seed in (0, 1, 77, 2 ** 31, 2 ** 32 - 1, 0x9E3779B9 ^ 5):
        want = np.asarray(r_ref.hash_u32(jnp.asarray(idx), jnp.uint32(seed)))
        got = t_ref.hash_u32(torch.from_numpy(idx.astype(np.int64)), seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for p in (0.0, 1e-10, 0.1, 0.25, 1 / 3, 0.5, 0.75, 1 - 1e-10, 1.0):
        assert t_ref.prob_to_u32(p) == int(r_ref.prob_to_u32(p)), p
    assert t_ref.prob_to_u32(1.0) == 0xFFFFFFFF


# -- the unfused kernels -------------------------------------------------------

@pytest.mark.parametrize("B,F,cpc", [(13, 17, 7), (40, 70, 11), (1, 33, 3),
                                     (64, 784, 200)])   # tm-mnist's width, batch 64
def test_clause_fire_and_class_sum_match_reference(B, F, cpc):
    rc, tc, ta, x, y = _problem(B=B, F=F, cpc=cpc, seed=B)
    ta[::5] = -1                              # empty clauses fire in training
    lw = r_pk.pack_literals(jnp.asarray(x))
    iw = r_pk.pack_include_masks(jnp.asarray(ta))
    fire_ref = r_ref.clause_fire_ref(lw, iw)
    fire = t_clause_eval.clause_fire(_words(lw), _words(iw))
    _eq(fire, fire_ref)
    _eq(fire, r_ops.clause_fire(lw, iw, **KW))
    votes = r_tm.vote_matrix(rc)
    _eq(t_tm.vote_matrix(tc), votes)
    sums = t_class_sum.class_sum(fire, t_tm.vote_matrix(tc))
    _eq(sums, r_ref.class_sum_ref(fire_ref, votes))
    _eq(sums, r_ops.class_sums(fire_ref, votes, **KW))
    for nonempty in (None, (ta >= 0).any(-1).astype(np.uint8)):
        ne_r = None if nonempty is None else jnp.asarray(nonempty)
        ne_t = None if nonempty is None else _t(nonempty)
        want = r_ops.tm_forward_packed(lw, iw, votes, ne_r, fuse=False, **KW)
        _eq(t_ops.tm_forward_packed(_words(lw), _words(iw), t_tm.vote_matrix(tc),
                                    ne_t, fuse=False), want)
        _eq(t_ops.tm_forward_packed(_words(lw), _words(iw), t_tm.vote_matrix(tc),
                                    ne_t), want)


@pytest.mark.parametrize("B,C,K", [(13, 35, 3), (64, 2048, 10), (5, 17, 33)])
def test_class_sum_takes_int8_and_uint8_fired(B, C, K):
    """class_sum reads fired as bytes: int8 and uint8 fire matrices give the
    reference's class sums (its Pallas kernel in interpret mode), with
    general votes; other types are refused."""
    rng = np.random.default_rng(B + C + K)
    fired = rng.integers(0, 2, (B, C), dtype=np.int8)
    votes = rng.integers(-2 ** 19, 2 ** 19, (C, K), dtype=np.int32)
    want = np.asarray(r_ops.class_sums(jnp.asarray(fired), jnp.asarray(votes), **KW))
    for dt in (torch.int8, torch.uint8):
        _eq(t_class_sum.class_sum(torch.from_numpy(fired).to(dt), torch.from_numpy(votes)),
            want)
    with pytest.raises(TypeError, match="int8 or uint8"):
        t_class_sum.class_sum(torch.from_numpy(fired).to(torch.int32), torch.from_numpy(votes))
    with pytest.raises(ValueError, match="CUDA"):
        t_class_sum.class_sum_cuda(torch.from_numpy(fired), torch.from_numpy(votes))


def _selection(rc, ta, x, y, seed, b_off, sl=slice(None), c_off=0, p=None):
    """Reference fire / ftype / lits for a (possibly sliced) bank.  ``p``
    sets every sample's selection probabilities p_t and p_n (1.0: every
    target and negative pair has feedback; 0.0: none); ``probs`` keeps
    ``feedback_probs``'s own (kn, p_t, p_n)."""
    T = rc.threshold
    lits = r_tm.literals(jnp.asarray(x))
    lw = r_pk.pack_bits(lits)
    iw = r_pk.pack_include_masks(jnp.asarray(ta))
    votes = r_tm.vote_matrix(rc)
    cls = jnp.clip(jnp.arange(rc.n_clauses_total) // rc.clauses_per_class, 0,
                   rc.n_classes - 1)
    pol = r_tm.polarity(rc)
    sums = jnp.clip(r_ref.clause_fire_ref(lw, iw).astype(jnp.int32) @ votes, -T, T)
    kn, p_t, p_n = r_ops.feedback_probs(sums, jnp.asarray(y), rc.n_classes, T,
                                        jnp.uint32(seed), b_offset=b_off)
    probs = (kn, p_t, p_n)
    if p is not None:
        p_t = p_n = jnp.full_like(p_t, p)
    fire = r_ref.clause_fire_ref(lw, iw[sl]).astype(jnp.uint8)
    ftype = r_ops.feedback_select(jnp.asarray(y), kn, p_t, p_n, cls[sl], pol[sl],
                                  jnp.uint32(seed), b_offset=b_off, c_offset=c_off)
    return dict(lits=lits, lw=lw, iw=iw, sums=sums, kn=kn, p_t=p_t, p_n=p_n,
                probs=probs, cls=cls, pol=pol, fire=fire, ftype=ftype)


def _case(*values, name=None):
    """A parametrised case whose id is its values joined by "-", or ``name``
    after them; a trailing selection probability (see ``_selection``) is
    left out of the id."""
    return pytest.param(*values, id="-".join(str(v) for v in values[:-1])
                        + (f"-{name}" if name else ""))


@pytest.mark.parametrize("b_off,c_off,n_loc,c_total,p", [
    _case(0, 0, None, None, None), _case(37, 0, None, None, None),
    _case(5, 10, 11, None, None), _case(2 ** 32 - 7, 7, 12, 21, None),
    _case(0, 0, None, None, 1.0, name="saturated"),
    _case(2 ** 32 - 7, 7, 12, 21, 1.0, name="saturated"),
    _case(37, 0, None, None, 0.0, name="no-feedback"),
])
def test_feedback_plan_and_ta_delta_match_reference(b_off, c_off, n_loc, c_total, p):
    rc, tc, ta, x, y = _problem(B=11, F=23, K=3, cpc=7, seed=3)
    seed = 55
    sl = slice(c_off, None if n_loc is None else c_off + n_loc)
    r = _selection(rc, ta, x, y, seed, b_off, sl, c_off, p)
    kn, p_t, p_n = t_ops.feedback_probs(_t(np.asarray(r["sums"])), _t(y),
                                        tc.n_classes, tc.threshold, seed,
                                        b_offset=b_off)
    _eq(kn, r["probs"][0])
    _eq(p_t, r["probs"][1])
    _eq(p_n, r["probs"][2])
    if p is not None:
        p_t = p_n = torch.full_like(p_t, p)
    _eq(t_tm.clause_class(tc), r["cls"])
    _eq(t_tm.polarity(tc), r["pol"])
    ftype = t_ops.feedback_select(_t(y), kn, p_t, p_n, t_tm.clause_class(tc)[sl],
                                  t_tm.polarity(tc)[sl], seed, b_offset=b_off,
                                  c_offset=c_off)
    _eq(ftype, r["ftype"])
    kw = dict(p_act=1.0, p_inact=0.25, b_offset=b_off, c_offset=c_off,
              c_total=c_total)
    want = r_ref.ta_delta_ref(jnp.asarray(ta[sl]), r["lits"], r["fire"],
                              r["ftype"], jnp.uint32(seed), **kw)
    got = t_ta_update.ta_delta(_t(ta[sl]), _t(np.asarray(r["lits"])),
                               _t(np.asarray(r["fire"])), ftype, seed, **kw)
    _eq(got, want)
    kw["b_offset"] = jnp.uint32(b_off)     # the jitted kernel takes uint32
    _eq(got, r_ops.ta_delta(jnp.asarray(ta[sl]), r["lits"], r["fire"], r["ftype"],
                            jnp.uint32(seed), **kw, **KW))
    assert (int(got.abs().sum()) > 0) == (p != 0.0)


def test_feedback_plan_returns_ftype_and_clamped_sums():
    rc, tc, ta, x, y = _problem(B=7, seed=2)
    r = _selection(rc, ta, x, y, 4, 0)
    want_ft, want_sums = r_ops.feedback_plan(
        r["fire"], jnp.asarray(y), r_tm.vote_matrix(rc), r["cls"], r["pol"],
        rc.threshold, jnp.uint32(4))
    ft, sums = t_ops.feedback_plan(
        _t(np.asarray(r["fire"])), _t(y), t_tm.vote_matrix(tc),
        t_tm.clause_class(tc), t_tm.polarity(tc), tc.threshold, 4)
    _eq(ft, want_ft)
    _eq(sums, want_sums)


# -- the fused kernel ----------------------------------------------------------

def _fused_args(r, ta, y, sl):
    return (_t(ta[sl]), _t(np.asarray(r["lits"])), _words(r["lw"]),
            _words(np.asarray(r["iw"])[sl]), _t(y), _t(np.asarray(r["kn"])),
            _t(np.asarray(r["p_t"])), _t(np.asarray(r["p_n"])),
            _t(np.asarray(r["cls"])[sl]), _t(np.asarray(r["pol"])[sl]))


@pytest.mark.parametrize("B,F,K,cpc,p", [
    _case(13, 17, 3, 7, None), _case(8, 64, 4, 32, None), _case(33, 9, 2, 50, None),
    _case(13, 17, 3, 7, 1.0, name="saturated"),
    _case(33, 9, 2, 50, 0.0, name="no-feedback"),
])
@pytest.mark.parametrize("b_off,c_off", [(0, 0), (37, 10)])
def test_fused_train_delta_matches_reference(B, F, K, cpc, p, b_off, c_off):
    """The plain fused delta equals the reference's composed oracle and its
    Pallas kernel in interpret mode: selection hashed on global (sample,
    clause) ids, the automaton draw on (global sample, local clause)."""
    rc, tc, ta, x, y = _problem(B=B, F=F, K=K, cpc=cpc, seed=B)
    seed = 77
    C = rc.n_clauses_total
    sl = slice(c_off, C)
    r = _selection(rc, ta, x, y, seed, b_off, sl, c_off, p)
    kw = dict(p_act=1.0, p_inact=0.25, b_offset=b_off, c_offset=c_off)
    want = r_ref.ta_delta_ref(jnp.asarray(ta[sl]), r["lits"], r["fire"],
                              r["ftype"], jnp.uint32(seed), p_act=1.0,
                              p_inact=0.25, b_offset=b_off)
    got = t_fused_train.fused_tm_train_delta(*_fused_args(r, ta, y, sl), seed, **kw)
    _eq(got, want)
    pallas = r_fused_train.fused_tm_train_delta(
        jnp.asarray(ta[sl]), r["lits"], r["lw"], r["iw"][sl], jnp.asarray(y),
        r["kn"], r["p_t"], r["p_n"], r["cls"][sl], r["pol"][sl],
        jnp.uint32(seed), interpret=True, **kw)
    _eq(got, pallas)
    assert (int(got.abs().sum()) > 0) == (p != 0.0)


def test_fused_clause_shards_reassemble_full_delta():
    """Two half-bank shards with ``c_offset``/``c_total`` equal the full
    bank's delta rows (the clause-sharded trainer's invariant), in the port
    and in the reference's kernel."""
    rc, tc, ta, x, y = _problem(B=9, F=15, K=2, cpc=12, seed=8)
    seed, C = 13, rc.n_clauses_total
    half = C // 2
    r = _selection(rc, ta, x, y, seed, 0)
    full = t_fused_train.fused_tm_train_delta(
        *_fused_args(r, ta, y, slice(None)), seed, p_act=1.0, p_inact=0.25)
    parts = []
    for c_off in (0, half):
        sl = slice(c_off, c_off + half)
        kw = dict(p_act=1.0, p_inact=0.25, c_offset=c_off, c_total=C)
        part = t_fused_train.fused_tm_train_delta(*_fused_args(r, ta, y, sl),
                                                  seed, **kw)
        _eq(part, r_fused_train.fused_tm_train_delta(
            jnp.asarray(ta[sl]), r["lits"], r["lw"], r["iw"][sl], jnp.asarray(y),
            r["kn"], r["p_t"], r["p_n"], r["cls"][sl], r["pol"][sl],
            jnp.uint32(seed), interpret=True, **kw))
        parts.append(part)
    _eq(torch.cat(parts), full.numpy())


# -- the training step -----------------------------------------------------------

def _steps(cfg, ta, x, y, seed, **kw):
    new_ta, delta = r_ops.tm_train_step_kernel(cfg, jnp.asarray(ta), jnp.asarray(x),
                                               jnp.asarray(y), jnp.uint32(seed), **kw)
    return np.asarray(new_ta), np.asarray(delta)


@pytest.mark.parametrize("B,F,K,cpc", [(13, 17, 3, 7), (8, 64, 4, 32), (33, 9, 2, 50)])
@pytest.mark.parametrize("fuse", [True, False])
def test_train_step_matches_reference(B, F, K, cpc, fuse):
    rc, tc, ta, x, y = _problem(B=B, F=F, K=K, cpc=cpc, seed=B)
    want_ta, want_d = _steps(rc, ta, x, y, 77, use_kernel=False)
    got_ta, got_d = t_ops.tm_train_step_kernel(tc, _t(ta), _t(x), _t(y), 77, fuse=fuse)
    _eq(got_d, want_d)
    _eq(got_ta, want_ta)
    assert np.abs(want_d).sum() > 0


@pytest.mark.parametrize("B,chunk", [(24, 8), (21, 8), (13, 4)])
@pytest.mark.parametrize("fuse", [True, False])
def test_chunked_step_matches_unchunked_reference(B, chunk, fuse):
    rc, tc, ta, x, y = _problem(B=B, seed=B + chunk)
    _, want = _steps(rc, ta, x, y, 31, use_kernel=False)
    _, fused_pallas = _steps(rc, ta, x, y, 31, batch_chunk=chunk, fuse=fuse, **KW)
    _, got = t_ops.tm_train_step_kernel(tc, _t(ta), _t(x), _t(y), 31, chunk, fuse=fuse)
    _eq(got, want)
    _eq(got, fused_pallas)


def test_train_step_clause_shard_with_sums_reduce():
    """A clause shard with ``c_total`` and a sums reduction equals the
    full-bank delta's rows (the data the sharded trainer exchanges)."""
    rc, tc, ta, x, y = _problem(B=10, F=13, K=2, cpc=8, seed=6)
    C = tc.n_clauses_total
    _, full = t_ops.tm_train_step_kernel(tc, _t(ta), _t(x), _t(y), 3)
    for fuse in (True, False):
        parts = []
        for c_off in (0, C // 2):
            sl = slice(c_off, c_off + C // 2)
            other = slice(C // 2 - c_off, C - c_off)

            def reduce(s, other=other):
                lw = t_pk.pack_literals(_t(x))
                iw = t_pk.pack_include_masks(_t(ta[other]))
                return s + t_ref.class_sum_ref(t_ref.clause_fire_ref(lw, iw),
                                               t_tm.vote_matrix(tc)[other])
            parts.append(t_ops.tm_train_step_kernel(
                tc, _t(ta[sl]), _t(x), _t(y), 3, fuse=fuse, c_offset=c_off,
                c_total=C, sums_reduce=reduce)[1])
        _eq(torch.cat(parts), full.numpy())
    with pytest.raises(ValueError, match="c_total"):
        t_ops.tm_train_step_kernel(tc, _t(ta), _t(x), _t(y), 3, c_total=C + 1)


def test_five_tm_tiny_steps_from_reference_init():
    """Five consecutive steps of tm-tiny from the reference's ``tm.init``
    bank, carried over with ``state_from_numpy``."""
    from repro.configs.matador_tm import TM_TINY as R_TINY
    from repro.core import train as r_train
    from repro_torch.configs.matador_tm import TM_TINY as T_TINY
    from repro_torch.core import train as t_train

    rng = np.random.default_rng(4)
    xs = rng.integers(0, 2, (5, 16, 32), dtype=np.uint8)
    ys = rng.integers(0, 3, (5, 16), dtype=np.int32)
    r_state = r_tm.init(R_TINY, jax.random.PRNGKey(0))
    t_state = t_tm.state_from_numpy(np.asarray(r_state.ta_state), device="cpu")
    for s in range(5):
        fuse = s % 2 == 0
        r_state, r_m = r_train.train_step_kernel(R_TINY, r_state, jnp.asarray(xs[s]),
                                                 jnp.asarray(ys[s]), jnp.uint32(s))
        t_state, t_m = t_train.train_step_kernel(T_TINY, t_state, _t(xs[s]),
                                                 _t(ys[s]), s, fuse=fuse)
        _eq(t_state.ta_state, r_state.ta_state)
        assert t_state.steps == int(r_state.steps) == s + 1
        assert t_m["delta_abs_sum"] == int(r_m["delta_abs_sum"])
    new_ta, das = t_train.online_step(T_TINY, t_state.ta_state, _t(xs[0]), _t(ys[0]), 9)
    want_ta, want_das = r_train.online_step(R_TINY, r_state.ta_state,
                                            jnp.asarray(xs[0]), jnp.asarray(ys[0]),
                                            jnp.uint32(9))
    _eq(new_ta, want_ta)
    assert das == int(want_das)


def test_init_predict_accuracy_and_apply_delta():
    from repro.core import feedback as r_feedback
    from repro_torch.core import feedback as t_feedback

    rc, tc = _cfgs(n_features=20, n_classes=3, clauses_per_class=5,
                   clause_pad_multiple=8)
    st = t_tm.init(tc, t_prng.PRNGKey(0), "cpu")
    assert st.ta_state.dtype == torch.int8 and st.ta_state.shape == (16, 40)
    assert set(st.ta_state[:15].unique().tolist()) == {-1, 0}
    assert (st.ta_state[15:] == -tc.n_states).all()
    _eq(st.ta_state, r_tm.init(rc, jax.random.PRNGKey(0)).ta_state)
    with pytest.raises(ValueError):
        t_tm.state_from_numpy(np.zeros((3, 4), np.int32), device="cpu")

    rng = np.random.default_rng(1)
    ta = rng.integers(-20, 20, (16, 40), dtype=np.int8)
    ta[3] = -5                                    # an empty clause: dropped
    x = rng.integers(0, 2, (50, 20), dtype=np.uint8)
    y = rng.integers(0, 3, 50, dtype=np.int32)
    r_st = r_tm.TMState(ta_state=jnp.asarray(ta), steps=jnp.int32(0))
    t_st = t_tm.state_from_numpy(ta, device="cpu")
    for kw in (dict(), KW):
        _eq(t_tm.predict(tc, t_st, _t(x)), r_tm.predict(rc, r_st, jnp.asarray(x), **kw))
    assert t_tm.accuracy(tc, t_st, _t(x), _t(y)) == float(
        r_tm.accuracy(rc, r_st, jnp.asarray(x), jnp.asarray(y)))
    lits = t_tm.literals(_t(x))
    for training in (True, False):
        _eq(t_tm.clause_outputs(_t(ta), lits, training=training),
            r_tm.clause_outputs(jnp.asarray(ta), jnp.asarray(lits.numpy()),
                                training=training))
        _eq(t_tm.class_sums(tc, _t(ta), lits, training=training),
            r_tm.class_sums(rc, jnp.asarray(ta), jnp.asarray(lits.numpy()),
                            training=training))
    delta = rng.integers(-300, 300, ta.shape).astype(np.int32)
    _eq(t_feedback.apply_delta(tc, _t(ta), _t(delta)),
        r_feedback.apply_delta(rc, jnp.asarray(ta), jnp.asarray(delta)))


def test_run_compiled_unfused_dense_engine():
    from repro.core import compiler as r_compiler
    from repro_torch.core import compiler as t_compiler

    rc, tc, ta, x, y = _problem(B=37, F=30, K=4, cpc=9, seed=12)
    r_comp = r_compiler.compile_tm(rc, jnp.asarray(ta))
    t_comp = t_compiler.compile_tm(tc, _t(ta))
    xp_r = r_pk.pack_literals(jnp.asarray(x))
    want = r_compiler.run_compiled(r_comp, xp_r,
                                   engine=r_ops.EngineSpec("dense", fuse=False),
                                   interpret=True)
    xp = _words(xp_r)
    got = t_compiler.run_compiled(t_comp, xp, engine=t_ops.EngineSpec("dense", fuse=False))
    _eq(got, want)
    _eq(got, r_compiler.run_compiled(r_comp, xp_r, engine="oracle"))
    _eq(t_compiler.run_compiled(t_comp, xp, engine="oracle"), want)
    for name in ("sparse", "factorized"):
        with pytest.raises(ValueError, match="unfused"):
            t_ops.EngineSpec(name, fuse=False)


# -- fit and the launcher ------------------------------------------------------------

def test_fit_matches_manual_loop():
    from repro_torch.core import feedback as t_feedback
    from repro_torch.core import train as t_train
    from repro_torch.data.synthetic import make_noisy_xor

    X, y = make_noisy_xor(120, noise=0.05, seed=11)
    cfg = t_tm.TMConfig(n_features=12, n_classes=2, clauses_per_class=10,
                        threshold=15, s=3.9)
    st0 = t_tm.init(cfg, t_prng.PRNGKey(0), "cpu")
    bs, epochs = 30, 2
    for engine in ("kernel", "jnp"):
        st = t_train.fit(cfg, st0, _t(X), _t(y), epochs=epochs, batch_size=bs,
                         rng=t_prng.PRNGKey(7), engine=engine)
        rng = t_prng.PRNGKey(7)
        ta, gstep = st0.ta_state, 0
        for _ in range(epochs):
            rng, rp = t_prng.split(rng)
            perm = t_prng.permutation(rp, 120)
            xs, ys = _t(X)[perm], _t(y)[perm]
            for i in range(120 // bs):
                xb, yb = xs[i * bs:(i + 1) * bs], ys[i * bs:(i + 1) * bs]
                rng, rs = t_prng.split(rng)
                if engine == "kernel":
                    ta, _ = t_ops.tm_train_step_kernel(cfg, ta, xb, yb, gstep)
                else:
                    ta = t_feedback.apply_delta(
                        cfg, ta, t_feedback.batch_feedback_delta(cfg, ta, xb, yb, rs))
                gstep += 1
        _eq(st.ta_state, ta.numpy())
        assert st.steps == gstep
    with pytest.raises(ValueError, match="engine"):
        t_train.fit(cfg, st0, _t(X), _t(y), epochs=1, batch_size=bs,
                    rng=t_prng.PRNGKey(7), engine="mesh")


def test_train_tm_flags_not_ported_and_device(monkeypatch):
    """``--mesh`` needs the devices it names (``device_count`` in the
    error; ``REPRO_TORCH_FORCE_DEVICE_COUNT`` lays logical ones), and
    ``--device cuda`` raises without a card."""
    from repro_torch.launch import train as t_launch

    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    base = ["--arch", "tm-tiny", "--steps", "1", "--device", "cpu"]
    for extra in (["--mesh", "model=2"],):
        args = t_launch.build_parser().parse_args(base + extra)
        with pytest.raises(ValueError, match="device_count"):
            t_launch.train_tm(args)
    if not torch.cuda.is_available():
        args = t_launch.build_parser().parse_args(["--arch", "tm-tiny", "--steps", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            t_launch.train_tm(args)


@pytest.mark.parametrize("extra", [[], ["--batch-chunk", "6"], ["--no-fuse"]])
def test_train_tm_autotune_on_cpu(tmp_path, monkeypatch, extra):
    """``train_tm --autotune`` on the CPU plain versions: the bank equals an
    untuned run's bit for bit, and the fused run resolves its two training
    shapes' launches in a fresh cache (the unfused step tunes nothing)."""
    from repro_torch.kernels import autotune
    from repro_torch.launch import train as t_launch

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_DATA", str(tmp_path / "data.json"))
    base = ["--arch", "tm-tiny", "--steps", "3", "--device", "cpu",
            "--batch-size", "16", "--log-every", "3", *extra]
    want, _ = t_launch.train_tm(t_launch.build_parser().parse_args(base))
    got, health = t_launch.train_tm(t_launch.build_parser().parse_args(base + ["--autotune"]))
    assert torch.equal(got, want) and health["steps"] == 3
    keys = sorted(k.split(":")[0] for k in autotune._load_cache())
    assert keys == ([] if "--no-fuse" in extra else ["fused_infer", "fused_train"])


# -- the jax.random trainer (engine="jnp") and the matmul step ----------------------

@pytest.mark.parametrize("pad", [1, 8])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_matches_reference(pad, seed):
    rc, tc = _cfgs(n_features=23, n_classes=3, clauses_per_class=5,
                   clause_pad_multiple=pad)
    st = t_tm.init(tc, t_prng.PRNGKey(seed), "cpu")
    assert st.steps == 0
    _eq(st.ta_state, r_tm.init(rc, jax.random.PRNGKey(seed)).ta_state)


FEEDBACK_CASES = {
    "s3.9": dict(F=12, K=3, cpc=6, T=5, s=3.9, B=16),       # float32(1/s) trap
    "K2": dict(F=10, K=2, cpc=8, T=7, s=4.0, B=40),         # two passes of 32
    "padded": dict(F=14, K=3, cpc=5, T=6, s=3.0, B=12, pad=8),
    "no_boost": dict(F=12, K=4, cpc=6, T=5, s=3.9, B=16, boost=False),
}


def _feedback_problem(F, K, cpc, T, s, B, pad=1, boost=True, seed=0):
    rc, tc = _cfgs(n_features=F, n_classes=K, clauses_per_class=cpc, threshold=T,
                   s=s, boost_true_positive=boost, clause_pad_multiple=pad)
    rng = np.random.default_rng(seed)
    ta = rng.integers(-3, 3, (rc.n_clauses_total, rc.n_literals), dtype=np.int8)
    x = rng.integers(0, 2, (B, F), dtype=np.uint8)
    y = rng.integers(0, K, B).astype(np.int32)
    return rc, tc, ta, x, y


@pytest.mark.parametrize("case", list(FEEDBACK_CASES))
def test_batch_feedback_delta_matches_reference(case):
    from repro.core import feedback as r_feedback
    from repro_torch.core import feedback as t_feedback

    for seed in (0, 1):
        rc, tc, ta, x, y = _feedback_problem(**FEEDBACK_CASES[case], seed=seed)
        want = r_feedback.batch_feedback_delta(rc, jnp.asarray(ta), jnp.asarray(x),
                                               jnp.asarray(y), jax.random.PRNGKey(seed))
        got = t_feedback.batch_feedback_delta(tc, _t(ta), _t(x), _t(y),
                                              t_prng.PRNGKey(seed))
        assert got.dtype == torch.int32 and got.shape == ta.shape
        _eq(got, want)
        assert int(np.abs(np.asarray(want)).sum()) > 0
        if rc.n_clauses_total != rc.n_clauses_raw:     # padded clauses: no feedback
            assert not got[rc.n_clauses_raw:].any()


def test_class_feedback_delta_entries_match_reference_samples():
    """The port's batched per-class delta, entry by entry, against the
    reference's per-sample ``_class_feedback_delta``; with its fire and
    polarity helpers."""
    from repro.core import feedback as r_feedback
    from repro_torch.core import feedback as t_feedback

    rc, tc, ta, x, _ = _feedback_problem(F=12, K=3, cpc=6, T=5, s=3.9, B=8, seed=4)
    cpc = rc.clauses_per_class
    rng = np.random.default_rng(5)
    cls = rng.integers(0, 3, 8)
    is_t = np.arange(8) % 2 == 0
    slices = np.stack([ta[c * cpc:(c + 1) * cpc] for c in cls])
    lits = t_tm.literals(_t(x))
    keys = t_prng.split(t_prng.PRNGKey(9), 8)
    got = t_feedback._class_feedback_delta(tc, _t(slices), lits, _t(is_t), keys)
    _eq(t_feedback._clause_polarity(cpc), r_feedback._clause_polarity(cpc))
    for e in range(8):
        sl, li = jnp.asarray(slices[e]), jnp.asarray(lits[e].numpy())
        _eq(t_feedback._clause_fire(_t(slices[e]), lits[e]), r_feedback._clause_fire(sl, li))
        want = r_feedback._class_feedback_delta(
            rc, sl, li, jnp.asarray(bool(is_t[e])),
            jnp.asarray(keys[e].numpy().astype(np.uint32)))
        _eq(got[e], want)


def test_train_step_matches_reference_jnp():
    from repro.configs.matador_tm import TM_TINY as R_TINY
    from repro.core import train as r_train
    from repro_torch.configs.matador_tm import TM_TINY as T_TINY
    from repro_torch.core import train as t_train

    rng = np.random.default_rng(6)
    xs = rng.integers(0, 2, (3, 20, 32), dtype=np.uint8)
    ys = rng.integers(0, 3, (3, 20), dtype=np.int32)
    r_state = r_tm.init(R_TINY, jax.random.PRNGKey(2))
    t_state = t_tm.init(T_TINY, t_prng.PRNGKey(2), "cpu")
    for s in range(3):
        r_state, r_m = r_train.train_step(R_TINY, r_state, jnp.asarray(xs[s]),
                                          jnp.asarray(ys[s]), jax.random.PRNGKey(10 + s))
        t_state, t_m = t_train.train_step(T_TINY, t_state, _t(xs[s]), _t(ys[s]),
                                          t_prng.PRNGKey(10 + s))
        _eq(t_state.ta_state, r_state.ta_state)
        assert t_state.steps == int(r_state.steps) == s + 1
        assert t_m["delta_abs_sum"] == int(r_m["delta_abs_sum"]) > 0
        # a float32 mean in both packages, summed in different orders
        assert t_m["include_frac"] == pytest.approx(float(r_m["include_frac"]), rel=1e-6)


@pytest.mark.parametrize("engine", ["jnp", "kernel"])
def test_fit_matches_reference(engine):
    """Two epochs of tm-tiny from the same keys: the reference's shuffle and
    step stream, and the same bank, for either engine."""
    from repro.configs.matador_tm import TM_TINY as R_TINY
    from repro.core import train as r_train
    from repro.data import make_boolean_classification
    from repro_torch.configs.matador_tm import TM_TINY as T_TINY
    from repro_torch.core import train as t_train

    X, y = make_boolean_classification(200, 32, 3, seed=0)
    want = r_train.fit(R_TINY, r_tm.init(R_TINY, jax.random.PRNGKey(0)),
                       jnp.asarray(X), jnp.asarray(y), epochs=2, batch_size=32,
                       rng=jax.random.PRNGKey(1), engine=engine)
    got = t_train.fit(T_TINY, t_tm.init(T_TINY, t_prng.PRNGKey(0), "cpu"), _t(X),
                      _t(y), epochs=2, batch_size=32, rng=t_prng.PRNGKey(1),
                      engine=engine)
    _eq(got.ta_state, want.ta_state)
    assert got.steps == int(want.steps) == 12


@pytest.mark.parametrize("B, F, K, cpc, T, s, seed", [
    (13, 17, 3, 7, 9, 4.0, 0),
    (64, 30, 4, 10, 15, 3.9, 1),
    (200, 100, 5, 40, 20, 3.0, 3),     # penalty counts in the tens
])
def test_tm_train_step_matmul_matches_reference(B, F, K, cpc, T, s, seed):
    rc, tc = _cfgs(n_features=F, n_classes=K, clauses_per_class=cpc, threshold=T, s=s)
    rng = np.random.default_rng(seed)
    ta = rng.integers(-3, 3, (rc.n_clauses_total, rc.n_literals), dtype=np.int8)
    x = rng.integers(0, 2, (B, F), dtype=np.uint8)
    y = rng.integers(0, K, B).astype(np.int32)
    want_ta, want_d = r_ops.tm_train_step_matmul(rc, jnp.asarray(ta), jnp.asarray(x),
                                                 jnp.asarray(y), jnp.uint32(seed + 7))
    got_ta, got_d = t_ops.tm_train_step_matmul(tc, _t(ta), _t(x), _t(y), seed + 7)
    assert got_d.dtype == torch.int32 and got_ta.dtype == torch.int8
    _eq(got_d, want_d)
    _eq(got_ta, want_ta)
    with pytest.raises(ValueError, match="boost"):
        t_ops.tm_train_step_matmul(tc.replace(boost_true_positive=False), _t(ta),
                                   _t(x), _t(y), 0)


def test_train_tm_bank_equals_reference(tmp_path, monkeypatch):
    """``train_tm`` starts from the reference's ``tm.init`` bank: after 20
    tm-tiny steps its bank equals ``repro.launch.train``'s."""
    import sys

    from repro.launch import train as r_launch
    from repro_torch.launch import train as t_launch

    common = ["--arch", "tm-tiny", "--steps", "20", "--batch-size", "16",
              "--n-train", "200", "--seed", "3", "--log-every", "100"]
    monkeypatch.setattr(sys, "argv", ["train", *common, "--ckpt-dir", str(tmp_path)])
    r_launch.main()
    want = np.load(tmp_path / "step_0000000020" / "arrays.npz")["ta"]
    got, _ = t_launch.train_tm(t_launch.build_parser().parse_args(common + ["--device", "cpu"]))
    _eq(got, want)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fit_checkpoint_resumes_across_packages(tmp_path, writer, capsys):
    """A ``fit(engine="jnp")`` checkpoint written mid-run (global step 10
    of 12, epoch 1) by either package resumes in the other's ``fit`` and
    ends on the reference's uninterrupted bank."""
    from repro.checkpoint import CheckpointManager as RMgr
    from repro.configs.matador_tm import TM_TINY as R_TINY
    from repro.core import train as r_train
    from repro.data import make_boolean_classification
    from repro_torch.checkpoint import CheckpointManager as TMgr
    from repro_torch.configs.matador_tm import TM_TINY as T_TINY
    from repro_torch.core import train as t_train

    X, y = make_boolean_classification(192, 32, 3, seed=0)

    def ref_fit(**kw):
        return np.asarray(r_train.fit(
            R_TINY, r_tm.init(R_TINY, jax.random.PRNGKey(0)), jnp.asarray(X),
            jnp.asarray(y), epochs=2, batch_size=32, rng=jax.random.PRNGKey(1),
            **kw).ta_state)

    def port_fit(**kw):
        return t_train.fit(T_TINY, t_tm.init(T_TINY, t_prng.PRNGKey(0), "cpu"),
                           _t(X), _t(y), epochs=2, batch_size=32,
                           rng=t_prng.PRNGKey(1), **kw).ta_state.numpy()

    want = ref_fit()
    d = str(tmp_path / "ck")
    write, read = (ref_fit, port_fit) if writer == "reference" else (port_fit, ref_fit)
    write_mgr, read_mgr = (RMgr, TMgr) if writer == "reference" else (TMgr, RMgr)
    write(ckpt_manager=write_mgr(d), ckpt_every=5)
    assert read_mgr(d).latest_step() == 10
    np.testing.assert_array_equal(read(ckpt_manager=read_mgr(d)), want)
    assert "fit: resumed at epoch 1 step 4 (global step 10)" in capsys.readouterr().out
