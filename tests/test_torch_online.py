"""Port parity: drift stats, the incremental schedule and recompile, and the
online updater against the reference, exact (tolerance 0).

Two updaters, one of each package, start from the same bank and take the
same feedback stream with an injected clock; after every step their banks,
``health()`` and deployed or candidate artifacts must be equal.  The
reference's drills (corrupt feedback, failed rebuild, aborted swap, failed
canary, regression rollback) run through both, a drain checkpoint written
by either package resumes in the other, and the gateway acceptance drill of
``tests/test_online.py`` runs on the port.
"""

import asyncio
import contextlib
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.kernels import sparse_infer as ref_sparse  # noqa: E402
from repro.runtime import faults as ref_faults  # noqa: E402
from repro.runtime import online as ref_online  # noqa: E402
from repro.runtime import zoo as ref_zoo  # noqa: E402
from repro_torch.checkpoint import store as port_store  # noqa: E402
from repro_torch.core import compiler as port_compiler  # noqa: E402
from repro_torch.core import tm as port_tm  # noqa: E402
from repro_torch.kernels import sparse_infer as port_sparse  # noqa: E402
from repro_torch.kernels import term_infer as port_term  # noqa: E402
from repro_torch.runtime import faults as port_faults  # noqa: E402
from repro_torch.runtime import online as port_online  # noqa: E402
from repro_torch.runtime import zoo as port_zoo  # noqa: E402

pytestmark = pytest.mark.online

KW = dict(n_features=16, n_classes=3, clauses_per_class=4, threshold=8, s=4.0)
REF_CFG, PORT_CFG = ref_tm.TMConfig(**KW), port_tm.TMConfig(**KW)
PKG = {"ref": (ref_compiler, ref_online, ref_zoo, ref_faults, ref_store),
       "port": (port_compiler, port_online, port_zoo, port_faults, port_store)}


def _bank(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-60, 20, size=(REF_CFG.n_clauses_raw, REF_CFG.n_literals)
                        ).astype(np.int8)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 2, size=(n, KW["n_features"])).astype(np.uint8)
    y = rng.integers(0, KW["n_classes"], size=n).astype(np.int32)
    return X, y


def _sched_equal(a, b):
    for f in ("block_c", "block_j", "n_rows", "n_lit_bits"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("chain_ids", "tile_cb", "tile_jb", "tile_first", "tile_last",
              "counts", "indptr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _artifact_equal(a, b, tuned=True):
    """Arrays, stats, tunings and the default chain schedule."""
    for f in ("include_words", "word_ids", "votes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.n_features, a.n_classes) == (b.n_features, b.n_classes)
    assert a.stats.as_dict() == b.stats.as_dict()
    assert a.tuned == b.tuned or not tuned
    _sched_equal(a.schedule(), b.schedule())


def _saved_equal(a, b, tmp_path):
    """Both artifacts saved: every array and the meta, but the checksum and
    the cost-model features (the port writes none, ROADMAP queue 3)."""
    za = np.load(a.save(str(tmp_path / "a.npz")))
    zb = np.load(b.save(str(tmp_path / "b.npz")))
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        if k != "meta":
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    ma, mb = (json.loads(bytes(z["meta"]).decode()) for z in (za, zb))
    for m in (ma, mb):
        m.pop("checksum"), m.pop("features")
    assert ma == mb


# -- drift math and the content tag --------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_include_drift_and_artifact_tag_match_reference(seed):
    ta = _bank(seed)
    live = ta.copy()
    rng = np.random.default_rng(seed + 10)
    flip = rng.random(live.shape) < 0.05
    live[flip] = np.where(live[flip] >= 0, -30, 30)
    ref_words = ref_compiler.dense_include_words(REF_CFG, ta)
    for port_ta in (ta, torch.from_numpy(ta.copy())):      # numpy and tensor banks
        np.testing.assert_array_equal(
            port_compiler.dense_include_words(PORT_CFG, port_ta), ref_words)
    want = ref_compiler.include_drift(
        ref_words, ref_compiler.dense_include_words(REF_CFG, live))
    got = port_compiler.include_drift(
        port_compiler.dense_include_words(PORT_CFG, torch.from_numpy(ta.copy())),
        port_compiler.dense_include_words(PORT_CFG, torch.from_numpy(live)))
    assert got.as_dict() == want.as_dict() and got.n_bits_changed > 0
    with pytest.raises(ValueError):
        port_compiler.include_drift(ref_words[:1], ref_words)
    iw = ref_compiler.compile_tm(REF_CFG, live).include_words
    assert port_sparse.artifact_tag(iw) == ref_sparse.artifact_tag(iw)
    assert port_sparse.artifact_tag(iw[:-1]) != port_sparse.artifact_tag(iw)


def test_schedule_memos_return_one_object_per_content():
    iw = ref_compiler.compile_tm(REF_CFG, _bank(3)).include_words
    a = port_sparse.build_schedule_cached(iw, block_c=8, block_j=8)
    assert port_sparse.build_schedule_cached(iw.copy(), block_c=8, block_j=8) is a
    _sched_equal(a, ref_sparse.build_schedule_cached(iw, block_c=8, block_j=8))
    f = port_term.build_factorized_schedule_cached(iw)
    assert port_term.build_factorized_schedule_cached(iw.copy()) is f
    assert f.term_w == port_term.pick_term_width(iw)


# -- incremental schedule -------------------------------------------------------

def _iw(U=40, Wa=3, seed=1):
    rng = np.random.default_rng(seed)
    iw = (rng.integers(0, 2 ** 32, size=(U, Wa), dtype=np.uint64)
          & rng.integers(0, 2 ** 32, size=(U, Wa), dtype=np.uint64)).astype(np.uint32)
    iw[iw.sum(axis=1) == 0, 0] = 1
    return iw


@pytest.mark.parametrize("changed", ["none", "one", "tenth", "all", "layout"])
def test_build_schedule_incremental_matches_reference_and_full(changed):
    iw = _iw()
    prev_ref = ref_sparse.build_schedule(iw, block_c=8, block_j=8)
    prev_port = port_sparse.build_schedule(iw, block_c=8, block_j=8)
    live = iw.copy()
    rng = np.random.default_rng(5)
    if changed == "one":
        live[21] ^= 0b1011
    elif changed == "tenth":
        for r in rng.choice(len(live), len(live) // 10, replace=False):
            live[r, r % 3] ^= 1 << int(r % 32)
    elif changed == "all":
        live ^= np.uint32(0x10)
    elif changed == "layout":
        live = _iw(U=48, seed=2)          # a row count prev cannot cover
    want, want_info = ref_sparse.build_schedule_incremental(
        live, prev_ref, iw, block_c=8, block_j=8)
    got, info = port_sparse.build_schedule_incremental(
        live, prev_port, iw, block_c=8, block_j=8)
    assert info == want_info
    _sched_equal(got, want)
    _sched_equal(got, port_sparse.build_schedule(live, block_c=8, block_j=8))
    expect_rebuilt = {"none": 0, "one": 1, "tenth": 4, "all": 40, "layout": 48}
    assert info["rows_rebuilt"] == expect_rebuilt[changed]
    if changed == "none":
        assert info["tiles_reused"] == int(got.counts.sum())


# -- incremental recompile ------------------------------------------------------

@pytest.mark.parametrize("case", ["two_clauses", "layout_change", "no_schedule"])
def test_incremental_recompile_matches_reference(case):
    ta = _bank()
    live = ta.copy()
    if case == "layout_change":
        live[:, :] = np.abs(live)          # everything includes: layout changes
    else:
        live[3, :4] = np.where(live[3, :4] >= 0, -50, 50)
        live[7, 2:5] = np.where(live[7, 2:5] >= 0, -50, 50)
    out = {}
    for name, comp in (("ref", ref_compiler), ("port", port_compiler)):
        cfg = REF_CFG if name == "ref" else PORT_CFG
        prev = comp.compile_tm(cfg, ta)
        if case != "no_schedule":
            prev.schedule()
        prev.tuned["sparse_infer:B64"] = {"block_c": 8}
        out[name] = comp.incremental_recompile(cfg, live, prev)
    (rnew, rinfo), (pnew, pinfo) = out["ref"], out["port"]
    assert pinfo == rinfo
    assert pinfo["mode"] == ("incremental" if case == "two_clauses" else "full")
    _artifact_equal(pnew, rnew)
    _artifact_equal(pnew, port_compiler.compile_tm(PORT_CFG, live), tuned=False)
    if pinfo["mode"] == "incremental":
        assert pnew.tuned == {"sparse_infer:B64": {"block_c": 8}}


# -- two updaters, step by step -------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Pair:
    """An updater of each package over its own zoo, from the same bank."""

    def __init__(self, ta=None, *, zoo=True, ckpt_dirs=None, **cfg_kw):
        ta = _bank() if ta is None else ta
        cfg_kw = {**dict(drift_threshold=0.0, batch_size=4,
                         swap_policy="immediate"), **cfg_kw}
        self.upd, self.zoo, self.first = {}, {}, {}
        for name, (comp, onl, zmod, _, store) in PKG.items():
            cfg = REF_CFG if name == "ref" else PORT_CFG
            compiled = comp.compile_tm(cfg, ta)
            compiled.schedule()
            self.first[name] = compiled

            def make_obj(c):
                return {"compiled": c}, 1

            z = None
            if zoo:
                z = zmod.ArtifactZoo(lambda t, c=compiled, mk=make_obj: mk(c))
                with z.lease("t0"):
                    pass
            bank = ta.copy() if name == "ref" else torch.from_numpy(ta.copy())
            ckpt = (store.CheckpointManager(ckpt_dirs[name])
                    if ckpt_dirs else None)
            self.upd[name] = onl.OnlineUpdater(
                cfg, bank, compiled, cfg=onl.OnlineConfig(**cfg_kw), zoo=z,
                tenant="t0", make_obj=make_obj,
                deployed_obj={"compiled": compiled} if zoo else None,
                deployed_nbytes=1, ckpt_manager=ckpt, clock=Clock())
            self.zoo[name] = z

    def each(self, fn, inject=None):
        """``fn(updater, name)`` on both, under each package's injector."""
        out = {}
        for name, upd in self.upd.items():
            ctx = PKG[name][3].injected(inject) if inject else contextlib.nullcontext()
            with ctx:
                out[name] = fn(upd, name)
        return out

    def feed(self, X, y, inject=None):
        def go(upd, _):
            acc = [upd.ingest(X[i], int(y[i])) for i in range(len(y))]
            return acc, upd.step()
        out = self.each(go, inject)
        assert out["ref"] == out["port"]
        self.check()
        return out["port"]

    def check(self):
        r, p = self.upd["ref"], self.upd["port"]
        np.testing.assert_array_equal(p.bank.numpy(), np.asarray(r._ta))
        assert p.health() == r.health()
        assert p.state == r.state
        _artifact_equal(p.deployed, r.deployed)
        assert (p._candidate is None) == (r._candidate is None)
        if p._candidate is not None:
            _artifact_equal(p._candidate, r._candidate)
        if self.zoo["port"] is not None:
            assert self.zoo["port"].health() == self.zoo["ref"].health()


def test_updaters_match_step_by_step_and_candidates_save_equal(tmp_path):
    pair = Pair()
    for seed in range(1, 7):
        pair.feed(*_data(4, seed=seed))
    r, p = pair.upd["ref"], pair.upd["port"]
    assert p.promotions == 6 and p.incremental_rebuilds >= 1
    assert p.rebuild_info[-1]["mode"] in ("incremental", "full")
    _saved_equal(p.deployed, r.deployed, tmp_path)
    # the promoted artifact's tables were put on the bank's device
    assert str(p.bank.device) in p.deployed._dev


def test_feedback_corrupt_drill_matches_reference():
    pair = Pair(zoo=False, drift_threshold=10.0)
    X, y = _data(8)
    out = pair.each(lambda u, _: u.ingest(X[0], y[0]),
                    inject="online.feedback_corrupt*1")
    assert out == {"ref": False, "port": False}
    pair.each(lambda u, _: (u.ingest(np.zeros(3, np.uint8), 0),
                            u.ingest(X[0], KW["n_classes"])))
    pair.check()
    assert pair.upd["port"].rejected_corrupt == 3
    assert pair.feed(X[:4], y[:4])[1]
    assert pair.upd["port"].steps == 1


def test_rebuild_fail_drill_matches_reference():
    pair = Pair()
    pair.feed(*_data(4, seed=1), inject="online.rebuild_fail*1")
    p = pair.upd["port"]
    assert p.rebuild_failures == 1 and p.promotions == 0
    assert p.deployed is pair.first["port"]
    pair.feed(*_data(4, seed=2))
    assert p.rebuilds == 1 and p.promotions == 1
    assert pair.zoo["port"].version("t0") == 2


def test_swap_abort_drill_matches_reference():
    pair = Pair()
    orig = pair.first["port"].include_words.copy()
    pair.feed(*_data(4, seed=1), inject="zoo.swap_abort@0*1")
    p = pair.upd["port"]
    assert p.swap_aborts == 1 and p.promotions == 0
    with pair.zoo["port"].lease("t0") as obj:
        assert obj["compiled"] is pair.first["port"]
        np.testing.assert_array_equal(obj["compiled"].include_words, orig)
    assert p.state == port_online.IDLE
    pair.feed(*_data(4, seed=2))
    assert p.promotions == 1 and pair.zoo["port"].version("t0") == 2


def test_failed_canary_drill_matches_reference():
    pair = Pair(swap_policy="canary", canary_min=1, canary_frac=1.0)
    for upd in pair.upd.values():
        upd.serve_fn = lambda obj, rows: np.full(len(rows), 0, np.int64)
    pair.feed(*_data(4, seed=1))
    assert pair.upd["port"].state == port_online.CANARY

    def mirror(upd, _):
        rows = list(upd._pack(_data(4, seed=9)[0]))
        upd.mirror("t0", rows, np.full(len(rows), 1, np.int64))
    pair.each(mirror)
    pair.check()
    p = pair.upd["port"]
    assert p.canary_failures == 1 and p.promotions == 0 and p._candidate is None
    assert pair.zoo["port"].breakers["t0"].state == port_zoo.OPEN
    assert p.deployed is pair.first["port"]


def test_canary_pass_drill_matches_reference():
    pair = Pair(swap_policy="canary", canary_min=2, canary_frac=1.0)
    pair.feed(*_data(4, seed=1))

    def mirror(upd, _):
        rows = list(upd._pack(_data(4, seed=9)[0]))
        agreeing = np.asarray(upd.serve_fn(upd._cand_obj, rows))
        upd.mirror("t9", rows, np.zeros(4, np.int64))     # wrong tenant
        upd.mirror("t0", rows, agreeing)
        upd.mirror("t0", rows, agreeing)
    pair.each(mirror)
    pair.check()
    assert pair.upd["port"].promotions == 1 and pair.upd["port"].canary_passes == 1


def test_regression_rollback_drill_matches_reference():
    pair = Pair(regression_window=2, regression_drop=0.2)
    orig = pair.first["port"].include_words.copy()

    def feed_labeled(seed, truthful):
        X, _ = _data(4, seed=seed)
        preds = port_compiler.run_compiled(
            pair.upd["port"].deployed,
            torch.from_numpy(pair.upd["port"]._pack(X))).argmax(-1).numpy()
        ys = preds if truthful else (preds + 1) % KW["n_classes"]
        pair.feed(X, ys)

    feed_labeled(1, truthful=True)
    assert pair.upd["port"].promotions == 1
    for upd in pair.upd.values():
        upd.cfg.drift_threshold = 10.0      # freeze promotions; watch only
    feed_labeled(2, truthful=False)
    feed_labeled(3, truthful=False)
    p = pair.upd["port"]
    assert len(p.rollbacks) == 1 and "accuracy regression" in p.rollbacks[0]["reason"]
    assert p.deployed is pair.first["port"]
    np.testing.assert_array_equal(p.deployed.include_words, orig)
    assert pair.zoo["port"].version("t0") == 3
    for name, z in pair.zoo.items():
        with pytest.raises(PKG[name][2].TenantQuarantined):
            with z.lease("t0"):
                pass
    pair.each(lambda u, _: u.rollback("again"))      # idempotent
    pair.check()


def test_latency_rollback_drill_matches_reference():
    pair = Pair()
    pair.each(lambda u, _: [u.record_bucket_latency(0.01) for _ in range(2)])
    pair.feed(*_data(4, seed=1))                      # promote
    for upd in pair.upd.values():
        upd.cfg.drift_threshold = 10.0
    # 3 exempt buckets after the swap, then a blow-up past 3x the EWMA
    pair.each(lambda u, _: [u.record_bucket_latency(s) for s in (9, 9, 9, 1, 1, 1)])
    assert pair.each(lambda u, _: u.step()) == {"ref": False, "port": False}
    pair.check()
    p = pair.upd["port"]
    assert len(p.rollbacks) == 1 and "latency regression" in p.rollbacks[0]["reason"]
    assert p.deployed is pair.first["port"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_drain_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    dirs = {writer: str(tmp_path / "w"), reader: str(tmp_path / "unused")}
    pair = Pair(zoo=False, drift_threshold=10.0, ckpt_dirs=dirs)
    X, y = _data(6, seed=3)
    pair.feed(X[:4], y[:4])
    pair.each(lambda u, _: [u.ingest(X[i], y[i]) for i in (4, 5)])
    w = pair.upd[writer]
    assert w.drain() == 1 and len(w.queue) == 0

    comp, onl, _, _, store = PKG[reader]
    cfg = REF_CFG if reader == "ref" else PORT_CFG
    other = _bank(seed=99)
    bank = other if reader == "ref" else torch.from_numpy(other)
    resumed = onl.OnlineUpdater(
        cfg, bank, comp.compile_tm(cfg, _bank()),
        cfg=onl.OnlineConfig(batch_size=4, drift_threshold=10.0),
        ckpt_manager=store.CheckpointManager(dirs[writer]))
    got = resumed.bank.numpy() if reader == "port" else np.asarray(resumed._ta)
    want = w.bank.numpy() if writer == "port" else np.asarray(w._ta)
    np.testing.assert_array_equal(got, want)
    assert resumed.gstep == 1 and len(resumed.queue) == 2
    assert resumed.ingested == w.ingested
    for i in range(2):
        resumed.ingest(X[i], y[i])
    assert resumed.step() and resumed.gstep == 2


def test_live_bank_must_be_a_tensor():
    ta = _bank()
    compiled = port_compiler.compile_tm(PORT_CFG, ta)
    with pytest.raises(TypeError, match="int8 tensor"):
        port_online.OnlineUpdater(PORT_CFG, ta, compiled)
    upd = port_online.OnlineUpdater(PORT_CFG, torch.from_numpy(ta), compiled)
    assert upd.bank.device.type == "cpu"


def test_promotions_under_concurrent_leases():
    """The updater promotes on its own thread while four serving threads
    lease the zoo, answer from the leased artifact and feed the latency
    watch, with a tiny switch interval: every answer equals the oracle of
    the artifact it was served from, that artifact is one the updater
    deployed, and every promotion is one zoo swap."""
    import sys
    import threading

    ta = _bank()
    compiled = port_compiler.compile_tm(PORT_CFG, ta)
    compiled.schedule()
    deployed = [compiled]

    def make_obj(c):
        deployed.append(c)
        return {"compiled": c}, 1

    zoo = port_zoo.ArtifactZoo(lambda t: ({"compiled": compiled}, 1))
    upd = port_online.OnlineUpdater(
        PORT_CFG, torch.from_numpy(ta.copy()), compiled,
        cfg=port_online.OnlineConfig(drift_threshold=0.0, batch_size=4,
                                     swap_policy="immediate"),
        zoo=zoo, make_obj=make_obj, deployed_obj={"compiled": compiled},
        deployed_nbytes=1)
    X, y = _data(48, seed=11)
    xw = torch.from_numpy(port_online.OnlineUpdater._pack(X[:8]))
    stop, errors, served = threading.Event(), [], []

    def serve():
        try:
            while not stop.is_set():
                with zoo.lease("t0") as obj:
                    c = obj["compiled"]
                    got = port_compiler.run_compiled(c, xw, engine="sparse")
                    want = port_compiler.run_compiled(c, xw, engine="oracle")
                    assert torch.equal(got, want)
                    served.append(c)
                upd.record_bucket_latency(0.001)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def train():
        try:
            for i in range(12):
                for j in range(4 * i, 4 * i + 4):
                    upd.ingest(X[j], int(y[j]))
                assert upd.step()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve) for _ in range(4)]
        trainer = threading.Thread(target=train)
        for t in threads + [trainer]:
            t.start()
        trainer.join(120)
        stop.set()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not trainer.is_alive() and not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert upd.steps == 12 and upd.promotions == 12
    assert zoo.version("t0") == 13 and zoo.health()["swaps"] == 12
    ids = {id(c) for c in deployed}
    assert served and all(id(c) in ids for c in served)


# -- end to end through the gateway ---------------------------------------------

def test_end_to_end_drift_canary_swap_through_gateway():
    """The reference's acceptance drill on the port: serve -> labeled
    feedback -> drift -> recompile -> shadow canary on mirrored buckets ->
    atomic swap, with ``offered == answered + shed`` intact and every
    bucket answered by a fully-committed artifact."""
    from repro_torch.runtime.gateway import Gateway

    ta = _bank()
    compiled = port_compiler.compile_tm(PORT_CFG, ta)
    compiled.schedule()                 # give the incremental path its shot
    served_ids = []

    def serve_rows(obj, rows):
        served_ids.append(id(obj["compiled"]))
        xw = torch.from_numpy(np.stack([np.asarray(r) for r in rows]))
        return port_compiler.run_compiled(
            obj["compiled"], xw, engine="oracle").argmax(-1).numpy()

    def make_obj(c):
        return {"compiled": c}, 1

    zoo = port_zoo.ArtifactZoo(lambda t: make_obj(compiled))
    runner = zoo.runner(serve_rows)
    upd = port_online.OnlineUpdater(
        PORT_CFG, torch.from_numpy(ta.copy()), compiled,
        cfg=port_online.OnlineConfig(drift_threshold=0.0, batch_size=4,
                                     swap_policy="canary", canary_min=2,
                                     canary_frac=1.0, canary_agreement=0.0),
        zoo=zoo, tenant="t0", make_obj=make_obj, serve_fn=serve_rows,
        deployed_obj={"compiled": compiled}, deployed_nbytes=1)

    X, y = _data(32, seed=5)
    xw = port_online.OnlineUpdater._pack(X)

    async def go():
        gw = await Gateway(runner, bucket=4, max_wait=0.01,
                           mirror=upd.mirror).start()

        async def offer(lo, hi):
            return await asyncio.gather(*[gw.offer("t0", xw[j])
                                          for j in range(lo, hi)])

        r1 = await offer(0, 8)                      # version 1 serves
        for i in range(4):                          # feedback -> drift
            upd.ingest(X[i], int(y[i]))
        assert upd.step() and upd.state == port_online.CANARY
        assert upd.rebuilds == 1 and upd.incremental_rebuilds == 1
        r2 = await offer(8, 24)       # mirrored buckets decide the canary
        r3 = await offer(24, 32)
        return r1 + r2 + r3, await gw.drain()

    res, h = asyncio.run(go())
    assert upd.canary_passes == 1 and upd.promotions == 1
    assert zoo.version("t0") == 2
    assert h["unaccounted"] == 0 and h["answered"] == 32
    assert h["mirrored"] >= 2 and h["mirror_failures"] == 0
    assert all(r.ok for r in res)
    assert set(served_ids) <= {id(compiled), id(upd.deployed)}
    assert id(compiled) in served_ids and id(upd.deployed) in served_ids


# -- the live bank's boot -------------------------------------------------------------

def test_serve_online_boot_bank_equals_reference(monkeypatch):
    """``serve_tm --online`` boots its live bank as the reference does
    (``tm.init`` from key 0, ``fit(engine="jnp")`` from key 1 at batch 64):
    the bank the port's updater starts from equals the reference's."""
    from repro.configs.matador_tm import TM_TINY as R_TINY
    from repro.core import train as ref_train
    from repro.data import make_boolean_classification
    from repro_torch.launch import serve

    booted = []

    class Recording(port_online.OnlineUpdater):
        def __init__(self, config, bank, *a, **kw):
            booted.append(bank.clone())
            super().__init__(config, bank, *a, **kw)

    monkeypatch.setattr(port_online, "OnlineUpdater", Recording)
    serve.main(["--arch", "tm-tiny", "--device", "cpu", "--online", "--epochs", "2",
                "--n-train", "256", "--requests", "128", "--bucket", "64",
                "--swap-policy", "immediate"])
    X, y = make_boolean_classification(256, 32, 3, seed=0)
    want = ref_train.fit(R_TINY, ref_tm.init(R_TINY, jax.random.PRNGKey(0)),
                         jax.numpy.asarray(X), jax.numpy.asarray(y), epochs=2,
                         batch_size=64, rng=jax.random.PRNGKey(1))
    assert len(booted) == 1
    np.testing.assert_array_equal(booted[0].numpy(), np.asarray(want.ta_state))
