"""Port parity: the clause-sharded mesh path (``launch/mesh.py``,
``core/sharding.py``, ``stack_shard_*``, ``tm_train_step_matmul_local``,
``fit(mesh=)``, ``load_checkpoint(shardings=)`` and the launchers'
``--mesh``) against the JAX reference, at tolerance 0, on emulated meshes
of (4,) model and (2, 2) data x model.

The reference's sharded results come from ONE subprocess, which forces 4
host devices (``XLA_FLAGS``) before jax starts and writes every case to an
``.npz``; the port runs in this process with
``REPRO_TORCH_FORCE_DEVICE_COUNT=4``.  Both start from the same numpy
inputs (the reference's ``tests/test_sharded_fused.py`` prelude).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels import sparse_infer as ref_sparse  # noqa: E402
from repro.kernels import term_infer as ref_term  # noqa: E402
from repro_torch.core import compiler, packetizer, prng, sharding, tm  # noqa: E402
from repro_torch.kernels import ops, sparse_infer, term_infer  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

pytestmark = pytest.mark.multidevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "src", "repro_torch", "assets", "tm_mnist_e1.npz")
MESHES = {"m4": {"model": 4}, "d2m2": {"data": 2, "model": 2}}
# the schedule stacks' tiling in the forward cases: two clause blocks a
# shard, so shards differ in real tiles and carry padding
SCHED_BLOCKS = dict(block_c=8, block_j=8)

_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import compiler, packetizer, sharding, tm, train
from repro.data import make_noisy_xor
from repro.kernels import ops, sparse_infer, term_infer

out_path, art_path = sys.argv[1], sys.argv[2]
cfg = tm.TMConfig(n_features=32, n_classes=4, clauses_per_class=16,
                  clause_pad_multiple=8, threshold=15, s=5.0)
state = tm.init(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
X = jnp.asarray(rng.integers(0, 2, (24, 32), dtype=np.uint8))
y = jnp.asarray(rng.integers(0, 4, 24, dtype=np.int32))
seed = jnp.uint32(5)
out = {}
meshes = {"m4": jax.make_mesh((4,), ("model",)),
          "d2m2": jax.make_mesh((2, 2), ("data", "model"))}
iw = packetizer.pack_include_masks(state.ta_state)
votes = tm.vote_matrix(cfg)
ne = jnp.any(state.ta_state >= 0, -1).astype(jnp.uint8)
lw = packetizer.pack_bits(tm.literals(X))
# a sparse bank's artifact for the schedule builders
srng = np.random.default_rng(1)
C, L = cfg.n_clauses_total, cfg.n_literals
ta_s = np.where(srng.random((C, L)) < 0.08, srng.integers(0, 127, (C, L)),
                srng.integers(-128, 0, (C, L))).astype(np.int8)
art = compiler.compile_tm(cfg, jnp.asarray(ta_s))
art.save(art_path)
xw = lw[:, jnp.asarray(art.word_ids)]
for name, mesh in meshes.items():
    n = mesh.shape["model"]
    fwd = sharding.sharded_forward_fn(mesh, use_kernel=True, interpret=True)
    out[f"dense_{name}"] = np.asarray(fwd(iw, votes, ne, lw))
    for tag, kw in (("kernel", dict(use_kernel=True, interpret=True)),
                    ("gspmd", {})):
        pred = sharding.sharded_predict_fn(cfg, mesh, **kw)
        out[f"predict_{tag}_{name}"] = np.asarray(pred(iw, votes, ne, lw))
    sch, cs, vs, ts, _ = sparse_infer.stack_shard_schedules(
        art.include_words, art.votes, n, block_c=8, block_j=8)
    fwd = sharding.sharded_schedule_forward_fn(
        mesh, block_c=sch[0].block_c, block_j=sch[0].block_j, block_s=1,
        use_kernel=True, interpret=True)
    out[f"sparse_{name}"] = np.asarray(fwd(cs, vs, ts, xw))
    fs, tst, cst, vst, tls, _ = term_infer.stack_shard_factorized(
        art.include_words, art.votes, n, block_c=8, block_j=8)
    fwd = sharding.sharded_factorized_forward_fn(
        mesh, block_t=fs[0].block_t, block_c=fs[0].block_c,
        block_j=fs[0].block_j, block_s=1, use_kernel=True, interpret=True)
    out[f"factorized_{name}"] = np.asarray(fwd(tst, cst, vst, tls, xw))
    for tag, kw in (("fused", dict(use_kernel=True, interpret=True)),
                    ("unfused", dict(use_kernel=True, interpret=True, fuse=False)),
                    ("oracle", dict(use_kernel=False))):
        step = sharding.sharded_train_step_fn(cfg, mesh, engine="kernel", **kw)
        out[f"train_{tag}_{name}"] = np.asarray(step(state.ta_state, X, y, seed))
mesh = meshes["d2m2"]
step = sharding.sharded_train_step_fn(cfg, mesh, batch_chunk=5, engine="kernel",
                                      use_kernel=True, interpret=True)
out["train_chunk5_d2m2"] = np.asarray(step(state.ta_state, X, y, seed))
step = sharding.sharded_train_step_fn(cfg, mesh)
out["train_gspmd_d2m2"] = np.asarray(step(state.ta_state, X, y, seed))
step = sharding.sharded_train_step_fn(cfg, mesh, algorithm="matmul")
out["matmul_d2m2"] = np.asarray(step(state.ta_state, X, y, seed))
out["matmul_single"] = np.asarray(
    ops.tm_train_step_matmul(cfg, state.ta_state, X, y, seed)[0])
# tests/test_sharded_fused.py's fit recipe
Xf, yf = make_noisy_xor(64, noise=0.05, seed=3)
fcfg = tm.TMConfig(n_features=12, n_classes=2, clauses_per_class=8,
                   clause_pad_multiple=4)
st0 = tm.init(fcfg, jax.random.PRNGKey(0))
out["fit_ta0"] = np.asarray(st0.ta_state)
st = train.fit(fcfg, st0, jnp.asarray(Xf), jnp.asarray(yf), epochs=2,
               batch_size=16, rng=jax.random.PRNGKey(7), engine="kernel",
               mesh=mesh)
out["fit_mesh"] = np.asarray(st.ta_state)
np.savez(out_path, **out)
print("REF_DONE")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_sharding")
    out, art = d / "ref.npz", d / "art.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(out), str(art)], env=env,
                       capture_output=True, text=True, timeout=600, cwd=REPO)
    assert "REF_DONE" in r.stdout, r.stdout + r.stderr
    return dict(np.load(out)), str(art)


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv(mesh_mod.FORCE_ENV, "4")


def _mesh(name):
    return mesh_mod.make_mesh(MESHES[name], "cpu")


def _prelude():
    cfg = tm.TMConfig(n_features=32, n_classes=4, clauses_per_class=16,
                      clause_pad_multiple=8, threshold=15, s=5.0)
    ta = tm.init(cfg, prng.PRNGKey(0), "cpu").ta_state
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.integers(0, 2, (24, 32), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 4, 24, dtype=np.int32))
    return cfg, ta, X, y


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


# -- launch/mesh.py ----------------------------------------------------------

@pytest.mark.parametrize("spec, shape", [
    ("model=2", {"model": 2}),
    ("data=2,model=2", {"data": 2, "model": 2}),
    ("model=2,data=2", {"data": 2, "model": 2}),
    ("2x2", {"data": 2, "model": 2}),
    ("pod=1,data=2,model=2", {"pod": 1, "data": 2, "model": 2}),
])
def test_parse_mesh_spec_shapes(forced, spec, shape):
    m = mesh_mod.parse_mesh_spec(spec, "cpu")
    assert m.shape == shape and list(m.shape) == list(shape)
    assert m.devices == [torch.device("cpu")] * m.size


def test_parse_mesh_spec_validation(monkeypatch):
    """The reference's errors (``tests/test_sharded_fused.py:153``): a
    too-few-devices error that names the device count, a bad spec."""
    monkeypatch.delenv(mesh_mod.FORCE_ENV, raising=False)
    m = mesh_mod.parse_mesh_spec("model=1", "cpu")
    assert m.axis_names == ("model",)
    with pytest.raises(ValueError, match="device_count"):
        mesh_mod.parse_mesh_spec("model=64", "cpu")
    for bad in ("modl=2", "data=2", "model=0", "2x", "model=two"):
        with pytest.raises(ValueError, match="bad --mesh spec"):
            mesh_mod.parse_mesh_spec(bad, "cpu")
    monkeypatch.setenv(mesh_mod.FORCE_ENV, "x")
    with pytest.raises(ValueError, match=mesh_mod.FORCE_ENV):
        mesh_mod.parse_mesh_spec("model=2", "cpu")
    monkeypatch.setenv(mesh_mod.FORCE_ENV, "8")
    assert mesh_mod.make_host_mesh(2, 4).shape == {"data": 2, "model": 4}


# -- stack_shard_* (host numpy) ----------------------------------------------

def _tiny_artifact():
    from repro_torch.configs.matador_tm import TM_CONFIGS

    cfg = TM_CONFIGS["tm-tiny"]
    rng = np.random.default_rng(0)
    C, L = cfg.n_clauses_total, cfg.n_literals
    ta = np.where(rng.random((C, L)) < 0.08, rng.integers(0, 127, (C, L)),
                  rng.integers(-128, 0, (C, L))).astype(np.int8)
    return compiler.compile_tm(cfg, ta)


@functools.cache
def _artifact(which):
    return _tiny_artifact() if which == "tiny" else compiler.CompiledTM.load(ASSET)


@pytest.mark.parametrize("which, n", [("tiny", 2), ("tiny", 4), ("mnist", 2), ("mnist", 4)])
def test_stack_shard_schedules_equal_reference(which, n):
    art = _artifact(which)
    kw = dict(block_c=8, block_j=8) if which == "tiny" else {}
    want = ref_sparse.stack_shard_schedules(art.include_words, art.votes, n, **kw)
    got = sparse_infer.stack_shard_schedules(art.include_words, art.votes, n, **kw)
    for a, b in zip(want[1:], got[1:]):
        _eq(a, b)
    for a, b in zip(want[0], got[0]):
        for f in ("chain_ids", "tile_cb", "tile_jb", "tile_first", "tile_last",
                  "counts", "indptr"):
            _eq(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("which, n", [("tiny", 2), ("tiny", 4), ("mnist", 2), ("mnist", 4)])
def test_stack_shard_factorized_equal_reference(which, n):
    art = _artifact(which)
    kw = dict(block_c=8, block_j=8) if which == "tiny" else {}
    want = ref_term.stack_shard_factorized(art.include_words, art.votes, n, **kw)
    got = term_infer.stack_shard_factorized(art.include_words, art.votes, n, **kw)
    for a, b in zip(want[1:], got[1:]):
        _eq(a, b)
    for a, b in zip(want[0], got[0]):
        assert (a.block_t, a.term_w, a.n_terms) == (b.block_t, b.term_w, b.n_terms)
        for f in ("term_chain", "clause_chain", "tile_stage", "tile_jb",
                  "tile_last", "indptr"):
            _eq(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("n", [2, 4])
def test_padded_shards_fold_nothing(forced, n):
    """tm_mnist_e1 at 2 and 4 shards: the shards' real tile counts differ,
    the shorter ones ride on no-op padding tiles, and both sharded
    schedule forwards equal the unsharded oracle."""
    art = _artifact("mnist")
    mesh = mesh_mod.make_mesh({"model": n}, "cpu")
    X = np.random.default_rng(2).integers(0, 2, (64, 784), dtype=np.uint8)
    xp = packetizer.pack_literals(torch.from_numpy(X))
    want = compiler.run_compiled(art, xp, engine="oracle")
    xw = xp[:, art.tensors("cpu")["word_ids"]]

    fs, *fstacks, _ = term_infer.stack_shard_factorized(art.include_words, art.votes, n)
    tiles = fstacks[3]
    real = sharding.real_tiles(tiles, fstacks[1].shape[1], fs[0].block_c)
    assert len(set(real)) > 1 and min(real) < tiles.shape[-1], real
    fwd = sharding.sharded_factorized_forward_fn(
        mesh, block_t=fs[0].block_t, block_c=fs[0].block_c, block_j=fs[0].block_j)
    _eq(want, fwd(*(torch.from_numpy(a) for a in fstacks), xw))

    ss, *sstacks, _ = sparse_infer.stack_shard_schedules(art.include_words, art.votes, n)
    fwd = sharding.sharded_schedule_forward_fn(mesh, block_c=ss[0].block_c,
                                               block_j=ss[0].block_j)
    _eq(want, fwd(*(torch.from_numpy(a) for a in sstacks), xw))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_stack_shard_dense_pads_with_silent_clauses(forced, n):
    """The dense mesh rung's tables: U rows padded up to a multiple of n
    with zero include words, zero votes and nonempty 1, and the sharded
    dense forward over them equals the unsharded oracle."""
    art = _artifact("tiny")
    U = art.n_unique
    inc, votes, ne = sharding.stack_shard_dense(art.include_words, art.votes, n)
    Up = -(-U // n) * n
    assert inc.shape[0] == votes.shape[0] == ne.shape[0] == Up
    assert inc.dtype == votes.dtype == ne.dtype == np.int32
    _eq(art.include_words.view(np.int32), inc[:U])
    assert not inc[U:].any() and not votes[U:].any() and ne.all()
    mesh = mesh_mod.make_mesh({"model": n}, "cpu")
    X = np.random.default_rng(4).integers(0, 2, (16, art.n_features),
                                          dtype=np.uint8)
    xp = packetizer.pack_literals(torch.from_numpy(X))
    xw = xp[:, art.tensors("cpu")["word_ids"]]
    got = sharding.sharded_forward_fn(mesh)(
        *(torch.from_numpy(a) for a in (inc, votes, ne)), xw)
    _eq(compiler.run_compiled(art, xp, engine="oracle"), got)


def test_tile_indptr_drops_padding_and_checks_order():
    sched = sparse_infer.build_schedule(_artifact("tiny").include_words,
                                        block_c=8, block_j=8, pad_tiles_to=40)
    assert sched.n_tiles == 40
    _eq(sched.indptr, sparse_infer.tile_indptr(sched.tile_cb, sched.tile_last,
                                               sched.n_cblocks))
    with pytest.raises(ValueError, match="not in order"):
        sparse_infer.tile_indptr(np.array([1, 0]), np.array([1, 1]), 2)


# -- core/sharding.py --------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", ["dense", "predict_kernel", "predict_gspmd",
                                  "sparse", "factorized"])
def test_sharded_forward_equal_reference(ref, forced, mesh_name, case):
    want, art_path = ref
    cfg, ta, X, _ = _prelude()
    mesh = _mesh(mesh_name)
    iw = packetizer.pack_include_masks(ta)
    votes, ne = tm.vote_matrix(cfg), (ta >= 0).any(-1).to(torch.uint8)
    lw = packetizer.pack_bits(tm.literals(X))
    key = f"{case}_{mesh_name}"
    if case == "dense":
        got = sharding.sharded_forward_fn(mesh)(iw, votes, ne, lw)
        _eq(got, sharding.sharded_forward_fn(mesh, engine="oracle")(iw, votes, ne, lw))
    elif case.startswith("predict"):
        kw = {} if case == "predict_kernel" else dict(engine="oracle")
        got = sharding.sharded_predict_fn(cfg, mesh, **kw)(iw, votes, ne, lw)
    else:
        art = compiler.CompiledTM.load(art_path)
        xw = lw[:, art.tensors("cpu")["word_ids"]]
        n = mesh.shape["model"]
        if case == "sparse":
            s, *stacks, _ = sparse_infer.stack_shard_schedules(
                art.include_words, art.votes, n, **SCHED_BLOCKS)
            build = lambda **kw: sharding.sharded_schedule_forward_fn(  # noqa: E731
                mesh, block_c=s[0].block_c, block_j=s[0].block_j, block_s=1, **kw)
        else:
            s, *stacks, _ = term_infer.stack_shard_factorized(
                art.include_words, art.votes, n, **SCHED_BLOCKS)
            build = lambda **kw: sharding.sharded_factorized_forward_fn(  # noqa: E731
                mesh, block_t=s[0].block_t, block_c=s[0].block_c,
                block_j=s[0].block_j, block_s=1, **kw)
        tabs = [torch.from_numpy(a) for a in stacks]
        got = build()(*tabs, xw)
        _eq(got, build(engine="oracle")(*tabs, xw))
        _eq(got, compiler.run_compiled(art, packetizer.pack_bits(tm.literals(X)),
                                       engine="oracle"))
    _eq(want[key], got)


@pytest.mark.parametrize("case", ["fused_m4", "unfused_m4", "oracle_m4", "fused_d2m2",
                                  "unfused_d2m2", "oracle_d2m2", "chunk5_d2m2",
                                  "gspmd_d2m2"])
def test_sharded_train_step_equal_reference(ref, forced, case):
    """Every engine and mesh gives the reference's sharded bank, which is
    the single-device step's (kernel fused, unfused, plain, chunked by 5
    with a ragged tail of 2 a data shard, gspmd)."""
    want, _ = ref
    cfg, ta, X, y = _prelude()
    tag, mesh_name = case.split("_")
    kw = dict(engine="kernel")
    if tag == "unfused":
        kw["fuse"] = False
    elif tag == "oracle":
        kw["use_kernel"] = False
    elif tag == "chunk5":
        kw["batch_chunk"] = 5
    elif tag == "gspmd":
        kw = {}
    step = sharding.sharded_train_step_fn(cfg, _mesh(mesh_name), **kw)
    ta_before = ta.clone()
    got = step(ta, X, y, 5)
    _eq(want[f"train_{case}"], got)
    _eq(ops.tm_train_step_kernel(cfg, ta, X, y, 5)[0], got)
    _eq(ta_before, ta)                      # the bank is never written


def test_sharded_matmul_equal_reference(ref, forced):
    """``algorithm="matmul"`` on (2, 2): the reference's sharded bank, which
    equals its (and the port's) single-device ``tm_train_step_matmul``."""
    want, _ = ref
    cfg, ta, X, y = _prelude()
    _eq(want["matmul_d2m2"], want["matmul_single"])
    got = sharding.sharded_train_step_fn(cfg, _mesh("d2m2"), algorithm="matmul")(ta, X, y, 5)
    _eq(want["matmul_d2m2"], got)
    _eq(ops.tm_train_step_matmul(cfg, ta, X, y, 5)[0], got)


def test_sharded_builders_refuse_what_the_reference_refuses(forced):
    cfg, ta, X, y = _prelude()
    mesh = mesh_mod.make_mesh({"model": 3}, "cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        sharding.sharded_train_step_fn(cfg, mesh, engine="kernal")
    with pytest.raises(ValueError, match="not divisible by the model axis"):
        sharding.sharded_train_step_fn(cfg, mesh, engine="kernel")
    with pytest.raises(ValueError, match="does not apply"):
        sharding.sharded_forward_fn(mesh, engine="sparse")
    with pytest.raises(TypeError, match="not both"):
        sharding.sharded_forward_fn(mesh, engine="dense", use_kernel=True)
    step = sharding.sharded_train_step_fn(cfg, _mesh("d2m2"), engine="kernel")
    with pytest.raises(ValueError, match="batch"):
        step(ta, X[:23], y[:23], 5)


def test_fit_on_mesh_equal_reference(ref, forced):
    """``tests/test_sharded_fused.py``'s recipe: ``fit(engine="kernel",
    mesh=)`` ends on the reference's bank, which is ``fit`` without a mesh."""
    from repro_torch.core import train
    from repro_torch.data import make_noisy_xor

    want, _ = ref
    X, y = make_noisy_xor(64, noise=0.05, seed=3)
    cfg = tm.TMConfig(n_features=12, n_classes=2, clauses_per_class=8,
                      clause_pad_multiple=4)
    st0 = tm.init(cfg, prng.PRNGKey(0), "cpu")
    _eq(want["fit_ta0"], st0.ta_state)
    kw = dict(epochs=2, batch_size=16, rng=prng.PRNGKey(7), engine="kernel")
    got = train.fit(cfg, st0, torch.from_numpy(X), torch.from_numpy(y),
                    mesh=_mesh("d2m2"), **kw)
    _eq(want["fit_mesh"], got.ta_state)
    plain = train.fit(cfg, st0, torch.from_numpy(X), torch.from_numpy(y), **kw)
    _eq(plain.ta_state, got.ta_state)
    assert got.steps == plain.steps == 8
    with pytest.raises(ValueError, match="requires engine='kernel'"):
        train.fit(cfg, st0, torch.from_numpy(X), torch.from_numpy(y), epochs=1,
                  batch_size=16, rng=prng.PRNGKey(7), mesh=_mesh("d2m2"))


def test_checkpoint_restore_with_shardings(tmp_path, forced):
    """The counterpart of ``tests/test_substrate.py``'s elastic restore:
    arrays come back block by block on the mesh's devices."""
    from repro_torch.checkpoint.store import CheckpointManager, load_checkpoint, save_checkpoint

    mesh = _mesh("d2m2")
    w = torch.arange(8, dtype=torch.float32)
    shd = {"w": sharding.NamedSharding(mesh, ("data",))}
    save_checkpoint(str(tmp_path), 1, {"w": w})
    got, _ = load_checkpoint(str(tmp_path), {"w": w}, shardings=shd)
    assert got["w"].sharding == shd["w"]
    np.testing.assert_array_equal(np.asarray(got["w"]), np.arange(8))
    assert {tuple(t.tolist()) for t in got["w"].shards.values()} == {
        (0.0, 1.0, 2.0, 3.0), (4.0, 5.0, 6.0, 7.0)}
    state_s, batch_s = sharding.tm_shardings(tm.TMConfig(4, 2, 4), mesh)
    assert state_s.ta_state.spec == ("model", None)
    assert batch_s.spec == (("data",), None)
    ta = torch.arange(8 * 8, dtype=torch.int8).reshape(8, 8)
    mgr = CheckpointManager(str(tmp_path / "m"))
    mgr.save(3, {"ta": ta})
    got, _ = mgr.restore({"ta": ta}, shardings={"ta": state_s.ta_state})
    blocks = got["ta"].shards
    assert blocks[(0, 1)] is blocks[(1, 1)]          # data replicas share
    _eq(blocks[(1, 1)], ta[4:])
    _eq(got["ta"].full(), ta)


# -- the launchers -----------------------------------------------------------

def test_train_tm_mesh_equals_unsharded(forced, capsys, monkeypatch):
    from repro_torch.launch import train as t_launch

    base = ["--arch", "tm-tiny", "--device", "cpu", "--steps", "3",
            "--batch-size", "16", "--n-train", "96", "--log-every", "10"]
    plain, _ = t_launch.train_tm(t_launch.build_parser().parse_args(base))
    meshed, _ = t_launch.train_tm(t_launch.build_parser().parse_args(
        base + ["--mesh", "data=2,model=2", "--batch-chunk", "5"]))
    assert "mesh {'data': 2, 'model': 2}: clause axis sharded over model=2" in \
        capsys.readouterr().out
    _eq(plain, meshed)
    monkeypatch.setenv(mesh_mod.FORCE_ENV, "5")
    with pytest.raises(SystemExit, match=r"clause axis \(24\) not divisible by mesh model=5"):
        t_launch.train_tm(t_launch.build_parser().parse_args(
            base + ["--mesh", "model=5"]))


@pytest.mark.parametrize("extra", [["--factorize"], ["--no-factorize"], ["--no-sparse"]])
def test_serve_tm_mesh_predicts_like_unsharded(forced, capsys, tmp_path, extra):
    """``serve_tm --mesh model=2`` on each top rung (factorized, sparse,
    dense) serves every bucket on the mesh rung and predicts what the
    unsharded run predicts."""
    from repro_torch.launch import serve

    art = _artifact("tiny").save(str(tmp_path / "tiny.npz"))
    argv = ["--arch", "tm-tiny", "--device", "cpu", "--artifact", art,
            "--requests", "300", "--bucket", "128", *extra]
    _, _, _, want = serve.serve_tm(serve.build_parser().parse_args(argv))
    health, gw, _, got = serve.serve_tm(serve.build_parser().parse_args(
        argv + ["--mesh", "model=2"]))
    out = capsys.readouterr().out
    top = health["ladder"][0]
    assert top == "mesh-" + health["ladder"][1] and health["final_engine"] == top
    assert health["engine_buckets"][top] == health["buckets"] == 3
    assert health["demotions"] == [] and gw["unaccounted"] == 0
    assert "clause-sharded" in out and "inf/s" in out
    assert "mesh {'model': 2}: " in out
    _eq(want, got)
