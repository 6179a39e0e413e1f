"""Port parity and policies: the autotuner (``repro_torch.kernels.autotune``)
held to ``repro.kernels.autotune`` at tolerance 0 -- each tuner's basis on
candidates both packages can express, cache keys equal to the reference's
with the mode segment swapped, schema invalidation -- and its policies on
the CPU plain versions: ``predict`` makes no timing run, ``verify`` times
only the top-k, ``sweep`` feeds the sidecar and shares the legacy key,
``plan_engine`` picks the reference's engine, ``artifact_loader`` loads
through the zoo, ``serve_tm``/``train_tm --autotune`` run and round-trip
their tilings, and a reference-saved tiling is never recalled."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import compiler as ref_compiler
from repro.core import tm as ref_tm
from repro.kernels import autotune as ref_at
from repro.kernels import cost_model as ref_cm
from repro_torch.core import compiler as port_compiler
from repro_torch.core import packetizer as port_pk
from repro_torch.core import tm as port_tm
from repro_torch.kernels import autotune as port_at
from repro_torch.kernels import cost_model as port_cm
from repro_torch.kernels import fused_infer, fused_train, sparse_infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "src", "repro_torch", "assets", "tm_mnist_e1.npz")
CPU = torch.device("cpu")


@pytest.fixture()
def tune_env(tmp_path, monkeypatch):
    """Both packages' caches and sidecars in a fresh directory."""
    env = dict(REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "port_tune.json"),
               REPRO_TORCH_TUNE_DATA=str(tmp_path / "port_data.json"),
               REPRO_AUTOTUNE_CACHE=str(tmp_path / "ref_tune.json"),
               REPRO_TUNE_DATA=str(tmp_path / "ref_data.json"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cm in (port_cm, ref_cm):
        cm._invalidate_model_cache()
    yield tmp_path
    for cm in (port_cm, ref_cm):
        cm._invalidate_model_cache()


def _bank(n_features, n_classes, cpc, density, seed):
    rng = np.random.default_rng(seed)
    C, L = n_classes * cpc, 2 * n_features
    ta = np.where(rng.random((C, L)) < density, rng.integers(0, 127, (C, L)),
                  rng.integers(-128, 0, (C, L))).astype(np.int8)
    kw = dict(n_features=n_features, n_classes=n_classes, clauses_per_class=cpc)
    return (ref_compiler.compile_tm(ref_tm.TMConfig(**kw), ta),
            port_compiler.compile_tm(port_tm.TMConfig(**kw), torch.from_numpy(ta)))


def _shared_bank():
    """High term sharing: every clause carries the same two-word core."""
    C, L = 16, 128
    ta = np.full((C, L), -5, np.int8)
    ta[:, 3] = ta[:, 40] = 3
    for c in range(C):
        ta[c, 64 + ((c * 4) % 64)] = 3
    kw = dict(n_features=64, n_classes=2, clauses_per_class=8)
    return (ref_compiler.compile_tm(ref_tm.TMConfig(**kw), ta),
            port_compiler.compile_tm(port_tm.TMConfig(**kw), torch.from_numpy(ta)))


def _shapes(kernel):
    """(shape kwargs, id) a kernel is held at: tm-mnist's own and small
    ragged ones; the walks on the committed artifact and a random bank."""
    if kernel == "fused_infer":
        return [dict(B=B, C=C, W=W, K=K) for B, C, W, K in
                ((512, 2000, 49, 10), (64, 2048, 49, 10), (1, 5, 1, 2), (97, 130, 5, 3))]
    if kernel == "fused_train":
        return [dict(B=B, C=C, W=W, L=L, K=K) for B, C, W, L, K in
                ((64, 2000, 49, 1568, 10), (13, 21, 2, 34, 3), (300, 40, 70, 2230, 4))]
    asset = port_compiler.CompiledTM.load(ASSET).include_words
    small = _bank(40, 3, 20, 0.05, 1)[1].include_words
    return [dict(B=512, K=10, include_words=asset), dict(B=97, K=3, include_words=small),
            dict(B=20, K=3, include_words=small)]


# -- held to the reference -------------------------------------------------------

@pytest.mark.parametrize("kernel", ["fused_infer", "fused_train", "sparse_infer",
                                    "term_infer"])
def test_basis_and_cache_keys_equal_reference(kernel):
    """Each tuner's basis on the port's candidates (all expressible in the
    reference's tuples) equals the reference's, and the sweep key equals
    the reference's with ``cpu:interp`` swapped for ``torch-cpu`` (and
    ``torch-cuda``) -- with a representative literal stream too."""
    pt, rt = port_at._REGISTRY[kernel], ref_at._REGISTRY[kernel]
    assert pt.block_names == rt.block_names
    for shape in _shapes(kernel):
        if kernel == "term_infer" and shape["B"] == 512:
            continue     # the asset's term schedules: held in the next test
        p, r = pt.prepare(**shape), rt.prepare(**shape)
        clipped = pt.clip(pt.default_candidates, p)
        assert len(clipped) >= 2
        for cand in clipped:
            assert pt.basis(p, cand) == rt.basis(r, cand), (kernel, cand)
        ref_mode = ref_at._mode_backend(True)
        assert ref_mode == "cpu:interp"
        for mode in ("torch-cpu", "torch-cuda"):
            assert pt.cache_key(p, clipped, mode) == \
                rt.cache_key(r, clipped, ref_mode).replace(ref_mode, mode)
        if "include_words" in shape:
            rng = np.random.default_rng(3)
            lw = rng.integers(0, 2 ** 32, (shape["B"], p["Wa"]), dtype=np.uint32)
            pl = pt.prepare(**shape, lit_words=torch.from_numpy(lw.view(np.int32)))
            rl = rt.prepare(**shape, lit_words=lw)
            assert pt.cache_key(pl, clipped, "torch-cpu") == \
                rt.cache_key(rl, clipped, ref_mode).replace(ref_mode, "torch-cpu")


def test_term_basis_on_the_committed_artifact_equals_reference():
    comp = port_compiler.CompiledTM.load(ASSET)
    pt, rt = port_at._REGISTRY["term_infer"], ref_at._REGISTRY["term_infer"]
    shape = dict(B=512, K=10, include_words=comp.include_words)
    p, r = pt.prepare(**shape), rt.prepare(**shape)
    clipped = pt.clip(pt.default_candidates, p)
    assert len(clipped) == 21                     # 7 tilings x 3 slabs
    for cand in clipped[::3]:                    # one slab a tiling: the builds
        assert pt.basis(p, cand) == rt.basis(r, cand), cand
    assert {c[3] for c in clipped} == {2, 4, 8}


def test_candidates_are_launches_the_kernels_make():
    dense = port_at.candidates_for("fused_infer", B=64, C=2048, W=49, K=10)
    assert dense == [fused_infer.blocks_for(s, 49) for s in (1, 2, 4)]
    train = port_at.candidates_for("fused_train", B=64, C=2000, W=49, L=1568, K=10)
    assert train == [fused_train.blocks_for(c, 64, 49) for c in (4, 2, 8)]
    iw = port_compiler.CompiledTM.load(ASSET).include_words
    sparse = port_at.candidates_for("sparse_infer", B=512, K=10, include_words=iw)
    # 8 tilings x 3 slabs, less the 3 where block_c 2048 and 4096 both clip to U
    assert len(sparse) == 21 and {c["block_s"] for c in sparse} == {2, 4, 8}
    # the reference's clip, with the slab clipped to the power of two that
    # covers the bucket's words (B 97: 4 words; B 20: 1)
    for B, top in ((97, 4), (20, 1)):
        got = port_at.candidates_for("sparse_infer", B=B, K=10, include_words=iw)
        assert max(c["block_s"] for c in got) == top
    with pytest.raises(ValueError, match="fused_infer launches"):
        port_at.candidates_for("fused_infer", candidates=((128, 128, 64),),
                               B=64, C=2048, W=49, K=10)
    with pytest.raises(ValueError, match="clauses a block"):
        port_at.candidates_for("fused_train", candidates=((0, 16, 0),),
                               B=64, C=2000, W=49, L=1568, K=10)


@pytest.mark.parametrize("bad", [3, 16, 0, -2])
def test_wrappers_refuse_launches_they_cannot_make(bad):
    with pytest.raises(ValueError, match="sample words a block"):
        sparse_infer.walk_words(bad)
    comp = port_compiler.CompiledTM.load(ASSET)
    x = port_pk.pack_literals(torch.zeros((4, 784), dtype=torch.uint8))
    for eng in ("sparse", "factorized"):
        with pytest.raises(ValueError, match="sample words a block"):
            port_compiler.run_compiled(comp, x, engine=eng, block_s=bad)
    with pytest.raises(ValueError, match="fused_infer launches"):
        fused_infer.word_split(49, block_c=128 + abs(bad))
    with pytest.raises(ValueError, match="clauses a block"):
        fused_train.clauses_a_block(64, 49, block_c=abs(bad) + 16)
    with pytest.raises(ValueError, match="launches block_b"):
        fused_train.clauses_a_block(64, 49, block_b=65, block_c=4)


def test_cache_schema_invalidation_and_foreign_caches(tune_env):
    path = tune_env / "port_tune.json"
    shape = dict(B=9, C=17, W=1, K=2)
    blocks = port_at.tune("fused_infer", device=CPU, policy="sweep", reps=1, **shape)
    raw = json.loads(path.read_text())
    assert raw["schema"] == ref_at._SCHEMA_VERSION == port_at._SCHEMA_VERSION
    (key,) = raw["entries"]
    assert key.startswith("fused_infer:v1:torch-cpu:B9:C17:W1:K2:cands[")
    for stale in ({"schema": 2, "entries": raw["entries"]}, raw["entries"], "{torn"):
        path.write_text(stale if isinstance(stale, str) else json.dumps(stale))
        assert port_at._load_cache() == {}
    # a reference sweep's cache at the port's path: its keys carry the
    # reference's mode, so nothing answers and the port times again
    ref_at.tune("fused_infer", interpret=True, policy="sweep", reps=1,
                candidates=((32, 64, 1), (32, 32, 1), (32, 16, 1)), **shape)
    shutil.copy(tune_env / "ref_tune.json", path)
    port_at._PROC_CACHE.clear()
    before = port_at.TIMING_RUNS
    assert port_at.tune("fused_infer", device=CPU, policy="sweep", reps=1,
                        **shape) == blocks or True
    assert port_at.TIMING_RUNS > before


# -- the policies on the CPU plain versions ---------------------------------------

def test_tune_rejects_unknown(tune_env):
    with pytest.raises(ValueError, match="unknown kernel"):
        port_at.tune("warp_drive", device=CPU, B=1, C=1, W=1, K=1)
    with pytest.raises(ValueError, match="unknown policy"):
        port_at.tune("fused_infer", device=CPU, policy="guess", B=1, C=1, W=1, K=1)
    assert port_at._mode_backend(CPU) == "torch-cpu"
    assert port_at._mode_backend(torch.device("cuda", 0)) == "torch-cuda"
    assert port_at._mode_backend("cuda") == "torch-cuda"


@pytest.mark.parametrize("kernel", ["fused_infer", "sparse_infer", "term_infer"])
def test_predict_makes_zero_timing_runs(tune_env, kernel):
    shape = _shapes(kernel)[1]
    before = port_at.TIMING_RUNS
    blocks = port_at.tune(kernel, device=CPU, policy="predict", **shape)
    ranked = port_at.rank_candidates(kernel, device=CPU, **shape)
    assert blocks == ranked[0][0]
    port_at._PROC_CACHE.clear()            # the on-disk entry answers too
    assert port_at.tune(kernel, device=CPU, policy="predict", **shape) == blocks
    assert port_at.TIMING_RUNS == before
    entries = port_at._load_cache()
    assert len(entries) == 1 and next(iter(entries)).endswith(":ppredict")
    assert port_cm.load_observations() == []


def test_verify_times_only_top_k(tune_env):
    shape = _shapes("sparse_infer")[1]
    reps, top_k = 2, 3
    n = len(port_at.candidates_for("sparse_infer", **shape))
    assert n > top_k
    before = port_at.TIMING_RUNS
    blocks = port_at.tune("sparse_infer", device=CPU, policy="verify", top_k=top_k,
                          reps=reps, **shape)
    assert port_at.TIMING_RUNS - before == top_k * (1 + reps)
    short = [b for b, _ in port_at.rank_candidates("sparse_infer", device=CPU,
                                                   **shape)[:top_k]]
    assert blocks in short
    rows = port_cm.load_observations()
    assert sorted(map(json.dumps, (r["blocks"] for r in rows))) == \
        sorted(map(json.dumps, short))
    (key,) = port_at._load_cache()
    assert ":pverify:top[" in key


@pytest.mark.parametrize("kernel", ["fused_infer", "fused_train", "sparse_infer",
                                    "term_infer"])
def test_sweep_feeds_sidecar_and_shares_legacy_key(tune_env, kernel):
    shape = _shapes(kernel)[1]
    n = len(port_at.candidates_for(kernel, **shape))
    before = port_at.TIMING_RUNS
    blocks = port_at.tune(kernel, device=CPU, policy="sweep", reps=1,
                          features={"schema": 1}, **shape)
    assert port_at.TIMING_RUNS - before == 2 * n
    rows = port_cm.load_observations()
    assert len(rows) == n and blocks in [r["blocks"] for r in rows]
    assert all(r["mode"] == "torch-cpu" and r["kernel"] == kernel
               and r["measured_us"] > 0 and r["features"] == {"schema": 1} for r in rows)
    legacy = dict(
        fused_infer=lambda: port_at.autotune_fused_blocks(
            shape["B"], shape["C"], shape["W"], shape["K"], device=CPU, reps=1),
        fused_train=lambda: port_at.autotune_fused_train_blocks(
            shape["B"], shape["C"], shape["W"], shape["L"], shape["K"], device=CPU),
        sparse_infer=lambda: port_at.autotune_sparse_infer_blocks(
            shape["B"], shape["K"], shape["include_words"], device=CPU),
        term_infer=lambda: port_at.autotune_term_infer_blocks(
            shape["B"], shape["K"], shape["include_words"], device=CPU))[kernel]
    port_at._PROC_CACHE.clear()
    before = port_at.TIMING_RUNS
    assert legacy() == blocks
    assert port_at.TIMING_RUNS == before


@pytest.mark.parametrize("which", ["sparse", "factorized"])
def test_plan_engine_picks_the_references_engine(tune_env, which):
    ref, port = _bank(24, 2, 4, 0.08, 0) if which == "sparse" else _shared_bank()
    before = port_at.TIMING_RUNS
    engine, blocks = port_at.plan_engine(port, 32, device=CPU)
    ref_engine, _ = ref_at.plan_engine(ref, 32, interpret=True)
    assert engine == ref_engine == which
    assert port_at.TIMING_RUNS == before
    kernel = "term_infer" if which == "factorized" else "sparse_infer"
    assert blocks in port_at.candidates_for(kernel, B=32, K=2,
                                            include_words=port.include_words)
    x = port_pk.pack_literals(torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (32, port.n_features), dtype=np.uint8)))
    want = port_compiler.run_compiled(port, x, engine="oracle")
    assert torch.equal(port_compiler.run_compiled(port, x, engine=engine, **blocks), want)


def test_artifact_loader_loads_through_the_zoo(tune_env):
    from repro_torch.runtime.zoo import ArtifactZoo, artifact_loader

    paths = {}
    for i, (ref, port) in enumerate((_bank(24, 2, 4, 0.08, 0), _shared_bank())):
        paths[f"t{i}"] = port.save(str(tune_env / f"t{i}.npz"))
    zoo = ArtifactZoo(artifact_loader(paths.__getitem__, batch=32, device="cpu"),
                      max_entries=1)
    before = port_at.TIMING_RUNS
    for tenant, engine in (("t0", "sparse"), ("t1", "factorized"), ("t0", "sparse")):
        with zoo.lease(tenant) as obj:
            assert obj["engine"] == engine
            comp = obj["compiled"]
            x = port_pk.pack_literals(torch.ones((32, comp.n_features), dtype=torch.uint8))
            assert torch.equal(
                port_compiler.run_compiled(comp, x, engine=engine, **obj["blocks"]),
                port_compiler.run_compiled(comp, x, engine="oracle"))
    assert port_at.TIMING_RUNS == before
    assert zoo.health()["evictions"] >= 1


# -- run_compiled takes the reference's block keys ---------------------------------

@pytest.mark.parametrize("engine, blocks", [
    ("dense", dict(block_b=32, block_c=32, block_w=1)),
    ("dense", dict(block_b=32, block_c=16, block_w=1)),
    ("sparse", dict(block_c=8, block_j=4, block_s=1)),
    ("factorized", dict(block_c=8, block_j=4, block_t=8, block_s=2, term_w=2)),
])
def test_run_compiled_takes_the_same_blocks_as_the_reference(engine, blocks):
    import jax.numpy as jnp

    from repro.core import packetizer as ref_pk

    ref, port = _bank(24, 3, 6, 0.1, 4)
    x = np.random.default_rng(5).integers(0, 2, (40, 24), dtype=np.uint8)
    want = np.asarray(ref_compiler.run_compiled(
        ref, ref_pk.pack_literals(jnp.asarray(x)), engine=engine, interpret=True, **blocks))
    got = port_compiler.run_compiled(port, port_pk.pack_literals(torch.from_numpy(x)),
                                     engine=engine, **blocks)
    np.testing.assert_array_equal(got.numpy(), want)
    if engine == "dense":     # a dense-only key pins the dense kernel under auto
        auto = port_compiler.run_compiled(port, port_pk.pack_literals(torch.from_numpy(x)),
                                          **blocks)
        np.testing.assert_array_equal(auto.numpy(), want)


# -- ops and the entry points -------------------------------------------------------

def test_ops_autotune_paths_equal_untuned(tune_env):
    from repro_torch.kernels import ops

    cfg = port_tm.TMConfig(n_features=19, n_classes=3, clauses_per_class=11)
    rng = np.random.default_rng(2)
    ta = torch.from_numpy(rng.integers(-30, 30, (cfg.n_clauses_total, cfg.n_literals),
                                       dtype=np.int8))
    x = torch.from_numpy(rng.integers(0, 2, (21, 19), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 3, 21, dtype=np.int32))
    for chunk in (None, 8):
        want = ops.tm_train_step_kernel(cfg, ta, x, y, 9, chunk)
        got = ops.tm_train_step_kernel(cfg, ta, x, y, 9, chunk, autotune=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    keys = sorted(k.split(":")[0] for k in port_at._load_cache())
    assert keys == ["fused_infer", "fused_infer", "fused_train", "fused_train"]
    lw = port_pk.pack_bits(port_tm.literals(x))
    iw = port_pk.pack_include_masks(ta)
    votes = port_tm.vote_matrix(cfg)
    assert torch.equal(ops.tm_forward_packed(lw, iw, votes, autotune=True),
                       ops.tm_forward_packed(lw, iw, votes))


def _run(argv, env):
    full = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env)
    full.pop("REPRO_FAULT_INJECT", None)
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=600)


def _env(tmp):
    return dict(REPRO_TORCH_AUTOTUNE_CACHE=str(tmp / "port_tune.json"),
                REPRO_TORCH_TUNE_DATA=str(tmp / "port_data.json"),
                REPRO_AUTOTUNE_CACHE=str(tmp / "ref_tune.json"),
                REPRO_TUNE_DATA=str(tmp / "ref_data.json"),
                JAX_PLATFORMS="cpu")


def _line(out, tag):
    lines = [l for l in out.splitlines() if l.startswith(tag)]
    assert lines, out
    return lines[0]


def test_reference_saved_tilings_are_never_recalled(tmp_path):
    """An artifact whose tuned entries the reference recorded (CPU
    interpret mode) re-tunes on the port, and the port's tiling rides
    beside the reference's in the re-saved file."""
    ref, _ = _bank(32, 3, 8, 0.15, 0)       # tm-tiny's shape
    key_rows = ref.n_unique
    ref.record_tuned("sparse_infer", 128, dict(block_c=8, block_j=4, block_s=1),
                     rows=key_rows, mode="cpu:interp")
    ref.record_tuned("term_infer", 128, dict(block_c=8, block_j=4, block_t=8,
                                             block_s=1, term_w=2),
                     rows=key_rows, mode="cpu:interp")
    path = ref.save(str(tmp_path / "ref_tuned.npz"))
    argv = ["-m", "repro_torch.launch.serve", "--arch", "tm-tiny", "--device", "cpu",
            "--requests", "300", "--bucket", "128", "--artifact", path,
            "--autotune", "--tune-policy", "sweep"]
    r = _run(argv, _env(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "artifact-recorded" not in r.stdout
    assert "autotuned" in r.stdout and "saved artifact" in r.stdout
    tuned = port_compiler.CompiledTM.load(path).tuned
    mine = [k for k in tuned if k.endswith(":torch-cpu")]
    assert len(mine) == 1 and len(tuned) == 3
    # the second cold start recalls the port's own tiling with no sweep
    r2 = _run(argv[:-1] + ["predict"], _env(tmp_path))
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "artifact-recorded" in r2.stdout and "autotuned" not in r2.stdout
