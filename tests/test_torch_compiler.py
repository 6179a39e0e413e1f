"""Port parity: the host compiler, schedules, margins and the artifact
envelope against the JAX reference, exact (tolerance 0).  Artifacts move
between the packages in both directions, and the port rejects the same
bad files the reference rejects."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro_torch.core import compiler as port_compiler  # noqa: E402
from repro_torch.core import tm as port_tm  # noqa: E402
from repro_torch.runtime import faults as port_faults  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "src", "repro_torch", "assets", "tm_mnist_e1.npz")


def _random_tm(n_features, n_classes, cpc, include_density, seed):
    """The reference tests' random automata bank (tests/test_sparse_infer.py)."""
    rng = np.random.default_rng(seed)
    C = n_classes * cpc
    ta = np.where(
        rng.random((C, 2 * n_features)) < include_density,
        rng.integers(0, 127, (C, 2 * n_features)),
        rng.integers(-128, 0, (C, 2 * n_features)),
    ).astype(np.int8)
    kw = dict(n_features=n_features, n_classes=n_classes, clauses_per_class=cpc)
    return ref_tm.TMConfig(**kw), port_tm.TMConfig(**kw), ta


def _assert_schedules_equal(a, b):
    for f in ("block_c", "block_j", "n_rows", "n_lit_bits"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("chain_ids", "tile_cb", "tile_jb", "tile_first", "tile_last",
              "counts", "indptr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _assert_fschedules_equal(a, b):
    for f in ("block_c", "block_j", "block_t", "term_w", "n_rows", "n_terms",
              "n_lit_bits"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("term_word", "term_val", "term_chain", "clause_chain", "tile_stage",
              "tile_tb", "tile_cb", "tile_jb", "tile_first", "tile_last",
              "counts", "indptr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _assert_artifacts_equal(a, b):
    np.testing.assert_array_equal(a.include_words, b.include_words)
    np.testing.assert_array_equal(a.word_ids, b.word_ids)
    np.testing.assert_array_equal(a.votes, b.votes)
    assert (a.n_features, a.n_classes) == (b.n_features, b.n_classes)
    assert a.stats.as_dict() == b.stats.as_dict()
    _assert_schedules_equal(a.default_schedule, b.default_schedule)
    _assert_fschedules_equal(a.default_factorized_schedule,
                             b.default_factorized_schedule)
    np.testing.assert_array_equal(a.tile_margins(), b.tile_margins())
    np.testing.assert_array_equal(a.factorized_tile_margins(),
                                  b.factorized_tile_margins())
    for eng in ("sparse", "factorized"):
        if eng == "factorized" and b.default_factorized_schedule.n_tiles <= 1:
            # all-empty bank: the reference's quality_prefixes indexes past
            # its one-tile table (ROADMAP queue 3); the port clamps
            assert [q["bound"] for q in b.quality_levels(eng)] == [0] * 4
            continue
        assert a.quality_levels(eng) == b.quality_levels(eng)


@pytest.mark.parametrize("case", [
    dict(n_features=24, n_classes=3, cpc=6, density=0.12, seed=0, dedup=True),
    dict(n_features=48, n_classes=4, cpc=16, density=0.05, seed=1, dedup=False),
    dict(n_features=70, n_classes=5, cpc=12, density=0.25, seed=2, dedup=True),
    dict(n_features=16, n_classes=2, cpc=4, density=0.0, seed=3, dedup=True),
])
def test_compile_tm_identical(case):
    rcfg, pcfg, ta = _random_tm(case["n_features"], case["n_classes"],
                                case["cpc"], case["density"], case["seed"])
    a = ref_compiler.compile_tm(rcfg, ta, dedup=case["dedup"])
    b = port_compiler.compile_tm(pcfg, ta, dedup=case["dedup"])
    _assert_artifacts_equal(a, b)
    for level in (1, 3):
        for eng in ("sparse", "factorized"):
            if eng == "factorized" and b.default_factorized_schedule.n_tiles <= 1:
                continue
            pa = a.quality_prefix_schedule(level, eng)
            pb = b.quality_prefix_schedule(level, eng)
            (_assert_fschedules_equal if eng == "factorized"
             else _assert_schedules_equal)(pa, pb)


def test_nondefault_tilings_identical():
    rcfg, pcfg, ta = _random_tm(40, 3, 20, 0.1, 7)
    a = ref_compiler.compile_tm(rcfg, ta)
    b = port_compiler.compile_tm(pcfg, ta)
    _assert_schedules_equal(a.schedule(block_c=16, block_j=8),
                            b.schedule(block_c=16, block_j=8))
    _assert_fschedules_equal(
        a.factorized_schedule(block_c=8, block_j=4, block_t=16, term_w=2),
        b.factorized_schedule(block_c=8, block_j=4, block_t=16, term_w=2))


def test_asset_loads_identically_in_both_packages():
    a = ref_compiler.CompiledTM.load(ASSET)
    b = port_compiler.CompiledTM.load(ASSET)
    _assert_artifacts_equal(a, b)
    st = b.stats
    assert (st.n_clauses_unique, st.n_words_active, st.n_includes) == (2000, 49, 89724)
    assert st.partial_term_sharing >= port_compiler.FACTORIZE_SHARING_THRESHOLD


def test_port_saved_artifact_loads_in_reference(tmp_path):
    rcfg, pcfg, ta = _random_tm(32, 3, 8, 0.1, 11)
    b = port_compiler.compile_tm(pcfg, ta)
    b.record_tuned("term_infer", 128, dict(block_c=8))
    path = b.save(str(tmp_path / "port"))
    assert path.endswith(".npz")
    a = ref_compiler.CompiledTM.load(path)
    _assert_artifacts_equal(a, b)
    _assert_artifacts_equal(a, port_compiler.CompiledTM.load(path))
    # the same bank saved by each package: identical arrays, and identical
    # meta but for the cost-model features the port does not compute yet
    paths = (ref_compiler.compile_tm(rcfg, ta).save(str(tmp_path / "ref.npz")),
             port_compiler.compile_tm(pcfg, ta).save(str(tmp_path / "port2.npz")))
    z = [np.load(p) for p in paths]
    assert sorted(z[0].files) == sorted(z[1].files)
    for k in z[0].files:
        if k != "meta":
            np.testing.assert_array_equal(z[0][k], z[1][k], err_msg=k)
    meta = [json.loads(bytes(zz["meta"]).decode()) for zz in z]
    for m in meta:
        m.pop("checksum")
        m.pop("features")
    assert meta[0] == meta[1]


def test_tuned_keys_carry_port_mode():
    _, pcfg, ta = _random_tm(16, 2, 4, 0.1, 5)
    b = port_compiler.compile_tm(pcfg, ta)
    b.tuned["sparse_infer:B512:tpu:compiled"] = dict(block_c=64)
    assert b.tuned_blocks("sparse_infer", 512, mode="tpu:compiled") is None
    b.record_tuned("sparse_infer", 512, dict(block_c=32))
    assert b.tuned_blocks("sparse_infer", 512) == dict(block_c=32)
    assert "sparse_infer:B512:torch-cuda" in b.tuned


# -- the reference's bad-file drills (tests/test_fault_tolerance.py) ---------

@pytest.fixture(scope="module")
def tiny_artifact():
    rcfg, _, ta = _random_tm(32, 3, 8, 0.1, 0)
    return ref_compiler.compile_tm(rcfg, ta)


def _rewrite(path, mutate, fix_checksum=True):
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    arrays = {k: np.array(z[k]) for k in z.files if k != "meta"}
    mutate(arrays, meta)
    if fix_checksum:
        meta.pop("checksum", None)
        meta["checksum"] = ref_compiler._artifact_checksum(arrays, meta)
    with open(path, "wb") as f:
        np.savez_compressed(
            f, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)


def _truncate(path):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])


def _poison_chain(path):
    def poison(arrays, meta):
        bad = np.array(arrays["sched_chain_ids"])
        bad[0, 0] = meta["schedule"]["n_lit_bits"] + 7
        arrays["sched_chain_ids"] = bad
    _rewrite(path, poison)


def _flip_votes(path):
    def flip(arrays, meta):
        arrays["votes"] = arrays["votes"] + 1
    _rewrite(path, flip, fix_checksum=False)


def _unsort_words(path):
    def unsort(arrays, meta):
        arrays["word_ids"] = np.ascontiguousarray(arrays["word_ids"][::-1])
    _rewrite(path, unsort)


@pytest.mark.parametrize("corrupt, match", [
    (_truncate, "unreadable"),
    (lambda p: _rewrite(p, lambda arrays, meta: meta.update(schema=0)),
     "schema version 0"),
    (_flip_votes, "checksum"),
    (_poison_chain, "chain ids out of range"),
    (_unsort_words, "word_ids"),
])
def test_port_rejects_what_reference_rejects(tiny_artifact, tmp_path, corrupt, match):
    assert tiny_artifact.word_ids.shape[0] >= 2
    path = tiny_artifact.save(str(tmp_path / "art.npz"))
    corrupt(path)
    with pytest.raises(ref_compiler.ArtifactError, match=match):
        ref_compiler.CompiledTM.load(path)
    with pytest.raises(port_compiler.ArtifactError, match=match):
        port_compiler.CompiledTM.load(path)


def test_port_bitflip_and_margin_drills(tiny_artifact, tmp_path):
    b = port_compiler.CompiledTM.load(tiny_artifact.save(str(tmp_path / "a.npz")))
    with port_faults.injected("artifact.bitflip"):
        path = b.save(str(tmp_path / "flipped.npz"))
    with pytest.raises(port_compiler.ArtifactError):
        port_compiler.CompiledTM.load(path)
    with pytest.raises(ref_compiler.ArtifactError):
        ref_compiler.CompiledTM.load(path)
    good = b.save(str(tmp_path / "good.npz"))
    with port_faults.injected("anytime.margin_corrupt"):
        with pytest.raises(port_compiler.ArtifactError, match="margin"):
            port_compiler.CompiledTM.load(good)
    port_compiler.CompiledTM.load(good)
