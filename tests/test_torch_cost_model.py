"""Port parity: the cost model (``repro_torch.kernels.cost_model``) held to
``repro.kernels.cost_model`` at tolerance 0 -- workload features without
the HLO terms, the ridge refit, the ranking and the predictions on the same
observation rows -- and the port's own sidecar: round trip, cap, corrupt
and stale files, and isolation from the reference's."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.core import compiler as ref_compiler
from repro.core import tm as ref_tm
from repro.kernels import cost_model as ref_cm
from repro_torch.core import compiler as port_compiler
from repro_torch.core import tm as port_tm
from repro_torch.kernels import cost_model as port_cm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "src", "repro_torch", "assets", "tm_mnist_e1.npz")

# the terms the reference reads from its compiled HLO and the port from the
# op stream on ``meta`` (``launch/op_analysis``)
HLO_KEYS = ("hlo_flops_per_sample", "hlo_bytes_per_sample", "xla_flops_per_sample",
            "roofline_t_comp", "roofline_t_mem")


@pytest.fixture()
def tune_env(tmp_path, monkeypatch):
    """Both packages' caches and sidecars in a fresh directory."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port_tune.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_DATA", str(tmp_path / "port_data.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref_tune.json"))
    monkeypatch.setenv("REPRO_TUNE_DATA", str(tmp_path / "ref_data.json"))
    port_cm._invalidate_model_cache()
    ref_cm._invalidate_model_cache()
    yield tmp_path
    port_cm._invalidate_model_cache()
    ref_cm._invalidate_model_cache()


def _tiny_pair(seed=0, density=0.1):
    """The same tm-tiny-shaped bank compiled by each package."""
    kw = dict(n_features=12, n_classes=3, clauses_per_class=8)
    rng = np.random.default_rng(seed)
    C, L = 24, 24
    ta = np.where(rng.random((C, L)) < density, rng.integers(0, 127, (C, L)),
                  rng.integers(-128, 0, (C, L))).astype(np.int8)
    return (ref_compiler.compile_tm(ref_tm.TMConfig(**kw), ta),
            port_compiler.compile_tm(port_tm.TMConfig(**kw), torch.from_numpy(ta)))


def _pair(which):
    if which == "asset":
        return ref_compiler.CompiledTM.load(ASSET), port_compiler.CompiledTM.load(ASSET)
    return _tiny_pair(*dict(tiny=(0, 0.1), tiny_dense=(3, 0.4))[which])


# -- features ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "tiny_dense", "asset"])
def test_artifact_features_equal_reference_fallback(which):
    ref, port = _pair(which)
    want = ref_cm.artifact_features(ref, with_hlo=False)
    got = port_cm.artifact_features(port, with_hlo=False)
    assert got == want
    assert json.loads(json.dumps(got)) == got          # JSON-serializable as is
    # with_hlo (the default) adds the five op-stream terms, positive, the
    # FLOPs a sample at least the class-sum product's 2 U K
    full = port_cm.artifact_features(port)
    assert set(full) == set(want) | set(HLO_KEYS)
    assert {k: v for k, v in full.items() if k not in HLO_KEYS} == want
    assert all(full[k] > 0 for k in HLO_KEYS), {k: full[k] for k in HLO_KEYS}
    U, K = got["n_rows"], got["n_classes"]
    assert full["hlo_flops_per_sample"] >= 2 * U * K
    assert json.loads(json.dumps(full)) == full


def test_extract_features_persist_through_save_and_load(tmp_path):
    ref, port = _tiny_pair(1)
    feats = port.extract_features()
    assert set(HLO_KEYS) <= set(feats)
    base = {k: v for k, v in feats.items() if k not in HLO_KEYS}
    assert base == ref_cm.artifact_features(ref, with_hlo=False)
    path = port.save(str(tmp_path / "port.npz"))
    for pkg in (port_compiler, ref_compiler):          # both packages load it
        assert pkg.CompiledTM.load(path).features == feats
    # a reference-saved artifact's features (HLO terms included) load
    # untouched, and its fallback part is the port's
    rpath = ref.save(str(tmp_path / "ref.npz"))
    loaded = port_compiler.CompiledTM.load(rpath).features
    assert set(HLO_KEYS) <= set(loaded)
    assert {k: v for k, v in loaded.items() if k not in HLO_KEYS} == base


# -- the model -----------------------------------------------------------------

_BASIS_TERMS = dict(
    fused_infer=("steps", "work_melem", "fold_melem", "bytes_mb"),
    fused_train=("steps", "work_melem", "l_work_melem", "bytes_mb"),
    sparse_infer=("steps", "chain_melem", "fold_melem", "bytes_mb"),
    term_infer=("steps", "term_melem", "chain_melem", "fold_melem", "bytes_mb"),
)


def _rows(kernel, n, seed):
    """(reference rows, port rows): the same numpy-made observations, each
    under its package's CPU mode tag."""
    rng = np.random.default_rng(seed)
    terms = _BASIS_TERMS[kernel]
    theta = rng.random(len(terms)) * 50
    out = ([], [])
    for i in range(n):
        basis = {t: float(rng.random() * 10 ** rng.integers(0, 3)) for t in terms}
        us = float(20 + sum(th * basis[t] for th, t in zip(theta, terms))
                   + rng.normal() * 3)
        blocks = dict(block_c=int(rng.integers(1, 9)))
        out[0].append(ref_cm.make_observation(kernel, "cpu:interp", blocks, basis, us))
        out[1].append(port_cm.make_observation(kernel, "torch-cpu", blocks, basis, us))
    return out


@pytest.mark.parametrize("kernel", list(_BASIS_TERMS))
@pytest.mark.parametrize("n,ridge", [(8, 1e-3), (40, 1e-3), (40, 1e-6)])
def test_fit_rank_predict_equal_reference(kernel, n, ridge):
    ref_rows, port_rows = _rows(kernel, n, n + len(kernel))
    ref_m = ref_cm.CostModel().fit(ref_rows, "cpu:interp", ridge=ridge)
    port_m = port_cm.CostModel().fit(port_rows, "torch-cpu", ridge=ridge)
    assert port_m.coeffs == ref_m.coeffs
    assert port_m.coeffs[kernel] != port_cm.DEFAULT_COEFFS["torch-cpu"][kernel]
    items = [((int(r["blocks"]["block_c"]), i), r["basis"])
             for i, r in enumerate(port_rows)]
    assert port_m.rank(kernel, items) == ref_m.rank(kernel, items)
    for _, basis in items:
        assert port_m.predict_us(kernel, basis) == ref_m.predict_us(kernel, basis)
    # an unregistered kernel ranks by grid steps in both
    assert (port_m.predict_us("other", items[0][1])
            == ref_m.predict_us("other", items[0][1]))


def test_fit_ignores_other_modes_small_samples_and_clips_negatives():
    base = port_cm.CostModel()
    _, rows = _rows("fused_infer", 50, 7)
    cuda_rows = [dict(r, mode="torch-cuda") for r in rows]
    assert base.fit(cuda_rows, "torch-cpu").coeffs == base.coeffs
    assert base.fit(rows[:port_cm.MIN_FIT_ROWS - 1], "torch-cpu").coeffs == base.coeffs
    adversarial = [port_cm.make_observation(
        "fused_infer", "torch-cpu", {}, {"steps": float(i), "work_melem": 2.0 * i},
        1000.0 - i) for i in range(1, 20)]
    ref_adv = [dict(r, mode="cpu:interp") for r in adversarial]
    got = base.fit(adversarial, "torch-cpu").coeffs
    assert got == ref_cm.CostModel().fit(ref_adv, "cpu:interp").coeffs
    assert all(v >= 0.0 for v in got["fused_infer"].values())


def test_defaults_per_mode(tune_env):
    assert port_cm.DEFAULT_COEFFS["torch-cpu"] == ref_cm.DEFAULT_COEFFS
    assert port_cm.CostModel().coeffs == ref_cm.DEFAULT_COEFFS
    assert set(port_cm.DEFAULT_COEFFS["torch-cuda"]) == set(ref_cm.DEFAULT_COEFFS)
    for mode in ("torch-cpu", "torch-cuda"):
        assert port_cm.get_model(mode).coeffs == port_cm.DEFAULT_COEFFS[mode]
    _, rows = _rows("sparse_infer", 30, 2)
    port_cm.record_observations(rows)                   # invalidates the memo
    refit = port_cm.get_model("torch-cpu")
    assert refit.coeffs["sparse_infer"] != port_cm.DEFAULT_COEFFS["torch-cpu"]["sparse_infer"]
    # CPU rows never train the card's model
    assert port_cm.get_model("torch-cuda").coeffs == port_cm.DEFAULT_COEFFS["torch-cuda"]


# -- the sidecar -----------------------------------------------------------------

def test_sidecar_roundtrip_and_cap(tune_env):
    _, rows = _rows("fused_infer", 10, 0)
    port_cm.record_observations(rows)
    back = port_cm.load_observations()
    assert back == json.loads(json.dumps(rows))
    assert port_cm.data_path() == str(tune_env / "port_data.json")
    flood = [port_cm.make_observation("fused_infer", "torch-cpu", {"block_b": 8},
                                      {"steps": 1.0}, float(i))
             for i in range(port_cm._MAX_OBSERVATIONS + 50)]
    port_cm.record_observations(flood)
    kept = port_cm.load_observations()
    assert len(kept) == port_cm._MAX_OBSERVATIONS
    assert kept[-1]["measured_us"] == float(port_cm._MAX_OBSERVATIONS + 49)   # FIFO
    assert sorted(p.name for p in tune_env.iterdir()) == ["port_data.json"]


@pytest.mark.parametrize("content", ["{torn write", '{"schema": 0, "observations": []}',
                                     '[1, 2]', '{"schema": 1, "observations": 5}'])
def test_sidecar_corrupt_or_stale_file_reads_empty(tune_env, content):
    (tune_env / "port_data.json").write_text(content)
    assert port_cm.load_observations() == []
    port_cm.record_observations([port_cm.make_observation(
        "fused_infer", "torch-cpu", {}, {"steps": 1.0}, 5.0)])
    assert len(port_cm.load_observations()) == 1


def test_sidecars_never_read_each_other(tune_env):
    ref_rows, port_rows = _rows("term_infer", 12, 5)
    ref_cm.record_observations(ref_rows)
    assert port_cm.load_observations() == []
    port_cm.record_observations(port_rows)
    assert len(ref_cm.load_observations()) == 12
    assert all(r["mode"] == "torch-cpu" for r in port_cm.load_observations())
    assert port_cm.data_path() != ref_cm.data_path()


def test_default_paths_are_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_DATA", raising=False)
    monkeypatch.delenv("REPRO_TUNE_DATA", raising=False)
    assert port_cm.data_path().endswith(os.path.join(".cache", "repro_torch",
                                                     "tune_data.json"))
    assert port_cm.data_path() != ref_cm.data_path()
