"""Port: engine ladder drills, the serve loop on the CPU, device handling,
and the package's isolation from JAX and from the reference package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from repro_torch.kernels import ops
from repro_torch.runtime import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("REPRO_FAULT_INJECT", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _health(r, tag):
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [l for l in r.stdout.splitlines() if l.startswith(tag + " ")]
    assert lines, r.stdout + r.stderr
    return json.loads(lines[0][len(tag) + 1:])


def test_isolation_no_jax_no_reference():
    """Every port module imports without loading jax or any repro module."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))
assert not bad, bad
print(len(names), 'modules')
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 18


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import device

    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve("cuda")
    assert device.resolve("cpu").type == "cpu"


def _kernel_builders(log):
    def make(name, site):
        def build():
            def f(x, quality=0):
                faults.raise_if(site)
                log.append(name)
                return x + 1
            f.supports_quality = True
            return f
        return build
    return [("factorized", make("factorized", "kernel.factorized")),
            ("sparse", make("sparse", "kernel.sparse")),
            ("dense", make("dense", "kernel.dense")),
            ("oracle", lambda: (lambda x: x + 1))]


def test_ladder_demotes_under_env_faults_and_repromotes(monkeypatch):
    log = []
    lad = ops.EngineLadder(_kernel_builders(log), promote_after=2)
    # the reference grammar, read from the environment on every probe
    monkeypatch.setenv(faults.ENV_VAR, "kernel.factorized*2,kernel.sparse*1")
    assert lad.run(lambda: np.int64(0), bucket=0) == 1     # factorized, sparse fail
    assert lad.engine == "dense"
    assert [d["frm"] for d in lad.demotions] == ["factorized", "sparse"]
    assert lad.run(lambda: np.int64(0), bucket=1) == 1     # streak 2
    assert lad.run(lambda: np.int64(0), bucket=2) == 1     # probe sparse: promoted
    assert lad.engine == "sparse" and lad.promotions[0]["to"] == "sparse"
    lad.run(lambda: np.int64(0), bucket=3)
    lad.run(lambda: np.int64(0), bucket=4)                 # streak 2 on sparse
    lad.run(lambda: np.int64(0), bucket=5)                 # probe factorized fails
    assert lad.engine == "sparse" and len(lad.probe_failures) == 1
    assert lad.probe_failures[0]["engine"] == "factorized"
    assert lad._cooldown == 4                              # doubled
    for b in range(6, 10):                                 # fault exhausted
        lad.run(lambda: np.int64(0), bucket=b)
    assert lad.engine == "factorized"
    assert sum(lad.counts.values()) == 10                  # every bucket served


def test_ladder_syncs_and_demotes_on_cpu_tensors():
    def bad():
        def f(x):
            raise RuntimeError("launch failed")
        return f

    lad = ops.EngineLadder([("sparse", bad), ("oracle", lambda: (lambda x: x * 2))])
    out = lad.run(lambda: torch.ones(3, dtype=torch.int32), bucket=0)
    assert out.tolist() == [2, 2, 2] and lad.engine == "oracle"


def test_ladder_lets_kernel_build_errors_through(monkeypatch, tmp_path):
    """Kernels that cannot be built are missing, not failing: the ladder
    raises instead of serving from the plain rungs, at its level and from
    a probe."""
    from repro_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()

    def missing():
        def f(x):
            raise _build.KernelBuildError("nvcc not found")
        return f

    lad = ops.EngineLadder([("sparse", missing), ("oracle", lambda: (lambda x: x))])
    with pytest.raises(_build.KernelBuildError):
        lad.run(lambda: torch.ones(2), bucket=0)
    assert lad.engine == "sparse" and lad.demotions == []

    calls = []

    def flaky_then_missing():
        def f(x):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("launch failed")
            raise _build.KernelBuildError("nvcc not found")
        return f

    lad = ops.EngineLadder([("sparse", flaky_then_missing),
                            ("oracle", lambda: (lambda x: x))], promote_after=1)
    lad.run(lambda: torch.ones(2), bucket=0)        # demotes, oracle serves
    assert lad.engine == "oracle"
    with pytest.raises(_build.KernelBuildError):
        lad.run(lambda: torch.ones(2), bucket=1)    # the probe up
    assert lad.probe_failures == []


@pytest.fixture(scope="module")
def tiny_artifact(tmp_path_factory):
    """A tm-tiny artifact compiled (and saved) by the port."""
    from repro_torch.configs.matador_tm import TM_CONFIGS
    from repro_torch.core import compiler

    cfg = TM_CONFIGS["tm-tiny"]
    rng = np.random.default_rng(0)
    ta = np.where(rng.random((cfg.n_clauses_total, cfg.n_literals)) < 0.08,
                  rng.integers(0, 127, (cfg.n_clauses_total, cfg.n_literals)),
                  rng.integers(-128, 0, (cfg.n_clauses_total, cfg.n_literals))
                  ).astype(np.int8)
    return compiler.compile_tm(cfg, ta).save(
        str(tmp_path_factory.mktemp("art") / "tiny.npz"))


SERVE = ["-m", "repro_torch.launch.serve", "--arch", "tm-tiny",
         "--device", "cpu", "--requests", "640", "--bucket", "128"]


def test_serve_cpu_health_schema_matches_reference(tiny_artifact):
    pytest.importorskip("jax")
    r = _run(SERVE + ["--artifact", tiny_artifact, "--factorize", "--early-exit"])
    h, g = _health(r, "SERVE_HEALTH"), _health(r, "GATEWAY_HEALTH")
    assert h["final_engine"] == "factorized" and h["demotions"] == []
    assert h["engine_buckets"]["factorized"] == h["buckets"] == 5
    assert g["unaccounted"] == 0 and g["answered"] == 640
    ref = _run(["-m", "repro.launch.serve", "--arch", "tm-tiny", "--requests", "640",
                "--bucket", "128", "--artifact", tiny_artifact],
               env_extra={"JAX_PLATFORMS": "cpu"})
    rh, rg = _health(ref, "SERVE_HEALTH"), _health(ref, "GATEWAY_HEALTH")
    assert sorted(h) == sorted(rh)
    assert sorted(g) == sorted(rg)


def test_serve_cpu_ladder_drill(tiny_artifact):
    r = _run(SERVE + ["--artifact", tiny_artifact, "--factorize",
                      "--promote-after", "2"],
             env_extra={"REPRO_FAULT_INJECT": "kernel.factorized*2,kernel.sparse*1"})
    h = _health(r, "SERVE_HEALTH")
    assert h["ladder"] == ["factorized", "sparse", "dense", "oracle"]
    assert [d["frm"] for d in h["demotions"]] == ["factorized", "sparse"]
    assert h["promotions"] and h["promotions"][0]["to"] == "sparse"
    assert sum(h["engine_buckets"].values()) == h["buckets"]


@pytest.mark.parametrize("extra, message", [
    ([], "later slice"),
    (["--mesh", "model=2"], "later slice"),
    (["--autotune"], "later slice"),
    (["--zoo", "2"], "later slice"),
    (["--online"], "later slice"),
])
def test_serve_refuses_what_later_slices_bring(tiny_artifact, extra, message):
    from repro_torch.launch import serve

    argv = SERVE[2:] + (["--artifact", tiny_artifact] if extra else []) + extra
    with pytest.raises(SystemExit, match=message):
        serve.main(argv)


def test_serve_refuses_corrupt_artifact(tiny_artifact, tmp_path):
    from repro_torch.launch import serve

    bad = tmp_path / "bad.npz"
    bad.write_bytes(open(tiny_artifact, "rb").read()[:100])
    with pytest.raises(SystemExit, match="refusing to serve"):
        serve.main(SERVE[2:] + ["--artifact", str(bad)])


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run([os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0 and '"ok"' not in r.stdout
