"""Port: checkpoints, the loader and resume, against the reference.

The on-disk layout is shared, so a checkpoint written by either package
restores in the other; ``fit`` and ``launch.train`` resume bit for bit
after a SIGTERM, and a reference checkpoint resumes in the port.
"""

import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as r_store
from repro.data.loader import ShardedBatcher as RBatcher
from repro_torch.checkpoint import store as t_store
from repro_torch.data.loader import ShardedBatcher as TBatcher
from repro_torch.runtime import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_layout_and_cross_package_restore(tmp_path):
    ta = np.random.default_rng(0).integers(-128, 128, (6, 10), dtype=np.int8)
    rng_state = np.arange(16, dtype=np.uint8)
    path = t_store.save_checkpoint(str(tmp_path / "t"), 5,
                                   {"ta": torch.from_numpy(ta), "rng": rng_state},
                                   extra={"step": 5, "loader": {"epoch": 1}})
    assert os.path.basename(path) == "step_0000000005"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 5 and man["n_arrays"] == 2
    assert man["extra"] == {"step": 5, "loader": {"epoch": 1}}
    tree, extra = r_store.load_checkpoint(
        str(tmp_path / "t"), {"ta": jnp.zeros((6, 10), jnp.int8),
                              "rng": jnp.zeros(16, jnp.uint8)})
    np.testing.assert_array_equal(np.asarray(tree["ta"]), ta)
    np.testing.assert_array_equal(np.asarray(tree["rng"]), rng_state)
    assert extra["loader"] == {"epoch": 1}

    r_store.save_checkpoint(str(tmp_path / "r"), 7, {"ta": jnp.asarray(ta)},
                            extra={"step": 7})
    like = torch.zeros((6, 10), dtype=torch.int8)
    got, extra = t_store.load_checkpoint(str(tmp_path / "r"), {"ta": like})
    assert got["ta"].dtype == torch.int8 and got["ta"].device == like.device
    np.testing.assert_array_equal(got["ta"].numpy(), ta)
    assert extra == {"step": 7}
    assert t_store.latest_step(str(tmp_path / "r")) == 7
    with pytest.raises(FileNotFoundError):
        t_store.load_checkpoint(str(tmp_path / "none"), {"ta": like})
    # a key is the reference's "/"-joined leaf path: {"a/b": x} restores
    # into the reference's {"a": {"b": ...}} tree
    t_store.save_checkpoint(str(tmp_path / "p"), 6, {"a/b": ta})
    tree, _ = r_store.load_checkpoint(str(tmp_path / "p"),
                                      {"a": {"b": jnp.zeros((6, 10), jnp.int8)}})
    np.testing.assert_array_equal(np.asarray(tree["a"]["b"]), ta)
    with pytest.raises(ValueError, match="strings"):
        t_store.save_checkpoint(str(tmp_path / "t"), 6, {1: ta})


def test_async_write_failure_surfaces_and_blocking_raises(tmp_path):
    mgr = t_store.CheckpointManager(str(tmp_path))
    with faults.injected("ckpt.write_fail"):
        mgr.save(1, {"ta": np.zeros(3, np.int8)}, blocking=False)
        with pytest.raises(faults.InjectedFault):
            mgr.wait()
        with pytest.raises(faults.InjectedFault):
            mgr.save(2, {"ta": np.zeros(3, np.int8)}, blocking=True)
    mgr.wait()                                  # the error was consumed once
    assert mgr.latest_step() is None
    mgr.save(3, {"ta": np.zeros(3, np.int8)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 3


def test_tmp_cleanup_malformed_names_and_retention(tmp_path):
    d = tmp_path / "ck"
    (d / "step_0000000004.tmp").mkdir(parents=True)
    (d / "step_junk").mkdir()
    (d / "step_").write_text("")
    mgr = t_store.CheckpointManager(str(d), max_to_keep=2)
    assert not (d / "step_0000000004.tmp").exists()
    assert mgr.latest_step() is None
    for s in (1, 2, 3, 4):
        mgr.save(s, {"ta": torch.full((2,), s, dtype=torch.int8)})
    kept = sorted(p.name for p in d.iterdir() if p.name.startswith("step_0"))
    assert kept == ["step_0000000003", "step_0000000004"]
    got, _ = mgr.restore({"ta": torch.zeros(2, dtype=torch.int8)}, step=3)
    assert got["ta"].tolist() == [3, 3]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_copy_matches_reference(prefetch):
    X = np.arange(103 * 3).reshape(103, 3)
    y = np.arange(103)
    r, t = (B((X, y), 16, seed=5, prefetch=prefetch) for B in (RBatcher, TBatcher))
    ri, ti = iter(r), iter(t)
    for _ in range(9):                          # crosses an epoch boundary
        for a, b in zip(next(ri), next(ti)):
            np.testing.assert_array_equal(a, b)
        assert r.state_dict() == t.state_dict()
    t2 = TBatcher((X, y), 16, seed=5, prefetch=prefetch)
    t2.load_state_dict(r.state_dict())
    for a, b in zip(next(iter(t2)), next(ri)):
        np.testing.assert_array_equal(a, b)


def _run(argv, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("REPRO_FAULT_INJECT", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


_FIT_CODE = """
import numpy as np, torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import prng, tm, train
from repro_torch.data.synthetic import make_boolean_classification
from repro_torch.runtime.preemption import PreemptionHandler
from repro_torch.runtime.straggler import StragglerMonitor

config = tm.TMConfig(n_features=32, n_classes=3, clauses_per_class=8)
X, y = make_boolean_classification(256, 32, 3, seed=0)
state = tm.init(config, prng.PRNGKey(0), "cpu")
state = train.fit(config, state, torch.from_numpy(X), torch.from_numpy(y),
                  epochs=3, batch_size=32, rng=prng.PRNGKey(1),
                  ckpt_manager=CheckpointManager({ckpt!r}), ckpt_every=2,
                  preemption=PreemptionHandler().install(),
                  monitor=StragglerMonitor())
np.save({out!r}, state.ta_state.numpy())
"""


def test_fit_sigterm_exits_resume_code_and_resumes_bit_exact():
    from repro_torch.runtime.preemption import RESUME_EXIT_CODE

    with tempfile.TemporaryDirectory() as d:
        ref_out = os.path.join(d, "ref.npy")
        r = _run(["-c", _FIT_CODE.format(ckpt=os.path.join(d, "ck_ref"), out=ref_out)])
        assert r.returncode == 0, r.stdout + r.stderr
        ck, out = os.path.join(d, "ck"), os.path.join(d, "out.npy")
        code = _FIT_CODE.format(ckpt=ck, out=out)
        # SIGTERM mid-epoch 1 (global step 10 of 24): checkpoint, exit 42
        r = _run(["-c", code], env_extra={"REPRO_FAULT_INJECT": "train.sigterm@9"})
        assert r.returncode == RESUME_EXIT_CODE, r.stdout + r.stderr
        assert not os.path.exists(out)
        r = _run(["-c", code])
        assert r.returncode == 0, r.stdout + r.stderr
        assert "fit: resumed at epoch 1" in r.stdout
        np.testing.assert_array_equal(np.load(ref_out), np.load(out))


def test_reference_checkpoint_resumes_in_the_port():
    """``repro.launch.train`` checkpoints tm-tiny at step 3; the port's
    ``train_tm --device cpu`` resumes it to step 6 and ends on the
    reference's uninterrupted 6-step bank."""
    common = ["--arch", "tm-tiny", "--batch-size", "16", "--n-train", "200",
              "--ckpt-every", "3", "--log-every", "100"]
    with tempfile.TemporaryDirectory() as d:
        ck_ref, ck = os.path.join(d, "ref"), os.path.join(d, "ck")
        r = _run(["-m", "repro.launch.train", *common, "--steps", "6",
                  "--ckpt-dir", ck_ref])
        assert r.returncode == 0, r.stdout + r.stderr
        r = _run(["-m", "repro.launch.train", *common, "--steps", "3",
                  "--ckpt-dir", ck])
        assert r.returncode == 0, r.stdout + r.stderr
        r = _run(["-m", "repro_torch.launch.train", *common, "--steps", "6",
                  "--ckpt-dir", ck, "--device", "cpu", "--no-fuse",
                  "--batch-chunk", "7"])
        assert r.returncode == 0, r.stdout + r.stderr
        assert "resumed from step 3" in r.stdout
        assert "TRAIN_HEALTH" in r.stdout
        a = np.load(os.path.join(ck_ref, "step_0000000006", "arrays.npz"))["ta"]
        b = np.load(os.path.join(ck, "step_0000000006", "arrays.npz"))["ta"]
        np.testing.assert_array_equal(a, b)


