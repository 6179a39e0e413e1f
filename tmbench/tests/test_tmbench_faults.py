"""A whole run on the CPU (the program's plain versions), past the look for
a card: sound, it is correct; with the timed path broken underneath, or
with the control in the program's place, ``correct`` comes out false."""

import contextlib
import io
import json
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import manifest, run, trace  # noqa: E402

CPU = torch.device("cpu")
# small enough for a test run: batches of 512 datapoints, or a kws6-wide
# bank of 6 x 10 clauses stepped at batch 128
INFER = dict(batch=512, pool_batches=2, warmup_batches=1, checked_batches=3)
TRAIN_MODEL = dict(n_features=377, n_classes=6, clauses_per_class=10, threshold=20,
                   s=10.0, n_states=128, boost_true_positive=True, clause_pad_multiple=64)
TRAIN = dict(batch=128, pool=1024, orders=2, checked_steps=2)


def cell_of(name, **traffic):
    cell, config, tr = run.load_cell(name)
    tr.update(traffic)
    if tr["kind"] == "train_stream":
        config = dict(config, model=TRAIN_MODEL, data={"dataset": "kws6", "data_seed": 0})
    return cell, config, tr


def run_once(name, traffic, seed=2 ** 31 + 5, seconds=0.3):
    cell, config, tr = cell_of(name, **traffic)
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=seconds, trace=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.run(args, cell, config, tr, CPU)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def test_sound_runs_are_correct():
    for name, tr in (("tm-mnist.infer-64k", INFER), ("tm-cifar2.train-b4096", TRAIN)):
        res = run_once(name, tr)
        assert res["correct"] is True
        assert list(res)[-1] == "compared"
        assert all(v["value"] == 0 for v in res["compared"].values())
        cell = manifest.cell(manifest.load(), name)
        assert set(res["metrics"]) <= {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in res["metrics"]


def half_batch_runner(real):
    def broken(compiled, x, **kw):
        out = real(compiled, x, **kw).clone()
        out[x.shape[0] // 2:] = 0
        return out
    return broken


def altered_runner(real):
    def broken(compiled, x, **kw):
        out = real(compiled, x, **kw).clone()
        out[0, 0] += 1
        return out
    return broken


@pytest.mark.parametrize("fault", [half_batch_runner, altered_runner])
def test_a_broken_runner_is_not_correct(monkeypatch, fault):
    from repro_torch.core import compiler

    monkeypatch.setattr(compiler, "run_compiled", fault(compiler.run_compiled))
    res = run_once("tm-mnist.infer-64k", INFER)
    assert res["correct"] is False
    assert res["compared"]["sums_mismatch"]["value"] > 0


def unchanged_step(real):
    def broken(config, ta, x, y, seed, **kw):
        new, delta = real(config, ta, x, y, seed, **kw)
        return ta.clone(), delta * 0
    return broken


def half_batch_step(real):
    def broken(config, ta, x, y, seed, **kw):
        h = x.shape[0] // 2
        return real(config, ta, x[:h], y[:h], seed, **kw)
    return broken


def altered_step(real):
    def broken(config, ta, x, y, seed, **kw):
        new, delta = real(config, ta, x, y, seed, **kw)
        new = new.clone()
        new[0, 0] = new[0, 0] + 1 if new[0, 0] < 127 else new[0, 0] - 1
        return new, delta
    return broken


@pytest.mark.parametrize("fault", [unchanged_step, half_batch_step, altered_step])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "tm_train_step_kernel", fault(ops.tm_train_step_kernel))
    res = run_once("tm-cifar2.train-b4096", TRAIN)
    assert res["correct"] is False
    assert res["compared"]["first_steps_mismatch"]["value"] > 0
    assert res["compared"]["window_steps_mismatch"]["value"] > 0


def kind_after_window(name, traffic, seed):
    cell, config, tr = cell_of(name, **traffic)
    kind = run.make_kind(config, tr, seed, CPU, trace.Tracer(False))
    kind.setup()
    kind.window(0.3)
    return kind


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12])
def test_the_inference_control_fails_and_the_program_passes(seed):
    kind = kind_after_window("tm-cifar2.infer-64k", dict(INFER, batch=2048), seed)
    assert kind.check() == [("sums_mismatch", 0, 0)]
    got = kind.controls()
    assert got["control_dropped_clauses"] > 0 and got["fault_half_batch"] > 0


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22])
def test_the_training_control_fails_and_the_program_passes(seed):
    kind = kind_after_window("tm-cifar2.train-b4096", TRAIN, seed)
    assert [v for _, v, _ in kind.check()] == [0, 0]
    got = kind.controls()
    assert got["control_bf16_first"] > 0
    assert got["fault_unchanged_first"] > 0 and got["fault_half_batch_first"] > 0
