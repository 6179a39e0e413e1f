"""The readers of the program's spans, on hand-made totals."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from repro_torch import spans  # noqa: E402
from tmbench import manifest  # noqa: E402

# metric -> (kind, span) of every reader of a span's mean
MEANS = {
    "run_compiled_ms.infer": ("infer", "run_compiled"),
    "runner_route_ms.infer": ("infer", "run_compiled.route"),
    "runner_gather_ms.infer": ("infer", "run_compiled.gather"),
    "term_infer_prep_ms.infer": ("infer", "term_infer.prep"),
    "term_infer_launch_ms.infer": ("infer", "term_infer.launch"),
    "train_step_ms.train": ("train", "train_step"),
    "train_prepare_ms.train": ("train", "train_step.prepare"),
    "train_sums_ms.train": ("train", "train_step.sums"),
    "train_feedback_ms.train": ("train", "train_step.feedback"),
    "train_delta_ms.train": ("train", "train_step.delta"),
    "train_apply_ms.train": ("train", "train_step.apply"),
}
TOP = {"infer": "run_compiled", "train": "train_step"}


def _run(kind, n):
    return ({"kind": "infer", "batches": n} if kind == "infer"
            else {"kind": "train", "steps": n})


@pytest.fixture
def totals(monkeypatch):
    """Sets the program's span totals the readers see."""
    def put(d):
        monkeypatch.setattr(spans, "totals", lambda: dict(d))
    return put


def test_every_span_metric_is_in_the_manifest():
    names = {p["name"] for p in manifest.load()["per_layer"]}
    assert set(MEANS) | {"runner_rebuilds.infer"} <= names


@pytest.mark.parametrize("metric", sorted(MEANS))
def test_mean_reader(metric, totals):
    kind, span = MEANS[metric]
    other = "train" if kind == "infer" else "infer"
    read = manifest.reader(metric)
    totals({TOP[kind]: (4, 9_000_000), span: (4, 6_000_000)})
    assert read(_run(kind, 4)) == pytest.approx(1.5)
    assert read(_run(kind, 5)) is None                  # calls unlike the batches
    assert read(_run(other, 4)) is None                 # the other kind
    totals({})
    assert read(_run(kind, 0)) is None


def test_rebuild_counter(totals):
    read = manifest.reader("runner_rebuilds.infer")
    totals({"run_compiled": (7, 1), "run_compiled.build": (2, 5)})
    assert read(_run("infer", 7)) == 2
    assert read(_run("infer", 6)) is None
    assert read(_run("train", 7)) is None
    totals({"run_compiled": (7, 1)})
    assert read(_run("infer", 7)) == 0


def test_a_program_without_spans_gives_nothing(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)      # import fails
    for metric in (*MEANS, "runner_rebuilds.infer"):
        kind = MEANS.get(metric, ("infer",))[0]
        assert manifest.reader(metric)(_run(kind, 3)) is None
