"""The work counts and the trace reduction, on hand-made inputs."""

import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import trace, work  # noqa: E402


def test_inference_work_of_a_hand_made_artifact():
    # 3 clauses, 2 classes; 40 datapoints = 2 words of 32 (the second half full)
    votes = torch.tensor([[1, 0], [-1, 2], [0, 0]])
    fire = torch.zeros((40, 3), dtype=torch.bool)
    fire[0, 0] = True        # clause 0 fires in word 0: 1 nonzero vote
    fire[35, 1] = True       # clause 1 fires in word 1: 2 nonzero votes
    fire[36, 1] = True       # same word: counted once
    fire[5, 2] = True        # clause 2 has no votes: nothing to add
    w = work.infer_batch(fire, votes, n_active_words=5)
    assert w["ops"] == 1 + 2
    assert w["bytes"] == 4 * (40 * 5 + 3 * 5 + 5 + 3 * 2 + 40 * 2)


def test_artifact_rows_fire_over_their_active_words(tmp_path):
    import numpy as np

    # 2 rows over the dense words 1 and 3 of 4; row 1 is empty
    inc = np.zeros((2, 2), np.uint32)
    inc[0, 0] = 0b101                    # literals 32 + 0 and 32 + 2
    inc[0, 1] = 1 << 31                  # literal 96 + 31
    np.savez(tmp_path / "a.npz", include_words=inc, word_ids=np.array([1, 3], np.int32),
             votes=np.array([[2, -1], [1, 1]], np.int32))
    rows = work.ArtifactRows(str(tmp_path / "a.npz"), "cpu")
    assert rows.n_active_words == 2
    words = torch.zeros((3, 4), dtype=torch.int32)
    words[0, 1], words[0, 3] = 0b101, -2 ** 31       # every included literal lit
    words[1, 1], words[1, 3] = 0b001, -2 ** 31       # literal 34 unlit
    words[2] = -1                                    # everything lit
    fire = rows.fire(words)
    assert fire.tolist() == [[True, False], [False, False], [True, False]]


def test_training_work_of_hand_made_feedback():
    B, C, L, F = 4, 6, 64, 32
    ftype = torch.tensor([[1, 0, 2, 0, 0, 0],
                          [1, 1, 0, 0, 0, 0],
                          [0, 0, 0, 0, 2, 0],
                          [0, 0, 0, 0, 0, 0]], dtype=torch.uint8)
    fire = torch.ones((B, C), dtype=torch.bool)
    y = torch.zeros(B, dtype=torch.int32)
    w = work.train_step(fire, ftype, y, n_features=F, n_literals=L, n_classes=3,
                        clauses_per_class=2)
    type1, selected, candidates = 3, 5, B * 2 * 2
    assert w["fused_train"]["ops"] == 10 * (type1 * L + candidates) + selected
    assert w["fused_train"]["bytes"] == C * L * 5 + 4 * B * 2 + 4 * C * 2 + 16 * B + 8 * C
    assert w["step"]["ops"] == w["fused_train"]["ops"] + 1 * C
    assert w["step"]["bytes"] == 2 * C * L + B * F + 4 * B


def test_bound_is_the_larger_term():
    pk = {"int32_ops_per_s": 10.0, "hbm_bytes_per_s": 100.0}
    assert work.bound_s(50, 100, pk) == 5.0
    assert work.bound_s(5, 1000, pk) == 10.0
    assert work.peaks()["hbm_bytes_per_s"] == 3.35e12


class Ev:
    def __init__(self, name, t0, t1, cuda, annotation=False):
        self._n, self._t, self._c, self._a = name, (t0, t1), cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._t[0]

    def end_ns(self):
        return self._t[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a


def fake_prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res))


def test_trace_reduction_clips_to_the_window_and_names_idle_gaps():
    ev = [Ev("spin_kernel", 0, 5, True),
          Ev("tmbench.window", 100, 200, False),
          Ev("tmbench.runner", 100, 130, False),
          Ev("tmbench.readback", 130, 180, False),
          Ev("tmbench.runner", 180, 200, False),
          Ev("k1", 90, 110, True),            # clipped to 100-110
          Ev("Memcpy HtoD", 105, 120, True),  # overlaps k1: busy 100-120
          Ev("tmbench.window", 100, 200, True, annotation=True),  # not work
          Ev("k2", 150, 160, True),           # gap 120-150 while in runner/readback
          Ev("k1", 190, 195, True)]           # gap 160-190 from readback; 195-200 runner
    red = trace.reduce(fake_prof(ev))
    assert red["window_s"] == pytest.approx(100e-9)
    assert red["busy_s"] == pytest.approx(35e-9)
    assert red["by_name"]["k1"] == pytest.approx(15e-9)
    assert red["idle_gaps"]["tmbench.runner"] == pytest.approx(30e-9 + 5e-9)
    assert red["idle_gaps"]["tmbench.readback"] == pytest.approx(30e-9)
    b = trace.breakdown(red)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2


def test_trace_without_markers_is_not_read():
    ev = [Ev("tmbench.window", 0, 10, False), Ev("k", 1, 2, True)]
    assert trace.reduce(fake_prof(ev)) is None
