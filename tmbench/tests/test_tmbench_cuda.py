"""Every cell end to end on the card, with a short window (``-m cuda``);
each skips where there is no card, decided inside the test."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "tmbench/run.py", "--workload", cell, "--seed", str(2 ** 31 + 77),
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    m = manifest.cell(manifest.load(), cell)
    want = m["per_layer"] if trace else m["end_to_end"]
    assert set(res["metrics"]) <= {x["name"] for x in want}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, v in res["metrics"].items():
            if name.endswith(("_roofline", "_mfu")):
                assert 0 < v["value"] <= 100


@pytest.mark.cuda
def test_a_bare_checkout_exits_without_a_result(card, tmp_path):
    """A directory holding only BENCHMARK.json and tmbench/ has no program."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "tmbench"), tmp_path / "tmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "tmbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
