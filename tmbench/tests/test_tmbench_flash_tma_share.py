"""The per-layer metric ``flash_tma_share.infer``: its entry in the manifest
and its reader, on the CPU with the program's counters given by hand."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import manifest  # noqa: E402

CELL = "deepseek-v2.prefill-16k"
NAME = "flash_tma_share.infer"


def _run(**kw):
    return dict(dict(kind="infer", batches=4, trace=None, bounds=None), **kw)


def test_the_prefill_cell_reports_the_share():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    cell = manifest.cell(bench, CELL)
    assert NAME in {m["name"] for m in cell["per_layer"]}
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == \
        ("%", "higher", "program_counter", "infer_rate")
    assert entry["workloads"] == [CELL]


@pytest.mark.parametrize("counts, want", [
    ({"flash.launches": 40, "flash.tma_launches": 40}, 100.0),
    ({"flash.launches": 40, "flash.tma_launches": 10}, 25.0),
    ({"flash.launches": 40}, 0.0),
    ({"moe_experts.rows": 400}, None),       # no flash launched (a TM cell)
    ({}, None),
], ids=["all-tma", "quarter", "none-tma", "no-flash", "empty"])
def test_reader_on_counts(monkeypatch, counts, want):
    from repro_torch import spans

    monkeypatch.setattr(spans, "counts", lambda: counts)
    assert manifest.reader(NAME)(_run()) == want


def test_reader_outside_an_infer_window(monkeypatch):
    from repro_torch import spans

    monkeypatch.setattr(spans, "counts", lambda: {"flash.launches": 40,
                                                  "flash.tma_launches": 40})
    assert manifest.reader(NAME)(_run(kind="train")) is None


def test_reader_on_a_program_without_counters(monkeypatch):
    """The parent's program has no ``spans.counts``: nothing, and no raise."""
    from repro_torch import spans

    monkeypatch.delattr(spans, "counts", raising=False)
    assert manifest.reader(NAME)(_run()) is None
