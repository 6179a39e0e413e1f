"""Named host spans that cost nothing unless a torch profiler records.

``with span(NAME):`` around a piece of host work.  With no profiler
recording it returns one shared no-op context: no ``record_function``
call, no ``profiler.*`` op dispatched, no clock read.  While a profiler
records (``torch.profiler.profile``, any activities) it opens
``torch.profiler.record_function(NAME)``, so the range lands in the trace
on the clock of the device's kernels and copies, and adds one call and the
host nanoseconds it took, the range's own record included, to this
module's totals.  So the totals are those of the profiled windows: profile
a window, then read :func:`totals`.

Each site names its span with a module-level constant, as the LM layers
name their profiler ranges.  A span inside another span of the same name
counts twice.

``count(NAME, n)`` adds ``n`` to a counter on the same terms: only while a
profiler records, read by :func:`counts`.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# the build span: every build on run_compiled's path (the artifact's device
# tables, a schedule, a placement of a schedule's tables on a device); its
# count in a window is the rebuild count
BUILD_RANGE = "run_compiled.build"

_NULL = contextlib.nullcontext()
_totals: dict = {}
_counts: dict = {}
_lock = threading.Lock()


class _Recorded:
    """A span while a profiler records: its profiler range and host time."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        with _lock:
            calls, total = _totals.get(self.name, (0, 0))
            _totals[self.name] = (calls + 1, total + ns)
        return False


def span(name: str):
    """A context manager around host work named ``name``: a profiler range
    and a timed call while a torch profiler records, else a shared no-op."""
    # the module flag the profiler sets, read cheaper than the C query
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Recorded(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a torch profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counts() -> dict:
    """``{name: total}`` of the counters recorded so far."""
    with _lock:
        return dict(_counts)


def totals() -> dict:
    """``{name: (calls, host ns)}`` of the spans recorded so far."""
    with _lock:
        return dict(_totals)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _totals.clear()
        _counts.clear()
