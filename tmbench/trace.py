"""The device trace of a ``--trace 1`` run, and its reduction.

The profiler records the device (CUDA activity) and the host (CPU
activity, of which only the harness's own ``tmbench.*`` ranges are read).
A copy of ``chip_smoke.py``'s ``profile_device`` window rule: the
profiler can miss a window's first launches, so the window starts with
``PROFILER_PREROLL`` marker launches (``torch.cuda._sleep``'s spin
kernel); a window in which no marker was recorded is not read.

The reduction takes the device's kernels, copies and sets inside the
window range (``tmbench.window``, on the profiler's own clock), and gives
their union (busy time), the time by name, and the idle gaps named by the
innermost harness range the host was in when the device fell idle.
Profiler ranges on the device (user annotations) are not work and are
left out.
"""

from __future__ import annotations

import bisect
import contextlib

PROFILER_PREROLL = 100
MARKER_KERNEL = "spin_kernel"
WINDOW_RANGE = "tmbench.window"
RANGE_PREFIX = "tmbench."
TOP = 10


class Tracer:
    """Harness ranges; a profiler around the window when tracing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_PREROLL):
                torch.cuda._sleep(1)
            with self.range(WINDOW_RANGE):
                yield
            torch.cuda.synchronize()
        self.prof = prof


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def reduce(prof) -> dict:
    """``{"window_s", "busy_s", "markers", "ops": [(start_s, end_s, name)]
    of the device work in the window, "by_name": {name: seconds},
    "idle_gaps": {host range: seconds}}`` of a profile; ``None`` when no
    marker or no window range was recorded."""
    device, ranges, window, markers = [], [], None, 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        t = (ev.start_ns(), ev.end_ns())
        if str(ev.device_type()).endswith("CUDA"):
            if ev.is_user_annotation():
                continue
            if MARKER_KERNEL in name:
                markers += 1
            else:
                device.append((*t, name))
        elif name == WINDOW_RANGE:
            window = t
        elif name.startswith(RANGE_PREFIX):
            ranges.append((*t, name))
    if window is None or markers == 0:
        return None
    w0, w1 = window
    ops, by_name = [], {}
    for t0, t1, name in sorted(device):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        ops.append((t0, t1, name))
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e9
    busy, end, gaps = 0, w0, {}
    ranges.sort()
    starts = [r[0] for r in ranges]

    def gap(t0, t1):
        # the harness's ranges inside the window do not overlap
        i = bisect.bisect_right(starts, t0) - 1
        where = ranges[i][2] if i >= 0 and ranges[i][1] > t0 else "host loop"
        gaps[where] = gaps.get(where, 0.0) + (t1 - t0) / 1e9

    for t0, t1, _ in ops:
        if t0 > end:
            gap(end, t0)
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    if w1 > end:
        gap(end, w1)
    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, markers=markers,
                ops=[(t0 / 1e9, t1 / 1e9, n) for t0, t1, n in ops],
                by_name=by_name, idle_gaps=gaps)


def breakdown(red: dict) -> dict:
    """The ``breakdown`` of a result line: the device operations that took
    most time and the longest idle time by host range, at most ``TOP``
    each, in seconds."""
    top = sorted(red["by_name"].items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(red["idle_gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
