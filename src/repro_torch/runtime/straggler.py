"""Straggler detection for the synchronous step loop.

With SPMD collectives a slow host stalls everyone, so mitigation at this
layer is (a) detecting it fast and (b) keeping the input pipeline off the
critical path (data/loader.py prefetch).  The monitor keeps an EWMA of step
wall-times; steps slower than ``threshold x`` EWMA are flagged with the
step index so the launcher can correlate across hosts and evict/replace the
offender (the actual replacement is the cluster manager's job; elastic
restore in checkpoint/store.py handles the mesh change).

Flagged samples are EXCLUDED from the EWMA update: an outlier that feeds
back into the baseline inflates it, so a second straggler right behind the
first would compare against a poisoned mean and slip under the threshold.
The EWMA tracks the healthy-step distribution only.
"""

from __future__ import annotations

import time
from typing import List, Optional


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.events: List[dict] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> Optional[dict]:
        assert self._t0 is not None, "start_step not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.n += 1
        flagged = None
        if self.ewma is None:
            self.ewma = dt
        else:
            if self.n > self.warmup and dt > self.threshold * self.ewma:
                flagged = {"step": step, "seconds": dt, "ewma": self.ewma}
                self.events.append(flagged)
            if flagged is None:
                # outliers stay out of the baseline: folding a straggler in
                # would desensitize the very next detection
                self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged
