"""Preemption-safe training: signal -> barrier -> checkpoint -> exit
(a copy of the reference's).

On TPU pods the maintenance system delivers SIGTERM ahead of eviction; the
handler flips a flag the step loop polls, so the loop checkpoints at the
next step boundary and exits with a dedicated code the launcher (or k8s
restart policy) recognizes as "resume me".

The handler is a good citizen in a process that already owns its signals
(the serving gateway wires SIGTERM to graceful drain): :meth:`install`
CHAINS to whatever handler was previously registered instead of silently
replacing it, and :meth:`uninstall` restores the previous handlers
exactly — so nested ``install()``/``uninstall()`` pairs (train loop
inside a serving process, tests inside pytest's own INT handling) unwind
like a stack.
"""

from __future__ import annotations

import signal
import sys
from typing import Callable, Dict, Optional

RESUME_EXIT_CODE = 42


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._preempted = False
        self._signals = signals
        self._installed = False
        self._previous: Dict[int, object] = {}

    def install(self) -> "PreemptionHandler":
        """Install, chaining to (not clobbering) any existing handlers.

        After our flag flips, the PREVIOUS handler still runs: a gateway
        drain wired to SIGTERM keeps draining, a nested outer
        PreemptionHandler still sees its own flag flip.  Idempotent —
        a second install() without uninstall() is a no-op.
        """
        if self._installed:
            return self

        def make_handler(prev):
            def handler(signum, frame):
                self._preempted = True
                if callable(prev):
                    prev(signum, frame)

            return handler

        for s in self._signals:
            try:
                prev = signal.getsignal(s)
                signal.signal(s, make_handler(prev))
            except ValueError:
                pass  # not main thread (tests)
            else:
                self._previous[s] = prev
        self._installed = True
        return self

    def uninstall(self) -> "PreemptionHandler":
        """Restore the handlers that were registered before install().

        Safe to call when never installed (no-op), and after uninstall
        a later install() chains afresh.
        """
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass  # not main thread, or prev was SIG_IGN-as-int etc.
        self._previous = {}
        self._installed = False
        return self

    @property
    def preempted(self) -> bool:
        return self._preempted

    def trigger(self) -> None:  # tests / manual drills
        self._preempted = True

    def checkpoint_and_exit(self, save_fn: Callable[[], None]) -> None:
        save_fn()
        sys.exit(RESUME_EXIT_CODE)
