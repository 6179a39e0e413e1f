"""Deterministic fault injection: the drill harness behind the runtime's
fault-tolerance claims.

Every recovery behavior in this repo (artifact-checksum rejection, the
serve engine degradation ladder, preemption-safe training, straggler
flagging, async-checkpoint error surfacing) is *drill-tested* by arming a
named fault site and asserting the runtime degrades the way it promises —
not merely asserted in a docstring.  Sites fire deterministically (no
randomness), so a failing drill reproduces exactly.

Arming
------
Set ``REPRO_FAULT_INJECT`` to a comma-separated list of entries::

    site[@step][:param][*count]

  * ``site``  — a registered site name (see ``SITES``).
  * ``@step`` — fire only when the call site passes that step/bucket index.
  * ``:param``— site-specific float (sleep seconds, byte offset, ...).
  * ``*count``— maximum number of firings (default: unlimited).

Examples::

    REPRO_FAULT_INJECT=kernel.factorized,kernel.sparse      # ladder drill
    REPRO_FAULT_INJECT=train.sigterm@7                      # preemption drill
    REPRO_FAULT_INJECT=serve.slow_bucket@3:0.5              # straggler drill
    REPRO_FAULT_INJECT=artifact.bitflip                     # bit-rot drill

In-process tests arm sites with the :func:`injected` context manager
instead of the environment variable.  With nothing armed every probe is a
dict miss — the harness costs nothing in production.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time
from typing import List, Optional

ENV_VAR = "REPRO_FAULT_INJECT"

# Registry of injection sites: name -> (where it fires, what it simulates).
# Drills and README documentation are generated against this table; adding
# a site here is the contract that some recovery path is drilled for it.
SITES = {
    "kernel.factorized": "ops.tm_forward_factorized kernel launch — a "
                         "Mosaic lowering/compile failure of the two-level "
                         "factorized schedule kernel",
    "kernel.sparse": "ops.tm_forward_schedule kernel launch — a lowering "
                     "failure of the flat block-sparse chain kernel",
    "kernel.dense": "ops.tm_forward_packed fused kernel launch — a lowering "
                    "failure of the dense single-pass kernel",
    "serve.slow_bucket": "launch/serve.py bucket loop — a stalled bucket "
                         "(param = seconds of stall)",
    "train.sigterm": "core/train.fit + launch/train.py step boundary — "
                     "delivers SIGTERM to this process (preemption)",
    "train.slow_step": "training step loop — a straggling step "
                       "(param = seconds of stall)",
    "ckpt.write_fail": "checkpoint/store.save_checkpoint — a failed "
                       "checkpoint write (disk full / permission)",
    "artifact.bitflip": "compiler.CompiledTM.save — flips one byte of the "
                        "written artifact (bit-rot; param = byte offset)",
    "artifact.save_abort": "compiler.CompiledTM.save — dies after writing "
                           "the tmp file, before the atomic replace "
                           "(SIGTERM mid-save)",
    "gateway.queue_overflow": "runtime/gateway.py admission — forces the "
                              "bounded request queue to report full, so the "
                              "request is SHED with a typed queue_full "
                              "rejection (never silently dropped)",
    "gateway.drain_timeout": "runtime/gateway.py drain — forces the drain "
                             "timer to expire immediately, so still-queued "
                             "requests are rejected drain_timeout instead "
                             "of being flushed",
    "zoo.evict_inflight": "runtime/zoo.py eviction — forces the LRU scan to "
                          "target a PINNED (in-flight) artifact; the zoo "
                          "must defer the eviction until the lease drops, "
                          "never yank a bucket's model mid-run",
    "zoo.load_fail": "runtime/zoo.py artifact load — an I/O/validation "
                     "failure loading a tenant's artifact (@step gates on "
                     "the tenant's trailing integer, e.g. zoo.load_fail@2 "
                     "targets tenant 't2' only)",
    "zoo.swap_abort": "runtime/zoo.py hot-swap — dies after the candidate "
                      "entry is prepared, before the atomic commit; the "
                      "tenant must keep serving the OLD artifact intact "
                      "(@step gates on the tenant's trailing integer)",
    "online.rebuild_fail": "runtime/online.py incremental recompile — the "
                           "candidate rebuild blows up (OOM / lowering "
                           "failure); the updater must keep serving the "
                           "deployed artifact and retry at the next drift "
                           "check",
    "online.feedback_corrupt": "runtime/online.py feedback ingest — "
                               "corrupts a labeled feedback record before "
                               "validation (label out of range); the "
                               "updater must reject it, never train on it",
    "anytime.margin_corrupt": "compiler.CompiledTM.load — tampers the "
                              "anytime margin metadata after the checksum "
                              "passes (adversarial producer); "
                              "validate_artifact must reject the artifact, "
                              "never serve early-exit/budgeted answers "
                              "from skewed margins",
    "gateway.brownout_stuck": "runtime/gateway.py brownout controller — "
                              "pins the primary level-lowering path so the "
                              "controller stays at a degraded quality "
                              "level after pressure clears; the low-"
                              "pressure watchdog must force recovery to "
                              "exact serving",
}


class InjectedFault(RuntimeError):
    """Raised at an armed raise-type fault site."""


@dataclasses.dataclass
class FaultSpec:
    site: str
    step: Optional[int] = None    # fire only at this step/bucket index
    param: Optional[float] = None
    count: Optional[int] = None   # max firings; None = unlimited
    fired: int = 0


def parse_spec(spec: str) -> List[FaultSpec]:
    """Parse the ``REPRO_FAULT_INJECT`` grammar into FaultSpecs."""
    out: List[FaultSpec] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        count = param = step = None
        if "*" in entry:
            entry, c = entry.rsplit("*", 1)
            count = int(c)
        if ":" in entry:
            entry, p = entry.split(":", 1)
            param = float(p)
        if "@" in entry:
            entry, s = entry.split("@", 1)
            step = int(s)
        if entry not in SITES:
            raise ValueError(
                f"unknown fault site {entry!r}; registered sites: "
                f"{sorted(SITES)}")
        out.append(FaultSpec(site=entry, step=step, param=param, count=count))
    return out


class FaultInjector:
    """Holds armed FaultSpecs and answers per-site probes."""

    def __init__(self, specs):
        self._specs = list(specs)

    @property
    def armed(self) -> bool:
        return bool(self._specs)

    def poll(self, site: str, step=None) -> Optional[FaultSpec]:
        """The armed spec for ``site`` (consuming one firing), else None."""
        for sp in self._specs:
            if sp.site != site:
                continue
            if sp.step is not None and (step is None or int(step) != sp.step):
                continue
            if sp.count is not None and sp.fired >= sp.count:
                continue
            sp.fired += 1
            return sp
        return None

    # -- standard actions ---------------------------------------------------
    def raise_if(self, site: str, step=None) -> None:
        if self.poll(site, step) is not None:
            at = f" (step {step})" if step is not None else ""
            raise InjectedFault(f"injected fault at {site}{at}")

    def sleep_if(self, site: str, step=None, default: float = 0.25) -> bool:
        sp = self.poll(site, step)
        if sp is None:
            return False
        time.sleep(sp.param if sp.param is not None else default)
        return True

    def sigterm_if(self, site: str, step=None) -> bool:
        sp = self.poll(site, step)
        if sp is None:
            return False
        os.kill(os.getpid(), signal.SIGTERM)
        return True

    def corrupt_if(self, site: str, path: str, step=None,
                   default_pos: Optional[int] = None) -> bool:
        """Flip one byte of ``path`` (XOR 0x40) at an armed site.

        The spec ``:param`` wins as the byte offset; otherwise the call
        site's ``default_pos`` (a position it knows holds real payload —
        e.g. inside a zip member's compressed data rather than redundant
        container metadata); otherwise the middle of the file.
        """
        sp = self.poll(site, step)
        if sp is None:
            return False
        with open(path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if sp.param is not None:
                pos = int(sp.param)
            elif default_pos is not None:
                pos = int(default_pos)
            else:
                pos = size // 2
            pos = min(max(pos, 0), size - 1)
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0x40]))
        return True


_DISARMED = FaultInjector([])
_installed: Optional[FaultInjector] = None
_env_cache: tuple = (None, _DISARMED)


def get_injector() -> FaultInjector:
    """The active injector: in-process install > env var > disarmed.

    The env spec is re-read on every probe (cached per value) so a
    subprocess drill controls its sites purely through the environment;
    spec state (firing counts) persists across probes of the same spec.
    """
    if _installed is not None:
        return _installed
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return _DISARMED
    global _env_cache
    if _env_cache[0] != spec:
        _env_cache = (spec, FaultInjector(parse_spec(spec)))
    return _env_cache[1]


@contextlib.contextmanager
def injected(spec: str):
    """Arm sites in-process (tests): ``with faults.injected("ckpt.write_fail"):``"""
    global _installed
    prev = _installed
    _installed = FaultInjector(parse_spec(spec))
    try:
        yield _installed
    finally:
        _installed = prev


# -- module-level conveniences (the call-site API) ---------------------------
def armed() -> bool:
    return get_injector().armed


def fire_if(site: str, step=None) -> bool:
    """True when ``site`` is armed (consumes one firing) — for call sites
    whose degraded behavior is a branch, not an exception/sleep/signal."""
    return get_injector().poll(site, step) is not None


def raise_if(site: str, step=None) -> None:
    get_injector().raise_if(site, step)


def sleep_if(site: str, step=None) -> bool:
    return get_injector().sleep_if(site, step)


def sigterm_if(site: str, step=None) -> bool:
    return get_injector().sigterm_if(site, step)


def corrupt_if(site: str, path: str, step=None, default_pos=None) -> bool:
    return get_injector().corrupt_if(site, path, step, default_pos=default_pos)
