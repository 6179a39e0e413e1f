"""Multi-tenant artifact zoo: LRU cache of loaded models + circuit breakers
(a copy of the reference's), and :func:`artifact_loader`, whose cold loads
plan each tenant's engine and launch through ``kernels/autotune.py``.

A production gateway serves MANY compiled TMs — far more than fit in
memory at once.  The zoo is the tenant-facing model cache:

* **LRU under a byte cap** — ``loader(tenant)`` returns ``(obj, nbytes)``
  (``obj`` is whatever the serving layer wants per tenant: typically a
  dict with the validated ``CompiledTM`` and its ``EngineLadder``).
  Entries are evicted least-recently-used when ``capacity_bytes`` /
  ``max_entries`` is exceeded.

* **Pin/lease** — :meth:`lease` pins the entry for the duration of a
  bucket; a pinned entry is NEVER evicted mid-flight.  When pressure (or
  the ``zoo.evict_inflight`` fault drill) targets a pinned entry, the
  eviction is DEFERRED: the entry is marked and dropped when its last
  lease is released, the in-flight bucket completes untouched.

* **Atomic hot-swap** — :meth:`swap` promotes a new artifact version for
  a tenant under the zoo lock with a single-assignment commit: in-flight
  leases finish against the OLD version (the release path identity-checks
  its entry, so draining leases never delete the successor), new
  admissions route to the new one, and the gateway's
  ``offered == answered + shed`` accounting never sees a gap.  The
  ``zoo.swap_abort`` fault site fires between candidate preparation and
  the commit — an aborted swap raises :class:`SwapAborted` and leaves the
  old entry serving, bit-intact (drilled).  :meth:`trip` force-opens a
  tenant's breaker, the rollback hook for a failed canary or a post-swap
  regression.

* **Per-tenant circuit breaker** — a tenant whose artifact repeatedly
  fails (load errors via the ``zoo.load_fail`` site, validation
  rejections, engine-ladder exhaustion reported through
  :meth:`record_fault`) trips its breaker OPEN: subsequent leases raise
  :class:`TenantQuarantined` (``shed_reason="tenant_quarantined"`` — the
  gateway sheds that tenant's requests with a typed reason) instead of
  re-paying the failure in the shared dispatch loop.  After an
  exponential-backoff cooldown the breaker half-opens and admits ONE
  probe lease: success closes it, failure re-opens with doubled backoff.
  Healthy tenants never notice.

The breaker clock is injectable so the open/half-open/close transitions
are unit-testable without sleeping.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import threading
import time
from typing import Callable, Dict, Optional

from repro_torch.runtime import faults

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class TenantQuarantined(RuntimeError):
    """Lease refused: the tenant's breaker is open (typed gateway shed)."""
    shed_reason = "tenant_quarantined"

    def __init__(self, tenant: str, retry_in: float):
        super().__init__(
            f"tenant {tenant!r} quarantined; retry in {retry_in:.2f}s")
        self.tenant = tenant
        self.retry_in = retry_in


class ArtifactLoadError(RuntimeError):
    """Loading/validating the tenant's artifact failed (typed shed)."""
    shed_reason = "load_failed"


class SwapAborted(RuntimeError):
    """Hot-swap died before its commit point; the old entry still serves."""


class CircuitBreaker:
    """closed -> open (threshold consecutive faults) -> half_open (after
    cooldown * 2^(trips-1)) -> closed on probe success / re-open on probe
    failure."""

    def __init__(self, threshold: int = 3, cooldown: float = 1.0,
                 max_cooldown: float = 300.0, clock=time.monotonic):
        self.threshold = threshold
        self.cooldown = cooldown
        self.max_cooldown = max_cooldown
        self._clock = clock
        self.state = CLOSED
        self.consecutive = 0
        self.trips = 0                      # times opened (drives backoff)
        self.retry_at: Optional[float] = None

    def _open(self) -> None:
        self.state = OPEN
        self.trips += 1
        backoff = min(self.cooldown * (2 ** (self.trips - 1)),
                      self.max_cooldown)
        self.retry_at = self._clock() + backoff

    def allow(self) -> bool:
        """May a lease proceed?  OPEN past its cooldown admits one probe."""
        if self.state == OPEN:
            if self._clock() >= self.retry_at:
                self.state = HALF_OPEN
                return True
            return False
        return True                          # CLOSED or HALF_OPEN (probe)

    def record_failure(self) -> None:
        self.consecutive += 1
        if self.state == HALF_OPEN or self.consecutive >= self.threshold:
            self._open()

    def record_success(self) -> None:
        self.consecutive = 0
        if self.state in (HALF_OPEN, OPEN):
            self.state = CLOSED
            self.trips = 0
            self.retry_at = None

    @property
    def retry_in(self) -> float:
        if self.retry_at is None:
            return 0.0
        return max(self.retry_at - self._clock(), 0.0)


@dataclasses.dataclass
class _Entry:
    tenant: str
    obj: object
    nbytes: int
    pins: int = 0
    evict_on_release: bool = False
    version: int = 1                 # bumped by swap(); 1 = cold load


def artifact_loader(resolve_path: Callable[[str], str], *,
                    batch: int = 64, device="cuda",
                    policy: str = "predict") -> Callable:
    """Build a zoo ``loader`` that cold-loads compiled-TM artifacts.

    ``resolve_path(tenant)`` maps a tenant name to a ``save()``-produced
    artifact path.  The loader validates + loads the ``CompiledTM`` and
    asks ``kernels.autotune.plan_engine`` for an engine + block plan on
    ``device``.  Under the default ``policy="predict"`` the plan comes
    purely from the persisted feature vector and the cost model: a cold
    zoo load issues ZERO kernel timing runs.  Returns the ``(obj, nbytes)``
    pair the zoo expects, with ``obj`` a dict::

        {"compiled": CompiledTM, "engine": str, "blocks": dict}
    """
    def load(tenant: str):
        from repro_torch.core import compiler
        from repro_torch.kernels import autotune

        compiled = compiler.CompiledTM.load(resolve_path(tenant))
        engine, blocks = autotune.plan_engine(
            compiled, batch, device=device, policy=policy)
        nbytes = (compiled.include_words.nbytes + compiled.word_ids.nbytes
                  + compiled.votes.nbytes)
        return {"compiled": compiled, "engine": engine,
                "blocks": dict(blocks)}, nbytes
    return load


def _tenant_step(tenant: str) -> Optional[int]:
    """Trailing integer of a tenant name — lets ``zoo.load_fail@K`` target
    tenant ``...K`` specifically in multi-tenant drills."""
    m = re.search(r"(\d+)$", tenant)
    return int(m.group(1)) if m else None


class ArtifactZoo:
    def __init__(self, loader: Callable, *,
                 capacity_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 1.0,
                 breaker_max_cooldown: float = 300.0,
                 clock=time.monotonic):
        self._loader = loader
        self.capacity_bytes = capacity_bytes
        self.max_entries = max_entries
        self._clock = clock
        self._mk_breaker = lambda: CircuitBreaker(
            threshold=breaker_threshold, cooldown=breaker_cooldown,
            max_cooldown=breaker_max_cooldown, clock=clock)
        # insertion order == recency order (move_to_end on touch)
        self._entries: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self.breakers: Dict[str, CircuitBreaker] = {}
        # reentrant: swap() and lease bookkeeping share _evict(); the lock
        # makes the zoo safe to hot-swap from an updater thread while the
        # gateway's worker thread leases (the loader itself runs under the
        # lock — cold loads serialize, which is the safe default for a
        # cache whose loads mutate shared autotune state)
        self._lock = threading.RLock()
        self.loads = 0
        self.load_failures = 0
        self.evictions = 0
        self.deferred_evictions = 0
        self.quarantine_rejections = 0
        self.swaps = 0
        self.swap_aborts = 0

    # -- breaker plumbing ----------------------------------------------------

    def _breaker(self, tenant: str) -> CircuitBreaker:
        br = self.breakers.get(tenant)
        if br is None:
            br = self.breakers[tenant] = self._mk_breaker()
        return br

    def record_fault(self, tenant: str) -> None:
        """Report a serving fault (e.g. engine-ladder exhaustion) against
        the tenant's breaker."""
        with self._lock:
            self._breaker(tenant).record_failure()

    def record_success(self, tenant: str) -> None:
        with self._lock:
            self._breaker(tenant).record_success()

    def trip(self, tenant: str) -> None:
        """Force the tenant's breaker OPEN immediately — the rollback hook
        for a failed canary or a post-swap regression.  New admissions
        shed ``tenant_quarantined`` until the backoff expires (half-open
        probe semantics apply as usual afterwards)."""
        with self._lock:
            br = self._breaker(tenant)
            br.consecutive = max(br.consecutive, br.threshold)
            br._open()

    # -- cache ---------------------------------------------------------------

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _over_cap(self) -> bool:
        # entries already marked for deferred eviction are as good as
        # freed — counting them would cascade-mark every pinned entry
        live = [e for e in self._entries.values() if not e.evict_on_release]
        if self.max_entries is not None and len(live) > self.max_entries:
            return True
        return (self.capacity_bytes is not None
                and sum(e.nbytes for e in live) > self.capacity_bytes)

    def _evict(self) -> None:
        # the drill forces the scan to target a PINNED entry first: the
        # only acceptable behavior is deferral, never a mid-flight yank
        if faults.fire_if("zoo.evict_inflight"):
            for e in self._entries.values():
                if e.pins > 0 and not e.evict_on_release:
                    e.evict_on_release = True
                    self.deferred_evictions += 1
                    break
        while self._over_cap():
            victim = None
            for e in self._entries.values():     # oldest (LRU) first
                if e.pins == 0:
                    victim = e
                    break
            if victim is None:
                # everything is in flight: defer to the release path
                for e in self._entries.values():
                    if not e.evict_on_release:
                        e.evict_on_release = True
                        self.deferred_evictions += 1
                        break
                return
            del self._entries[victim.tenant]
            self.evictions += 1

    def _get(self, tenant: str) -> _Entry:
        br = self._breaker(tenant)
        if not br.allow():
            self.quarantine_rejections += 1
            raise TenantQuarantined(tenant, br.retry_in)
        entry = self._entries.get(tenant)
        if entry is not None:
            self._entries.move_to_end(tenant)
            return entry
        try:
            faults.raise_if("zoo.load_fail", step=_tenant_step(tenant))
            obj, nbytes = self._loader(tenant)
        except Exception as e:
            self.load_failures += 1
            br.record_failure()
            raise ArtifactLoadError(
                f"loading artifact for tenant {tenant!r} failed: "
                f"{type(e).__name__}: {e}") from e
        self.loads += 1
        entry = self._entries[tenant] = _Entry(
            tenant=tenant, obj=obj, nbytes=int(nbytes))
        return entry

    @contextlib.contextmanager
    def lease(self, tenant: str):
        """Pin the tenant's artifact for one bucket; yields the loaded obj.

        Raises :class:`TenantQuarantined` / :class:`ArtifactLoadError`
        (both carry ``shed_reason`` for the gateway's typed rejection).
        A load that succeeds counts toward closing a half-open breaker
        only when the caller also reports :meth:`record_success` after
        the bucket actually serves.
        """
        with self._lock:
            entry = self._get(tenant)
            entry.pins += 1
            # evict AFTER pinning: a freshly-loaded entry must not be the
            # LRU scan's own victim before its first bucket runs
            self._evict()
        try:
            yield entry.obj
        finally:
            with self._lock:
                entry.pins -= 1
                # identity check: after a swap() the tenant maps to the
                # NEW entry — a draining lease on the old version must
                # never delete its successor
                if (entry.pins == 0 and entry.evict_on_release
                        and self._entries.get(tenant) is entry):
                    del self._entries[tenant]
                    self.evictions += 1

    def swap(self, tenant: str, obj: object, nbytes: int) -> int:
        """Atomically promote ``obj`` as the tenant's serving artifact.

        The new entry is prepared (version = old + 1), the
        ``zoo.swap_abort`` fault site gets its shot (``@step`` gates on
        the tenant's trailing integer), and only then does a SINGLE dict
        assignment commit the promotion — there is no intermediate state
        in which a lease can observe a half-promoted object.  In-flight
        leases pinned to the old entry finish against the old object;
        admissions after the commit route to the new one.  An abort
        raises :class:`SwapAborted` and leaves the old entry serving,
        untouched.  Returns the committed version number.
        """
        with self._lock:
            old = self._entries.get(tenant)
            entry = _Entry(tenant=tenant, obj=obj, nbytes=int(nbytes),
                           version=(old.version + 1) if old else 1)
            try:
                faults.raise_if("zoo.swap_abort", step=_tenant_step(tenant))
            except Exception as e:
                self.swap_aborts += 1
                raise SwapAborted(
                    f"hot-swap for tenant {tenant!r} aborted before "
                    f"commit: {e}") from e
            self._entries[tenant] = entry         # the commit point
            self._entries.move_to_end(tenant)
            self.swaps += 1
            self._evict()
            return entry.version

    def version(self, tenant: str) -> Optional[int]:
        """Serving version of the tenant's entry (None when not loaded)."""
        with self._lock:
            entry = self._entries.get(tenant)
            return entry.version if entry else None

    def runner(self, serve: Callable) -> Callable:
        """Gateway-runner adapter: ``serve(obj, rows) -> preds`` under a
        lease, reporting success/fault to the tenant's breaker."""
        def run(tenant, rows):
            with self.lease(tenant) as obj:
                try:
                    preds = serve(obj, rows)
                except Exception:
                    self.record_fault(tenant)
                    raise
            self.record_success(tenant)
            return preds
        return run

    def health(self) -> dict:
        with self._lock:
            return dict(
                entries=sorted(self._entries),
                nbytes=self.nbytes, loads=self.loads,
                load_failures=self.load_failures,
                evictions=self.evictions,
                deferred_evictions=self.deferred_evictions,
                quarantine_rejections=self.quarantine_rejections,
                swaps=self.swaps,
                swap_aborts=self.swap_aborts,
                versions={t: e.version for t, e in self._entries.items()
                          if e.version > 1},
                breakers={t: dict(state=b.state, trips=b.trips,
                                  consecutive=b.consecutive)
                          for t, b in self.breakers.items()
                          if b.state != CLOSED or b.trips or b.consecutive},
            )
