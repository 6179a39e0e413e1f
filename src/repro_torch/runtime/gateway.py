"""Resilient async serving gateway: continuous batching + admission control.

A synchronous serve loop that executes a fixed
request array bucket by bucket — fine for a benchmark, useless under live
traffic where requests arrive one at a time, carry deadlines, and belong
to different tenants/models.  This gateway is the traffic-facing layer:

* **Continuous batching** — requests are admitted into a partially-filled
  per-tenant bucket (one fixed shape per tenant: the executed batch is
  always padded to the fixed ``bucket`` size, so a partial flush never
  retraces).  A bucket flushes when it fills, when its OLDEST request has
  waited ``max_wait`` seconds (age-based flush — tail latency is bounded
  even at low arrival rates), or at drain.

* **Admission control / load shedding** — the pending-request queue is
  bounded by ``max_queue``: when it is full the request is REJECTED at
  admission with the typed reason ``queue_full`` instead of growing an
  unbounded backlog.  Per-request deadlines are enforced at dequeue: an
  expired request is rejected ``deadline_expired``, never executed and
  never silently dropped.  Every offered request resolves to exactly one
  :class:`Response` — answered or shed with a typed reason — and
  :meth:`Gateway.health` proves it (``unaccounted`` must be 0).

* **Typed bucket rejection** — the runner (engine ladder / artifact zoo)
  signals per-bucket failure by raising; an exception carrying a
  ``shed_reason`` attribute (e.g. ``zoo.TenantQuarantined``) rejects the
  bucket's requests with that reason, anything else with
  ``engine_failed``.  One tenant's poisoned artifact therefore sheds THAT
  tenant's requests while other tenants keep flushing.

* **Shadow mirror** — an optional ``mirror(tenant, rows, preds)`` tap
  observes each successfully-answered bucket on the worker thread (the
  online updater's shadow-canary: replay the bucket against a candidate
  artifact and compare).  The tap is best-effort by construction: its
  exceptions are swallowed and counted (``mirror_failures``), and it can
  never shed or alter an answer.

* **Graceful drain** — :meth:`drain` (wired to SIGTERM by the server)
  stops admission (``shutting_down``), flushes the remaining partial
  buckets under ``drain_timeout`` seconds, and rejects whatever is still
  queued when the timer expires with ``drain_timeout``.  The final
  ``GATEWAY_HEALTH`` dict accounts for 100% of offered requests.

* **Brownout serving** — under overload the gateway can degrade ANSWER
  QUALITY instead of shedding: a :class:`BrownoutController` maps load
  pressure (queue depth, bucket age, deadline pressure) to an anytime
  quality level (0 = exact, 1..max = budgeted prefix inference with a
  concrete vote-margin error bound — see ``kernels/anytime.py``).  A
  quality-aware runner (one taking a ``quality`` keyword) receives the
  level per bucket and may return ``(preds, info)`` where ``info``
  carries the quality actually served and its ``err_bound``.  Degraded
  answers are still ANSWERS: the accounting invariant refines to
  ``offered == answered_exact + answered_degraded + shed_total`` and
  :meth:`Gateway.health` reports the quality-tier distribution.
  Escalation is immediate (one evaluation above an enter threshold);
  recovery steps down one level per evaluation with hysteresis
  (``exit[k] < enter[k]``), and a fault-independent low-pressure
  watchdog forces exact serving if the primary step-down path wedges.

Fault sites (``runtime/faults.py``): ``gateway.queue_overflow`` forces an
admission-time shed; ``gateway.drain_timeout`` forces the drain timer to
expire immediately; ``gateway.brownout_stuck`` pins the controller's
primary step-down path so the watchdog recovery is drilled.  All are
drilled in ``tests/test_gateway.py`` and under live Poisson load in
``benchmarks/serve_gateway.py --chaos``.

Execution is serialized through a single worker thread: the engines are
device callables whose per-bucket wall-time is the unit of straggler/
deadline attribution, and the event loop stays free to admit, age-flush,
and shed while a bucket is on the accelerator.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import inspect
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.runtime import faults

# Typed shed reasons: the closed vocabulary of ways the gateway refuses
# work.  Every non-answer carries exactly one of these — "silently
# dropped" is not in the list by construction.
QUEUE_FULL = "queue_full"            # admission: bounded queue at capacity
SHUTTING_DOWN = "shutting_down"      # admission: drain already started
DEADLINE_EXPIRED = "deadline_expired"  # dequeue: request deadline passed
DRAIN_TIMEOUT = "drain_timeout"      # drain: still queued when timer expired
ENGINE_FAILED = "engine_failed"      # execution: runner raised (untyped)
# The built-in vocabulary; runner exceptions extend it via a
# ``shed_reason`` attribute (zoo: tenant_quarantined, load_failed), so
# shed counters are an OPEN dict keyed by whatever reasons actually fired.
SHED_REASONS = (QUEUE_FULL, SHUTTING_DOWN, DEADLINE_EXPIRED, DRAIN_TIMEOUT,
                ENGINE_FAILED)


@dataclasses.dataclass
class Response:
    """Terminal outcome of one request: answered or typed-shed.

    ``quality`` is the anytime level the answer was served at (0 = exact
    full-schedule inference); a degraded answer (``quality > 0``) carries
    the concrete vote-margin ``err_bound`` it was computed under.
    """
    tenant: str
    ok: bool
    pred: Optional[int] = None
    reason: Optional[str] = None
    latency_s: float = 0.0
    quality: int = 0
    err_bound: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Hysteresis thresholds for the brownout controller.

    ``enter[k-1]`` is the pressure at which level ``k`` is entered;
    ``exit[k-1]`` the pressure below which level ``k`` steps down one
    level.  ``exit[k] < enter[k]`` gives the hysteresis band that stops
    the controller from flapping around a threshold.  ``watchdog_evals``
    consecutive evaluations below ``exit[0]`` force level 0 through a
    path that does NOT consult the primary step-down logic — the
    recovery drilled by the ``gateway.brownout_stuck`` fault site.
    """
    max_level: int = 3
    enter: tuple = (0.5, 0.7, 0.85)
    exit: tuple = (0.3, 0.5, 0.65)
    watchdog_evals: int = 8


class BrownoutController:
    """Maps load pressure to an anytime quality level with hysteresis.

    Pressure is the worst of three normalized signals — queue occupancy,
    oldest-bucket age (relative to 4x the age-flush window), and the
    flushed bucket's deadline pressure (fraction of its tightest
    deadline already elapsed) — clipped to [0, 1].  Escalation is
    immediate: one evaluation at/above ``enter[k-1]`` jumps straight to
    level ``k``.  Recovery is deliberate: one level per evaluation once
    pressure drops below the current level's exit threshold.
    """

    def __init__(self, config: Optional[BrownoutConfig] = None):
        self.cfg = config or BrownoutConfig()
        self.level = 0
        self.escalations = 0
        self.stepdowns = 0
        self.watchdog_resets = 0
        self.evals = 0
        self._calm = 0    # consecutive evaluations below exit[0]

    @staticmethod
    def pressure(*, pending: int, max_queue: Optional[int],
                 oldest_age: float, max_wait: float,
                 deadline_frac: float = 0.0) -> float:
        terms = [float(deadline_frac)]
        if max_queue:
            terms.append(pending / max_queue)
        if max_wait > 0:
            terms.append(oldest_age / (4.0 * max_wait))
        return min(max(max(terms), 0.0), 1.0)

    def update(self, pressure: float) -> int:
        """Fold one pressure sample; returns the quality level to serve."""
        cfg = self.cfg
        self.evals += 1
        self._calm = self._calm + 1 if pressure < cfg.exit[0] else 0
        target = 0
        for k in range(cfg.max_level, 0, -1):
            if pressure >= cfg.enter[k - 1]:
                target = k
                break
        if target > self.level:
            self.level = target
            self.escalations += 1
            return self.level
        if self.level > 0 and self._calm >= cfg.watchdog_evals:
            # fault-independent recovery: sustained calm forces exact
            # serving even when the primary step-down path is wedged
            self.level = 0
            self.watchdog_resets += 1
            self._calm = 0
            return self.level
        if (self.level > 0 and pressure < cfg.exit[self.level - 1]
                and not faults.fire_if("gateway.brownout_stuck")):
            self.level -= 1
            self.stepdowns += 1
        return self.level

    def health(self) -> dict:
        return dict(level=self.level, evals=self.evals,
                    escalations=self.escalations, stepdowns=self.stepdowns,
                    watchdog_resets=self.watchdog_resets)


@dataclasses.dataclass
class _Request:
    tenant: str
    x: np.ndarray
    t_submit: float
    deadline: Optional[float]            # absolute clock() time, or None
    future: "asyncio.Future[Response]"


class Gateway:
    """Async request gateway over a per-tenant bucket runner.

    ``runner(tenant, rows)`` executes one bucket: ``rows`` is a non-empty
    list of request payloads (each an ``(W,)`` array) and the return value
    is the ``(len(rows),)`` prediction array.  The runner owns padding to
    its fixed bucket shape, engine-ladder demotion, and straggler accounting;
    it raises to reject the whole bucket (typed via a ``shed_reason``
    attribute on the exception, else ``engine_failed``).

    A quality-aware runner additionally accepts a ``quality`` keyword
    (the brownout controller's level for this bucket) and may return
    ``(preds, info)`` where ``info`` is a dict with the quality actually
    served (``quality``) and its vote-margin ``err_bound``.  A plain
    runner under brownout keeps serving exact — degradation is opt-in.
    """

    def __init__(self, runner: Callable, *, bucket: int = 128,
                 max_queue: Optional[int] = None, max_wait: float = 0.02,
                 drain_timeout: float = 5.0, clock=time.monotonic,
                 mirror: Optional[Callable] = None,
                 brownout: Optional[BrownoutController] = None):
        self._runner = runner
        self._brownout = brownout
        try:
            self._runner_quality = "quality" in inspect.signature(
                runner).parameters
        except (TypeError, ValueError):   # builtins / C callables
            self._runner_quality = False
        # shadow-canary tap: ``mirror(tenant, rows, preds)`` observes a
        # successfully-answered bucket (worker thread, AFTER the serving
        # predictions are computed).  It must never affect the answer: any
        # exception is swallowed and counted, never shed
        self._mirror = mirror
        self.mirrored = 0
        self.mirror_failures = 0
        self.bucket = int(bucket)
        self.max_queue = max_queue if max_queue and max_queue > 0 else None
        self.max_wait = float(max_wait)
        self.drain_timeout = float(drain_timeout)
        self._clock = clock
        self._queues: Dict[str, collections.deque] = {}
        self._pending = 0
        self._inflight = 0
        self._draining = False
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._idle: Optional[asyncio.Event] = None
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="gw-exec")
        # -- accounting: offered == answered_exact + answered_degraded
        #    + sum(shed.values()) always (answered = exact + degraded) --
        self.offered = 0
        self.admitted = 0
        self.answered = 0
        self.answered_exact = 0
        self.answered_degraded = 0
        self.quality_tiers: Dict[int, int] = {}
        self.shed: Dict[str, int] = {}
        self.buckets = 0
        self.flushes = {"full": 0, "age": 0, "drain": 0}
        self.tenants: Dict[str, dict] = {}
        self._latencies: List[float] = []

    # -- admission -----------------------------------------------------------

    def _tenant_row(self, tenant: str) -> dict:
        row = self.tenants.get(tenant)
        if row is None:
            row = self.tenants[tenant] = dict(offered=0, answered=0, shed={})
        return row

    def _resolve(self, req: _Request, resp: Response) -> None:
        if req.future.done():        # already rejected (e.g. drain sweep)
            return
        row = self._tenant_row(req.tenant)
        if resp.ok:
            self.answered += 1
            row["answered"] += 1
            q = int(resp.quality)
            self.quality_tiers[q] = self.quality_tiers.get(q, 0) + 1
            if q == 0:
                self.answered_exact += 1
            else:
                self.answered_degraded += 1
            self._latencies.append(resp.latency_s)
        else:
            self.shed[resp.reason] = self.shed.get(resp.reason, 0) + 1
            row["shed"][resp.reason] = row["shed"].get(resp.reason, 0) + 1
        req.future.set_result(resp)

    def _shed_at_admission(self, tenant: str, reason: str,
                           fut: "asyncio.Future[Response]") -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        row = self._tenant_row(tenant)["shed"]
        row[reason] = row.get(reason, 0) + 1
        fut.set_result(Response(tenant=tenant, ok=False, reason=reason))

    def offer(self, tenant: str, x, deadline: Optional[float] = None
              ) -> "asyncio.Future[Response]":
        """Admit (or typed-shed) one request; returns a Future[Response].

        Must be called on the event-loop thread.  ``deadline`` is seconds
        from now; a request still queued when it expires is rejected
        ``deadline_expired`` at dequeue time.
        """
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        now = self._clock()
        self.offered += 1
        self._tenant_row(tenant)["offered"] += 1
        if self._draining:
            self._shed_at_admission(tenant, SHUTTING_DOWN, fut)
            return fut
        over = self.max_queue is not None and self._pending >= self.max_queue
        if over or faults.fire_if("gateway.queue_overflow"):
            self._shed_at_admission(tenant, QUEUE_FULL, fut)
            return fut
        self.admitted += 1
        req = _Request(tenant=tenant, x=x, t_submit=now,
                       deadline=None if deadline is None else now + deadline,
                       future=fut)
        self._queues.setdefault(tenant, collections.deque()).append(req)
        self._pending += 1
        if self._idle is not None:
            self._idle.clear()
        if self._wake is not None:
            self._wake.set()
        return fut

    async def submit(self, tenant: str, x,
                     deadline: Optional[float] = None) -> Response:
        return await self.offer(tenant, x, deadline)

    # -- dispatch ------------------------------------------------------------

    async def start(self) -> "Gateway":
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._task = asyncio.create_task(self._dispatch_loop())
        return self

    def _expire(self, now: float) -> None:
        """Shed queued requests whose deadline has already passed."""
        for q in self._queues.values():
            kept = [r for r in q if not (r.deadline is not None
                                         and r.deadline < now)]
            if len(kept) != len(q):
                for r in q:
                    if r.deadline is not None and r.deadline < now:
                        self._pending -= 1
                        self._resolve(r, Response(
                            tenant=r.tenant, ok=False,
                            reason=DEADLINE_EXPIRED,
                            latency_s=now - r.t_submit))
                q.clear()
                q.extend(kept)

    def _pick_flush(self, now: float):
        """(tenant, cause) to flush now, or (None, earliest-age-due)."""
        due: Optional[float] = None
        for tenant, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self.bucket:
                return tenant, "full"
            if self._draining:
                return tenant, "drain"
            age_due = q[0].t_submit + self.max_wait
            if age_due <= now:
                return tenant, "age"
            due = age_due if due is None else min(due, age_due)
        return None, due

    def set_mirror(self, mirror: Optional[Callable]) -> None:
        """Install/remove the shadow tap (safe while serving: the tap is
        read once per bucket on the worker thread)."""
        self._mirror = mirror

    def _run_bucket(self, tenant: str, rows, quality: int = 0):
        """Worker-thread bucket execution + best-effort shadow mirror.

        Returns ``(preds, info)`` where ``info`` records the quality the
        bucket was actually served at (a runner may serve BETTER than
        requested — e.g. a dense fallback is always exact) and, for
        degraded service, the concrete error bound.
        """
        if self._runner_quality:
            out = self._runner(tenant, rows, quality=quality)
        else:
            out = self._runner(tenant, rows)
        if (isinstance(out, tuple) and len(out) == 2
                and isinstance(out[1], dict)):
            preds, info = out
        else:
            preds, info = out, {}
        info = dict(quality=int(info.get("quality", 0)),
                    err_bound=info.get("err_bound"))
        mirror = self._mirror
        if mirror is not None:
            try:
                mirror(tenant, rows, preds)
                self.mirrored += 1
            except Exception:  # noqa: BLE001 — the tap must never shed
                self.mirror_failures += 1
        return preds, info

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = self._clock()
            self._expire(now)
            tenant, cause = self._pick_flush(now)
            if tenant is None:
                if self._pending == 0 and self._inflight == 0:
                    self._idle.set()
                self._wake.clear()
                timeout = None if cause is None else max(cause - now, 0.0)
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
                continue
            q = self._queues[tenant]
            reqs = [q.popleft() for _ in range(min(self.bucket, len(q)))]
            self._pending -= len(reqs)
            self._inflight += len(reqs)
            self.flushes[cause] += 1
            self.buckets += 1
            quality = self._brownout_level(reqs, now)
            try:
                preds, info = await loop.run_in_executor(
                    self._pool, self._run_bucket, tenant,
                    [r.x for r in reqs], quality)
            except Exception as e:  # noqa: BLE001 — typed bucket rejection
                reason = getattr(e, "shed_reason", ENGINE_FAILED)
                end = self._clock()
                for r in reqs:
                    self._resolve(r, Response(
                        tenant=tenant, ok=False, reason=reason,
                        latency_s=end - r.t_submit))
            else:
                preds = np.asarray(preds)
                end = self._clock()
                served_q = info["quality"]
                bound = info["err_bound"] if served_q else None
                for i, r in enumerate(reqs):
                    self._resolve(r, Response(
                        tenant=tenant, ok=True, pred=int(preds[i]),
                        latency_s=end - r.t_submit,
                        quality=served_q, err_bound=bound))
            finally:
                self._inflight -= len(reqs)

    def _brownout_level(self, reqs, now: float) -> int:
        """Quality level for the bucket about to run (0 when disabled)."""
        if self._brownout is None:
            return 0
        frac = 0.0
        for r in reqs:
            if r.deadline is not None and r.deadline > r.t_submit:
                frac = max(frac, (now - r.t_submit)
                           / (r.deadline - r.t_submit))
        oldest = 0.0
        for q in self._queues.values():
            if q:
                oldest = max(oldest, now - q[0].t_submit)
        p = BrownoutController.pressure(
            pending=self._pending, max_queue=self.max_queue,
            oldest_age=oldest, max_wait=self.max_wait, deadline_frac=frac)
        return self._brownout.update(p)

    # -- drain / shutdown ----------------------------------------------------

    async def drain(self, timeout: Optional[float] = None) -> dict:
        """Stop admitting, flush what fits in the window, shed the rest.

        Returns the final health dict.  Idempotent enough for the common
        SIGTERM-then-natural-completion race: a second call finds empty
        queues and returns immediately.
        """
        self._draining = True
        if self._wake is not None:
            self._wake.set()
        timeout = self.drain_timeout if timeout is None else timeout
        if faults.fire_if("gateway.drain_timeout"):
            timeout = 0.0
        if self._idle is not None:
            try:
                await asyncio.wait_for(self._idle.wait(), timeout)
            except asyncio.TimeoutError:
                now = self._clock()
                for q in self._queues.values():
                    while q:
                        r = q.popleft()
                        self._pending -= 1
                        self._resolve(r, Response(
                            tenant=r.tenant, ok=False, reason=DRAIN_TIMEOUT,
                            latency_s=now - r.t_submit))
                # an in-flight bucket still completes (its futures resolve
                # normally); wait for it so shutdown never abandons work
                await self._idle.wait()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        self._pool.shutdown(wait=True)
        return self.health()

    # -- health --------------------------------------------------------------

    def health(self) -> dict:
        """GATEWAY_HEALTH: full accounting — ``unaccounted`` must be 0."""
        lat = np.sort(np.asarray(self._latencies)) * 1e3
        pct = (lambda p: float(lat[min(int(len(lat) * p / 100),
                                       len(lat) - 1)]) if len(lat) else None)
        shed_total = sum(self.shed.values())
        return dict(
            offered=self.offered, admitted=self.admitted,
            answered=self.answered,
            answered_exact=self.answered_exact,
            answered_degraded=self.answered_degraded,
            quality_tiers={str(k): v for k, v in
                           sorted(self.quality_tiers.items())},
            brownout=(None if self._brownout is None
                      else self._brownout.health()),
            shed={k: v for k, v in self.shed.items() if v},
            shed_total=shed_total,
            unaccounted=(self.offered - self.answered_exact
                         - self.answered_degraded - shed_total),
            buckets=self.buckets, bucket_size=self.bucket,
            flushes=dict(self.flushes),
            queue_depth=self._pending, draining=self._draining,
            mirrored=self.mirrored, mirror_failures=self.mirror_failures,
            latency_ms=dict(p50=pct(50), p99=pct(99)),
            tenants={
                t: dict(offered=row["offered"], answered=row["answered"],
                        shed={k: v for k, v in row["shed"].items() if v})
                for t, row in self.tenants.items()},
        )
