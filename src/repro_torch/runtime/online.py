"""Online-learning service: stream feedback, drift-track, hot-swap safely
(the reference's updater, with the live bank on the card).

MATADOR compiles a *frozen* TM; this module closes the train→compile→serve
loop (grounded in "An FPGA Architecture for Online Learning
using the Tsetlin Machine"): labeled feedback streams into a live automata
bank beside the serving artifact, fused-train steps update it, and when the
bank's include bits have drifted far enough from what is deployed, the
updater rebuilds and — robustly — promotes a successor artifact.

Promotion is a pipeline, not an assignment:

1. **Drift tracking** — every accepted feedback batch runs one
   ``train.online_step``; the bank's dense packed include words are
   compared against the anchor snapshot taken at the last compile
   (``compiler.include_drift``).  Crossing ``drift_threshold`` arms a
   rebuild.
2. **Incremental recompile** — ``compiler.incremental_recompile`` reuses
   the previous artifact's chain-schedule rows for clauses that did not
   move and falls back to a full ``compile_tm`` on layout changes.  The
   ``online.rebuild_fail`` fault site fires here: a failed rebuild keeps
   the deployed artifact serving and retries at the next drift check.
3. **Integrity envelope** — the candidate is saved and re-loaded through
   the artifact path (atomic write, sha256 checksum,
   ``validate_artifact``), which also materializes both default schedules;
   the candidate's tables and both default schedules' tables are then put
   on the bank's device, so the swap installs a pre-warmed artifact.
4. **Shadow canary** — the gateway's mirror tap replays a sampled
   fraction of live buckets against the candidate (``canary_frac``) and
   compares predictions bucket-for-bucket with the serving artifact.
   Agreement below ``canary_agreement`` after ``canary_min`` mirrored
   buckets fails the canary: the candidate is discarded and the tenant's
   circuit breaker is tripped (``swap_policy="immediate"`` skips this
   phase).
5. **Atomic swap** — ``zoo.swap`` commits the candidate with a single
   assignment under the zoo lock: in-flight leases finish on the old
   version, new admissions route to the new one, and the gateway's
   ``offered == answered + shed`` invariant is untouched.  The
   ``zoo.swap_abort`` drill proves an aborted swap leaves the old entry
   serving, bit-intact.
6. **Post-swap watch + rollback** — deployed-artifact accuracy on the
   labeled feedback stream (and optionally a bucket-latency EWMA via
   :meth:`OnlineUpdater.record_bucket_latency`) is tracked across the
   swap; a regression swaps the RETAINED previous object back (bit-exact)
   and trips the breaker.

Feedback hygiene: :meth:`OnlineUpdater.ingest` validates every record
(shape, label range) before it can touch the bank — the
``online.feedback_corrupt`` site corrupts a record *pre-validation* and
the drill asserts it is rejected, never trained on.  SIGTERM drains the
pending feedback queue through the checkpoint path
(:meth:`OnlineUpdater.drain`), and a restarted updater re-ingests it.

**The bank.**  The live bank is an int8 tensor on its device, stepped by
``train.online_step`` (on a CUDA device the fused kernels, ``fused_infer``
then ``fused_train``; on the CPU their plain versions), which leaves the
previous bank as it was (rollback and the drain checkpoint need it).  The
drift snapshot is packed on the device and compared on the host; the
drain checkpoint holds numpy in the reference's layout, so a drain written
by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import compiler, packetizer, tm
from repro_torch.runtime import faults

IDLE, CANARY = "idle", "canary"


@dataclasses.dataclass
class OnlineConfig:
    """Policy knobs of the updater (CLI: ``launch/serve.py --online``)."""

    drift_threshold: float = 0.05     # include-bit drift arming a rebuild
    batch_size: int = 64              # feedback batch (one training step)
    max_pending: int = 4096           # feedback queue bound (typed drops)
    canary_frac: float = 0.25         # fraction of live buckets mirrored
    canary_min: int = 4               # mirrored buckets before a verdict
    canary_agreement: float = 0.98    # pass bar: candidate-vs-serving match
    swap_policy: str = "canary"       # "canary" | "immediate"
    regression_window: int = 4        # feedback batches per accuracy window
    regression_drop: float = 0.2      # post-swap accuracy drop -> rollback
    latency_factor: float = 3.0       # post-swap latency blow-up -> rollback
    latency_warmup: int = 3           # post-swap buckets exempt from the
                                      # watch (rebound engines rebuild)


class FeedbackQueue:
    """Bounded, thread-safe labeled-feedback buffer.

    Producers (the serving loop, a label joiner) call :meth:`put` from any
    thread; the updater pops full training batches.  Overflow drops are
    COUNTED (``dropped_overflow``) — feedback is best-effort by nature,
    but the accounting never lies about it.
    """

    def __init__(self, max_pending: int = 4096):
        self.max_pending = int(max_pending)
        self._lock = threading.Lock()
        self._x: List[np.ndarray] = []
        self._y: List[int] = []
        self.accepted = 0
        self.dropped_overflow = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._y)

    def put(self, x: np.ndarray, y: int) -> bool:
        with self._lock:
            if len(self._y) >= self.max_pending:
                self.dropped_overflow += 1
                return False
            self._x.append(x)
            self._y.append(int(y))
            self.accepted += 1
            return True

    def pop_batch(self, n: int):
        """A full ``n``-record batch, or None when fewer are pending
        (partial batches stay queued: one batch shape for every step)."""
        with self._lock:
            if len(self._y) < n:
                return None
            xs, self._x = self._x[:n], self._x[n:]
            ys, self._y = self._y[:n], self._y[n:]
        return np.stack(xs), np.asarray(ys, np.int32)

    def snapshot_and_clear(self):
        """Everything pending (for the SIGTERM-drain checkpoint)."""
        with self._lock:
            xs, ys = self._x, self._y
            self._x, self._y = [], []
        if not ys:
            return None, None
        return np.stack(xs), np.asarray(ys, np.int32)


class OnlineUpdater:
    """The streaming train→compile→canary→swap engine for ONE tenant.

    ``ta_state`` is the live bank, an int8 tensor: it stays on its device
    (on the CPU the kernels' plain versions step it).
    ``make_obj(compiled) -> (obj, nbytes)`` builds the zoo entry the
    serving layer wants (runner closure, engine plan, ...);
    ``serve_fn(obj, rows) -> preds`` executes one bucket of packed int32
    rows against such an object — the same callable the zoo runner uses,
    reused here to run the candidate side of the shadow canary and the
    accuracy watch.  ``zoo``/``tenant`` are the serving cache to swap
    under; ``ckpt_manager`` (optional) is the checkpoint path the SIGTERM
    drain writes through — when its directory already holds a checkpoint,
    construction resumes from it (bank + pending feedback).
    """

    def __init__(self, config: tm.TMConfig, ta_state, deployed, *,
                 cfg: Optional[OnlineConfig] = None,
                 zoo=None, tenant: str = "t0",
                 make_obj: Optional[Callable] = None,
                 serve_fn: Optional[Callable] = None,
                 deployed_obj=None, deployed_nbytes: int = 0,
                 ckpt_manager=None, artifact_dir: Optional[str] = None,
                 on_promote: Optional[Callable] = None,
                 clock=time.monotonic):
        if not isinstance(ta_state, torch.Tensor):
            raise TypeError("the live bank must be an int8 tensor on its device, "
                            f"got {type(ta_state).__name__}")
        self.config = config
        self.cfg = cfg or OnlineConfig()
        if self.cfg.swap_policy not in ("canary", "immediate"):
            raise ValueError(
                f"swap_policy must be 'canary' or 'immediate', "
                f"got {self.cfg.swap_policy!r}")
        self.zoo = zoo
        self.tenant = tenant
        self.make_obj = make_obj or self._default_make_obj
        self.serve_fn = serve_fn or self._default_serve
        self._clock = clock
        self._ckpt = ckpt_manager
        self._artifact_dir = artifact_dir
        # on_promote(compiled) fires AFTER the zoo commit (and after a
        # rollback re-commit) so the serving layer can rebind anything
        # outside the zoo — e.g. serve.py's engine ladder — to the newly
        # deployed artifact
        self._on_promote = on_promote
        self.queue = FeedbackQueue(self.cfg.max_pending)
        self._lock = threading.RLock()

        self._ta = ta_state
        self._dev = ta_state.device
        self.deployed = deployed
        self._deployed_obj = deployed_obj
        self._deployed_nbytes = int(deployed_nbytes)
        # drift anchor: the dense include snapshot of the bank the
        # DEPLOYED artifact was compiled from
        self._anchor = compiler.dense_include_words(config, self._ta)
        self.gstep = 0

        # canary state
        self.state = IDLE
        self._candidate = None
        self._cand_obj = None
        self._cand_nbytes = 0
        self._canary_buckets = 0
        self._canary_agree = 0
        self._canary_total = 0
        self._mirror_count = 0
        # rollback state
        self._previous = None         # (compiled, obj, nbytes) pre-swap
        self._acc_window: List[float] = []
        self._acc_at_promote: Optional[float] = None
        self._lat_ewma: Optional[float] = None
        self._lat_at_promote: Optional[float] = None
        self._lat_warmup = 0
        self._drift_crossed_at: Optional[float] = None

        # telemetry
        self.ingested = 0
        self.rejected_corrupt = 0
        self.steps = 0
        self.rebuilds = 0
        self.rebuild_failures = 0
        self.incremental_rebuilds = 0
        self.full_rebuilds = 0
        self.canary_passes = 0
        self.canary_failures = 0
        self.promotions = 0
        self.swap_aborts = 0
        self.rollbacks: List[dict] = []
        self.last_drift = 0.0
        self.drift_to_promotion_ms: List[float] = []
        # the rebuilds' schedule reuse, in the order they ran
        self.rebuild_info: List[dict] = []

        if self._ckpt is not None and self._ckpt.latest_step() is not None:
            self._resume()

    @property
    def bank(self) -> torch.Tensor:
        """The live int8 bank, on its device."""
        return self._ta

    # -- defaults ------------------------------------------------------------

    @staticmethod
    def _artifact_nbytes(compiled) -> int:
        return (compiled.include_words.nbytes + compiled.word_ids.nbytes
                + compiled.votes.nbytes)

    def _default_make_obj(self, compiled):
        return {"compiled": compiled}, self._artifact_nbytes(compiled)

    def _default_serve(self, obj, rows):
        xw = packetizer.words_to_tensor(np.stack([np.asarray(r) for r in rows]),
                                        self._dev)
        sums = compiler.run_compiled(obj["compiled"], xw)
        return sums.argmax(-1).cpu().numpy()

    # -- feedback ingest -----------------------------------------------------

    def ingest(self, x, y) -> bool:
        """Validate one labeled feedback record and queue it.

        The ``online.feedback_corrupt`` site corrupts the record BEFORE
        validation — the drill for "a corrupt record is rejected and
        counted, never trained on".  Returns True when accepted.
        """
        x = np.asarray(x)
        y = int(y)
        if faults.fire_if("online.feedback_corrupt"):
            y = self.config.n_classes + 1_000_000      # wild label
        if x.shape != (self.config.n_features,):
            self.rejected_corrupt += 1
            return False
        if not (0 <= y < self.config.n_classes):
            self.rejected_corrupt += 1
            return False
        if not self.queue.put(x.astype(np.uint8), y):
            return False
        self.ingested += 1
        return True

    # -- training + drift ----------------------------------------------------

    def step(self) -> bool:
        """Train on ONE full pending feedback batch (if any), update the
        drift/accuracy trackers, and advance the promotion pipeline.
        Returns True when a batch was consumed."""
        from repro_torch.core import train

        batch = self.queue.pop_batch(self.cfg.batch_size)
        if batch is None:
            self._check_regression()
            return False
        xb, yb = batch
        with self._lock:
            self._track_accuracy(xb, yb)
            self._ta, _ = train.online_step(
                self.config, self._ta, torch.from_numpy(xb).to(self._dev),
                torch.from_numpy(yb).to(self._dev), self.gstep)
            self.gstep += 1
            self.steps += 1

            drift = compiler.include_drift(
                self._anchor,
                compiler.dense_include_words(self.config, self._ta))
            self.last_drift = drift.drift
            if (self.state == IDLE
                    and drift.drift >= self.cfg.drift_threshold):
                if self._drift_crossed_at is None:
                    self._drift_crossed_at = self._clock()
                self._rebuild()
            self._check_regression()
        return True

    def _track_accuracy(self, xb, yb) -> None:
        """Deployed-artifact accuracy on the labeled feedback stream —
        the post-swap regression signal (labels are right here; no extra
        eval traffic needed)."""
        obj = self._deployed_obj
        if obj is None:
            preds = self._default_serve({"compiled": self.deployed},
                                        list(self._pack(xb)))
        else:
            try:
                preds = np.asarray(self.serve_fn(obj, list(self._pack(xb))))
            except Exception:
                return                      # serving trouble is not signal
        acc = float((preds == yb).mean())
        self._acc_window.append(acc)
        if len(self._acc_window) > self.cfg.regression_window:
            self._acc_window.pop(0)

    @staticmethod
    def _pack(xb) -> np.ndarray:
        """(B, F) features -> (B, W) packed literal words as int32 bit
        patterns, the rows the gateway hands a runner."""
        lits = np.concatenate([xb, 1 - xb], axis=1).astype(np.uint8)
        return packetizer.pack_bits_np(lits).view(np.int32)

    # -- rebuild + integrity -------------------------------------------------

    def _rebuild(self) -> None:
        """Drift crossed: build + validate a candidate, start its canary."""
        try:
            faults.raise_if("online.rebuild_fail")
            candidate, info = compiler.incremental_recompile(
                self.config, self._ta, self.deployed)
            candidate = self._integrity_roundtrip(candidate)
        except Exception as e:  # noqa: BLE001 — keep serving the old artifact
            self.rebuild_failures += 1
            print(f"online: rebuild failed ({type(e).__name__}: {e}); "
                  "still serving the deployed artifact, will retry")
            return
        self.rebuilds += 1
        self.rebuild_info.append(info)
        if info["mode"] == "incremental":
            self.incremental_rebuilds += 1
        else:
            self.full_rebuilds += 1
        obj, nbytes = self.make_obj(candidate)
        self._candidate = candidate
        self._cand_obj = obj
        self._cand_nbytes = int(nbytes)
        # fresh anchor candidate: the bank the candidate was compiled from
        self._cand_anchor = compiler.dense_include_words(
            self.config, self._ta)
        if self.cfg.swap_policy == "immediate":
            self._promote()
        else:
            self.state = CANARY
            self._canary_buckets = 0
            self._canary_agree = 0
            self._canary_total = 0

    def _integrity_roundtrip(self, candidate):
        """The artifact envelope: atomic save + checksum/validate re-load.
        Also places on the bank's device what ``run_compiled(engine="auto")``
        reads there, so the promoted artifact's first bucket builds
        nothing."""
        d = self._artifact_dir or tempfile.mkdtemp(prefix="online-cand-")
        os.makedirs(d, exist_ok=True)
        path = candidate.save(os.path.join(
            d, f"candidate-{self.tenant}-{self.gstep}.npz"))
        loaded = compiler.CompiledTM.load(path)
        if self._artifact_dir is None:
            try:
                os.unlink(path)
                os.rmdir(d)
            except OSError:
                pass
        # keep the incrementally-built schedule objects (equal to the
        # loaded ones, already memoized) + carried-over tunings; the
        # roundtrip's job was verification
        candidate.features = loaded.features or candidate.features
        compiler.place(candidate, self._dev)
        return candidate

    # -- shadow canary -------------------------------------------------------

    def mirror(self, tenant: str, rows, preds) -> None:
        """Gateway mirror tap: replay a sampled bucket on the candidate.

        Deterministic sampling (every ``round(1/canary_frac)``-th bucket)
        keeps drills reproducible.  Called on the gateway worker thread;
        exceptions are swallowed by the gateway (counted, never shed).
        """
        if tenant != self.tenant:
            return
        with self._lock:
            if self.state != CANARY or self._cand_obj is None:
                return
            self._mirror_count += 1
            stride = max(1, int(round(1.0 / max(self.cfg.canary_frac,
                                                1e-9))))
            if (self._mirror_count - 1) % stride != 0:
                return
            cand = np.asarray(self.serve_fn(self._cand_obj, rows))
            serving = np.asarray(preds)
            self._canary_agree += int((cand == serving).sum())
            self._canary_total += int(serving.shape[0])
            self._canary_buckets += 1
            if self._canary_buckets >= self.cfg.canary_min:
                self._finish_canary()

    @property
    def canary_agreement(self) -> float:
        if self._canary_total == 0:
            return 1.0
        return self._canary_agree / self._canary_total

    def _finish_canary(self) -> None:
        if self.canary_agreement >= self.cfg.canary_agreement:
            self.canary_passes += 1
            self._promote()
        else:
            self.canary_failures += 1
            print(f"online: canary FAILED for {self.tenant!r} "
                  f"(agreement {self.canary_agreement:.3f} < "
                  f"{self.cfg.canary_agreement}); discarding candidate "
                  "and tripping the breaker")
            self._discard_candidate()
            if self.zoo is not None:
                self.zoo.trip(self.tenant)

    def _discard_candidate(self) -> None:
        self.state = IDLE
        self._candidate = None
        self._cand_obj = None
        self._cand_nbytes = 0
        self._drift_crossed_at = None

    # -- promotion / rollback ------------------------------------------------

    def _promote(self) -> None:
        """Commit the candidate via the zoo's atomic swap."""
        from repro_torch.runtime import zoo as zoo_mod

        candidate, obj, nbytes = (self._candidate, self._cand_obj,
                                  self._cand_nbytes)
        if self.zoo is not None:
            try:
                self.zoo.swap(self.tenant, obj, nbytes)
            except zoo_mod.SwapAborted as e:
                self.swap_aborts += 1
                print(f"online: swap aborted for {self.tenant!r}: {e}; "
                      "the old artifact keeps serving")
                self._discard_candidate()
                return
        self._previous = (self.deployed, self._deployed_obj,
                          self._deployed_nbytes)
        self.deployed = candidate
        self._deployed_obj = obj
        self._deployed_nbytes = int(nbytes)
        self._anchor = self._cand_anchor
        self.promotions += 1
        if self._drift_crossed_at is not None:
            self.drift_to_promotion_ms.append(
                (self._clock() - self._drift_crossed_at) * 1e3)
        self._acc_at_promote = (float(np.mean(self._acc_window))
                                if self._acc_window else None)
        self._lat_at_promote = self._lat_ewma
        self._lat_warmup = self.cfg.latency_warmup
        self._acc_window = []
        self._discard_candidate()
        if self._on_promote is not None:
            self._on_promote(self.deployed)

    def record_bucket_latency(self, seconds: float) -> None:
        """Optional serving-side latency feed for the post-swap watch.

        The first ``latency_warmup`` buckets after a promotion are exempt:
        the swap rebinds the serving engines, and their rebuilds would
        otherwise read as a latency regression of the ARTIFACT."""
        with self._lock:
            if self._lat_warmup > 0:
                self._lat_warmup -= 1
                return
            a = 0.2
            self._lat_ewma = (seconds if self._lat_ewma is None
                              else (1 - a) * self._lat_ewma + a * seconds)

    def _check_regression(self) -> None:
        if self._previous is None:
            return
        if (self._acc_at_promote is not None
                and len(self._acc_window) >= self.cfg.regression_window):
            acc = float(np.mean(self._acc_window))
            if acc < self._acc_at_promote - self.cfg.regression_drop:
                self.rollback(
                    f"accuracy regression: {acc:.3f} < "
                    f"{self._acc_at_promote:.3f} - {self.cfg.regression_drop}")
                return
        if (self._lat_at_promote is not None and self._lat_ewma is not None
                and self._lat_ewma
                > self.cfg.latency_factor * max(self._lat_at_promote, 1e-9)):
            self.rollback(
                f"latency regression: ewma {self._lat_ewma * 1e3:.2f}ms > "
                f"{self.cfg.latency_factor}x pre-swap")

    def rollback(self, reason: str) -> None:
        """Swap the retained pre-promotion object back (bit-exact) and
        trip the tenant's breaker."""
        with self._lock:
            if self._previous is None:
                return
            prev_compiled, prev_obj, prev_nbytes = self._previous
            print(f"online: ROLLBACK for {self.tenant!r}: {reason}")
            if self.zoo is not None and prev_obj is not None:
                self.zoo.swap(self.tenant, prev_obj, prev_nbytes)
                self.zoo.trip(self.tenant)
            self.deployed = prev_compiled
            self._deployed_obj = prev_obj
            self._deployed_nbytes = prev_nbytes
            self._previous = None
            self._acc_at_promote = None
            self._lat_at_promote = None
            self._acc_window = []
            self.rollbacks.append(dict(reason=reason, gstep=self.gstep))
            if self._on_promote is not None:
                self._on_promote(self.deployed)
            # restart drift from the CURRENT live bank: the regressed
            # direction already accumulated once, so requiring a fresh
            # threshold crossing before the next rebuild acts as a
            # cooldown instead of immediately re-promoting the same bank
            self._anchor = compiler.dense_include_words(self.config, self._ta)

    # -- drain / resume (the checkpoint path) --------------------------------

    def drain(self) -> Optional[int]:
        """SIGTERM path: checkpoint the bank + every pending feedback
        record through the checkpoint store.  Returns the checkpointed
        step (None without a manager)."""
        if self._ckpt is None:
            return None
        with self._lock:
            xs, ys = self.queue.snapshot_and_clear()
            if xs is None:
                xs = np.zeros((0, self.config.n_features), np.uint8)
                ys = np.zeros((0,), np.int32)
            tree = {"ta": self._ta, "pending_x": xs, "pending_y": ys}
            extra = dict(gstep=self.gstep, ingested=self.ingested,
                         n_pending=int(ys.shape[0]),
                         rejected_corrupt=self.rejected_corrupt)
            self._ckpt.save(self.gstep, tree, extra=extra, blocking=True)
            return self.gstep

    def _resume(self) -> None:
        target = {"ta": self._ta,
                  "pending_x": np.zeros((0,), np.uint8),
                  "pending_y": np.zeros((0,), np.int32)}
        tree, extra = self._ckpt.restore(target)
        self._ta = tree["ta"]
        self.gstep = int(extra.get("gstep", 0))
        self.ingested = int(extra.get("ingested", 0))
        self.rejected_corrupt = int(extra.get("rejected_corrupt", 0))
        px, py = np.asarray(tree["pending_x"]), np.asarray(tree["pending_y"])
        for i in range(py.shape[0]):
            self.queue.put(px[i].astype(np.uint8), int(py[i]))
        self._anchor = compiler.dense_include_words(self.config, self._ta)
        print(f"online: resumed at gstep {self.gstep} with "
              f"{int(py.shape[0])} pending feedback records")

    # -- health --------------------------------------------------------------

    def health(self) -> dict:
        with self._lock:
            return dict(
                tenant=self.tenant, state=self.state, gstep=self.gstep,
                steps=self.steps, ingested=self.ingested,
                rejected_corrupt=self.rejected_corrupt,
                pending=len(self.queue),
                dropped_overflow=self.queue.dropped_overflow,
                drift=self.last_drift,
                rebuilds=self.rebuilds,
                rebuild_failures=self.rebuild_failures,
                incremental_rebuilds=self.incremental_rebuilds,
                full_rebuilds=self.full_rebuilds,
                canary=dict(buckets=self._canary_buckets,
                            agreement=self.canary_agreement,
                            passes=self.canary_passes,
                            failures=self.canary_failures),
                promotions=self.promotions,
                swap_aborts=self.swap_aborts,
                rollbacks=list(self.rollbacks),
                drift_to_promotion_ms=list(self.drift_to_promotion_ms),
            )
