"""Engine selection and dispatch over the port's inference kernels.

``EngineSpec`` names an engine, ``EngineLadder`` degrades through engines
on failure, and the ``tm_forward_*`` functions run one compiled artifact
through one kernel: the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors.  Each calls ``faults.raise_if("kernel.<engine>")``
first, so the reference's ladder and chaos drills apply unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_infer as _fused_infer_kernel
from repro_torch.kernels import sparse_infer as _sparse_infer_kernel
from repro_torch.kernels import term_infer as _term_infer_kernel
from repro_torch.runtime import faults


def kernel_dispatch(x: torch.Tensor) -> bool:
    """Whether ``engine="auto"`` takes the kernel path for input ``x``: it
    does whenever the tensor lives on a CUDA device."""
    return x.is_cuda


def _ready(out):
    """Block until a CUDA result is computed, so a fault surfaces in the
    engine call that caused it (``torch.cuda`` calls return early)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


ENGINE_NAMES = ("auto", "factorized", "sparse", "dense", "oracle")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One inference-engine selection, in the :class:`EngineLadder` level
    vocabulary:

    * ``"auto"`` — the factorized kernel when the artifact's measured term
      sharing clears ``compiler.FACTORIZE_SHARING_THRESHOLD``, else the
      sparse one, for CUDA inputs; the oracle for CPU inputs.
    * ``"factorized"`` — the two-level shared-term schedule kernel.
    * ``"sparse"`` — the flat block-sparse chain schedule kernel.
    * ``"dense"`` — the fused dense kernel.
    * ``"oracle"`` — the plain PyTorch reference path.

    The named kernel engines run their plain versions on CPU inputs.
    """

    name: str = "auto"

    def __post_init__(self):
        if self.name not in ENGINE_NAMES:
            raise ValueError(
                f"unknown engine {self.name!r}; one of {ENGINE_NAMES}")

    @classmethod
    def coerce(cls, spec) -> "EngineSpec":
        """``None`` -> auto; a level-name string -> that engine; an
        ``EngineSpec`` passes through."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(name=spec)
        raise TypeError(
            f"engine must be an EngineSpec or one of {ENGINE_NAMES}, "
            f"got {type(spec).__name__}")


class EngineLadder:
    """Degradation ladder over inference engines (serve fault tolerance).

    ``engines`` is an ordered ``[(name, builder)]`` list, preferred engine
    first; ``builder()`` returns the engine's callable and is invoked
    lazily, so engines the ladder never reaches pay nothing.  :meth:`run` executes the current
    engine on a *fresh* input from ``make_input`` (re-invoked per attempt
    so a retry never reuses a buffer a failed call may have written),
    synchronizes the device before it returns so asynchronous CUDA
    failures surface here, on the bucket that caused them, and on any
    exception — a kernel launch error, an injected fault in a drill —
    demotes one level and retries the same input.  Only the LAST engine's
    failure propagates: the run degrades instead of crashing.  The one
    exception is ``_build.KernelBuildError``: kernels that cannot be built
    are missing, not failing, and serving on without them would hide that,
    so it propagates from any level and from a probe.  ``counts``/``demotions`` feed the serve
    health summary (which engine actually served each bucket).

    **Re-promotion** (``promote_after=N``): a demotion is not a life
    sentence — after ``N`` consecutive healthy buckets at the current
    level, the next :meth:`run` serves its bucket as a PROBE on the engine
    one level up.  A successful probe promotes (the probe bucket IS served
    by the higher engine, so probing costs nothing extra); a failed probe
    falls back to the current engine for the same input, resets the
    healthy streak, and DOUBLES the cooldown (the streak required before
    the next probe) — a permanent fault converges to exponentially-rare
    probes while a transient one no longer pins the tenant on the slow
    oracle forever.  A demotion resets both streak and cooldown to base.
    ``promote_after=None`` (default) keeps the demote-only behavior.
    ``promotions``/``probe_failures`` feed the health summary alongside
    ``demotions``.

    **Anytime quality** (brownout serving): :meth:`run` takes a
    ``quality`` level.  Engines whose built callable is marked
    ``supports_quality = True`` (an attribute the builder sets on the
    closure) are invoked ``fn(x, quality)`` and serve the budgeted tile
    prefix; every other engine serves exact.  ``last_quality`` reports
    what the serving engine actually delivered (0 = exact) so the caller
    can attribute the answer — a ladder demoted to the dense or oracle
    engine keeps serving exact answers under brownout, which is safe
    (stronger than requested).
    """

    def __init__(self, engines, promote_after: int | None = None):
        self._names = [name for name, _ in engines]
        self._builders = dict(engines)
        self._built: dict = {}
        self._level = 0
        self.counts = {name: 0 for name in self._names}
        self.demotions: list = []
        self.promote_after = promote_after
        self.promotions: list = []
        self.probe_failures: list = []
        self._healthy = 0                    # success streak at this level
        self._cooldown = promote_after or 0  # streak required to probe up
        self.last_quality = 0                # quality the last run served

    @property
    def engine(self) -> str:
        """Name of the engine currently serving."""
        return self._names[self._level]

    @property
    def exhausted(self) -> bool:
        return self._level + 1 >= len(self._names)

    def demote(self, reason: str, bucket=None) -> bool:
        """Drop one level (False when already on the last engine)."""
        if self.exhausted:
            print(f"engine ladder exhausted at {self.engine!r}; cannot "
                  f"demote further ({reason})")
            return False
        frm, to = self._names[self._level], self._names[self._level + 1]
        self.demotions.append(
            dict(frm=frm, to=to, bucket=bucket, reason=reason))
        print(f"engine demoted: {frm} -> {to} (bucket {bucket}): {reason}")
        self._level += 1
        self._healthy = 0
        self._cooldown = self.promote_after or 0
        return True

    def rebind(self, engines) -> None:
        """Swap in a new ``[(name, builder)]`` list (artifact hot-swap).

        Built callables are discarded — they closed over the OLD
        artifact's schedules — and rebuild lazily on next use, while the
        ladder's health state (current level, streaks, telemetry) carries
        over: a tenant demoted to a safe engine stays demoted across a
        swap instead of re-crashing its way down the ladder.  The engine
        names must match the existing ladder (the level index keeps its
        meaning).
        """
        names = [name for name, _ in engines]
        if names != self._names:
            raise ValueError(
                f"rebind: engine names {names} != ladder levels "
                f"{self._names} — a swap must not reorder the ladder")
        self._builders = dict(engines)
        self._built = {}

    def _run_at(self, level, make_input, quality=0):
        name = self._names[level]
        fn = self._built.get(name)
        if fn is None:
            fn = self._built[name] = self._builders[name]()
        if quality and getattr(fn, "supports_quality", False):
            out = _ready(fn(make_input(), quality))
            self.last_quality = int(quality)
        else:
            out = _ready(fn(make_input()))
            self.last_quality = 0
        return out

    def _maybe_probe(self, make_input, bucket, count, quality=0):
        """Serve this bucket on the engine one level up when the healthy
        streak has cleared the cooldown; returns the output or None."""
        if (not self.promote_after or self._level == 0
                or self._healthy < self._cooldown):
            return None
        target = self._names[self._level - 1]
        try:
            out = self._run_at(self._level - 1, make_input, quality)
        except _build.KernelBuildError:
            raise
        except Exception as e:  # noqa: BLE001 — a failed probe never escapes
            self.probe_failures.append(dict(
                engine=target, bucket=bucket,
                reason=f"{type(e).__name__}: {e}"))
            self._healthy = 0
            self._cooldown *= 2
            print(f"engine probe failed: {target} (bucket {bucket}); "
                  f"cooldown now {self._cooldown} healthy buckets")
            return None
        self.promotions.append(
            dict(to=target, frm=self.engine, bucket=bucket,
                 after_healthy=self._healthy))
        print(f"engine promoted: {self.engine} -> {target} (bucket {bucket}) "
              f"after {self._healthy} healthy buckets")
        self._level -= 1
        self._healthy = 0
        self._cooldown = self.promote_after
        if count:
            self.counts[target] += 1
        return out

    def run(self, make_input, bucket=None, count=True, quality=0):
        """Run the current engine on ``make_input()``, demoting on failure.

        ``quality > 0`` requests a budgeted (anytime) answer; engines
        without quality support serve exact.  ``self.last_quality`` holds
        the level actually served after the call returns.
        """
        probed = self._maybe_probe(make_input, bucket, count, quality)
        if probed is not None:
            return probed
        while True:
            name = self.engine
            try:
                out = self._run_at(self._level, make_input, quality)
            except _build.KernelBuildError:
                raise
            except Exception as e:  # noqa: BLE001 — any engine failure demotes
                if not self.demote(f"{type(e).__name__}: {e}", bucket=bucket):
                    raise
                continue
            if count:
                self.counts[name] += 1
            self._healthy += 1
            return out


def tm_forward_packed(
    lit_words: torch.Tensor,    # (B, W) int32 packed literals
    inc_words: torch.Tensor,    # (C, W) int32 packed includes
    votes: torch.Tensor,        # (C, K) int32
    nonempty: torch.Tensor | None = None,   # (C,); None = training semantics
) -> torch.Tensor:
    """Packed literals -> (B, K) class sums through the fused dense kernel
    (``fused_infer.py``): clause chain, empty-clause mask and vote fold in
    one pass."""
    faults.raise_if("kernel.dense")   # drill: dense-kernel failure
    return _fused_infer_kernel.fused_tm_forward(lit_words, inc_words, votes,
                                                nonempty)


def tm_forward_schedule(
    lit_words: torch.Tensor,    # (B, Wa) packed literals (word-compacted)
    votes: torch.Tensor,        # (U, K) int32 multiplicity x polarity
    schedule,                   # sparse_infer.SparseSchedule
    *,
    tile_margin=None,           # (T,) int32 anytime margins -> exact early exit
) -> torch.Tensor:
    """Compiled-artifact class sums via the block-sparse chain schedule
    (``sparse_infer.sparse_tm_forward``).  Vacuous-AND contract: all-zero
    rows must carry zero votes (true for every ``compile_tm`` artifact)."""
    faults.raise_if("kernel.sparse")  # drill: chain-kernel failure
    return _sparse_infer_kernel.sparse_tm_forward(
        lit_words, votes, schedule, tile_margin=tile_margin)


def tm_forward_factorized(
    lit_words: torch.Tensor,    # (B, Wa) packed literals (word-compacted)
    votes: torch.Tensor,        # (U, K) int32 multiplicity x polarity
    schedule,                   # term_infer.FactorizedSchedule
    *,
    tile_margin=None,           # (T,) int32 anytime margins -> exact early exit
) -> torch.Tensor:
    """Compiled-artifact class sums via the two-level FACTORIZED schedule
    (``term_infer.factorized_tm_forward``): stage 1 evaluates each unique
    AND term once per sample word, stage 2 chains term ids per clause."""
    faults.raise_if("kernel.factorized")  # drill: factorized-kernel failure
    return _term_infer_kernel.factorized_tm_forward(
        lit_words, votes, schedule, tile_margin=tile_margin)
