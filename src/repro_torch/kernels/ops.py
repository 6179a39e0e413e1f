"""Engine selection and dispatch over the port's kernels.

``EngineSpec`` names an inference engine, ``EngineLadder`` degrades
through engines on failure, and the ``tm_forward_*`` functions run one
compiled artifact through one kernel: the CUDA kernel for CUDA tensors,
its plain PyTorch version for CPU tensors.  Each kernel engine calls
``faults.raise_if("kernel.<engine>")`` first, so the reference's ladder
and chaos drills apply unchanged.

The training half is the hash-RNG batch step ``tm_train_step_kernel``:
the fused form is two launches (``fused_infer`` for the class sums, then
``fused_train``), the unfused form three (``clause_eval``, ``class_sum``
inside the feedback plan, ``ta_update``).  Every draw is
``ref.hash_u32`` of global indices, so both forms, chunked or not, equal
the reference's step bit for bit.  ``tm_train_step_matmul`` is the
reference's beyond-paper step: three 0/1 matrix products and binomial
penalty counts, from the same hash draws.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import spans
from repro_torch.kernels import _build, ref
from repro_torch.kernels import class_sum as _class_sum_kernel
from repro_torch.kernels import clause_eval as _clause_eval_kernel
from repro_torch.kernels import fused_infer as _fused_infer_kernel
from repro_torch.kernels import fused_train as _fused_train_kernel
from repro_torch.kernels import sparse_infer as _sparse_infer_kernel
from repro_torch.kernels import ta_update as _ta_update_kernel
from repro_torch.kernels import term_infer as _term_infer_kernel
from repro_torch.kernels import xnor_popcount as _xnor_popcount_kernel
from repro_torch.kernels.ref import M32
from repro_torch.runtime import faults


def kernel_dispatch(device: torch.device) -> bool:
    """Whether ``engine="auto"`` takes the kernel path for an input on
    ``device``: it does whenever that is a CUDA device."""
    return device.type == "cuda"


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
    * ``"dense"`` — the fused dense kernel (``fuse=False``: the unfused
      ``clause_eval`` -> ``class_sum`` pipeline).
    * ``"oracle"`` — the plain PyTorch reference path.

    The named kernel engines run their plain versions on CPU inputs.
    """

    name: str = "auto"
    fuse: bool = True

    def __post_init__(self):
        if self.name not in ENGINE_NAMES:
            raise ValueError(
                f"unknown engine {self.name!r}; one of {ENGINE_NAMES}")
        if self.name in ("factorized", "sparse") and not self.fuse:
            raise ValueError(f"engine {self.name!r} has no unfused form")

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


clause_fire = _clause_eval_kernel.clause_fire
class_sums = _class_sum_kernel.class_sum
ta_delta = _ta_update_kernel.ta_delta
# the BNN baseline's binarized matmul: (B, W) x (O, W) packed words -> (B, O)
xnor_dot = _xnor_popcount_kernel.xnor_popcount


def tm_forward_packed(
    lit_words: torch.Tensor,    # (B, W) int32 packed literals
    inc_words: torch.Tensor,    # (C, W) int32 packed includes
    votes: torch.Tensor,        # (C, K) int32
    nonempty: torch.Tensor | None = None,   # (C,); None = training semantics
    *,
    fuse: bool = True,
    autotune: bool = False,
    **blocks,
) -> torch.Tensor:
    """Packed literals -> (B, K) class sums.  ``fuse=True`` runs the fused
    dense kernel (``fused_infer.py``): clause chain, empty-clause mask and
    vote fold in one pass, launched as ``blocks`` (``block_b``/``block_c``/
    ``block_w``) name, or as ``autotune.py``'s cached sweep picks with
    ``autotune=True`` and no blocks.  ``fuse=False`` runs the two-kernel
    pipeline ``clause_fire`` -> (mask) -> ``class_sums`` with the (B, C)
    fire matrix in device memory; those kernels pick their own launch, as
    the reference's untuned ones do, and ``blocks`` are not theirs."""
    if fuse:
        faults.raise_if("kernel.dense")   # drill: dense-kernel failure
        if autotune and not blocks:
            from repro_torch.kernels import autotune as _autotune

            B, W = lit_words.shape
            C, K = votes.shape
            blocks = _autotune.autotune_fused_blocks(B, C, W, K,
                                                     device=lit_words.device)
        return _fused_infer_kernel.fused_tm_forward(lit_words, inc_words, votes,
                                                    nonempty, **blocks)
    fired = clause_fire(lit_words, inc_words)
    if nonempty is not None:
        fired = fired * (nonempty != 0).to(torch.int8)[None, :]
    return class_sums(fired, votes)


def tm_forward_schedule(
    lit_words: torch.Tensor,    # (B, Wa) packed literals (word-compacted)
    placed,                     # sparse_infer.PlacedSchedule
    *,
    block_s: int | None = None,  # sample words a block of the walk
) -> torch.Tensor:
    """Compiled-artifact class sums via a placed block-sparse chain schedule
    (``sparse_infer.sparse_tm_forward``; exact early exit when the
    placement holds a margin table).  Vacuous-AND contract: all-zero rows
    must carry zero votes (true for every ``compile_tm`` artifact)."""
    faults.raise_if("kernel.sparse")  # drill: chain-kernel failure
    return _sparse_infer_kernel.sparse_tm_forward(lit_words, placed, block_s=block_s)


def tm_forward_factorized(
    lit_words: torch.Tensor,    # (B, Wa) packed literals (word-compacted)
    placed,                     # term_infer.PlacedSchedule
    *,
    block_s: int | None = None,  # sample words a block of the stage-2 walk
) -> torch.Tensor:
    """Compiled-artifact class sums via a placed two-level FACTORIZED
    schedule (``term_infer.factorized_tm_forward``): stage 1 evaluates each
    unique AND term once per sample word, stage 2 chains term ids per
    clause."""
    faults.raise_if("kernel.factorized")  # drill: factorized-kernel failure
    return _term_infer_kernel.factorized_tm_forward(lit_words, placed, block_s=block_s)


# ---------------------------------------------------------------------------
# Kernel-path TM training step (hash RNG; equals the reference bit for bit)
# ---------------------------------------------------------------------------

# host spans of the step (``repro_torch/spans.py``): the whole call, the
# set-up (the batch on the device, ``StepShard``'s packed include masks and
# clause tables), the class sums, the feedback scalars, the delta and the
# clamp that applies it; a clause-sharded caller's ``StepShard`` nests the
# middle three
STEP_RANGE = "train_step"
PREPARE_RANGE = "train_step.prepare"
SUMS_RANGE = "train_step.sums"
FEEDBACK_RANGE = "train_step.feedback"
DELTA_RANGE = "train_step.delta"
APPLY_RANGE = "train_step.apply"

_NEG_XOR = 0x9E3779B9     # negative-class stream
_SEL_MIX = 0x9E3779B1     # selection stream: must match csrc/hash_rng.cuh
_SEL_XOR = 0x85EBCA6B


def feedback_probs(
    sums: torch.Tensor,    # (B, K) int32 CLAMPED class sums
    y: torch.Tensor,       # (B,) int32 targets (-1 = padded sample)
    n_classes: int,
    threshold: int,
    seed: int,
    b_offset: int = 0,     # global index of sample 0 (chunked training)
):
    """Per-sample feedback scalars ``(kn, p_t, p_n)``.

    ``kn`` is the hash-sampled negative class (uniform over the K-1
    others); ``p_t``/``p_n`` are the Type-I-side / Type-II-side clause
    selection probabilities ``(T -/+ clamp(sum)) / 2T`` in float32.  A
    padded sample (``y = -1``) reads its sums at a clamped index: the
    caller masks its feedback.
    """
    B = y.shape[0]
    T = threshold
    b_idx = (torch.arange(B, dtype=torch.int64, device=y.device) + b_offset) & M32
    r_neg = ref.hash_u32(b_idx, (int(seed) ^ _NEG_XOR) & M32)
    kn = (r_neg % (n_classes - 1)).to(torch.int32)
    kn = kn + (kn >= y).to(torch.int32)
    cols = torch.stack([y, kn], dim=1).to(torch.int64).clamp(0, n_classes - 1)
    picked = sums.gather(1, cols)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # rounded reciprocal, which rounds some sums differently from the
    # reference's (and the CPU's) division
    two_t = torch.tensor(2.0 * T, dtype=torch.float32, device=y.device)
    p_t = (T - picked[:, 0]).to(torch.float32) / two_t
    p_n = (T + picked[:, 1]).to(torch.float32) / two_t
    return kn, p_t, p_n


def feedback_select(
    y: torch.Tensor,       # (B,) int32 targets
    kn: torch.Tensor,      # (B,) int32 sampled negative classes
    p_t: torch.Tensor,     # (B,) float32
    p_n: torch.Tensor,     # (B,) float32
    clause_class: torch.Tensor,   # (C,) int32 class id per clause
    clause_pol: torch.Tensor,     # (C,) int32 +1/-1 (0 = padded)
    seed: int,
    b_offset: int = 0,     # global index of sample 0
    c_offset: int = 0,     # global index of clause 0 (clause-sharded step)
) -> torch.Tensor:
    """(B, C) uint8 feedback types: 0 none, 1 Type I, 2 Type II.

    The oracle the fused training kernel reproduces: the selection draw of
    (b, c) hashes GLOBAL ids, ``(b + b_offset) * _SEL_MIX + c + c_offset``
    mod 2**32, so chunked and sharded callers match the unsharded stream.
    The draw becomes float32 ``round(r) / 2**32`` (r >= 0xFFFFFF80 gives
    exactly 1.0) and selects where it is below p.
    """
    B, C = y.shape[0], clause_class.shape[0]
    dev = y.device
    b_idx = (torch.arange(B, dtype=torch.int64, device=dev) + b_offset) & M32
    c_idx = (torch.arange(C, dtype=torch.int64, device=dev) + c_offset) & M32
    mixed = (ref.mul_u32(b_idx, _SEL_MIX)[:, None] + c_idx[None, :]) & M32
    r_sel = ref.hash_u32(mixed, (int(seed) ^ _SEL_XOR) & M32)
    r_sel = r_sel.to(torch.float32) / 2 ** 32

    is_t = clause_class[None, :] == y[:, None]                 # (B, C)
    is_n = clause_class[None, :] == kn[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p = torch.where(is_t, p_t[:, None], torch.where(is_n, p_n[:, None], zero))
    sel = r_sel < p
    pos = (clause_pol > 0)[None, :]
    neg = (clause_pol < 0)[None, :]
    ftype = torch.where(
        is_t & pos, 1, torch.where(is_t & neg, 2,
        torch.where(is_n & pos, 2, torch.where(is_n & neg, 1, 0))))
    return torch.where(sel, ftype, 0).to(torch.uint8)


def feedback_plan(
    fire: torch.Tensor,    # (B, C) uint8 training-mode clause outputs
    y: torch.Tensor,       # (B,) int32 targets
    votes: torch.Tensor,   # (C, K) int32
    clause_class: torch.Tensor,
    clause_pol: torch.Tensor,
    threshold: int,
    seed: int,
    b_offset: int = 0,
    c_offset: int = 0,
    sums: torch.Tensor | None = None,   # precomputed clamped class sums
):
    """Per-(sample, clause) feedback types and the clamped class sums
    ``(ftype, sums)``; the sums are ``fire @ votes`` through the
    ``class_sum`` kernel (its plain version on the CPU)."""
    K, T = votes.shape[1], threshold
    if sums is None:
        sums = torch.clamp(class_sums(fire, votes), -T, T)
    kn, p_t, p_n = feedback_probs(sums, y, K, T, seed, b_offset=b_offset)
    ftype = feedback_select(y, kn, p_t, p_n, clause_class, clause_pol, seed,
                            b_offset=b_offset, c_offset=c_offset)
    return ftype, sums


class StepShard:
    """The hash-RNG batch step of one bank or clause shard, in two phases a
    batch chunk, so that a clause-sharded caller can complete every shard's
    partial class sums between them (``core/sharding.py`` runs the shards
    of a mesh one after another in one process):

    * :meth:`sums`: the chunk's class sums over this shard's clauses,
      unclamped (``fused_infer`` fused, ``clause_eval`` + ``class_sum``
      unfused);
    * :meth:`delta`: the chunk's (C_loc, L) int32 delta from the completed
      sums (``fused_train`` fused, the feedback plan + ``ta_update``
      unfused).

    ``use_kernel=False`` runs the plain versions on any device (the
    oracle route) and is unfused.  The bank is read, never written.
    """

    def __init__(self, config, ta_state, seed, *, fuse=True, autotune=False,
                 blocks=None, chunk_b=None, c_offset=0, c_total=None,
                 use_kernel=True):
        from repro_torch.core import packetizer, tm

        dev = ta_state.device
        self.config, self.ta, self.seed = config, ta_state, seed
        self.fuse = bool(fuse and use_kernel)
        self.use_kernel = use_kernel
        self.inc_words = packetizer.pack_include_masks(ta_state)
        C_loc = ta_state.shape[0]
        votes = tm.vote_matrix(config, dev)
        cls = tm.clause_class(config, dev)
        pol = tm.polarity(config, dev)
        if c_total is not None:   # clause shard: local slices of the bank metadata
            if c_total != config.n_clauses_total:
                raise ValueError(f"c_total {c_total} != the config's "
                                 f"{config.n_clauses_total} clauses")
            sl = slice(c_offset, c_offset + C_loc)
            votes, cls, pol = votes[sl], cls[sl], pol[sl]
        self.votes, self.cls, self.pol = votes, cls, pol
        p_act = 1.0 if config.boost_true_positive else (config.s - 1.0) / config.s
        self.step_kw = dict(p_act=p_act, p_inact=1.0 / config.s,
                            c_offset=c_offset, c_total=c_total)
        self.blocks, self.infer_blocks = blocks, {}
        if self.fuse and autotune:
            from repro_torch.kernels import autotune as _autotune

            W = packetizer.n_words(config.n_literals)
            K = config.n_classes
            if blocks is None:
                self.blocks = _autotune.autotune_fused_train_blocks(
                    chunk_b, C_loc, W, ta_state.shape[1], K, device=dev)
            self.infer_blocks = _autotune.autotune_fused_blocks(chunk_b, C_loc, W, K,
                                                                device=dev)

    def sums(self, xc):
        """Phase 1 -> ``(prep, sums)``: what phase 2 reuses and the (B, K)
        int32 class sums over this shard's clauses."""
        from repro_torch.core import packetizer, tm

        with spans.span(SUMS_RANGE):
            lits = tm.literals(xc)
            lit_words = packetizer.pack_bits(lits)
            if self.fuse:
                # launch 1: class sums (no empty-clause mask in training)
                sums = _fused_infer_kernel.fused_tm_forward(
                    lit_words, self.inc_words, self.votes, None, **self.infer_blocks)
                return (lits, lit_words, None), sums
            if self.use_kernel:
                fire = clause_fire(lit_words, self.inc_words).to(torch.uint8)
                return (lits, lit_words, fire), class_sums(fire, self.votes)
            fire = _clause_eval_kernel.clause_fire_plain(
                lit_words.contiguous(), self.inc_words.contiguous()).to(torch.uint8)
            sums = _class_sum_kernel.class_sum_plain(fire, self.votes)
            return (lits, lit_words, fire), sums

    def delta(self, prep, sums, yc, b_off, valid):
        """Phase 2 -> the chunk's (C_loc, L) int32 delta; ``sums`` are the
        completed class sums, ``valid`` masks a padded tail (or None)."""
        lits, lit_words, fire = prep
        T, K, seed = self.config.threshold, self.config.n_classes, self.seed
        with spans.span(FEEDBACK_RANGE):
            sums = torch.clamp(sums, -T, T)
            if self.fuse:
                kn, p_t, p_n = feedback_probs(sums, yc, K, T, seed, b_offset=b_off)
                if valid is not None:     # padded tail samples select nothing
                    p_t = torch.where(valid, p_t, 0.0)
                    p_n = torch.where(valid, p_n, 0.0)
            else:
                ftype, _ = feedback_plan(fire, yc, self.votes, self.cls, self.pol, T,
                                         seed, b_offset=b_off,
                                         c_offset=self.step_kw["c_offset"], sums=sums)
                if valid is not None:
                    ftype = torch.where(valid[:, None], ftype, 0).to(torch.uint8)
        with spans.span(DELTA_RANGE):
            if self.fuse:
                # launch 2: fire -> feedback type -> delta
                return _fused_train_kernel.fused_tm_train_delta(
                    self.ta, lits, lit_words, self.inc_words, yc, kn, p_t, p_n,
                    self.cls, self.pol, seed, b_offset=b_off, **self.step_kw,
                    **(self.blocks or {}))
            if self.use_kernel:
                return ta_delta(self.ta, lits, fire, ftype, seed, b_offset=b_off,
                                **self.step_kw)
            return _ta_update_kernel.ta_delta_plain(
                self.ta.contiguous(), lits.contiguous(), fire.contiguous(),
                ftype.contiguous(), seed, b_offset=b_off, **self.step_kw)


def batch_chunks(x, y, batch_chunk, b_offset=0) -> list:
    """``[(x, y, b_offset, valid)]``, the slices a batch is stepped in:
    one without a mask unless ``batch_chunk`` is below ``B``; a ragged tail
    is padded with zero samples whose ``y = -1``, masked by ``valid``."""
    B = x.shape[0]
    b_base = int(b_offset) & M32
    if not (batch_chunk and B > batch_chunk):
        return [(x, y, b_base, None)]
    n = -(-B // batch_chunk)
    pad = n * batch_chunk - B
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        y = torch.cat([y, y.new_full((pad,), -1)])
    out = []
    for i in range(n):
        lo = i * batch_chunk
        valid = (torch.arange(lo, lo + batch_chunk, device=x.device) < B) if pad else None
        out.append((x[lo:lo + batch_chunk], y[lo:lo + batch_chunk],
                    (b_base + lo) & M32, valid))
    return out


def tm_train_step_kernel(
    config,
    ta_state: torch.Tensor,  # (C, L) int8: the full bank OR a clause shard
    x: torch.Tensor,         # (B, F) {0,1}
    y: torch.Tensor,         # (B,) class ids
    seed: int,
    batch_chunk: int | None = None,
    *,
    fuse: bool = True,
    autotune: bool = False,
    blocks: dict | None = None,
    b_offset: int = 0,       # global index of sample 0 (data-sharded caller)
    c_offset: int = 0,       # global index of clause 0 (clause-sharded caller)
    c_total: int | None = None,  # set when ta_state is a clause shard
    sums_reduce=None,        # completes a shard's partial class sums
    use_kernel: bool = True,
):
    """One hash-RNG batch training step on ``ta_state``'s device ->
    ``(new_ta, delta)``, the (C, L) int8 bank and its int32 delta.

    ``fuse=True`` runs two launches: the dense fused-inference kernel for
    the class sums (training semantics: empty clauses fire), then the
    fused training kernel (fire -> feedback type -> delta, nothing of
    (B, C) in device memory).  ``fuse=False`` runs ``clause_fire``, the
    feedback plan (``class_sums``) and ``ta_delta``.  CPU tensors run the
    kernels' plain versions; ``use_kernel=False`` runs them on any device
    (unfused).  Every form gives the same bits.

    ``autotune=True`` picks the two fused kernels' launches from
    ``kernels/autotune.py``'s cached sweeps (training shapes cache under
    their own key); ``blocks`` pins the fused training kernel's launch.

    ``batch_chunk`` steps through the batch in slices, summing the deltas:
    the draws are indexed by global sample id, so the result equals the
    unchunked step; a ragged tail is padded with ``y = -1`` samples whose
    feedback is masked.  For a clause shard pass ``c_offset``,
    ``c_total=config.n_clauses_total`` and ``sums_reduce`` (the sum of the
    partial class sums over the shards); the delta is then the full bank's
    rows, and ``new_ta`` applies only this batch's delta.  The two phases
    of each chunk are :class:`StepShard`'s.
    """
    with spans.span(STEP_RANGE):
        with spans.span(PREPARE_RANGE):
            dev = ta_state.device
            x = x.to(dev)
            y = y.to(device=dev, dtype=torch.int32)
            B = x.shape[0]
            chunk_b = batch_chunk if (batch_chunk and B > batch_chunk) else B
            shard = StepShard(config, ta_state, seed, fuse=fuse, autotune=autotune,
                              blocks=blocks, chunk_b=chunk_b, c_offset=c_offset,
                              c_total=c_total, use_kernel=use_kernel)
        delta = None
        for xc, yc, b_off, valid in batch_chunks(x, y, batch_chunk, b_offset):
            prep, sums = shard.sums(xc)
            if sums_reduce is not None:
                sums = sums_reduce(sums)
            d = shard.delta(prep, sums, yc, b_off, valid)
            delta = d if delta is None else delta + d
        with spans.span(APPLY_RANGE):
            new_ta = torch.clamp(ta_state.to(torch.int32) + delta, -config.n_states,
                                 config.n_states - 1).to(torch.int8)
        return new_ta, delta


# ---------------------------------------------------------------------------
# Beyond-paper: matmul + binomial-aggregation TM training step
# ---------------------------------------------------------------------------

def _binomial_approx(n: torch.Tensor, p: float, gidx: torch.Tensor,
                     seed: int) -> torch.Tensor:
    """~Binomial(n, p) per element via a moment-matched normal (triangular
    z from two hash draws), in float32 as the reference computes it: ``p``
    and ``1 - p`` are Python doubles rounded to float32, ``round`` is half
    to even."""
    dev = n.device
    u1 = ref.hash_u32(gidx, seed).to(torch.float32) / 2 ** 32
    u2 = ref.hash_u32(gidx, (int(seed) ^ 0xC2B2AE35) & M32).to(torch.float32) / 2 ** 32
    z = (u1 + u2 - 1.0) * torch.tensor(2.449489742783178, dtype=torch.float32,
                                       device=dev)        # sqrt(6): unit variance
    nf = n.to(torch.float32)
    pf = torch.tensor(p, dtype=torch.float32, device=dev)
    qf = torch.tensor(1.0 - p, dtype=torch.float32, device=dev)
    s = nf * pf + torch.sqrt(torch.clamp(nf * pf * qf, min=0.0)) * z
    return torch.minimum(torch.clamp(torch.round(s), min=0.0), nf).to(torch.int32)


def psum(parts, device) -> torch.Tensor:
    """The exact sum of per-shard partial results on ``device``, the
    reference's ``psum``: the mesh's one collective.  A lone part comes
    back as it is (moved, not copied); callers never write the result in
    place, so no shard's tensor is changed."""
    out = parts[0].to(device)
    if len(parts) > 1:
        out = out.clone()
        for p in parts[1:]:
            out += p.to(device)
    return out


def tm_train_step_matmul(config, ta_state: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, seed: int):
    """Batch TM training as three 0/1 matrix products and (C, L)
    elementwise sampling -> ``(new_ta, delta)``, equal to the reference's.

    With ``boost_true_positive`` (required), Type I on a firing clause's
    1-literals is a deterministic +1 (``A = M1f^T @ lit``); its penalties
    (p = 1/s) are ``~Binomial(n1, 1/s)`` with ``n1 = M1f^T @ (1 - lit) +
    rowsum(M1n)``; Type II adds ``n2 = M2^T @ (1 - lit)`` on excluded
    automata.  ``M1f``, ``M1n`` and ``M2`` are the (B, C) feedback masks of
    the hash-RNG feedback plan, and clause evaluation is the violation
    count ``include @ (1 - lit)^T``.  Memory is O(BC + BL + CL): no (B, C,
    L) field exists.  It is :func:`tm_train_step_matmul_local` on a grid of
    one shard.

    The products are float32 ``torch.matmul`` of 0/1 matrices: exact
    counts, with or without TF32, whose 10-bit mantissa holds 0 and 1 and
    whose products accumulate in float32 (counts stay far below 2**24).
    """
    new, delta = tm_train_step_matmul_local(config, [[ta_state]], [x], [y], seed)
    return new[0][0], delta[0][0]


def tm_train_step_matmul_local(config, ta_grid, x_loc, y_loc, seed):
    """The matmul step on a (data, model) grid of dual-axis shards ->
    ``(new, delta)``, grids of the new (C_loc, L_loc) int8 shards and their
    int32 deltas, equal to the step on the whole bank bit for bit (every
    count is an exact float32 integer and every draw is indexed by global
    (clause, literal) and sample ids).

    ``ta_grid[d][m]`` is the (C_loc, L_loc) int8 shard of clause block
    ``m`` and literal block ``d``, on its shard's device; ``x_loc[d]`` and
    ``y_loc[d]`` are data shard ``d``'s samples.  The reference's shard
    body runs its collectives inside; one process driving every shard runs
    them as phases across the shards instead:

      1. gather the int8 automata over ``data`` -> (C_loc, L) a shard;
      2. fire and the (B_loc, K) partial class sums; their sum over ``model``;
      3. the feedback masks and the three (C_loc, L) float32 count products;
      4. their sum over ``data``, scattered by literal block -> (C_loc, L_loc);
      5. the penalty draws and the clamped update of each shard.
    """
    from repro_torch.core import tm

    if not config.boost_true_positive:
        raise ValueError("tm_train_step_matmul assumes boost_true_positive "
                         "(p_act = 1)")
    n_data, n_model = len(ta_grid), len(ta_grid[0])
    C_loc, L_loc = ta_grid[0][0].shape
    L = L_loc * n_data
    B_loc = x_loc[0].shape[0]
    T = config.threshold
    grid = [(d, m) for d in range(n_data) for m in range(n_model)]

    def meta(fn, m, dev):
        return fn(config, dev)[m * C_loc:(m + 1) * C_loc]

    st = {}
    for d, m in grid:                                         # phases 1 and 2
        dev = ta_grid[d][m].device
        ta_full = (ta_grid[d][m] if n_data == 1 else
                   torch.cat([ta_grid[e][m].to(dev) for e in range(n_data)], dim=1))
        lit_f = tm.literals(x_loc[d].to(dev)).to(torch.float32)   # (B_loc, L)
        off_f = 1.0 - lit_f
        fire = ((ta_full >= 0).to(torch.float32) @ off_f.T).T < 0.5
        fire_u8 = fire.to(torch.uint8)
        votes = meta(tm.vote_matrix, m, dev)
        st[d, m] = dict(dev=dev, lit_f=lit_f, off_f=off_f, fire=fire, fire_u8=fire_u8,
                        votes=votes, sums=class_sums(fire_u8, votes))
    for d in range(n_data):                                   # sum over model
        total = psum([st[d, m]["sums"] for m in range(n_model)], st[d, 0]["dev"])
        for m in range(n_model):
            st[d, m]["sums"] = torch.clamp(total.to(st[d, m]["dev"]), -T, T)
    for d, m in grid:                                         # phase 3
        s = st[d, m]
        dev = s["dev"]
        ftype, _ = feedback_plan(
            s["fire_u8"], y_loc[d].to(device=dev, dtype=torch.int32),
            s["votes"], meta(tm.clause_class, m, dev),
            meta(tm.polarity, m, dev), T, seed, b_offset=d * B_loc,
            c_offset=m * C_loc, sums=s["sums"])
        f1 = ftype == 1
        m1f = (f1 & s["fire"]).to(torch.float32)
        m1n = (f1 & ~s["fire"]).to(torch.float32)
        m2 = ((ftype == 2) & s["fire"]).to(torch.float32)
        s["counts"] = (m1f.T @ s["lit_f"],                     # reward counts
                       m1f.T @ s["off_f"] + m1n.sum(0)[:, None],
                       m2.T @ s["off_f"])                      # 3 x (C_loc, L)
    new = [[None] * n_model for _ in range(n_data)]
    delta = [[None] * n_model for _ in range(n_data)]
    for d, m in grid:                                         # phases 4 and 5
        ta_loc = ta_grid[d][m]
        dev = ta_loc.device
        lo = d * L_loc
        A, n1, n2 = (psum([st[e, m]["counts"][k][:, lo:lo + L_loc]
                           for e in range(n_data)], dev) for k in range(3))
        c_idx = torch.arange(m * C_loc, (m + 1) * C_loc, dtype=torch.int64, device=dev)
        l_idx = torch.arange(lo, lo + L_loc, dtype=torch.int64, device=dev)
        gidx = (c_idx[:, None] * L + l_idx[None, :]) & M32
        pen = _binomial_approx(n1, 1.0 / config.s, gidx, (int(seed) ^ 0x27D4EB2F) & M32)
        excl = (ta_loc < 0).to(torch.int32)
        delta[d][m] = A.to(torch.int32) - pen + n2.to(torch.int32) * excl
        new[d][m] = torch.clamp(ta_loc.to(torch.int32) + delta[d][m], -config.n_states,
                                config.n_states - 1).to(torch.int8)
    return new, delta
