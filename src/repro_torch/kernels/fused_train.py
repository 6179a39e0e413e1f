"""Fused single-pass Tsetlin-machine training delta: clause fire ->
feedback type -> batch-summed automaton delta, with the (B, C) fire and
feedback-type matrices never in device memory.

:func:`fused_tm_train_delta` runs ``csrc/fused_train.cu`` for CUDA tensors
and :func:`fused_train_plain` for CPU tensors.  The plain version is the
unfused composition the kernel must equal bit for bit::

    fire  = clause_fire_ref(lit_words, inc_words)
    ftype = ops.feedback_select(y, kn, p_t, p_n, clause_class, clause_pol,
                                seed, b_offset, c_offset)
    delta = ta_delta_ref(ta, lits, fire, ftype, seed, p_act, p_inact,
                         b_offset, c_offset, c_total)

The per-sample scalars (``kn``, ``p_t``, ``p_n``) come from the class sums
of a fused-inference pass (``ops.tm_train_step_kernel``), so one training
step is two launches.

The kernel reads the literals only as the packed ``lit_words``, which it
stages in shared memory for both the clause chain and the delta walk; the
unpacked ``lits`` stay in the signature, the reference's, and are what the
plain version reads (they must be ``lit_words`` unpacked).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (M32, clause_fire_ref, prob_to_u32,
                                     ta_delta_ref)

# kernel launches through fused_tm_train_delta on CUDA tensors
launches = 0

# The launches the kernel can make, in the reference's block names: a CUDA
# block of `block_c` clauses (CLAUSES_A_BLOCK; csrc/ta_delta.cuh's kCT is
# the default) walks the batch in segments of `block_b` samples (fixed by
# B and W: segment()), one warp walking all W words of a sample's chain.
CLAUSES_A_BLOCK = (2, 4, 8)
DEFAULT_CLAUSES = 4
# what the occupancy entry point writes after the common fields
LAUNCH_FIELDS = ("clauses_per_block", "segment_samples")

_DTYPES = dict(ta=torch.int8, lits=torch.uint8, lit_words=torch.int32,
               inc_words=torch.int32, y=torch.int32, kn=torch.int32,
               p_t=torch.float32, p_n=torch.float32, clause_class=torch.int32,
               clause_pol=torch.int32)


def prepare(tensors: dict) -> dict:
    """The kernel's inputs by name, each cast to its dtype, contiguous and
    checked for device and shape: what the plain and CUDA versions take."""
    out = {k: tensors[k].to(dt).contiguous() for k, dt in _DTYPES.items()}
    dev = out["ta"].device
    for k, t in out.items():
        if t.device != dev:
            raise ValueError(f"{k} is on {t.device}, ta on {dev}")
    C, L = out["ta"].shape
    B, W = out["lit_words"].shape
    shapes = dict(lits=(B, L), inc_words=(C, W), y=(B,), kn=(B,), p_t=(B,),
                  p_n=(B,), clause_class=(C,), clause_pol=(C,))
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            raise ValueError(f"{k} has shape {tuple(out[k].shape)}, expected {s} "
                             f"(C={C}, L={L}, B={B}, W={W})")
    return out


def fused_train_plain(t: dict, seed, *, p_act, p_inact, b_offset=0, c_offset=0,
                      c_total=None):
    """Plain PyTorch version (any device) of the prepared inputs ``t``."""
    from repro_torch.kernels import ops

    fire = clause_fire_ref(t["lit_words"], t["inc_words"]).to(torch.uint8)
    ftype = ops.feedback_select(t["y"], t["kn"], t["p_t"], t["p_n"],
                                t["clause_class"], t["clause_pol"], seed,
                                b_offset=b_offset, c_offset=c_offset)
    return ta_delta_ref(t["ta"], t["lits"], fire, ftype, seed, p_act=p_act,
                        p_inact=p_inact, b_offset=b_offset, c_offset=c_offset,
                        c_total=c_total)


def segment(B: int, W: int) -> int:
    """Samples a segment of the kernel at batch ``B`` over ``W`` words: its
    staged literal rows fit 32 KB, at most 128 (csrc/ta_delta.cuh:
    seg_samples)."""
    return max(min(32 * 1024 // (4 * W), 128, B), 1)


def blocks_for(clauses: int, B: int, W: int) -> dict:
    """``{block_b, block_c, block_w}`` of the launch with ``clauses`` a
    block at batch ``B`` over ``W`` words."""
    return dict(block_b=segment(B, W), block_c=clauses, block_w=W)


def clauses_a_block(B: int, W: int, block_b=None, block_c=None,
                    block_w=None) -> int:
    """Clauses a block (2, 4 or 8) that a tiling names at batch ``B`` over
    ``W`` words, or 0, the default, when it names none.  A tiling the kernel
    does not launch raises ``ValueError``."""
    if block_c is not None and int(block_c) not in CLAUSES_A_BLOCK:
        raise ValueError(f"fused_train takes {CLAUSES_A_BLOCK} clauses a block, "
                         f"not block_c={block_c}")
    want = blocks_for(int(block_c or DEFAULT_CLAUSES), B, W)
    for k, v in dict(block_b=block_b, block_w=block_w).items():
        if v is not None and int(v) != want[k]:
            raise ValueError(f"fused_train at B={B}, W={W} launches {k}={want[k]}, "
                             f"not {v}")
    return 0 if block_c is None else int(block_c)


def fused_train_cuda(t: dict, seed, *, p_act, p_inact, b_offset=0, c_offset=0,
                     c_total=None, clauses: int = 0):
    """Launch ``csrc/fused_train.cu`` on the prepared CUDA inputs ``t``,
    ``clauses`` a block (0: the default)."""
    global launches
    ta = t["ta"]
    if not ta.is_cuda:
        raise ValueError("fused_train_cuda takes CUDA tensors")
    C, L = ta.shape
    B, W = t["lit_words"].shape
    out = torch.empty((C, L), dtype=torch.int32, device=ta.device)
    P, I, U = _build.P, _build.I, _build.U
    fn = _build.entry("fused_train", "fused_train_launch",
                      [P] * 10 + [I] * 4 + [U] * 7 + [I, P])
    err = fn(*(_build.ptr(t[k]) for k in _DTYPES if k != "lits"), _build.ptr(out),
             B, C, L, W,
             (C if c_total is None else c_total) & M32,
             (0 if c_total is None else c_offset) & M32,
             int(seed) & M32, int(b_offset) & M32, int(c_offset) & M32,
             prob_to_u32(p_act), prob_to_u32(p_inact), int(clauses),
             _build.stream_ptr(ta.device))
    _build.check("fused_train", err)
    launches += 1
    return out


def occupancy(B: int, L: int, W: int, clauses: int = 0) -> dict:
    """The kernel's registers a thread, threads a block, resident blocks per
    SM, shared bytes a block and spill bytes a thread at batch ``B``, ``L``
    literals in ``W`` words (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    and the clauses a block and samples a segment of the launch with
    ``clauses`` a block (0: the default)."""
    return _build.occupancy("fused_train", B, L, W, int(clauses), extra=LAUNCH_FIELDS)


def fused_tm_train_delta(
    ta: torch.Tensor,            # (C, L) int8 automata states
    lits: torch.Tensor,          # (B, L) uint8 {0,1} literals (unpacked)
    lit_words: torch.Tensor,     # (B, W) int32 packed literals
    inc_words: torch.Tensor,     # (C, W) int32 packed include masks
    y: torch.Tensor,             # (B,) int32 target class (-1 = padded sample)
    kn: torch.Tensor,            # (B,) int32 sampled negative class
    p_t: torch.Tensor,           # (B,) float32 Type-I-side selection prob
    p_n: torch.Tensor,           # (B,) float32 Type-II-side selection prob
    clause_class: torch.Tensor,  # (C,) int32 class id per clause
    clause_pol: torch.Tensor,    # (C,) int32 +1/-1 polarity (0 = padded)
    seed: int,
    *,
    p_act: float,
    p_inact: float,
    b_offset: int = 0,           # global index of sample 0
    c_offset: int = 0,           # global index of clause 0
    c_total: int | None = None,  # global clause count (clause-sharded caller)
    block_b: int | None = None,  # the launch (clauses_a_block): checked on
    block_c: int | None = None,  # every device, used on the card
    block_w: int | None = None,
) -> torch.Tensor:
    """Batch-summed feedback delta -> (C, L) int32 in one pass.

    The selection hash is indexed by global (sample, clause) ids
    (``b_offset``/``c_offset``), the automaton hash by (global sample,
    local clause, literal), so chunked, sharded and unsharded callers draw
    the same bits; ``c_total`` switches the automaton hash to global clause
    ids too, so a clause shard's delta equals the full bank's rows.
    """
    B, W = lit_words.shape
    clauses = clauses_a_block(B, W, block_b, block_c, block_w)
    t = prepare(dict(ta=ta, lits=lits, lit_words=lit_words, inc_words=inc_words,
                      y=y, kn=kn, p_t=p_t, p_n=p_n, clause_class=clause_class,
                      clause_pol=clause_pol))
    kw = dict(p_act=p_act, p_inact=p_inact, b_offset=b_offset,
              c_offset=c_offset, c_total=c_total)
    if t["ta"].is_cuda:
        return fused_train_cuda(t, seed, clauses=clauses, **kw)
    return fused_train_plain(t, seed, **kw)
