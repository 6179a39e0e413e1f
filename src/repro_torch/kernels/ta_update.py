"""Batched Tsetlin-automaton feedback delta from given fire bits and
feedback types -> (C, L) int32, summed over the batch (the unfused
training step's last dispatch).

:func:`ta_delta` runs ``csrc/ta_update.cu`` for CUDA tensors and
:func:`ta_delta_plain` (``ref.ta_delta_ref``) for CPU tensors.  The
randomness is the counter hash ``ref.hash_u32`` of global (sample, clause,
literal) ids, generated inside the kernel: no (B, C, L) field exists.

The kernel walks, per tile of clauses, only the pairs that change the
delta (``csrc/ta_delta.cuh``, shared with the fused training kernel),
after packing the uint8 ``lits`` of the samples that have such a pair
into bit rows in shared memory.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import M32, prob_to_u32, ta_delta_ref

# kernel launches through ta_delta on CUDA tensors
launches = 0


def _check(ta, lits, fire, ftype):
    want = dict(ta=(ta, torch.int8), lits=(lits, torch.uint8),
                fire=(fire, torch.uint8), ftype=(ftype, torch.uint8))
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.device != ta.device:
            raise ValueError(f"{name} is on {t.device}, ta on {ta.device}")
    C, L = ta.shape
    B = lits.shape[0]
    if lits.shape[1] != L or fire.shape != (B, C) or ftype.shape != (B, C):
        raise ValueError(f"shape mismatch: ta {tuple(ta.shape)}, lits "
                         f"{tuple(lits.shape)}, fire {tuple(fire.shape)}, "
                         f"ftype {tuple(ftype.shape)}")


def ta_delta_plain(ta, lits, fire, ftype, seed, *, p_act, p_inact,
                   b_offset=0, c_offset=0, c_total=None):
    """Plain PyTorch version (any device) -> (C, L) int32."""
    _check(ta, lits, fire, ftype)
    return ta_delta_ref(ta, lits, fire, ftype, seed, p_act=p_act,
                        p_inact=p_inact, b_offset=b_offset, c_offset=c_offset,
                        c_total=c_total)


def ta_delta_cuda(ta, lits, fire, ftype, seed, *, p_act, p_inact,
                  b_offset=0, c_offset=0, c_total=None):
    """Launch ``csrc/ta_update.cu`` on CUDA tensors -> (C, L) int32."""
    global launches
    _check(ta, lits, fire, ftype)
    if not ta.is_cuda:
        raise ValueError("ta_delta_cuda takes CUDA tensors")
    C, L = ta.shape
    B = lits.shape[0]
    out = torch.empty((C, L), dtype=torch.int32, device=ta.device)
    P, I, U = _build.P, _build.I, _build.U
    fn = _build.entry("ta_update", "ta_update_launch",
                      [P, P, P, P, P, I, I, I, U, U, U, U, U, U, P])
    err = fn(_build.ptr(ta), _build.ptr(lits), _build.ptr(fire), _build.ptr(ftype),
             _build.ptr(out), B, C, L,
             (C if c_total is None else c_total) & M32,
             (0 if c_total is None else c_offset) & M32,
             int(seed) & M32, int(b_offset) & M32,
             prob_to_u32(p_act), prob_to_u32(p_inact),
             _build.stream_ptr(ta.device))
    _build.check("ta_update", err)
    launches += 1
    return out


def occupancy(B: int, L: int) -> dict:
    """The kernel's registers a thread, threads a block, resident blocks per
    SM, shared bytes a block and spill bytes a thread at batch ``B`` and
    ``L`` literals (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _build.occupancy("ta_update", B, L)


def ta_delta(ta: torch.Tensor, lits: torch.Tensor, fire: torch.Tensor,
             ftype: torch.Tensor, seed: int, *, p_act: float, p_inact: float,
             b_offset: int = 0, c_offset: int = 0,
             c_total: int | None = None) -> torch.Tensor:
    """(C, L) int32 batch-summed feedback delta (``ref.ta_delta_ref``
    semantics).  ``b_offset`` is the global id of ``lits[0]``; ``c_total``
    (with ``c_offset``) switches the automaton hash to global clause ids in
    a bank of ``c_total`` clauses (the clause-sharded trainer's indexing);
    by default clause ids are local."""
    args = (ta.to(torch.int8).contiguous(), lits.to(torch.uint8).contiguous(),
            fire.to(torch.uint8).contiguous(), ftype.to(torch.uint8).contiguous())
    kw = dict(p_act=p_act, p_inact=p_inact, b_offset=b_offset,
              c_offset=c_offset, c_total=c_total)
    if ta.is_cuda:
        return ta_delta_cuda(*args, seed, **kw)
    return ta_delta_plain(*args, seed, **kw)
