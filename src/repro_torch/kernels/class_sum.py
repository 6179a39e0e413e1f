"""Polarity-weighted class-sum vote tally: fired (B, C) @ votes (C, K) ->
(B, K) int32 (the paper's class-sum adder bank).

:func:`class_sum` runs ``csrc/class_sum.cu`` for CUDA tensors and
:func:`class_sum_plain` (``ref.class_sum_ref``) for CPU tensors.  It sums
the unfused training step's class votes and the unfused dense inference
pipeline's.  ``fired`` may be int8 or uint8: the kernel reads bytes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import class_sum_ref

# kernel launches through class_sum on CUDA tensors
launches = 0
LAUNCH_FIELDS = ("grid_x", "split", "samples_per_block")


def _check(fired, votes):
    if fired.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"fired must be int8 or uint8, got {fired.dtype}")
    if votes.dtype != torch.int32:
        raise TypeError(f"votes must be int32, got {votes.dtype}")
    for name, t in dict(fired=fired, votes=votes).items():
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if votes.device != fired.device:
        raise ValueError(f"votes is on {votes.device}, fired on {fired.device}")
    if fired.shape[1] != votes.shape[0]:
        raise ValueError(f"clause count mismatch: fired {tuple(fired.shape)}, "
                         f"votes {tuple(votes.shape)}")


def class_sum_plain(fired, votes):
    """Plain PyTorch version (any device) -> (B, K) int32."""
    _check(fired, votes)
    return class_sum_ref(fired, votes)


def class_sum_cuda(fired, votes):
    """Launch ``csrc/class_sum.cu`` on CUDA tensors -> (B, K) int32."""
    global launches
    _check(fired, votes)
    if not fired.is_cuda:
        raise ValueError("class_sum_cuda takes CUDA tensors")
    B, C = fired.shape
    K = votes.shape[1]
    out = torch.empty((B, K), dtype=torch.int32, device=fired.device)
    P, I = _build.P, _build.I
    fn = _build.entry("class_sum", "class_sum_launch", [P, I, P, P, I, I, I, P])
    # the launch chooses its cluster size and samples a block (see occupancy)
    err = fn(_build.ptr(fired), int(fired.dtype == torch.int8), _build.ptr(votes),
             _build.ptr(out), B, C, K, _build.stream_ptr(fired.device))
    _build.check("class_sum", err)
    launches += 1
    return out


def occupancy(B: int, C: int, K: int) -> dict:
    """The kernel's registers a thread, threads a block, resident blocks per
    SM, shared and spill bytes, and the grid, cluster size along the clause
    axis and samples a block it launches with at batch ``B``, ``C`` clauses
    and ``K`` classes."""
    return _build.occupancy("class_sum", B, C, K, extra=LAUNCH_FIELDS)


def class_sum(fired: torch.Tensor, votes: torch.Tensor) -> torch.Tensor:
    """(B, C) {0,1} int8/uint8 x (C, K) int32 -> (B, K) int32 class sums."""
    args = (fired.contiguous(), votes.to(torch.int32).contiguous())
    return class_sum_cuda(*args) if fired.is_cuda else class_sum_plain(*args)
