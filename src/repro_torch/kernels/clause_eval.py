"""Unfused clause evaluation: packed literals x packed includes -> the
(B, C) int8 fire matrix (the MATADOR Hard-Coded Clause Block chain).

:func:`clause_fire` runs ``csrc/clause_eval.cu`` (its chain in
``csrc/clause_chain.cuh``) for CUDA tensors and
:func:`clause_fire_plain` (``ref.clause_fire_ref``) for CPU tensors.  It
feeds the unfused (``fuse=False``) training step and the unfused dense
inference pipeline (``ops.tm_forward_packed(fuse=False)``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import clause_fire_ref

# what the occupancy entry point writes after the common fields: the grid
# and the warps that split each pair's words (csrc/clause_chain.cuh)
GRID_FIELDS = ("grid_x", "grid_y", "word_split")

# kernel launches through clause_fire on CUDA tensors
launches = 0


def _check(lit_words, inc_words):
    for name, t in dict(lit_words=lit_words, inc_words=inc_words).items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if inc_words.device != lit_words.device:
        raise ValueError(f"inc_words is on {inc_words.device}, lit_words on "
                         f"{lit_words.device}")
    if lit_words.shape[1] != inc_words.shape[1]:
        raise ValueError(f"word count mismatch: lit {tuple(lit_words.shape)}, "
                         f"inc {tuple(inc_words.shape)}")


def clause_fire_plain(lit_words, inc_words):
    """Plain PyTorch version (any device) -> (B, C) int8."""
    _check(lit_words, inc_words)
    return clause_fire_ref(lit_words, inc_words)


def clause_fire_cuda(lit_words, inc_words):
    """Launch ``csrc/clause_eval.cu`` on CUDA tensors -> (B, C) int8."""
    global launches
    _check(lit_words, inc_words)
    if not lit_words.is_cuda:
        raise ValueError("clause_fire_cuda takes CUDA tensors")
    B, W = lit_words.shape
    C = inc_words.shape[0]
    out = torch.empty((B, C), dtype=torch.int8, device=lit_words.device)
    P, I = _build.P, _build.I
    fn = _build.entry("clause_eval", "clause_eval_launch", [P, P, P, I, I, I, P])
    err = fn(_build.ptr(lit_words), _build.ptr(inc_words), _build.ptr(out),
             B, C, W, _build.stream_ptr(lit_words.device))
    _build.check("clause_eval", err)
    launches += 1
    return out


def occupancy(B: int, C: int) -> dict:
    """The kernel's registers a thread, threads a block, resident blocks per
    SM, shared and spill bytes, and the grid and word split it launches
    with at batch ``B`` and ``C`` clauses (nothing else changes the launch:
    its shared memory is static)."""
    return _build.occupancy("clause_eval", B, C, extra=GRID_FIELDS)


def clause_fire(lit_words: torch.Tensor, inc_words: torch.Tensor) -> torch.Tensor:
    """(B, W) packed literals x (C, W) packed includes (int32 bit patterns)
    -> (B, C) int8 clause outputs; an empty clause fires."""
    args = (lit_words.contiguous(), inc_words.contiguous())
    return clause_fire_cuda(*args) if lit_words.is_cuda else clause_fire_plain(*args)
