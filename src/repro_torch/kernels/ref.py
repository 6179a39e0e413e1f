"""Plain PyTorch oracles for the inference kernels.

Each function defines the exact semantics its kernel must reproduce, on
int32 bit patterns of packed words (``core/packetizer.py``).  The training
oracles (``hash_u32``, ``ta_delta_ref``) arrive with the training slice.
"""

from __future__ import annotations

import torch


def clause_fire_ref(lit_words: torch.Tensor, inc_words: torch.Tensor) -> torch.Tensor:
    """(B, W) literals x (C, W) includes (int32 bit patterns) -> (B, C) int8.

    fire[b, c] = 1 iff every include bit of clause c sees literal 1:
    AND_w ((inc[c, w] & ~lit[b, w]) == 0).  Vacuous AND (empty clause) = 1;
    empty-clause masking is the caller's concern (inference drops them).
    """
    viol = inc_words[None, :, :] & ~lit_words[:, None, :]      # (B, C, W)
    return (~torch.any(viol != 0, dim=-1)).to(torch.int8)


def class_sum_ref(fired: torch.Tensor, votes: torch.Tensor) -> torch.Tensor:
    """(B, C) {0,1} x (C, K) int32 -> (B, K) int32.

    The product runs in float64, which holds every partial sum exactly
    (|sum| <= C * max|vote| < 2**53) and has a matrix product on both the
    CPU and CUDA, where torch has none for int32.
    """
    return (fired.to(torch.float64) @ votes.to(torch.float64)).to(torch.int32)
