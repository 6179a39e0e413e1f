"""Fused single-pass dense TM inference (clause chain + class sum).

The whole MATADOR inference datapath of paper Fig. 5 in one kernel: the
Hard-Coded Clause Block chain ``ok &= (inc & ~lit) == 0`` over every
packed word, the empty-clause mask, and the class-sum adder bank, with no
``(B, C)`` fired matrix in device memory.  :func:`fused_tm_forward` runs
``csrc/fused_infer.cu`` (its chain in ``csrc/clause_chain.cuh``) for CUDA
tensors and :func:`fused_forward_plain` (the ``ref`` composition) for CPU
tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import class_sum_ref, clause_fire_ref

# what the occupancy entry point writes after the common fields: the grid
# and the warps that split each pair's words (csrc/clause_chain.cuh)
GRID_FIELDS = ("grid_x", "grid_y", "word_split")

# The launches the kernel can make, in the reference's block names: a CUDA
# block of BLOCK_B samples and 64 / split clauses, its warps split each
# pair's words `split` ways, so one warp walks ceil(W / split) words.
BLOCK_B = 32
SPLITS = (1, 2, 4)

# kernel launches through fused_tm_forward on CUDA tensors
launches = 0


def _check(lit_words, inc_words, votes, nonempty):
    for name, t in dict(lit_words=lit_words, inc_words=inc_words, votes=votes,
                        nonempty=nonempty).items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != lit_words.device:
            raise ValueError(f"{name} is on {t.device}, lit_words on {lit_words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, W = lit_words.shape
    C, Wc = inc_words.shape
    if W != Wc or votes.shape[0] != C or nonempty.shape != (C,):
        raise ValueError(f"shape mismatch: lit {tuple(lit_words.shape)}, inc "
                         f"{tuple(inc_words.shape)}, votes {tuple(votes.shape)}, "
                         f"nonempty {tuple(nonempty.shape)}")


def fused_forward_plain(lit_words, inc_words, votes, nonempty):
    """Plain PyTorch version: ``class_sum_ref(clause_fire_ref(lit, inc) *
    nonempty, votes)`` on int32 tensors (any device)."""
    _check(lit_words, inc_words, votes, nonempty)
    fired = clause_fire_ref(lit_words, inc_words) * (nonempty != 0).to(torch.int8)[None, :]
    return class_sum_ref(fired, votes)


def blocks_for(split: int, W: int) -> dict:
    """``{block_b, block_c, block_w}`` of the launch with word split
    ``split`` over ``W`` words."""
    return dict(block_b=BLOCK_B, block_c=64 // split, block_w=-(-W // split))


def word_split(W: int, block_b=None, block_c=None, block_w=None) -> int:
    """The word split (1, 2 or 4) that a tiling names over ``W`` words, or
    0, the kernel's own choice (``csrc/clause_chain.cuh:word_split``), when
    it names none.  A tiling the kernel does not launch raises
    ``ValueError``: it is never clamped to one it does."""
    given = {k: v for k, v in dict(block_b=block_b, block_c=block_c,
                                   block_w=block_w).items() if v is not None}
    if not given:
        return 0
    match = [s for s in SPLITS
             if all(blocks_for(s, W)[k] == int(v) for k, v in given.items())]
    if not match:
        raise ValueError(
            f"fused_infer launches {[blocks_for(s, W) for s in SPLITS]} at "
            f"W={W}; {given} is none of them")
    return match[0] if len(match) < len(SPLITS) else 0


def fused_forward_cuda(lit_words, inc_words, votes, nonempty, split: int = 0):
    """Launch ``csrc/fused_infer.cu`` on CUDA tensors -> (B, K) int32;
    ``split`` warps split each pair's words (0: the kernel's choice)."""
    global launches
    _check(lit_words, inc_words, votes, nonempty)
    if not lit_words.is_cuda:
        raise ValueError("fused_forward_cuda takes CUDA tensors")
    B, W = lit_words.shape
    C, K = votes.shape
    # the C entry point zeroes out on the stream before the kernel adds to it
    out = torch.empty((B, K), dtype=torch.int32, device=lit_words.device)
    P, I = _build.P, _build.I
    fn = _build.entry("fused_infer", "fused_infer_launch",
                      [P, P, P, P, P, I, I, I, I, I, P])
    err = fn(_build.ptr(lit_words), _build.ptr(inc_words), _build.ptr(votes),
             _build.ptr(nonempty), _build.ptr(out), B, C, W, K, int(split),
             _build.stream_ptr(lit_words.device))
    _build.check("fused_infer", err)
    launches += 1
    return out


def occupancy(B: int, C: int, split: int = 0) -> dict:
    """The kernel's registers a thread, threads a block, resident blocks per
    SM, shared and spill bytes, and the grid and word split it launches
    with at batch ``B`` and ``C`` clauses and word split ``split`` (0: the
    kernel's choice; nothing else changes the launch: its shared memory is
    static)."""
    return _build.occupancy("fused_infer", B, C, int(split), extra=GRID_FIELDS)


def fused_tm_forward(lit_words: torch.Tensor, inc_words: torch.Tensor,
                     votes: torch.Tensor, nonempty: torch.Tensor | None = None,
                     *, block_b: int | None = None, block_c: int | None = None,
                     block_w: int | None = None) -> torch.Tensor:
    """Packed literals (B, W) x includes (C, W) (int32 bit patterns) ->
    (B, K) int32 class sums; ``nonempty=None`` masks nothing (training
    semantics: empty clauses fire).  ``block_*`` pick the launch (see
    :func:`word_split`; checked on every device, used on the card)."""
    split = word_split(lit_words.shape[1], block_b, block_c, block_w)
    if nonempty is None:
        nonempty = torch.ones(inc_words.shape[0], dtype=torch.int32,
                              device=inc_words.device)
    args = (lit_words.contiguous(), inc_words.contiguous(),
            votes.to(torch.int32).contiguous(), nonempty.to(torch.int32).contiguous())
    if lit_words.is_cuda:
        return fused_forward_cuda(*args, split=split)
    return fused_forward_plain(*args)
