"""Fused single-pass dense TM inference (clause chain + class sum).

The whole MATADOR inference datapath of paper Fig. 5 in one kernel: the
Hard-Coded Clause Block chain ``ok &= (inc & ~lit) == 0`` over every
packed word, the empty-clause mask, and the class-sum adder bank, with no
``(B, C)`` fired matrix in device memory.  :func:`fused_tm_forward` runs
``csrc/fused_infer.cu`` for CUDA tensors and :func:`fused_forward_plain`
(the ``ref`` composition) for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import class_sum_ref, clause_fire_ref

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


def fused_forward_cuda(lit_words, inc_words, votes, nonempty):
    """Launch ``csrc/fused_infer.cu`` on CUDA tensors -> (B, K) int32."""
    global launches
    _check(lit_words, inc_words, votes, nonempty)
    if not lit_words.is_cuda:
        raise ValueError("fused_forward_cuda takes CUDA tensors")
    B, W = lit_words.shape
    C, K = votes.shape
    out = torch.zeros((B, K), dtype=torch.int32, device=lit_words.device)
    P, I = _build.P, _build.I
    fn = _build.entry("fused_infer", "fused_infer_launch",
                      [P, P, P, P, P, I, I, I, I, P])
    err = fn(_build.ptr(lit_words), _build.ptr(inc_words), _build.ptr(votes),
             _build.ptr(nonempty), _build.ptr(out), B, C, W, K,
             _build.stream_ptr(lit_words.device))
    _build.check("fused_infer", err)
    launches += 1
    return out


def fused_tm_forward(lit_words: torch.Tensor, inc_words: torch.Tensor,
                     votes: torch.Tensor, nonempty: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Packed literals (B, W) x includes (C, W) (int32 bit patterns) ->
    (B, K) int32 class sums; ``nonempty=None`` masks nothing (training
    semantics: empty clauses fire)."""
    if nonempty is None:
        nonempty = torch.ones(inc_words.shape[0], dtype=torch.int32,
                              device=inc_words.device)
    args = (lit_words.contiguous(), inc_words.contiguous(),
            votes.to(torch.int32).contiguous(), nonempty.to(torch.int32).contiguous())
    return fused_forward_cuda(*args) if lit_words.is_cuda else fused_forward_plain(*args)
