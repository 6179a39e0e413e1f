"""XNOR-popcount binarized matmul, the FINN-style BNN baseline's layer:
packed activations (B, W) x packed weights (O, W) -> (B, O) int32 dots of
the {-1, +1} vectors the bits encode.

:func:`xnor_popcount` runs ``csrc/xnor_popcount.cu`` for CUDA tensors and
:func:`xnor_popcount_plain` (``ref.xnor_popcount_ref``) for CPU tensors.
``ops.xnor_dot`` and ``baselines/bnn.py:bnn_predict`` call it.

The kernel takes the dot over the first ``n_bits`` bits only; the plain
version counts the pad bits past them as matches.  The two agree whenever
the pad bits of ``a_words`` and ``w_words`` agree, as ``pack_bits``' zero
pads do.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import xnor_popcount_ref

# kernel launches through xnor_popcount on CUDA tensors
launches = 0
LAUNCH_FIELDS = ("grid_x", "grid_y", "warp_cols", "block_rows")


def _check(a_words, w_words, n_bits):
    for name, t in dict(a_words=a_words, w_words=w_words).items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 bit patterns, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if w_words.device != a_words.device:
        raise ValueError(f"w_words is on {w_words.device}, a_words on "
                         f"{a_words.device}")
    W = a_words.shape[1]
    if w_words.shape[1] != W:
        raise ValueError(f"word count mismatch: a {tuple(a_words.shape)}, "
                         f"w {tuple(w_words.shape)}")
    if not (W - 1) * 32 < n_bits <= W * 32:
        raise ValueError(f"n_bits={n_bits} does not fill the last of {W} words")


def xnor_popcount_plain(a_words, w_words, n_bits: int):
    """Plain PyTorch version (any device) -> (B, O) int32."""
    _check(a_words, w_words, n_bits)
    return xnor_popcount_ref(a_words, w_words, n_bits)


def xnor_popcount_cuda(a_words, w_words, n_bits: int):
    """Launch ``csrc/xnor_popcount.cu`` on CUDA tensors -> (B, O) int32."""
    global launches
    _check(a_words, w_words, n_bits)
    if not a_words.is_cuda:
        raise ValueError("xnor_popcount_cuda takes CUDA tensors")
    B, W = a_words.shape
    O = w_words.shape[0]
    out = torch.empty((B, O), dtype=torch.int32, device=a_words.device)
    P, I = _build.P, _build.I
    fn = _build.entry("xnor_popcount", "xnor_popcount_launch",
                      [P, P, P, I, I, I, I, P])
    err = fn(_build.ptr(a_words), _build.ptr(w_words), _build.ptr(out), B, O, W,
             n_bits, _build.stream_ptr(a_words.device))
    _build.check("xnor_popcount", err)
    launches += 1
    return out


def occupancy(B: int, O: int, W: int) -> dict:
    """The kernel's registers a thread, threads a block, resident blocks per
    SM, dynamic shared and spill bytes, and the grid, warps side by side
    along O and samples a block (a block is block_rows samples x 32 *
    warp_cols outputs) it launches with at batch ``B``, ``O`` outputs and
    ``W`` words."""
    return _build.occupancy("xnor_popcount", B, O, W, extra=LAUNCH_FIELDS)


def xnor_popcount(a_words: torch.Tensor, w_words: torch.Tensor,
                  n_bits: int) -> torch.Tensor:
    """(B, W) x (O, W) packed {-1: 0, +1: 1} words -> (B, O) int32 dots."""
    args = (a_words.contiguous(), w_words.contiguous(), n_bits)
    return xnor_popcount_cuda(*args) if a_words.is_cuda else xnor_popcount_plain(*args)
