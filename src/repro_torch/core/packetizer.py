"""Literal packing — the port of MATADOR's Packetizer.

The 2F literals of each datapoint pack into ``ceil(2F/32)`` 32-bit words,
bit ``i`` of word ``w`` = literal ``32*w + i`` (LSB-first, paper Fig. 4a),
with zero padding in the final word.  Zero padding is safe: include masks
use the same layout and a zero include bit never produces a violation.

torch has no uint32 ``+``, ``>>``, ``<``, ``~`` or ``index_select``, so
packed words travel as **int32 bit patterns** (the same 32 bits a numpy
uint32 holds; ``words.view(np.uint32)`` recovers it).  Every right shift
is followed by a mask, because ``>>`` on int32 copies the sign bit.  The
CUDA kernels read the same memory as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def n_words(n_bits: int, word_bits: int = WORD_BITS) -> int:
    return (n_bits + word_bits - 1) // word_bits


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} tensor along its last axis into int32 words (LSB-first).

    (..., L) -> (..., ceil(L/32)) int32 bit patterns.
    """
    L = bits.shape[-1]
    W = n_words(L)
    b = bits.to(torch.int64)
    pad = W * WORD_BITS - L
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (W, WORD_BITS))
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=bits.device)
    return to_int32_bits((b * weights).sum(dim=-1))


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`. (..., W) int32 -> (..., n_bits) uint8."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1   # mask the sign copy
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return bits[..., :n_bits].to(torch.uint8)


def literals(x: torch.Tensor) -> torch.Tensor:
    """(B, F) {0,1} -> (B, 2F): each feature contributes x and ~x (Fig. 1b)."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def pack_literals(x: torch.Tensor) -> torch.Tensor:
    """(B, F) {0,1} features -> (B, ceil(2F/32)) packed int32 literal words."""
    return pack_bits(literals(x))


def pack_include_masks(ta_state: torch.Tensor) -> torch.Tensor:
    """(C, L) int8 automata -> (C, ceil(L/32)) packed int32 include words
    (include iff state >= 0)."""
    return pack_bits((ta_state >= 0).to(torch.uint8))


# -- numpy twins (host-side Packetizer used by the offline compiler) ---------

def pack_bits_np(bits: np.ndarray, word_bits: int = WORD_BITS) -> np.ndarray:
    L = bits.shape[-1]
    W = n_words(L, word_bits)
    pad = W * word_bits - L
    b = bits.astype(np.uint64)
    if pad:
        b = np.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    b = b.reshape(b.shape[:-1] + (W, word_bits))
    weights = (np.uint64(1) << np.arange(word_bits, dtype=np.uint64))
    return (b * weights).sum(axis=-1).astype(np.uint32)


def unpack_bits_np(words: np.ndarray, n_bits: int, word_bits: int = WORD_BITS) -> np.ndarray:
    shifts = np.arange(word_bits, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * word_bits,))
    return bits[..., :n_bits].astype(np.uint8)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor with the same bits on ``device``."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(w.view(np.int32).copy()).to(device)
