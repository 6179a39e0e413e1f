"""The reference's ``jax.random`` draws, bit for bit, in torch.

``jax.random`` with its default implementation (threefry2x32) and the
partitionable layout (``jax_threefry_partitionable``, the default since
jax 0.5) is a pure function of a key and a counter, so torch can
reproduce every draw the reference's trainer makes:

  * a key is two 32-bit words; ``PRNGKey(s)`` is ``(0, s mod 2**32)``, as
    jax makes it without 64-bit mode;
  * a draw of ``shape`` runs threefry2x32 over the flat row-major iota of
    ``shape``, cut into hi and lo counter words; 32-bit bits are
    ``y0 ^ y1``, 8- and 16-bit bits their low bits;
  * ``split(key, n)[i]`` is ``(y0, y1)`` at counter ``i``;
  * ``uniform`` puts the top 23 bits under the exponent of 1.0 and
    subtracts 1; ``randint`` folds two draws of the dtype's width modulo
    the span; ``permutation`` stable-sorts an iota by fresh 32-bit keys
    in ``ceil(3 ln n / ln(2**32 - 1))`` rounds.

torch on the CPU has no uint32 ``+``, ``>>`` or ``<``, so words are int64
tensors holding values in [0, 2**32), masked after every add.  Keys are
int64 tensors of shape ``(..., 2)``; every function is batched over the
leading key dimensions (``B`` keys draw ``B`` streams in one pass) and
draws on the key's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes: (2,) int64."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def as_key(key, device=None) -> torch.Tensor:
    """A key held as a tensor, a numpy array (a checkpoint's uint32
    ``rng``) or a sequence -> an int64 tensor of 32-bit words on
    ``device`` (the key's own when None)."""
    if isinstance(key, torch.Tensor):
        t = key.to(torch.int64)
    else:
        t = torch.from_numpy(np.asarray(key).astype(np.int64))
    if t.shape[-1:] != (2,):
        raise ValueError(f"a key has a last dimension of 2, got {tuple(t.shape)}")
    return (t & M32).to(device if device is not None else t.device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) on int64 words,
    broadcast over all four -> ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _words_at(key: torch.Tensor, index: torch.Tensor):
    """threefry2x32 of ``key`` (``(..., 2)``, broadcast against ``index``)
    at the 64-bit counters ``index`` (int64, >= 0)."""
    return threefry2x32(key[..., 0], key[..., 1], index >> 32, index & M32)


def _iota(key: torch.Tensor, shape) -> torch.Tensor:
    """The flat counters of ``shape``, shaped to broadcast after the key's
    leading dimensions."""
    shape = tuple(shape)
    return torch.arange(math.prod(shape), dtype=torch.int64,
                        device=key.device).reshape(shape)


def _key_for(key: torch.Tensor, shape) -> torch.Tensor:
    """``(*kb, 2)`` -> ``(*kb, 1, ..., 1, 2)`` for a draw of ``shape``."""
    return key.reshape(key.shape[:-1] + (1,) * len(tuple(shape)) + (2,))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(*kb, 2)`` -> ``(*kb, num, 2)``."""
    y0, y1 = _words_at(_key_for(key, (num,)), _iota(key, (num,)))
    return torch.stack([y0, y1], dim=-1)


def bits_at(key: torch.Tensor, index: torch.Tensor, bit_width: int = 32) -> torch.Tensor:
    """The bits ``random_bits(key, bit_width, shape)`` holds at the flat
    positions ``index`` of ``shape``, with ``key[..., 0]`` broadcast
    against ``index``: a caller that reads a few positions of a large
    draw computes only those."""
    y0, y1 = _words_at(key, index)
    bits = y0 ^ y1
    return bits if bit_width == 32 else bits & ((1 << bit_width) - 1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits``: ``(*kb, *shape)`` int64 values of ``bit_width``
    (8, 16 or 32) bits."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    return bits_at(_key_for(key, shape), _iota(key, shape), bit_width)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit draws -> float32 in [0, 1): the top 23 bits as the mantissa
    of a number in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    return bits_to_uniform(random_bits(key, 32, shape))


def _mul_mod(a: torch.Tensor, m: int, mask: int) -> torch.Tensor:
    """``(a * m) & mask`` for int64 ``a`` in [0, 2**32) and ``0 <= m <
    2**32``, in 16-bit halves so no int64 product overflows."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & mask


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint``: integers in [minval, maxval) of ``dtype``
    (8, 16 or 32 bits), ``(*kb, *shape)``.

    Two draws of the dtype's width (from a 2-way split) fold modulo the
    span, all in the dtype's unsigned width: ``(hi % span * m + lo %
    span) % span`` with ``m = (2**(nbits/2) % span)**2 % span``.
    """
    info = torch.iinfo(dtype)
    nbits = info.bits
    mask = (1 << nbits) - 1
    out_of_range = maxval > info.max
    lo_v = min(max(int(minval), info.min), info.max)
    hi_v = min(max(int(maxval), info.min), info.max)
    span = (hi_v - lo_v) & mask if hi_v > lo_v else 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & mask

    def rem(a, m):        # XLA's unsigned remainder: a % 0 == a
        return a % m if m else a

    mult = rem(1 << (nbits // 2), span)
    mult = rem((mult * mult) & mask, span)
    k = split(key, 2)
    hi = random_bits(k[..., 0, :], nbits, shape)
    lo = random_bits(k[..., 1, :], nbits, shape)
    off = rem((_mul_mod(rem(hi, span), mult, mask) + rem(lo, span)) & mask, span)
    # the offset converted to the signed dtype and added to minval, wrapping
    val = ((lo_v + off - info.min) & mask) + info.min
    return val.to(dtype)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for a single key: (n,) int64."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key, 2).unbind(-2)
        order = torch.sort(random_bits(sub, 32, (n,)), stable=True).indices
        x = x[order]
    return x
