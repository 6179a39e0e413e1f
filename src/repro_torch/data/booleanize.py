"""Booleanization front ends: real-valued features -> TM literals.

The MATADOR GUI booleanizes grayscale/MFCC inputs before training; these are
the two standard encoders from the TM literature (REDRESS, paper ref [5]).
Both take a ``(N, F)`` tensor and return ``uint8`` bits on its device, equal
bit for bit to the reference's numpy encoders: they run the same operations
in the same dtype and order.  Integer inputs are computed in float64, which
is where numpy's promotion takes them.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float64)


def thermometer_encode(x: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Per-feature thermometer code over [min, max]: (N, F) -> (N, F*n_bits)."""
    x = _as_float(x)
    lo = x.min(dim=0, keepdim=True).values
    hi = x.max(dim=0, keepdim=True).values
    span = torch.clamp_min(hi - lo, 1e-9)
    levels = (x - lo) / span * n_bits                      # (N, F) in [0, n_bits]
    th = levels[..., None] > torch.arange(n_bits, device=x.device)  # (N, F, n_bits)
    return th.reshape(x.shape[0], -1).to(torch.uint8)


def quantile_binarize(x: torch.Tensor, n_bits: int = 4) -> torch.Tensor:
    """Quantile-threshold code: bit b set iff x > quantile_(b+1)/(n+1).

    The thresholds are ``np.quantile``'s default linear interpolation,
    reproduced exactly: the sorted neighbours ``a <= b`` of each virtual
    index ``(N - 1) q`` are blended as ``a + (b - a) g`` in float64, or as
    ``b - (b - a)(1 - g)`` where ``g >= 0.5`` (numpy's ``_lerp``), and the
    comparison runs in float64.  ``torch.quantile`` is not bit-equal to it
    on tied integer data.
    """
    x = _as_float(x)
    n = x.shape[0]
    # data-independent positions, computed as numpy computes them
    q = np.linspace(0, 1, n_bits + 2)[1:-1]
    vidx = (n - 1) * q
    prev = np.floor(vidx)
    gamma = vidx - prev
    lo_i = prev.astype(np.int64)
    hi_i = lo_i + 1
    top = vidx >= n - 1                    # past the last sample: the maximum
    lo_i[top] = hi_i[top] = n - 1
    srt = torch.sort(x, dim=0).values
    a = srt[torch.from_numpy(lo_i).to(x.device)]           # (n_bits, F)
    b = srt[torch.from_numpy(hi_i).to(x.device)]
    g = torch.from_numpy(gamma).to(x.device)[:, None]      # (n_bits, 1) float64
    diff = (b - a).to(torch.float64)                       # in x's dtype, then widened
    qs = torch.where(g >= 0.5, b.to(torch.float64) - diff * (1 - g),
                     a.to(torch.float64) + diff * g)
    bits = x[None, ...].to(torch.float64) > qs[:, None, :]  # (n_bits, N, F)
    return bits.permute(1, 2, 0).reshape(n, -1).to(torch.uint8)
