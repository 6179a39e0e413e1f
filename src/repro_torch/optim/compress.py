"""Gradient compression: an int8 quantized all-reduce with error feedback
(``repro/optim/compress.py``).

Each data shard's gradient (plus its carried error) is quantized to int8
against one float32 scale, the largest magnitude over the shards / 127;
the int32 sum over the shards is exact (``ops.psum``), then dequantized to
the mean; each shard keeps its quantization residual for the next step
(error feedback).  One process holds every shard, so a call takes a list
of per-shard tensors where the reference's runs inside ``shard_map``.
Every scalar division takes a tensor: on the card a float32 division by a
Python scalar is a multiply by its rounded reciprocal, which the
reference does not do.  The residual is rounded once, as XLA's fused
multiply-add rounds it.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.kernels.ops import psum
from repro_torch.models.sharding import tree_leaves, tree_map


def quantize_psum(grads: List[torch.Tensor], errs: List[torch.Tensor]
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One tensor, one gradient and one error a shard -> (the all-reduced
    mean gradient, on the first shard's device; each shard's new error)."""
    g = [a.to(torch.float32) + e for a, e in zip(grads, errs)]
    dev = g[0].device
    amax = torch.stack([torch.max(torch.abs(x)).to(dev) for x in g]).max()   # pmax
    scale = torch.clamp(amax, min=1e-12) / torch.tensor(127.0, device=dev)
    q, new_err = [], []
    for x in g:
        s = scale.to(x.device)
        qx = torch.clamp(torch.round(x / s), -127, 127)
        q.append(qx)
        # g - q * scale rounded once, as the reference's fused multiply-add:
        # q * scale (7 x 24 bits) and the difference are exact in float64
        new_err.append((x.double() - qx.double() * s.double()).to(torch.float32))
    summed = psum([x.to(torch.int32) for x in q], dev)
    n = torch.tensor(float(len(g)), device=dev)
    return (summed.to(torch.float32) * scale) / n, new_err


def compressed_allreduce(grads: List[Any], errs: List[Any]) -> Tuple[Any, List[Any]]:
    """Trees (dicts, lists) of tensors, one tree a shard -> (the mean tree,
    each shard's new error tree)."""
    cols = list(zip(*(tree_leaves(t) for t in grads)))
    ecols = list(zip(*(tree_leaves(t) for t in errs)))
    out = [quantize_psum(list(g), list(e)) for g, e in zip(cols, ecols)]
    it = iter(out)
    mean = tree_map(lambda _: next(it)[0], grads[0])
    new_errs = []
    for k in range(len(grads)):
        it = iter(out)
        new_errs.append(tree_map(lambda _: next(it)[1][k], grads[0]))
    return mean, new_errs


def init_error(params: Any) -> Any:
    """A float32 zero error a leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
