"""FINN-style binarized MLP baseline (paper Table I comparison).

Binary {-1, +1} weights and activations at inference through XNOR-popcount
(``kernels/xnor_popcount.py``: a hand-written CUDA kernel on the card);
trained in float with straight-through estimators, the BNN recipe FINN
compiles.  Topologies default to the paper's Table II entries (MNIST
784-256-256-256-10).  Training runs float products only, so it stays on
``torch.matmul`` and autograd.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import packetizer
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class BNNConfig:
    layer_sizes: Tuple[int, ...] = (784, 256, 256, 256, 10)
    lr: float = 1e-3


def bnn_init(cfg: BNNConfig, generator: torch.Generator, device="cuda") -> list:
    """Per-layer (d_in, d_out) float32 weights, N(0, 1/d_in), drawn on the
    generator's device."""
    dev = _device.resolve(device)
    return [(torch.randn((d_in, d_out), generator=generator,
                         device=generator.device) * d_in ** -0.5).to(dev)
            for d_in, d_out in zip(cfg.layer_sizes[:-1], cfg.layer_sizes[1:])]


def bnn_params_from_numpy(arrays, device="cuda") -> list:
    """Weights given as numpy arrays (e.g. the reference's ``bnn_init``)
    -> float32 tensors on ``device``."""
    dev = _device.resolve(device)
    return [torch.from_numpy(np.array(a, np.float32)).to(dev) for a in arrays]


def _sign(x):
    return torch.sign(torch.where(x == 0, 1.0, x))


def _clip(x):
    # maximum then minimum, as jnp.clip: a tie at +-1 passes half the
    # gradient, as in the reference
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, -one), one)


def _binarize_ste(w):
    """Straight-through sign with the standard |w| <= 1 gradient clip."""
    y = _clip(w)
    return y + (_sign(w) - y).detach()


def _forward_float(params, x):
    """Training forward: binarized weights and activations, hard-tanh STE
    (gradients flow only where the normalized pre-activation is in
    [-1, 1])."""
    h = 2.0 * x.to(torch.float32) - 1.0           # {0,1} -> {-1,+1}
    for i, w in enumerate(params):
        h = h @ _binarize_ste(w)
        if i < len(params) - 1:
            y = _clip(h / float(w.shape[0]) ** 0.5)   # normalized pre-activation
            h = y + (_sign(h) - y).detach()
    return h


def bnn_train(cfg: BNNConfig, params, X, y, *, epochs: int, batch_size: int) -> list:
    """Plain SGD on the STE loss over numpy data ``X`` (N, F) {0,1}, ``y``
    (N,); batches follow the reference's ``np.random.default_rng(0)``
    permutation per epoch, so both packages see the same batches."""
    # logits scale: +-1 dots reach +-d_in and saturate the softmax; dividing
    # by sqrt(d_in) restores gradient flow (argmax-invariant)
    scale = 1.0 / float(cfg.layer_sizes[-2]) ** 0.5
    dev = params[0].device
    params = [p.detach().requires_grad_(True) for p in params]
    n = X.shape[0]
    nprng = np.random.default_rng(0)
    for _ in range(epochs):
        perm = nprng.permutation(n)
        for i in range(n // batch_size):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            xb = torch.from_numpy(X[idx]).to(dev)
            yb = torch.from_numpy(np.asarray(y[idx], np.int64)).to(dev)
            logits = _forward_float(params, xb) * scale
            loss = -torch.log_softmax(logits, dim=-1)[torch.arange(len(idx), device=dev), yb].mean()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                params = [(p - cfg.lr * g).requires_grad_(True)
                          for p, g in zip(params, grads)]
    return [p.detach() for p in params]


def bnn_pack(params) -> List[Tuple[torch.Tensor, int]]:
    """Deployable artifact: per layer, the (out, ceil(in/32)) packed sign
    bits of the weights (int32 bit patterns) and the input width."""
    return [(packetizer.pack_bits((torch.sign(w) > 0).to(torch.uint8).T), w.shape[0])
            for w in params]


def bnn_layer_dots(packed, x) -> list:
    """Every layer's (B, out) int32 XNOR-popcount dots for {0,1} inputs
    ``x`` (B, in), on ``x``'s device."""
    a = x.to(torch.uint8)                                     # {0,1} first layer
    dots = []
    for i, (w_words, n_bits) in enumerate(packed):
        dots.append(ops.xnor_dot(packetizer.pack_bits(a), w_words, n_bits))
        if i < len(packed) - 1:
            a = (dots[-1] >= 0).to(torch.uint8)               # sign activation
    return dots


def bnn_predict(packed, x) -> torch.Tensor:
    """Bitpacked XNOR-popcount inference over the whole stack -> (B,) int64."""
    return torch.argmax(bnn_layer_dots(packed, x)[-1], dim=-1)
