"""Shared LM building blocks: RMS norm, RoPE, the SwiGLU or GELU MLP, the
dense initializer and the chunked cross-entropy loss.  Each computes as
the reference does: norms and rotations in float32, cast back to the
input's type; the loss's logits in float32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    """(d_in, d_out) N(0, 1/d_in) in ``dtype``, drawn in float32 on the
    generator's device."""
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device)
    return (w * d_in ** -0.5).to(dtype)


def dense(generator, d_in: int, d_out: int, dtype, device, shape=None) -> torch.Tensor:
    """:func:`init_dense` reshaped to ``shape`` on ``device``, or zeros of
    that shape when ``generator`` is None (weights to be loaded)."""
    shape = shape or (d_in, d_out)
    if generator is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return init_dense(generator, d_in, d_out, dtype).reshape(shape).to(device)


def normal(generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in float32 and cast to ``dtype``, or zeros when
    ``generator`` is None."""
    if generator is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, device=generator.device) * std
    return w.to(dtype).to(device)


def parameters(tree: dict) -> nn.ParameterDict:
    """A nested dict of tensors -> nested ``nn.ParameterDict``s, so the
    parameters' dotted names are the reference tree's paths."""
    return nn.ParameterDict({k: parameters(v) if isinstance(v, dict) else nn.Parameter(v)
                             for k, v in tree.items()})


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's magnitude factor ``0.1 mscale ln(scale) + 1`` (1 for scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(dim: int, theta: float, yarn) -> tuple:
    """The frequency indices (low, high) between which YaRN's ramp runs:
    the dimensions that turn ``beta_fast`` and ``beta_slow`` times over the
    original context, floor and ceil, clamped to [0, dim - 1]."""
    def dim_of(rotations):
        return (dim * math.log(yarn.original_max_position_embeddings
                               / (rotations * 2 * math.pi)) / (2 * math.log(theta)))

    low = math.floor(dim_of(yarn.beta_fast))
    high = math.ceil(dim_of(yarn.beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_frequencies(dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """YaRN's (dim/2,) inverse frequencies (``DeepseekV2YarnRotaryEmbedding``):
    each plain frequency f_i, below the ramp kept, past it divided by the
    factor, and mixed linearly along it."""
    f = rope_frequencies(dim, theta, device)
    low, high = yarn_correction_range(dim, theta, yarn)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return f / yarn.factor * ramp + f * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: torch.Tensor | None = None, mscale: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Rotates the two halves by
    ``freqs`` (hd/2,) (default: the plain frequencies of ``theta``), with
    cos and sin multiplied by ``mscale``."""
    hd = x.shape[-1]
    if freqs is None:
        freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def init_mlp(generator, d_model: int, d_ff: int, dtype, gated: bool = True,
             device=None) -> dict:
    """``{"up", "down"}`` and, when ``gated``, ``"gate"``: dense matrices
    from ``generator`` (None: zeros, to be loaded), drawn gate, up, down."""
    shapes = {"gate": (d_model, d_ff), "up": (d_model, d_ff), "down": (d_ff, d_model)}
    if not gated:
        del shapes["gate"]
    return {k: dense(generator, *s, dtype, device) for k, s in shapes.items()}


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when ``params`` has a ``gate``, else GELU (tanh form, the
    reference's ``jax.nn.gelu`` default) over two matrices."""
    if "gate" in params:
        return (F.silu(x @ params["gate"]) * (x @ params["up"])) @ params["down"]
    return F.gelu(x @ params["up"], approximate="tanh") @ params["down"]


def chunked_ce_loss(x: torch.Tensor, w_unembed: torch.Tensor, labels: torch.Tensor,
                    n_chunks: int = 8) -> torch.Tensor:
    """Mean cross-entropy over the unmasked positions (label -1 is masked),
    with the logits of one sequence chunk at a time: x (B, S, d) final
    hidden states, w_unembed (d, V), labels (B, S).  ``n_chunks`` halves
    until it divides S; each chunk's ``xc @ w`` is cast to float32, and
    the target logit is read at ``max(label, 0)``."""
    B, S, _ = x.shape
    while S % n_chunks:
        n_chunks //= 2
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc in zip(x.chunk(n_chunks, dim=1), labels.chunk(n_chunks, dim=1)):
        logits = (xc @ w_unembed).to(torch.float32)              # (B, s, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None].long())[..., 0]
        mask = (lc >= 0).to(torch.float32)
        tot = tot + torch.sum((lse - tgt) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)
