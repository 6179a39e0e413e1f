"""AdamW with float32 moments over bf16 or float32 params, global-norm
clipping and a cosine schedule with warmup (``repro/optim/adamw.py``).

Parameters and moments are updated in place, one parameter at a time:
at tinyllama-1.1b's 1.1 B parameters, out-of-place copies of the params
and both moments (as the reference's pure function returns them) would
hold ~13 GB more at the peak.  The arithmetic and its cast order are the
reference's: ``g`` to float32 times the clipping scale
``min(1, clip / max(gnorm, 1e-9))``, the moments, ``u + wd * p``, then
``p - lr * u`` cast back to the parameter's type.  Step, learning rate and
scale stay on the parameters' device, so an update never waits for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

# the profiler range around an update, so a profile can split a step
UPDATE_RANGE = "adamw_update"


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class OptState:
    """First and second moments (float32, one per parameter, in the
    parameters' order) and the int32 step count."""

    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: torch.Tensor


def adamw_init(params) -> OptState:
    params = list(params)
    dev = params[0].device if params else None
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=[z(p) for p in params], v=[z(p) for p in params],
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d int tensor): linear warmup,
    then cosine decay to ``min_lr_ratio``, in float32.  Divisions take a
    tensor: on the card a float32 division by a Python scalar is a multiply
    by its rounded reciprocal, which the reference does not do."""
    step = step.to(torch.float32)
    warm = step / _f32(max(cfg.warmup_steps, 1), step)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    tensors = list(tensors)
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                                   for x in tensors]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, params, state: OptState):
    """One AdamW step over ``params`` (tensors, updated in place) from
    ``grads`` (same order) -> ``(state, {"grad_norm", "lr"})``; the moments
    in ``state`` are updated in place and its step advanced."""
    with torch.profiler.record_function(UPDATE_RANGE):
        grads, params = list(grads), list(params)
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = _schedule(cfg, step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
        bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
        for g, p, m, v in zip(grads, params, state.m, state.v):
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            p32 = p.to(torch.float32)
            u = u + cfg.weight_decay * p32
            p.copy_((p32 - lr * u).to(p.dtype))
        state.step = step
    return state, {"grad_norm": gnorm, "lr": lr}
