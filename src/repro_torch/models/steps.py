"""Step builders: train, prefill and decode (``repro/models/steps.py``).

  * train_step:   (model, opt_state, batch) -> (opt_state, info)
  * prefill_step: (model, batch, caches) -> (last-token logits, caches)
  * decode_step:  (model, caches, inputs, pos) -> (logits, caches)

``model`` is a :class:`transformer.Transformer`; ``batch`` and ``inputs``
hold ``tokens`` (B, S) and (B, 1) and/or a stub frontend's ``embeds``
(B, S, d) and (B, 1, d); ``pos`` is the decode position (host int).
Logits are float32.  The train step updates the model's parameters in
place.  ``mesh`` (``launch/mesh.Mesh``) and ``pure_dp`` place a step on a
mesh as the reference's do (``transformer.RunCtx``): MoE's experts run per
(data, model) shard on the mesh's logical devices, and the rest is layout,
so without a MoE layer a mesh step computes what the single-device step
does.  Without a mesh every step is the single-device one.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw

# the span around a prefill step's forward and last logits
PREFILL_RANGE = "prefill_step"


def make_train_step(cfg: ModelConfig, mesh=None,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    remat: bool = True, microbatches: int = 1, pure_dp: bool = False):
    """Train step: the loss's gradients, then one AdamW update in place.
    ``microbatches > 1`` accumulates float32 gradients over that many batch
    slices and divides loss and gradients by their number, as the
    reference's scan does (activation memory / microbatches).
    ``info`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d device tensors."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = RunCtx(mesh=mesh, pure_dp=pure_dp)

    def grads_of(model, params, batch):
        loss = transformer.loss_fn(cfg, model, batch, ctx=ctx, remat=remat)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def train_step(model, opt_state, batch):
        params = list(model.parameters())
        if microbatches == 1:
            loss, grads = grads_of(model, params, batch)
        else:
            micro = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in params]
            for i in range(microbatches):
                l, g = grads_of(model, params, {k: v[i] for k, v in micro.items()})
                loss = loss + l
                for a, b in zip(grads, g):
                    a.add_(b.to(torch.float32))
            # by a tensor: the card divides by a Python scalar as a multiply
            # by its rounded reciprocal
            n = torch.tensor(float(microbatches), device=loss.device)
            loss = loss / n
            grads = [g / n for g in grads]
        opt_state, info = adamw.adamw_update(opt_cfg, grads, params, opt_state)
        return opt_state, dict(info, loss=loss)

    return train_step


def _last_logits(model, hidden) -> torch.Tensor:
    return (hidden[:, -1] @ model.unembed_matrix()).to(torch.float32)


def make_prefill_step(cfg: ModelConfig, mesh=None):
    ctx = RunCtx(mesh=mesh)

    @torch.no_grad()
    def prefill_step(model, batch, caches):
        with spans.span(PREFILL_RANGE):
            hidden, caches = model(batch.get("tokens"), embeds=batch.get("embeds"),
                                   caches=caches, ctx=ctx)
            return _last_logits(model, hidden), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    ctx = RunCtx(mesh=mesh)

    @torch.no_grad()
    def decode_step(model, caches, inputs, pos):
        x = inputs["tokens"] if "tokens" in inputs else inputs["embeds"]
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        hidden, caches = model(inputs.get("tokens"), positions=positions, caches=caches,
                               embeds=inputs.get("embeds"), ctx=ctx)
        return _last_logits(model, hidden), caches

    return decode_step
