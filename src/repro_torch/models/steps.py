"""Step builders for serving: prefill and decode.

  * prefill_step: (model, batch, caches) -> (last-token logits, caches)
  * decode_step:  (model, caches, inputs, pos) -> (logits, caches)

``model`` is a :class:`transformer.Transformer`; ``batch`` and ``inputs``
hold ``tokens`` (B, S) and (B, 1); ``pos`` is the decode position (host
int).  Logits are float32.  The train step waits for the optimizer's port.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(model, batch, caches):
        hidden, caches = model(batch["tokens"], caches=caches)
        return (hidden[:, -1] @ model.unembed_matrix()).to(torch.float32), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(model, caches, inputs, pos):
        tokens = inputs["tokens"]
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=tokens.device)
        hidden, caches = model(tokens, positions=positions, caches=caches)
        return (hidden[:, -1] @ model.unembed_matrix()).to(torch.float32), caches

    return decode_step
