"""Mixture-of-experts feed-forward (``repro/models/moe.py``), all experts
on one device.

Routing: a float32 softmax router, the top-k experts of each token, their
gates renormalized to sum to 1.  Dispatch: each expert takes its
``capacity`` highest-gate tokens (tokens past capacity are dropped, GShard's
rule); an expert's unused slots pick tokens whose gate is 0, so they add
nothing.  Expert compute is SwiGLU over the gathered (E, capacity, d)
blocks as batched products, then a scatter-add back to the tokens; shared
experts are a dense SwiGLU beside them.

The reference's expert-parallel path (``shard_map`` over the ``model``
axis, a ``psum`` of the partial outputs) waits for the port of
``models/sharding.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

# profiler ranges around the routing and the routed experts' dispatch,
# products and scatter-add
ROUTE_RANGE = "moe_route"
EXPERTS_RANGE = "moe_experts"


def init_moe(generator, cfg: ModelConfig, dtype, device) -> dict:
    """``router`` (d, E) float32 whatever ``dtype`` is, as the reference
    keeps it; ``gate``, ``up`` (E, d, fe) and ``down`` (E, fe, d); and a
    ``shared`` SwiGLU of width ``n_shared_experts * fe`` when there is one."""
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": layers.dense(generator, d, E, torch.float32, device),
         "gate": layers.normal(generator, (E, d, fe), d ** -0.5, dtype, device),
         "up": layers.normal(generator, (E, d, fe), d ** -0.5, dtype, device),
         "down": layers.normal(generator, (E, fe, d), fe ** -0.5, dtype, device)}
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(generator, d, cfg.n_shared_experts * fe, dtype,
                                      device=device)
    return p


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` does not promise an order for ties, and capacity
    picks among many exact-zero gates)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, router_w, x_flat):
    """x_flat (T, d) -> gates (T, E) float32: each token's top-k router
    probabilities, renormalized, and zeros elsewhere."""
    probs = torch.softmax(x_flat.to(torch.float32) @ router_w, dim=-1)
    top_v, top_i = top_k(probs, cfg.top_k)
    top_v = top_v / torch.clamp(top_v.sum(-1, keepdim=True), min=1e-9)
    return torch.zeros_like(probs).scatter(1, top_i, top_v)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens each expert takes: ``min(T, max(8, int(T k cf / E)))``."""
    return min(n_tokens, max(8, int(n_tokens * cfg.top_k * cfg.capacity_factor
                                    / max(cfg.n_experts, 1))))


def _expert_compute(cfg: ModelConfig, gates, x_flat, gate_w, up_w, down_w):
    """gates (T, E) float32, x_flat (T, d), expert weights (E, d|fe, ...) ->
    (T, d): each expert's SwiGLU on its top-capacity tokens, weighted by
    their gates (cast to x's type), summed back into their rows."""
    T, d = x_flat.shape
    E = gates.shape[1]
    w_sel, idx = top_k(gates.T, capacity(cfg, T))              # (E, cap)
    flat = idx.reshape(-1)
    xe = x_flat[flat].view(E, -1, d)                            # (E, cap, d)
    h = F.silu(torch.bmm(xe, gate_w)) * torch.bmm(xe, up_w)
    out_e = torch.bmm(h, down_w) * w_sel[..., None].to(x_flat.dtype)
    return torch.zeros_like(x_flat).index_add(0, flat, out_e.reshape(-1, d))


def moe_ff(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): the routed experts plus the shared ones."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    with torch.profiler.record_function(ROUTE_RANGE):
        gates = _route(cfg, params["router"], x_flat)
    with torch.profiler.record_function(EXPERTS_RANGE):
        out = _expert_compute(cfg, gates, x_flat, params["gate"], params["up"],
                              params["down"]).view(B, S, d)
    if cfg.n_shared_experts:
        out = out + layers.mlp(params["shared"], x)
    return out
