"""Mixture-of-experts feed-forward (``repro/models/moe.py``), with expert
parallelism over a mesh's ``model`` axis.

Routing: a float32 softmax router, the top-k experts of each token, their
gates renormalized to sum to 1.  Dispatch: each expert takes its
``capacity`` highest-gate tokens (tokens past capacity are dropped, GShard's
rule); an expert's unused slots pick tokens whose gate is 0, so they add
nothing.  Expert compute is SwiGLU over the gathered (E, capacity, d)
blocks as batched products, then a scatter-add back to the tokens; shared
experts are a dense SwiGLU beside them.

On a mesh (``moe_ff(..., mesh, dp_axes)``, the reference's ``shard_map``
over ``model``): the batch is split over ``dp_axes`` and the expert banks
over ``model`` (``E / model`` experts a shard).  Each (data, model) shard
runs on its logical device: the replicated router over its own tokens, and
its local experts, whose capacity follows from its own token count, as the
reference's per-shard capacity does.  The partial outputs are summed over
``model`` in a fixed order (``ops.psum``) and the data shards concatenated.
Mesh axes that are neither in ``dp_axes`` nor ``model`` hold replicas, so
their first coordinate computes.  Without a mesh all experts are local.
The shard loops are trip scopes (``trace_scope.trips``): the
dry-run traces one shard on ``meta`` and counts it for all.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import psum
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.trace_scope import fold_backward, trips, unfolded

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


def _routed(cfg: ModelConfig, params, x: torch.Tensor, e0: int = 0,
            e_loc: int | None = None) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): the routed experts ``e0 .. e0 + e_loc`` (all
    of them by default) over x's tokens, routed among all the experts."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    E = cfg.n_experts if e_loc is None else e_loc
    with torch.profiler.record_function(ROUTE_RANGE):
        gates = _route(cfg, params["router"], x_flat)
        if e_loc is not None:
            gates = gates[:, e0:e0 + E]
    with torch.profiler.record_function(EXPERTS_RANGE):
        out = _expert_compute(cfg, gates, x_flat, *(params[k][e0:e0 + E]
                                                     for k in ("gate", "up", "down")))
    return out.view(B, S, d)


def _routed_on_mesh(cfg: ModelConfig, params, x: torch.Tensor, mesh,
                    dp_axes: tuple) -> torch.Tensor:
    shape = mesh.shape
    dp_axes = tuple(dp_axes)
    n_model = shape["model"]
    n_dp = math.prod(shape[a] for a in dp_axes)
    if cfg.n_experts % n_model or x.shape[0] % n_dp:
        raise ValueError(f"moe_ff on mesh {shape}: {cfg.n_experts} experts over model "
                         f"{n_model} and batch {x.shape[0]} over {dp_axes} ({n_dp}) "
                         "must divide")
    e_loc, b_loc = cfg.n_experts // n_model, x.shape[0] // n_dp
    keys = ("router", "gate", "up", "down")

    def expert_shard(j, dev, xs, *weights):
        return _routed(cfg, dict(zip(keys, weights)), xs.to(dev), j * e_loc, e_loc)

    def data_shard(k, xs, *weights):
        at, rest = {}, k
        for a in reversed(dp_axes):
            at[a], rest = rest % shape[a], rest // shape[a]
        parts, model_idx = [], range(n_model)
        for j in trips(model_idx):
            at["model"] = j
            dev = mesh.device(tuple(at.get(a, 0) for a in mesh.axis_names))
            parts.append(fold_backward(functools.partial(expert_shard, j, dev), xs,
                                       *(w.to(dev) for w in weights)))
        return psum(unfolded(parts, model_idx), x.device)

    outs, data_idx = [], range(n_dp)
    for k in trips(data_idx):               # data shards, row-major over dp_axes
        outs.append(fold_backward(functools.partial(data_shard, k),
                                  x[k * b_loc:(k + 1) * b_loc], *(params[key] for key in keys)))
    return torch.cat(unfolded(outs, data_idx), dim=0)


def moe_ff(cfg: ModelConfig, params, x: torch.Tensor, mesh=None,
           dp_axes: tuple = ()) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): the routed experts plus the shared ones;
    expert-parallel over ``mesh``'s ``model`` axis when given (the batch
    over ``dp_axes``), where the expert count and the batch must divide."""
    if mesh is not None and "model" in mesh.axis_names:
        out = _routed_on_mesh(cfg, params, x, mesh, dp_axes)
    else:
        out = _routed(cfg, params, x)
    if cfg.n_shared_experts:
        out = out + layers.mlp(params["shared"], x)
    return out
