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

DeepSeek-V2's published rule (:class:`config.DeepSeekV2Config`): routing
``group_limited_greedy`` (each token's best ``topk_group`` of ``n_group``
expert groups, a group scored by its best expert's probability, then the
top-k of those groups' experts), gates renormalized only under
``norm_topk_prob`` and scaled by ``routed_scaling_factor``; ``dropless``
dispatch (``DeepseekV2MoE.moe_infer``): every routed (token, held expert)
pair is computed, sorted by expert, each expert's SwiGLU over its own
rows, the gated outputs summed in float32.  Under ``held_group`` the layer
holds one routing group's experts (expert parallelism's share of one
device) and computes their part of the result; the router scores all
``n_experts``.

LongCat-Flash's (:class:`config.LongcatFlashConfig`): the router scores
the ``n_experts`` FFN experts and then ``zero_experts`` zero-compute
(identity) experts in one softmax; the top-k are chosen by the scores
plus the learned ``score_bias`` (for the choice only), and the gates are
the chosen scores times ``routed_scaling_factor``.  In the dropless
dispatch a pair of an identity expert adds its gate times the token, in
the float32 sum; the layer holds the FFN experts of ``held_range`` and
computes the identity experts for every token it is given.

The spans ``moe_route`` and ``moe_experts`` time the two parts; the
counters ``moe_experts.rows`` and ``moe_experts.pad_rows`` count the rows
the held experts' products computed and those of them no routed pair
filled, ``moe.pairs`` and ``moe.zero_pairs`` the routed pairs of all
experts and those of them that went to an identity expert.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels.ops import psum
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, held_experts
from repro_torch.trace_scope import fold_backward, trips, unfolded

# spans around the routing and the routed experts' dispatch, products and
# scatter-add
ROUTE_RANGE = "moe_route"
EXPERTS_RANGE = "moe_experts"
# counters of the dropless dispatch: rows the held experts' products
# computed, and those of them that no routed pair filled
ROWS_COUNTER = "moe_experts.rows"
PAD_COUNTER = "moe_experts.pad_rows"
# counters of the dropless dispatch: routed (token, expert) pairs, and those
# of them that went to a zero-compute (identity) expert
PAIRS_COUNTER = "moe.pairs"
ZERO_PAIRS_COUNTER = "moe.zero_pairs"


def init_moe(generator, cfg: ModelConfig, dtype, device) -> dict:
    """``router`` (d, router_width) float32 whatever ``dtype`` is, as the
    reference keeps it, and its float32 ``score_bias`` (router_width,),
    zeros, when it has one; ``gate``, ``up`` (E, d, fe) and ``down`` (E,
    fe, d) of the E experts held (``config.held_experts``); and a
    ``shared`` SwiGLU of width ``n_shared_experts * fe`` when there is
    one."""
    d, E, fe = cfg.d_model, len(held_experts(cfg)), cfg.d_ff_expert
    p = {"router": layers.dense(generator, d, cfg.router_width, torch.float32, device)}
    if cfg.score_bias:
        p["score_bias"] = torch.zeros((cfg.router_width,), dtype=torch.float32, device=device)
    p |= {"gate": layers.normal(generator, (E, d, fe), d ** -0.5, dtype, device),
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


def _top_experts(cfg: ModelConfig, router_w, x_flat, bias=None):
    """x_flat (T, d) -> (gates (T, k) float32, experts (T, k)): each token's
    top-k of the float32 softmax router over all its outputs, among its
    best ``topk_group`` groups under ``group_limited_greedy``, chosen by
    the probabilities plus ``bias`` (router_width,) when one is given, the
    gates being the chosen probabilities; renormalized under
    ``norm_topk_prob``, times ``routed_scaling_factor``."""
    probs = torch.softmax(x_flat.to(torch.float32) @ router_w, dim=-1)
    if cfg.topk_method == "group_limited_greedy":
        T, E = probs.shape
        group_best = probs.view(T, cfg.n_group, E // cfg.n_group).amax(-1)
        _, groups = top_k(group_best, cfg.topk_group)
        keep = torch.zeros_like(group_best, dtype=torch.bool).scatter(1, groups, True)
        probs = torch.where(keep.repeat_interleave(E // cfg.n_group, dim=1), probs, 0.0)
    elif cfg.topk_method != "greedy":
        raise ValueError(f"unknown topk_method {cfg.topk_method!r}")
    if bias is None:
        top_v, top_i = top_k(probs, cfg.top_k)
    else:
        _, top_i = top_k(probs + bias, cfg.top_k)
        top_v = probs.gather(1, top_i)
    if cfg.norm_topk_prob:
        top_v = top_v / torch.clamp(top_v.sum(-1, keepdim=True), min=1e-9)
    return top_v * cfg.routed_scaling_factor, top_i


def _route(cfg: ModelConfig, router_w, x_flat):
    """x_flat (T, d) -> gates (T, n_experts) float32: each token's
    ``_top_experts`` gates, and zeros elsewhere."""
    top_v, top_i = _top_experts(cfg, router_w, x_flat)
    return torch.zeros((x_flat.shape[0], router_w.shape[1]), dtype=torch.float32,
                       device=x_flat.device).scatter(1, top_i, top_v)


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


def _dropless_compute(top_v, top_i, x_flat, gate_w, up_w, down_w, e0: int, n_ffn: int):
    """Every routed pair of the held experts ``e0 .. e0 + E`` (weights (E,
    ...)) and of the identity experts, those from ``n_ffn`` on: top_v, top_i
    (T, k) -> (T, d) in x's type.  The pairs sorted by held expert (then the
    identity experts' pairs, then the other experts'), one host sync for
    the counts, each expert's SwiGLU over its own rows, the outputs times
    their float32 gates summed into their tokens in float32, and each
    identity pair's gate times its token added to that sum."""
    T, d = x_flat.shape
    E = gate_w.shape[0]
    local = top_i.reshape(-1) - e0
    other = torch.where(top_i.reshape(-1) >= n_ffn, E, E + 1)
    key = torch.where((local >= 0) & (local < E), local, other)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=E + 2).tolist()
    pairs = sum(counts[:E])
    spans.count(PAIRS_COUNTER, key.numel())
    spans.count(ZERO_PAIRS_COUNTER, counts[E])
    order = order[:pairs]
    tok = torch.div(order, top_i.shape[1], rounding_mode="floor")
    gates = top_v.reshape(-1)[order]
    xs = x_flat[tok]
    outs, start = [], 0
    for e, n in enumerate(counts[:E]):
        if n:
            xe = xs[start:start + n]
            h = F.silu(xe @ gate_w[e]) * (xe @ up_w[e])
            outs.append(h @ down_w[e])
        start += n
    rows = sum(o.shape[0] for o in outs)
    spans.count(ROWS_COUNTER, rows)
    spans.count(PAD_COUNTER, rows - pairs)
    out = torch.zeros((T, d), dtype=torch.float32, device=x_flat.device)
    if outs:
        out.index_add_(0, tok, torch.cat(outs).to(torch.float32) * gates[:, None])
    if counts[E]:
        # a token's identity pairs add its gates' sum times the token
        zero_gates = torch.where(top_i >= n_ffn, top_v, 0.0).sum(-1)
        out.addcmul_(x_flat.to(torch.float32), zero_gates[:, None])
    return out.to(x_flat.dtype)


def _routed(cfg: ModelConfig, params, x: torch.Tensor, e0: int = 0,
            e_loc: int | None = None) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): the routed experts ``e0 .. e0 + e_loc`` (all
    of them by default) over x's tokens, routed among all the experts;
    under ``dropless`` the held experts (``config.held_experts``), every
    pair."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    if cfg.dropless:
        with spans.span(ROUTE_RANGE):
            top_v, top_i = _top_experts(cfg, params["router"], x_flat,
                                        params.get("score_bias"))
        with spans.span(EXPERTS_RANGE):
            out = _dropless_compute(top_v, top_i, x_flat, params["gate"], params["up"],
                                    params["down"], held_experts(cfg).start, cfg.n_experts)
        return out.view(B, S, d)
    E = cfg.n_experts if e_loc is None else e_loc
    with spans.span(ROUTE_RANGE):
        gates = _route(cfg, params["router"], x_flat)
        if e_loc is not None:
            gates = gates[:, e0:e0 + E]
    with spans.span(EXPERTS_RANGE):
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
    over ``dp_axes``), where the expert count and the batch must divide.
    A ``dropless`` layer runs on one device."""
    if mesh is not None and "model" in mesh.axis_names:
        if cfg.dropless:
            raise ValueError("a dropless expert layer runs on one device, not on a mesh")
        out = _routed_on_mesh(cfg, params, x, mesh, dp_axes)
    else:
        out = _routed(cfg, params, x)
    if cfg.n_shared_experts:
        out = out + layers.mlp(params["shared"], x)
    return out
