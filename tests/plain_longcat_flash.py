"""LongCat-Flash-Chat's forward pass in plain PyTorch and float32: the plain
reference.

It follows the published model (``modeling_longcat_flash.py`` of
https://huggingface.co/meituan-longcat/LongCat-Flash-Chat and
arXiv:2509.01322) for inference: embedding; ``num_layers`` double layers;
a final norm and the output head.  A double layer
(``LongcatFlashDecoderLayer``), with RMS norms n_j before each MLA and m_j
before each feed-forward:

    h = x + MLA_0(n_0(x));  u = m_0(h)
    moe = MoE(u)                                  (the shortcut)
    h = h + FFN_0(u)
    h = h + MLA_1(n_1(h))
    y = h + FFN_1(m_1(h)) + moe

* MLA (``LongcatFlashMLA``): ``q = wq_b(norm(wq_a x))`` split into nope
  and rope parts, both times ``sqrt(hidden_size / q_lora_rank)`` under
  ``mla_scale_q_lora``; ``[c_kv, k_rope] = wkv_a x``, ``c_kv`` normed; per
  head k_nope and v from ``c_kv`` times ``sqrt(hidden_size /
  kv_lora_rank)`` under ``mla_scale_kv_lora``; the rope parts rotated by
  plain RoPE at ``rope_theta``; causal softmax attention at scale ``(nope +
  rope)^-0.5``.  The cache a sublayer writes is the unscaled normed
  ``c_kv`` and the rotated ``k_rope``.
* FFN: a dense SwiGLU of width ``ffn_hidden_size``.
* MoE (``LongcatFlashMoE``, ``LongcatFlashTopkRouter``): a float32 softmax
  router over ``n_routed_experts + zero_expert_num`` outputs, the FFN
  experts first; each token's ``moe_topk`` experts are the largest of the
  scores plus ``e_score_correction_bias`` (the lower index first among
  ties), the bias deciding the choice only; the gates are the chosen
  scores times ``routed_scaling_factor``, not renormalized.  A chosen FFN
  expert adds its gate times its SwiGLU (width ``expert_ffn_hidden_size``)
  of u; a chosen zero-compute expert (``zero_expert_type`` identity) its
  gate times u.

Departures from the published description:

* RoPE rotates the two halves of the rope dimensions (``rotate_half`` on
  ``[x1, x2]``), where the published code first de-interleaves the pairs.
  The two differ by a fixed permutation of the rope columns of ``wq_b``
  and ``wkv_a``: with random weights they are the same model.
* One device's share of an expert-parallel deployment, as the spec states
  it: the first ``held_layers`` double layers, the FFN experts ``[start,
  stop)`` of ``held_experts`` (the router still scores all its outputs;
  what the absent experts would add is left out, and that partial sum
  goes on), the identity experts of every token (the device that holds a
  token computes them), and the first ``held_vocab`` vocabulary rows.  Each
  defaults to the whole model.  :func:`weight_shapes` gives every weight
  of the share, its shape and the scale a random draw takes.
* Weights are named ``blocks.<i>.mix.<j>.wq_a``, ``blocks.<i>.ff.<j>.up``,
  ``blocks.<i>.moe.router``, ..., in the ``x @ W`` orientation, and a
  norm's weight is stored as its offset from 1 (the published
  ``RMSNorm.weight`` is 1 plus it).
* No dropout, no cache, no multi-token prediction: a prompt's forward from
  position 0, each prompt of a batch on its own.

:func:`forward` takes the weights as a dict, or as a function that returns
the weights of the names it is given, called for the embedding, once a
double layer and once for the head, so that only one double layer's
float32 weights need be held at a time.  The spec's ``variant`` (not the
published model; the benchmark's controls) changes one rule:
``sequential_moe`` adds the MoE output right after FFN_0, with no
shortcut; ``zero_dropped`` lets the identity experts add nothing;
``bias_in_gate`` uses the scores plus the bias as the gates too.

Everything is float32 with TF32 off.  Attention runs in blocks of query
rows over the keys up to the block's last row, so a 16,384-token prompt
fits on one card.  Nothing here imports the program or JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
VARIANTS = (None, "sequential_moe", "zero_dropped", "bias_in_gate")


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, pos, theta: float):
    """x (S, H, rope) rotated at positions pos (S,): the halves [x1, x2]."""
    dim = x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=F32, device=x.device) / dim)
    ang = pos[:, None].to(F32) * inv_freq                  # (S, rope/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def lora_scales(spec: dict) -> tuple:
    """(q's, the latent's) LoRA scales."""
    d = spec["hidden_size"]
    return ((d / spec["q_lora_rank"]) ** 0.5 if spec["mla_scale_q_lora"] else 1.0,
            (d / spec["kv_lora_rank"]) ** 0.5 if spec["mla_scale_kv_lora"] else 1.0)


def softmax_scale(spec: dict) -> float:
    return (spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]) ** -0.5


def causal_attention(q, k, v, scale, block: int):
    """q, k (S, H, qk), v (S, H, dv) -> (S, H, dv): each block of query rows
    over the keys up to its last row, the keys after a row masked."""
    S, H = q.shape[:2]
    qh = q.permute(1, 0, 2)                                # (H, S, qk)
    kt = k.permute(1, 2, 0).contiguous()                   # (H, qk, S)
    vh = v.permute(1, 0, 2).contiguous()                   # (H, S, dv)
    out = torch.empty((H, S, v.shape[2]), dtype=F32, device=q.device)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        s = torch.matmul(qh[:, q0:q1], kt[:, :, :q1]) * scale
        later = torch.ones((q1 - q0, q1 - q0), dtype=torch.bool, device=q.device).triu(1)
        s[:, :, q0:q1].masked_fill_(later, float("-inf"))
        out[:, q0:q1] = torch.matmul(torch.softmax(s, dim=-1), vh[:, :q1])
    return out.permute(1, 0, 2)


def mla(w: dict, p: str, x, pos, spec: dict, block: int):
    """-> (output (S, d), c_kv (S, kv_lora), k_rope (S, rope))."""
    nope = spec["qk_nope_head_dim"]
    kvl, eps, theta = spec["kv_lora_rank"], spec["rms_norm_eps"], float(spec["rope_theta"])
    q_scale, kv_scale = lora_scales(spec)
    q = torch.einsum("sr,rhk->shk", rms_norm(x @ w[p + "wq_a"], w[p + "q_norm"], eps),
                     w[p + "wq_b"]) * q_scale
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], dim=-1)
    kv = x @ w[p + "wkv_a"]
    c_kv = rms_norm(kv[:, :kvl], w[p + "kv_norm"], eps)
    k_rope = rope(kv[:, None, kvl:], pos, theta)[:, 0]
    H = q.shape[1]
    k = torch.cat([torch.einsum("sr,rhk->shk", c_kv * kv_scale, w[p + "wk_b"]),
                   k_rope[:, None, :].expand(-1, H, -1)], dim=-1)
    v = torch.einsum("sr,rhk->shk", c_kv * kv_scale, w[p + "wv_b"])
    o = causal_attention(q, k, v, softmax_scale(spec), block)
    return torch.einsum("shv,hvd->sd", o, w[p + "wo"]), c_kv, k_rope


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def route(x, router, bias, spec: dict):
    """x (T, d) -> (gates (T, k), experts (T, k)) over all the router's
    outputs (the FFN experts, then the zero-compute ones)."""
    scores = torch.softmax(x @ router, dim=-1)
    choice = scores + bias
    idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :spec["moe_topk"]]
    picked = choice if spec.get("variant") == "bias_in_gate" else scores
    return picked.gather(1, idx) * spec["routed_scaling_factor"], idx


def held_layers(spec: dict) -> int:
    return spec.get("held_layers", spec["num_layers"])


def held_vocab(spec: dict) -> int:
    return spec.get("held_vocab", spec["vocab_size"])


def held_range(spec: dict) -> range:
    """The held FFN experts of all ``n_routed_experts``."""
    return range(*spec.get("held_experts", (0, spec["n_routed_experts"])))


def layer_names(spec: dict, i: int) -> list:
    """The names of double layer ``i``'s weights."""
    return [k for k in weight_shapes(spec) if k.startswith(f"blocks.{i}.")]


def weight_shapes(spec: dict) -> dict:
    """``{name: (shape, std)}`` of every weight of the held share, in a fixed
    order: a matrix N(0, 1/d_in) (std d_in^-0.5), but the up-projections
    from the latents (``wq_b``, ``wk_b``, ``wv_b``) N(0, 1/hidden_size); the
    embedding N(0, 0.02^2); the router's bias N(0, 1/outputs^2) (about one
    mean score); a norm's offset from 1 zero (std 0).

    The LoRA scales multiply by sqrt(hidden_size / rank), which gives an
    up-projection from a unit-RMS latent of width rank, drawn at the
    model's width (std hidden_size^-0.5), the output scale of a full-width
    projection.  Drawn at their own fan-in instead, the scales would raise
    q 2 times and k and v 3.46 times over a variance-preserving draw, and
    attention would turn near-argmax."""
    d, V = spec["hidden_size"], held_vocab(spec)
    H, nope = spec["num_attention_heads"], spec["qk_nope_head_dim"]
    rope_d, dv = spec["qk_rope_head_dim"], spec["v_head_dim"]
    ql, kvl = spec["q_lora_rank"], spec["kv_lora_rank"]
    ff, fe = spec["ffn_hidden_size"], spec["expert_ffn_hidden_size"]
    E, R = len(held_range(spec)), spec["n_routed_experts"] + spec["zero_expert_num"]
    ws = {"embed": ((V, d), 0.02)}
    for i in range(held_layers(spec)):
        p = f"blocks.{i}."
        for j in range(2):
            m = f"{p}mix.{j}."
            ws.update({f"{p}norm1.{j}": ((d,), 0.0),
                       m + "wq_a": ((d, ql), d ** -0.5),
                       m + "q_norm": ((ql,), 0.0),
                       m + "wq_b": ((ql, H, nope + rope_d), d ** -0.5),
                       m + "wkv_a": ((d, kvl + rope_d), d ** -0.5),
                       m + "kv_norm": ((kvl,), 0.0),
                       m + "wk_b": ((kvl, H, nope), d ** -0.5),
                       m + "wv_b": ((kvl, H, dv), d ** -0.5),
                       m + "wo": ((H, dv, d), (H * dv) ** -0.5),
                       f"{p}norm2.{j}": ((d,), 0.0),
                       f"{p}ff.{j}.gate": ((d, ff), d ** -0.5),
                       f"{p}ff.{j}.up": ((d, ff), d ** -0.5),
                       f"{p}ff.{j}.down": ((ff, d), ff ** -0.5)})
        ws.update({p + "moe.router": ((d, R), d ** -0.5),
                   p + "moe.score_bias": ((R,), 1.0 / R),
                   p + "moe.gate": ((E, d, fe), d ** -0.5),
                   p + "moe.up": ((E, d, fe), d ** -0.5),
                   p + "moe.down": ((E, fe, d), fe ** -0.5)})
    ws.update({"final_norm": ((d,), 0.0), "unembed": ((d, V), d ** -0.5)})
    return ws


def moe(w: dict, p: str, u, spec: dict):
    """-> (output (T, d), routed pairs of the held FFN experts, pairs of the
    identity experts)."""
    gates, idx = route(u, w[p + "router"], w[p + "score_bias"], spec)
    held, n_ffn = held_range(spec), spec["n_routed_experts"]
    out = torch.zeros_like(u)
    pairs = 0
    for j, e in enumerate(held):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            pairs += tok.numel()
            y = swiglu(u[tok], w[p + "gate"][j], w[p + "up"][j], w[p + "down"][j])
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    tok, slot = torch.nonzero(idx >= n_ffn, as_tuple=True)
    if spec.get("variant") != "zero_dropped":
        out.index_add_(0, tok, u[tok] * gates[tok, slot][:, None])
    return out, pairs, tok.numel()


def double_layer(w: dict, p: str, x, pos, spec: dict, block: int):
    """One double layer of one prompt x (S, d) -> (y, [(c_kv, k_rope)] of
    its two MLA sublayers, held pairs, identity pairs, (the MoE's input u,
    its output))."""
    eps = spec["rms_norm_eps"]
    caches = []
    for j in range(2):
        h, c_kv, k_rope = mla(w, f"{p}mix.{j}.", rms_norm(x, w[f"{p}norm1.{j}"], eps), pos,
                              spec, block)
        caches.append((c_kv, k_rope))
        x = x + h
        u = rms_norm(x, w[f"{p}norm2.{j}"], eps)
        if j == 0:
            moe_io = (u, moe(w, p + "moe.", u, spec))
            shortcut, pairs, zero = moe_io[1]
        x = x + swiglu(u, w[f"{p}ff.{j}.gate"], w[f"{p}ff.{j}.up"], w[f"{p}ff.{j}.down"])
        if j == 0 and spec.get("variant") == "sequential_moe":
            x, shortcut = x + shortcut, 0.0
    return x + shortcut, caches, pairs, zero, (moe_io[0], moe_io[1][0])


def forward(weights, tokens: torch.Tensor, spec: dict, block: int = 256) -> dict:
    """``weights``: float32 weights by name (:func:`weight_shapes`), a dict
    or a function from a list of names to those weights; ``tokens`` (B,
    S); ``spec``: the model's ``config.json`` keys, with the held share's
    ``held_experts``, ``held_layers`` and ``held_vocab``.  -> ``{"logits":
    (B, V) at the last position, "cache": [(c_kv (B, S, kv_lora), k_rope
    (B, S, rope))] an MLA sublayer (two a double layer), "held_pairs":
    [routed pairs of the held FFN experts a double layer], "zero_pairs":
    [pairs of the identity experts a double layer], "moe": (u, output),
    the first double layer's MoE input and output (B, S, d)}``.  Raises on
    weights of other names or shapes."""
    _no_tf32()
    if spec.get("variant") not in VARIANTS:
        raise ValueError(f"variant {spec['variant']!r}")
    shapes = weight_shapes(spec)
    if callable(weights):
        get = weights
    else:
        if set(weights) != set(shapes):
            raise ValueError(f"weights unlike the held share's: "
                             f"{sorted(set(weights) ^ set(shapes))}")
        get = lambda names: {k: weights[k] for k in names}  # noqa: E731

    def load(names):
        w = get(names)
        for k in names:
            if tuple(w[k].shape) != shapes[k][0]:
                raise ValueError(f"{k}: shape {tuple(w[k].shape)}, the held share's "
                                 f"{shapes[k][0]}")
        return w

    L, eps = held_layers(spec), spec["rms_norm_eps"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = load(["embed"])["embed"][tokens]                      # (B, S, d)
    caches, pairs, zeros, moe_io = [], [0] * L, [0] * L, [[], []]
    for i in range(L):
        w = load(layer_names(spec, i))
        layer = [[], []]
        for b in range(B):
            x[b], cache, n, z, io = double_layer(w, f"blocks.{i}.", x[b], pos, spec, block)
            if i == 0:
                moe_io[0].append(io[0])
                moe_io[1].append(io[1])
            pairs[i] += n
            zeros[i] += z
            for j in range(2):
                layer[j].append(cache[j])
        del w
        caches += [(torch.stack([c for c, _ in sub]), torch.stack([r for _, r in sub]))
                   for sub in layer]
    w = load(["final_norm", "unembed"])
    logits = rms_norm(x[:, -1], w["final_norm"], eps) @ w["unembed"]
    return {"logits": logits, "cache": caches, "held_pairs": pairs, "zero_pairs": zeros,
            "moe": tuple(torch.stack(t) for t in moe_io)}
