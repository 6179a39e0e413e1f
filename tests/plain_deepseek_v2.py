"""DeepSeek-V2's forward pass in plain PyTorch and float32: the plain reference.

It follows the published model (``modeling_deepseek.py`` of
https://huggingface.co/deepseek-ai/DeepSeek-V2 and arXiv:2405.04434) for
inference: embedding; each layer a pre-norm multi-head latent attention
(MLA) and a pre-norm feed-forward, each with a residual; the first
``first_k_dense_replace`` feed-forwards dense SwiGLU, the others a mixture
of experts; a final norm and the output head.

* MLA: ``q = wq_b(norm(wq_a x))`` split into nope and rope parts;
  ``[c_kv, k_rope] = wkv_a x``, ``c_kv`` normed; per-head k_nope and v
  from ``c_kv``; the rope parts rotated by YaRN's frequencies
  (``DeepseekV2YarnRotaryEmbedding``, cos and sin times
  mscale(factor, mscale) / mscale(factor, mscale_all_dim)); causal softmax
  attention at scale ``(nope + rope)^-0.5 mscale(factor, mscale_all_dim)^2``.
* MoE (``DeepseekV2MoEGate``, ``DeepseekV2MoE.moe_infer``): a float32
  softmax router over all ``n_routed_experts``; under
  ``group_limited_greedy`` each token keeps its best ``topk_group`` of
  ``n_group`` groups (a group scores its best expert) and takes the top
  ``num_experts_per_tok`` of their experts (the lower index first among
  ties); the gates renormalized only under ``norm_topk_prob``, times
  ``routed_scaling_factor``; every routed token computed (no capacity);
  plus the shared experts, a SwiGLU of width ``n_shared_experts`` times
  the expert width.

Departures from the published description:

* RoPE rotates the two halves of the rope dimensions (``rotate_half`` on
  ``[x1, x2]``), where the published code first de-interleaves the pairs.
  The two differ by a fixed permutation of the rope columns of ``wq_b``
  and ``wkv_a``: with random weights they are the same model.
* One device's share of an expert-parallel deployment, as the spec states
  it: the first ``held_layers`` layers, the experts of routing group
  ``held_group`` (the router still scores all ``n_routed_experts``; what
  the absent experts would add is left out, and that partial sum goes on
  to the next layer), and the first ``held_vocab`` vocabulary rows.  Each
  defaults to the whole model (``held_group`` None: every expert).
  :func:`weight_shapes` gives every weight of the share, its shape and the
  scale a random draw takes; :func:`forward` refuses weights of any other
  names or shapes.
* Weights are named ``blocks.<i>.mix.wq_a``, ``blocks.<i>.ff.shared.up``,
  ..., in the ``x @ W`` orientation, and a norm's weight is stored as its
  offset from 1 (the published ``RMSNorm.weight`` is 1 plus it).
* No attention or router dropout, no auxiliary loss, no cache: a prompt's
  forward from position 0, each prompt of a batch on its own.

Everything is float32 with TF32 off.  Attention runs in blocks of query
rows over the keys up to the block's last row, so a 16,384-token prompt
fits on one card.  Nothing here imports the program or JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * float(np.log(scale)) + 1.0


def rope_inv_freq(spec: dict, device=None) -> torch.Tensor:
    """(rope/2,) inverse frequencies: YaRN's under ``rope_scaling``, else
    the plain ``theta^(-2i/rope)``."""
    dim, base = spec["qk_rope_head_dim"], float(spec["rope_theta"])
    f = 1.0 / base ** (torch.arange(0, dim, 2, dtype=F32, device=device) / dim)
    rs = spec.get("rope_scaling")
    if not rs:
        return f

    def corr_dim(rotations):
        return float(dim * np.log(rs["original_max_position_embeddings"]
                                  / (rotations * 2 * np.pi)) / (2 * np.log(base)))

    low = max(int(np.floor(corr_dim(rs["beta_fast"]))), 0)
    high = min(int(np.ceil(corr_dim(rs["beta_slow"]))), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32, device=device) - low)
                       / (high - low), 0, 1)
    return f / rs["factor"] * ramp + f * (1 - ramp)


def rope_mscale(spec: dict) -> float:
    rs = spec.get("rope_scaling")
    if not rs:
        return 1.0
    return mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])


def softmax_scale(spec: dict) -> float:
    scale = (spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]) ** -0.5
    rs = spec.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        scale *= mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, pos, inv_freq, m):
    """x (S, H, rope) rotated at positions pos (S,): the halves [x1, x2]."""
    ang = pos[:, None].to(F32) * inv_freq                  # (S, rope/2)
    cos, sin = (torch.cos(ang) * m)[:, None, :], (torch.sin(ang) * m)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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
    kvl, eps = spec["kv_lora_rank"], spec["rms_norm_eps"]
    inv_freq, m = rope_inv_freq(spec, x.device), rope_mscale(spec)
    q = torch.einsum("sr,rhk->shk", rms_norm(x @ w[p + "wq_a"], w[p + "q_norm"], eps),
                     w[p + "wq_b"])
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, inv_freq, m)], dim=-1)
    kv = x @ w[p + "wkv_a"]
    c_kv = rms_norm(kv[:, :kvl], w[p + "kv_norm"], eps)
    k_rope = rope(kv[:, None, kvl:], pos, inv_freq, m)[:, 0]
    H = q.shape[1]
    k = torch.cat([torch.einsum("sr,rhk->shk", c_kv, w[p + "wk_b"]),
                   k_rope[:, None, :].expand(-1, H, -1)], dim=-1)
    v = torch.einsum("sr,rhk->shk", c_kv, w[p + "wv_b"])
    o = causal_attention(q, k, v, softmax_scale(spec), block)
    return torch.einsum("shv,hvd->sd", o, w[p + "wo"]), c_kv, k_rope


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def route(x, router, spec: dict):
    """x (T, d) -> (gates (T, k), experts (T, k)) over all experts."""
    probs = torch.softmax(x @ router, dim=-1)
    T, E = probs.shape
    if spec["topk_method"] == "group_limited_greedy":
        G = spec["n_group"]
        best = probs.view(T, G, E // G).amax(-1)
        groups = torch.sort(best, dim=-1, descending=True, stable=True)[1][:, :spec["topk_group"]]
        keep = torch.zeros((T, G), dtype=torch.bool, device=x.device).scatter(1, groups, True)
        probs = probs * keep.repeat_interleave(E // G, dim=1)
    elif spec["topk_method"] != "greedy":
        raise ValueError(spec["topk_method"])
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :spec["num_experts_per_tok"]], idx[:, :spec["num_experts_per_tok"]]
    if spec["norm_topk_prob"]:
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-20)
    return vals * spec["routed_scaling_factor"], idx


def held_layers(spec: dict) -> int:
    return spec.get("held_layers", spec["num_hidden_layers"])


def held_vocab(spec: dict) -> int:
    return spec.get("held_vocab", spec["vocab_size"])


def held_range(spec: dict) -> range:
    """The held experts of all ``n_routed_experts``: group ``held_group``'s."""
    E, g = spec["n_routed_experts"], spec.get("held_group")
    if g is None:
        return range(E)
    n = E // spec["n_group"]
    return range(g * n, (g + 1) * n)


def weight_shapes(spec: dict) -> dict:
    """``{name: (shape, std)}`` of every weight of the held share, in a fixed
    order: a matrix N(0, 1/d_in) (std d_in^-0.5), the embedding N(0, 0.02^2),
    a norm's offset from 1 zero (std 0)."""
    d, V = spec["hidden_size"], held_vocab(spec)
    H, nope = spec["num_attention_heads"], spec["qk_nope_head_dim"]
    rope, dv = spec["qk_rope_head_dim"], spec["v_head_dim"]
    ql, kvl = spec["q_lora_rank"], spec["kv_lora_rank"]
    ff, fe = spec["intermediate_size"], spec["moe_intermediate_size"]
    fs, E = spec["n_shared_experts"] * fe, len(held_range(spec))
    ws = {"embed": ((V, d), 0.02)}
    for i in range(held_layers(spec)):
        p = f"blocks.{i}."
        ws.update({p + "norm1": ((d,), 0.0),
                   p + "mix.wq_a": ((d, ql), d ** -0.5),
                   p + "mix.q_norm": ((ql,), 0.0),
                   p + "mix.wq_b": ((ql, H, nope + rope), ql ** -0.5),
                   p + "mix.wkv_a": ((d, kvl + rope), d ** -0.5),
                   p + "mix.kv_norm": ((kvl,), 0.0),
                   p + "mix.wk_b": ((kvl, H, nope), kvl ** -0.5),
                   p + "mix.wv_b": ((kvl, H, dv), kvl ** -0.5),
                   p + "mix.wo": ((H, dv, d), (H * dv) ** -0.5),
                   p + "norm2": ((d,), 0.0)})
        if i < spec["first_k_dense_replace"]:
            ws.update({p + "ff.gate": ((d, ff), d ** -0.5), p + "ff.up": ((d, ff), d ** -0.5),
                       p + "ff.down": ((ff, d), ff ** -0.5)})
        else:
            ws.update({p + "ff.router": ((d, spec["n_routed_experts"]), d ** -0.5),
                       p + "ff.gate": ((E, d, fe), d ** -0.5),
                       p + "ff.up": ((E, d, fe), d ** -0.5),
                       p + "ff.down": ((E, fe, d), fe ** -0.5),
                       p + "ff.shared.gate": ((d, fs), d ** -0.5),
                       p + "ff.shared.up": ((d, fs), d ** -0.5),
                       p + "ff.shared.down": ((fs, d), fs ** -0.5)})
    ws.update({"final_norm": ((d,), 0.0), "unembed": ((d, V), d ** -0.5)})
    return ws


def check_weights(w: dict, spec: dict) -> None:
    """Raise unless ``w`` holds exactly :func:`weight_shapes`' names and shapes."""
    want = weight_shapes(spec)
    if set(w) != set(want):
        raise ValueError(f"weights unlike the held share's: {sorted(set(w) ^ set(want))}")
    for k, (shape, _) in want.items():
        if tuple(w[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(w[k].shape)}, the held share's {shape}")


def moe(w: dict, p: str, x, spec: dict):
    """-> (output (T, d), routed pairs of the held experts)."""
    gates, idx = route(x, w[p + "router"], spec)
    held = held_range(spec)
    if w[p + "gate"].shape[0] != len(held):
        raise ValueError(f"{w[p + 'gate'].shape[0]} experts given, {len(held)} held")
    out = swiglu(x, w[p + "shared.gate"], w[p + "shared.up"], w[p + "shared.down"])
    pairs = 0
    for j, e in enumerate(held):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            pairs += tok.numel()
            y = swiglu(x[tok], w[p + "gate"][j], w[p + "up"][j], w[p + "down"][j])
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out, pairs


def forward(w: dict, tokens: torch.Tensor, spec: dict, block: int = 256) -> dict:
    """``w``: float32 weights by name (:func:`weight_shapes`); ``tokens``
    (B, S); ``spec``: the model's ``config.json`` keys, with the held share's
    ``held_group``, ``held_layers`` and ``held_vocab``.  -> ``{"logits":
    (B, V) at the last position, "cache": [(c_kv (B, S, kv_lora), k_rope
    (B, S, rope))] a layer, "held_pairs": [routed pairs of the held experts
    a layer (0 for a dense layer)]}``."""
    _no_tf32()
    check_weights(w, spec)
    L, eps = held_layers(spec), spec["rms_norm_eps"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    logits, caches, pairs = [], [[] for _ in range(L)], [0] * L
    for b in range(B):
        x = w["embed"][tokens[b]]
        for i in range(L):
            p = f"blocks.{i}."
            h, c_kv, k_rope = mla(w, p + "mix.", rms_norm(x, w[p + "norm1"], eps), pos, spec,
                                  block)
            caches[i].append((c_kv, k_rope))
            x = x + h
            h = rms_norm(x, w[p + "norm2"], eps)
            if i < spec["first_k_dense_replace"]:
                x = x + swiglu(h, w[p + "ff.gate"], w[p + "ff.up"], w[p + "ff.down"])
            else:
                y, n = moe(w, p + "ff.", h, spec)
                x, pairs[i] = x + y, pairs[i] + n
        logits.append(rms_norm(x[-1], w["final_norm"], eps) @ w["unembed"])
    return {"logits": torch.stack(logits),
            "cache": [(torch.stack([c for c, _ in layer]), torch.stack([r for _, r in layer]))
                      for layer in caches],
            "held_pairs": pairs}
