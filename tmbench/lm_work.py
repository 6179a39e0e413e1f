"""Operations and bytes of a language model's prefill batch, counted from
the configuration's widths, the batch's shape and the plain reference's
own routing, never from the program's dispatch or launches.  A bound is
max(FLOPs / dense bf16 tensor-core peak, bytes / HBM rate) (``peaks.json``).

FLOPs are 2 a multiply-add.  A batch of B prompts of S tokens (T = B S)
through DeepSeek-V2's layers (``dims`` from :func:`dims`):

* MLA, every layer, a token: the projections ``wq_a``, ``wq_b``, ``wkv_a``,
  the latent expansions ``wk_b``, ``wv_b`` and ``wo``;
* the causal attention core, every layer: B H S(S+1)/2 (qk + v) 2, the
  query-key products and the probability-value products over the keys at
  or before each query (:func:`attention_core_flops`);
* the dense layers' SwiGLU (3 d d_ff a token); each expert layer's router
  (d E), shared experts (3 d n_shared fe) and the held experts' SwiGLU (3 d
  fe) over the routed pairs of the held experts that the reference's own
  routing gives (``held_pairs``, a layer);
* the output head at the last position of each prompt (B d V).

Bytes: the held model's bf16 weights read once (the embedding rows of the
batch's tokens only), the token ids in, the latent cache written (every
layer's kv_lora + rope values a token, bf16) and the (B, V) float32 logits
out.
"""

from __future__ import annotations

from tmbench import work


def dims(config: dict) -> dict:
    """The widths a count reads, from a configuration file (the catalog's
    keys at the top level, held counts at their held values)."""
    k = ("hidden_size", "intermediate_size", "moe_intermediate_size", "num_attention_heads",
         "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
         "n_shared_experts", "first_k_dense_replace", "num_hidden_layers", "vocab_size")
    out = {key: config[key] for key in k}
    out["router_width"] = config["published"]["n_routed_experts"]
    out["experts_held"] = config["held"]["n_routed_experts"]
    return out


def mla_params(m: dict) -> int:
    d, H = m["hidden_size"], m["num_attention_heads"]
    nope, rope, v = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    ql, kvl = m["q_lora_rank"], m["kv_lora_rank"]
    return (d * ql + ql * H * (nope + rope) + d * (kvl + rope) + kvl * H * nope
            + kvl * H * v + H * v * d)


def attention_core_flops(m: dict, B: int, S: int) -> int:
    """The causal attention core of one layer."""
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return B * m["num_attention_heads"] * S * (S + 1) // 2 * (qk + m["v_head_dim"]) * 2


def prefill_flops(m: dict, B: int, S: int, held_pairs: list) -> int:
    """FLOPs of a prefill of B prompts of S tokens; ``held_pairs`` a layer
    (0 for the dense ones)."""
    T, d = B * S, m["hidden_size"]
    L, fe = m["num_hidden_layers"], m["moe_intermediate_size"]
    flops = L * (2 * T * mla_params(m) + attention_core_flops(m, B, S))
    for i in range(L):
        if i < m["first_k_dense_replace"]:
            flops += 2 * T * 3 * d * m["intermediate_size"]
        else:
            flops += 2 * T * (d * m["router_width"] + 3 * d * m["n_shared_experts"] * fe)
            flops += 2 * held_pairs[i] * 3 * d * fe
    return flops + 2 * B * d * m["vocab_size"]


def prefill_bytes(m: dict, B: int, S: int) -> int:
    T, d, L = B * S, m["hidden_size"], m["num_hidden_layers"]
    fe, n_dense = m["moe_intermediate_size"], m["first_k_dense_replace"]
    moe_layer = (d * m["router_width"] * 2                      # float32 router
                 + 3 * d * fe * (m["experts_held"] + m["n_shared_experts"]))
    params = (L * (mla_params(m) + 2 * d + m["q_lora_rank"] + m["kv_lora_rank"])
              + n_dense * 3 * d * m["intermediate_size"] + (L - n_dense) * moe_layer
              + d * m["vocab_size"] + d)
    cache = T * L * (m["kv_lora_rank"] + m["qk_rope_head_dim"])
    return 2 * (params + cache + T * d) + 8 * T + 4 * B * m["vocab_size"]


def bound_s(flops: float, n_bytes: float, pk: dict) -> float:
    return max(flops / pk["bf16_dense_flops_per_s"], n_bytes / pk["hbm_bytes_per_s"])


def prefill_bounds(m: dict, B: int, S: int, held_pairs: list, pk: dict | None = None) -> dict:
    """``{"step": the batch's bound, "flash": its attention core's}`` in s."""
    pk = pk or work.peaks()
    core = m["num_hidden_layers"] * attention_core_flops(m, B, S)
    return {"step": bound_s(prefill_flops(m, B, S, held_pairs), prefill_bytes(m, B, S), pk),
            "flash": core / pk["bf16_dense_flops_per_s"]}
