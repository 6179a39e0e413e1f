"""Operations and bytes of a LongCat-Flash prefill batch, counted from the
configuration's widths, the batch's shape and the plain reference's own
routing, never from the program's dispatch or launches.  A bound is
max(FLOPs / dense bf16 tensor-core peak, bytes / HBM rate) (``peaks.json``).

FLOPs are 2 a multiply-add.  A batch of B prompts of S tokens (T = B S)
through the held double layers (``dims`` from :func:`dims`), each:

* two MLA sublayers, a token: the projections ``wq_a``, ``wq_b``,
  ``wkv_a``, the latent expansions ``wk_b``, ``wv_b`` and ``wo``
  (``lm_work.mla_params``);
* their two causal attention cores (``lm_work.attention_core_flops``);
* two dense SwiGLUs (3 d ffn a token);
* the router (d x (FFN + zero-compute experts) a token) and the held FFN
  experts' SwiGLU (3 d fe) over the routed pairs of the held experts that
  the reference's own routing gives (``held_pairs``, a double layer).  The
  identity experts' gate times token (2 d a pair, under 0.01% of the
  rest) is not counted;
* the output head at the last position of each prompt (B d V).

Bytes: the held model's bf16 weights read once (the float32 router and
its bias at 4 bytes; the embedding rows of the batch's tokens only), the
token ids in, the two latent caches of each double layer written (kv_lora
+ rope values a token, bf16) and the (B, V) float32 logits out.
"""

from __future__ import annotations

from tmbench import lm_work, work

MLA_KEYS = ("hidden_size", "num_attention_heads", "q_lora_rank", "kv_lora_rank",
            "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")


def dims(config: dict) -> dict:
    """The widths a count reads, from a configuration file (the catalog's
    keys at the top level, held counts at their held values)."""
    k = MLA_KEYS + ("ffn_hidden_size", "expert_ffn_hidden_size", "num_layers", "vocab_size")
    out = {key: config[key] for key in k}
    pub = config["published"]
    out["router_width"] = pub["n_routed_experts"] + pub["zero_expert_num"]
    out["experts_held"] = config["held"]["n_routed_experts"]
    return out


def prefill_flops(m: dict, B: int, S: int, held_pairs: list) -> int:
    """FLOPs of a prefill of B prompts of S tokens; ``held_pairs`` a double
    layer."""
    T, d = B * S, m["hidden_size"]
    per_layer = 2 * (2 * T * lm_work.mla_params(m) + lm_work.attention_core_flops(m, B, S)
                     + 2 * T * 3 * d * m["ffn_hidden_size"]) + 2 * T * d * m["router_width"]
    experts = sum(2 * n * 3 * d * m["expert_ffn_hidden_size"] for n in held_pairs)
    return m["num_layers"] * per_layer + experts + 2 * B * d * m["vocab_size"]


def prefill_bytes(m: dict, B: int, S: int) -> int:
    T, d, L = B * S, m["hidden_size"], m["num_layers"]
    sublayer = lm_work.mla_params(m) + 2 * d + m["q_lora_rank"] + m["kv_lora_rank"] \
        + 3 * d * m["ffn_hidden_size"]
    layer = (2 * sublayer + (d + 1) * m["router_width"] * 2           # float32 router, bias
             + 3 * d * m["expert_ffn_hidden_size"] * m["experts_held"])
    params = L * layer + d * m["vocab_size"] + d
    cache = T * L * 2 * (m["kv_lora_rank"] + m["qk_rope_head_dim"])
    return 2 * (params + cache + T * d) + 8 * T + 4 * B * m["vocab_size"]


def prefill_bounds(m: dict, B: int, S: int, held_pairs: list, pk: dict | None = None) -> dict:
    """``{"step": the batch's bound, "flash": its attention cores'}`` in s."""
    pk = pk or work.peaks()
    core = 2 * m["num_layers"] * lm_work.attention_core_flops(m, B, S)
    return {"step": lm_work.bound_s(prefill_flops(m, B, S, held_pairs),
                                    prefill_bytes(m, B, S), pk),
            "flash": core / pk["bf16_dense_flops_per_s"]}
