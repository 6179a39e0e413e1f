"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512) + MoE 160e top-6,
2 shared experts, first layer dense.

``CONFIG`` and ``SMOKE`` are the reference package's (plain top-k routing,
renormalized, capacity dispatch, plain RoPE); :func:`from_config_json`
builds the published model from its ``config.json``, on one device's
share of an expert-parallel deployment."""

from repro_torch.models.config import DeepSeekV2Config, ModelConfig, Yarn

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288,                       # dense layers (layer 0)
    vocab_size=102400,
    attn_kind="mla", q_lora=1536, kv_lora=512, rope_head_dim=64, v_head_dim=128,
    n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
    first_dense_layers=1, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512,
    attn_kind="mla", q_lora=32, kv_lora=24, rope_head_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=48,
    first_dense_layers=1, dtype="float32",
)


def from_config_json(hf: dict, *, group: int, n_layers: int, vocab_rows: int,
                     dtype: str = "bfloat16") -> DeepSeekV2Config:
    """DeepSeek-V2 as its ``config.json`` (``hf``, the published values)
    gives it, on one device of an expert-parallel deployment: the routing
    group ``group`` of ``hf["n_group"]`` is held here (its
    ``n_routed_experts / n_group`` experts; the router keeps all of its
    outputs), the first ``n_layers`` layers, and the vocabulary's first
    ``vocab_rows`` rows.  Group-limited routing, dropless dispatch, YaRN and
    the mscale^2 attention scale as ``hf`` states them."""
    if hf.get("model_type") != "deepseek_v2":
        raise ValueError(f"not a DeepSeek-V2 config: model_type {hf.get('model_type')!r}")
    if hf["moe_layer_freq"] != 1 or hf["scoring_func"] != "softmax" or hf["hidden_act"] != "silu":
        raise ValueError("the port runs DeepSeek-V2's softmax router, SiLU experts and an "
                         "expert layer every layer past the dense ones")
    if not 0 < n_layers <= hf["num_hidden_layers"] or not 0 < vocab_rows <= hf["vocab_size"]:
        raise ValueError(f"{n_layers} layers of {hf['num_hidden_layers']}, {vocab_rows} "
                         f"vocabulary rows of {hf['vocab_size']}")
    rs = hf.get("rope_scaling")
    yarn = None
    if rs is not None:
        if rs.get("type") != "yarn":
            raise ValueError(f"rope_scaling {rs.get('type')!r}: the port has YaRN only")
        yarn = Yarn(factor=float(rs["factor"]),
                    original_max_position_embeddings=int(rs["original_max_position_embeddings"]),
                    beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
                    mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]))
    return DeepSeekV2Config(
        name="deepseek-v2-held",
        n_layers=n_layers, d_model=hf["hidden_size"], n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"], head_dim=hf["qk_nope_head_dim"],
        d_ff=hf["intermediate_size"], vocab_size=vocab_rows,
        rope_theta=float(hf["rope_theta"]), norm_eps=hf["rms_norm_eps"],
        tie_embeddings=hf["tie_word_embeddings"], dtype=dtype,
        attn_kind="mla", q_lora=hf["q_lora_rank"], kv_lora=hf["kv_lora_rank"],
        rope_head_dim=hf["qk_rope_head_dim"], v_head_dim=hf["v_head_dim"],
        n_experts=hf["n_routed_experts"], top_k=hf["num_experts_per_tok"],
        n_shared_experts=hf["n_shared_experts"], d_ff_expert=hf["moe_intermediate_size"],
        first_dense_layers=hf["first_k_dense_replace"],
        topk_method=hf["topk_method"], n_group=hf["n_group"], topk_group=hf["topk_group"],
        norm_topk_prob=hf["norm_topk_prob"],
        routed_scaling_factor=float(hf["routed_scaling_factor"]),
        held_group=group, yarn=yarn)
