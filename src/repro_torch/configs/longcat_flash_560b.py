"""LongCat-Flash-Chat 560B [arXiv:2509.01322]: 28 shortcut-connected MoE
double layers, each two MLA sublayers (64 heads, q_lora 1536, kv_lora 512,
with the LoRA scales) with two dense SwiGLUs of width 12288, and one MoE of
512 FFN experts of width 2048 beside 256 zero-compute (identity) experts,
top-12 (``config.LongcatFlashConfig``).

The port runs it beyond the reference's pool: ``CONFIG`` is the published
model, ``SMOKE`` the CPU tests' size, and :func:`from_config_json` builds
the published model from its ``config.json`` on one device's share of an
expert-parallel deployment."""

from repro_torch.models.config import LongcatFlashConfig

CONFIG = LongcatFlashConfig(
    name="longcat-flash-560b",
    n_layers=28, d_model=6144, n_heads=64, n_kv_heads=64, head_dim=128,
    d_ff=12288, vocab_size=131072, rope_theta=1e7, norm_eps=1e-5,
    q_lora=1536, kv_lora=512, rope_head_dim=64, v_head_dim=128,
    n_experts=512, zero_experts=256, top_k=12, d_ff_expert=2048,
)

# the LoRA scales at these widths: q's 2 (as published), the latent's
# sqrt(64 / 24), not a power of two (as published: sqrt(12))
SMOKE = LongcatFlashConfig(
    name="longcat-flash-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=128, rope_theta=1e7, norm_eps=1e-5,
    q_lora=16, kv_lora=24, rope_head_dim=8, v_head_dim=16,
    n_experts=16, zero_experts=8, top_k=4, d_ff_expert=32, dtype="float32",
)


def from_config_json(hf: dict, *, experts: range, n_layers: int, vocab_rows: int,
                     dtype: str = "bfloat16") -> LongcatFlashConfig:
    """LongCat-Flash as its ``config.json`` (``hf``, the published values)
    gives it, on one device of an expert-parallel deployment: the FFN
    experts ``experts`` (a range of ``hf["n_routed_experts"]``) are held
    here, and the router keeps all its ``n_routed_experts + zero_expert_num``
    outputs; the first ``n_layers`` double layers; the vocabulary's first
    ``vocab_rows`` rows."""
    if hf.get("model_type") != "longcat_flash":
        raise ValueError(f"not a LongCat-Flash config: model_type {hf.get('model_type')!r}")
    if hf.get("zero_expert_type") != "identity":
        raise ValueError(f"zero_expert_type {hf.get('zero_expert_type')!r}: the port has "
                         "identity zero-compute experts only")
    if hf.get("attention_method", "MLA") != "MLA" or hf.get("rope_scaling"):
        raise ValueError("the port runs LongCat-Flash's MLA with plain RoPE")
    if not 0 < n_layers <= hf["num_layers"] or not 0 < vocab_rows <= hf["vocab_size"]:
        raise ValueError(f"{n_layers} layers of {hf['num_layers']}, {vocab_rows} "
                         f"vocabulary rows of {hf['vocab_size']}")
    return LongcatFlashConfig(
        name="longcat-flash-held",
        n_layers=n_layers, d_model=hf["hidden_size"], n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_attention_heads"], head_dim=hf["qk_nope_head_dim"],
        d_ff=hf["ffn_hidden_size"], vocab_size=vocab_rows,
        rope_theta=float(hf["rope_theta"]), norm_eps=hf["rms_norm_eps"],
        tie_embeddings=hf.get("tie_word_embeddings", False), dtype=dtype,
        q_lora=hf["q_lora_rank"], kv_lora=hf["kv_lora_rank"],
        rope_head_dim=hf["qk_rope_head_dim"], v_head_dim=hf["v_head_dim"],
        n_experts=hf["n_routed_experts"], zero_experts=hf["zero_expert_num"],
        top_k=hf["moe_topk"], d_ff_expert=hf["expert_ffn_hidden_size"],
        routed_scaling_factor=float(hf["routed_scaling_factor"]),
        mla_scale_q_lora=bool(hf["mla_scale_q_lora"]),
        mla_scale_kv_lora=bool(hf["mla_scale_kv_lora"]),
        held_range=(experts.start, experts.stop))
