"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512) + MoE 160e top-6,
2 shared experts, first layer dense."""

from repro_torch.models.config import ModelConfig

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
