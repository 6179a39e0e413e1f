"""Qwen3-235B-A22B [hf:Qwen/Qwen3-*]: MoE 128 experts top-8, GQA kv=4, qk_norm."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
    n_experts=128, top_k=8, d_ff_expert=1536,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=48, vocab_size=512, qk_norm=True,
    n_experts=8, top_k=2, d_ff_expert=48, dtype="float32",
)
