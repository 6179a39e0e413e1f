"""Qwen3-32B [hf:Qwen/Qwen3-*]: dense GQA kv=8, qk_norm, head_dim 128."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, qk_norm=True, rope_theta=1_000_000.0,
    dtype="float32",
)
