"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: mistral-nemo backbone;
the Pixtral-ViT frontend is a stub (precomputed patch embeddings)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1_000_000.0,
    frontend="vision_stub",
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, frontend="vision_stub", dtype="float32",
)
