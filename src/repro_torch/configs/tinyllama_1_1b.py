"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch small, GQA kv=4."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=176, vocab_size=512, rope_theta=10000.0, dtype="float32",
)
