"""SmolLM-360M [hf:HuggingFaceTB/SmolLM]: llama-arch small, GQA kv=5, tied."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    n_layers=3, d_model=60, n_heads=3, n_kv_heads=1,
    d_ff=160, vocab_size=512, rope_theta=10000.0, tie_embeddings=True,
    dtype="float32",
)
