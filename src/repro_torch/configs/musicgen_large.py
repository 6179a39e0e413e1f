"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens,
4 codebook heads; the EnCodec frontend is a stub (precomputed frame
embeddings via input_specs)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, rope_theta=10000.0,
    frontend="audio_stub", n_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=128, frontend="audio_stub", n_codebooks=4,
    dtype="float32",
)
