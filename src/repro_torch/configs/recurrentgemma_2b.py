"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: RG-LRU + local attention,
pattern (rec, rec, local), window 2048 — sub-quadratic, runs long_500k."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, pattern=("rec", "rec", "local"),
    window=2048, rnn_width=2560, subquadratic=True, rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=512, pattern=("rec", "rec", "local"),
    window=16, rnn_width=64, subquadratic=True, tie_embeddings=True, dtype="float32",
)
