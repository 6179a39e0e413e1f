"""StarCoder2-7B [arXiv:2402.19173]: dense GQA kv=4, RoPE."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, rope_theta=100_000.0, gated_mlp=False,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    n_layers=3, d_model=72, n_heads=6, n_kv_heads=2,
    d_ff=288, vocab_size=512, rope_theta=100_000.0, gated_mlp=False, dtype="float32",
)
