"""xLSTM-1.3B [arXiv:2405.04517]: mLSTM + sLSTM blocks (7:1) —
sub-quadratic recurrent, runs long_500k."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",), subquadratic=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512, pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    subquadratic=True, dtype="float32",
)
