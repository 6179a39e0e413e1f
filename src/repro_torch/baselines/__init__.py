"""Baselines the paper compares MATADOR against (Table I)."""

from repro_torch.baselines.bnn import BNNConfig, bnn_init, bnn_predict, bnn_train  # noqa: F401
