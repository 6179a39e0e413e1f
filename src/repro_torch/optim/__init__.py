from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update  # noqa: F401
