"""Synthetic request streams and the booleanization front ends."""

from repro_torch.data.booleanize import quantile_binarize, thermometer_encode  # noqa: F401
