"""Synthetic datasets and request streams, the booleanization front ends
and the sharded loader."""

from repro_torch.data.synthetic import (  # noqa: F401
    make_boolean_classification,
    make_noisy_xor,
    paper_dataset,
)
from repro_torch.data.booleanize import quantile_binarize, thermometer_encode  # noqa: F401
from repro_torch.data.loader import ShardedBatcher  # noqa: F401
