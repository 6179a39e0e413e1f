"""Port parity: the booleanization front ends against the reference's numpy
encoders, bit for bit (tolerance 0), on the same inputs made from a seed."""

import numpy as np
import pytest
import torch

from repro.data import booleanize as ref
from repro_torch.data import quantile_binarize, thermometer_encode


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "float32":
        return rng.normal(size=(203, 9)).astype(np.float32)
    if kind == "float64":
        return rng.random((150, 6)) * 40.0 - 3.0
    if kind == "pixels":        # grayscale 0..255 in float32: many ties
        return rng.integers(0, 256, (301, 12)).astype(np.float32)
    if kind == "few_levels":    # four levels only: quantiles land on ties
        return rng.integers(0, 4, (97, 5)).astype(np.float64)
    if kind == "uint8":         # integer dtype: numpy promotes to float64
        return rng.integers(0, 256, (64, 7)).astype(np.uint8)
    if kind == "constant_column":
        x = rng.random((80, 4)).astype(np.float32)
        x[:, 1] = 0.25
        return x
    if kind == "one_sample":
        return rng.random((1, 5)).astype(np.float32)
    raise ValueError(kind)


KINDS = ["float32", "float64", "pixels", "few_levels", "uint8",
         "constant_column", "one_sample"]
ENCODERS = {"thermometer": (ref.thermometer_encode, thermometer_encode),
            "quantile": (ref.quantile_binarize, quantile_binarize)}


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("n_bits", [1, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_booleanize_matches_reference(kind, n_bits, encoder):
    x = _inputs(kind)
    ref_fn, port_fn = ENCODERS[encoder]
    want = ref_fn(x.copy(), n_bits)
    got = port_fn(torch.from_numpy(x.copy()), n_bits)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.shape == want.shape == (x.shape[0], x.shape[1] * n_bits)
    np.testing.assert_array_equal(got.numpy(), want)

