"""Synthetic boolean datasets matching the paper's benchmark dimensions
(the request stream of the serve loop; a copy of the reference's generator).

The repository ships no MNIST/CIFAR/KWS files, so this generates
class-structured Bernoulli data with the same feature
widths as the paper's Table II datasets: each class owns a sparse set of
"prototype" pixels that light with high probability, over a noisy background
— learnable by a TM through the same include/exclude mechanics as the real
images, and producing comparably sparse models.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_boolean_classification(
    n_samples: int,
    n_features: int,
    n_classes: int,
    *,
    prototype_density: float = 0.15,
    on_prob: float = 0.9,
    background_prob: float = 0.08,
    label_noise: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-prototype Bernoulli data: X (N, F) uint8, y (N,) int32."""
    rng = np.random.default_rng(seed)
    protos = rng.random((n_classes, n_features)) < prototype_density
    y = rng.integers(0, n_classes, n_samples).astype(np.int32)
    p = np.where(protos[y], on_prob, background_prob)
    X = (rng.random((n_samples, n_features)) < p).astype(np.uint8)
    if label_noise:
        flip = rng.random(n_samples) < label_noise
        y = np.where(flip, rng.integers(0, n_classes, n_samples), y).astype(np.int32)
    return X, y
