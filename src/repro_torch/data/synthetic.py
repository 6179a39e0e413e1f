"""Synthetic boolean datasets matching the paper's benchmark dimensions
(the training data and the serve loop's request stream; a copy of the
reference's generators, so both packages see the same samples).

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

PAPER_DATASETS = {
    "mnist": dict(n_features=784, n_classes=10),
    "kmnist": dict(n_features=784, n_classes=10),
    "fmnist": dict(n_features=784, n_classes=10),
    "cifar2": dict(n_features=1024, n_classes=2),
    "kws6": dict(n_features=377, n_classes=6),
}


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


def make_noisy_xor(
    n_samples: int, n_features: int = 12, noise: float = 0.1, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """The 2D Noisy XOR benchmark (paper refs [22][23])."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 2, (n_samples, n_features)).astype(np.uint8)
    y = (X[:, 0] ^ X[:, 1]).astype(np.int32)
    flip = rng.random(n_samples) < noise
    return X, np.where(flip, 1 - y, y).astype(np.int32)


def paper_dataset(
    name: str, n_train: int = 4000, n_test: int = 1000, seed: int = 0
):
    """(X_train, y_train, X_test, y_test) with the paper dataset's dims."""
    spec = PAPER_DATASETS[name]
    X, y = make_boolean_classification(
        n_train + n_test, spec["n_features"], spec["n_classes"], seed=seed
    )
    return X[:n_train], y[:n_train], X[n_train:], y[n_train:]
