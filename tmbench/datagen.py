"""The benchmark's inputs, made from ``--seed``.

A frozen copy of the port's synthetic paper datasets
(``repro_torch/data/synthetic.py``): each class owns a set of prototype
features that light with probability 0.9 over a background of 0.08.  The
prototypes are drawn exactly as ``paper_dataset(name, seed=data_seed)``
draws them (numpy's ``default_rng(data_seed)``, first draw), so a served
artifact sees the distribution it was trained on.  The samples themselves
come from the same Bernoulli model on the card, from a ``torch.Generator``
seeded by the run's seed, in a few large calls, so every seed gives the
same sizes, the same distribution and other rows.

Packing and the training order are frozen copies too: literal words as
``core/packetizer.py`` packs them (bit ``i`` of word ``w`` is literal
``32 w + i``, the literals being the features then their complements),
and epochs in ``ShardedBatcher``'s order (``default_rng((seed, epoch))``
permutations).
"""

from __future__ import annotations

import numpy as np
import torch

PAPER_DATASETS = {
    "mnist": dict(n_features=784, n_classes=10),
    "kmnist": dict(n_features=784, n_classes=10),
    "fmnist": dict(n_features=784, n_classes=10),
    "cifar2": dict(n_features=1024, n_classes=2),
    "kws6": dict(n_features=377, n_classes=6),
}
PROTOTYPE_DENSITY, ON_PROB, BACKGROUND_PROB = 0.15, 0.9, 0.08
WORD_BITS = 32
M64 = (1 << 64) - 1
# rows packed at a time (bounds the int64 temporary of the packing)
PACK_ROWS = 8192


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any
    whole number, large ones too)."""
    words = [int(seed) & M64, *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def sync(device) -> None:
    """Wait for the work issued on ``device``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def prototypes(dataset: str, data_seed: int = 0) -> np.ndarray:
    """(K, F) bool class prototypes: ``paper_dataset``'s first draw."""
    spec = PAPER_DATASETS[dataset]
    rng = np.random.default_rng(data_seed)
    return rng.random((spec["n_classes"], spec["n_features"])) < PROTOTYPE_DENSITY


def sample(protos: np.ndarray, n: int, g: torch.Generator, device):
    """``n`` samples of the prototype model on ``device``: x (n, F) uint8,
    y (n,) int32."""
    K, F = protos.shape
    p = torch.where(torch.from_numpy(protos).to(device), ON_PROB, BACKGROUND_PROB)
    y = torch.randint(0, K, (n,), generator=g, device=device)
    x = (torch.rand((n, F), generator=g, device=device) < p[y]).to(torch.uint8)
    return x, y.to(torch.int32)


def n_words(n_bits: int) -> int:
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def pack_literals(x: torch.Tensor) -> torch.Tensor:
    """(n, F) {0,1} features -> (n, ceil(2F/32)) int32 literal words (the
    32 bits of a uint32 word, LSB first), on ``x``'s device."""
    n, F = x.shape
    W = n_words(2 * F)
    out = torch.empty((n, W), dtype=torch.int32, device=x.device)
    weights = torch.ones((), dtype=torch.int64, device=x.device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=x.device)
    for lo in range(0, n, PACK_ROWS):
        xb = x[lo:lo + PACK_ROWS].to(torch.int64)
        lits = torch.cat([xb, 1 - xb], dim=1)
        lits = torch.nn.functional.pad(lits, (0, W * WORD_BITS - 2 * F))
        v = (lits.view(-1, W, WORD_BITS) * weights).sum(-1)
        out[lo:lo + PACK_ROWS] = torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
    return out


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """``ShardedBatcher``'s shuffled order of ``n`` rows in ``epoch``."""
    return np.random.default_rng((int(seed) & M64, epoch)).permutation(n)
