"""Tsetlin Machine core (MATADOR / Granmo'18): configuration, state and
the dense clause semantics the kernels must match.

The model is a bank of Tsetlin Automata, one per (class, clause, literal):
``int8`` states centred at zero, action *include* iff state >= 0.  A clause
is the AND of its included literals; class sums are polarity-weighted
clause votes; classification is the argmax over class sums.  Training
(``core/train.py``) updates the bank through ``core/feedback.py`` or the
hash-RNG step of ``kernels/ops.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """Hyperparameters of a (multiclass, vanilla) Tsetlin Machine.

    Mirrors the knobs MATADOR's GUI exposes: clauses per class, threshold T,
    specificity s, number of automata states.
    """

    n_features: int
    n_classes: int
    clauses_per_class: int
    n_states: int = 128          # states per action -> int8 in [-128, 127]
    threshold: int = 15          # T
    s: float = 10.0              # specificity
    boost_true_positive: bool = True
    # Pad the flattened clause axis to a multiple of this (sharding alignment;
    # padded clauses are permanently empty and vote 0).
    clause_pad_multiple: int = 1

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def n_clauses_total(self) -> int:
        raw = self.n_classes * self.clauses_per_class
        m = self.clause_pad_multiple
        return ((raw + m - 1) // m) * m

    @property
    def n_clauses_raw(self) -> int:
        return self.n_classes * self.clauses_per_class

    def replace(self, **kw: Any) -> "TMConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TMState:
    """Trainable state: the automata bank, flattened over (class, clause)."""

    ta_state: torch.Tensor   # int8 (n_clauses_total, n_literals)
    steps: int = 0


def init(config: TMConfig, rng, device="cuda") -> TMState:
    """Random init in {-1, 0} from the key ``rng`` (``prng.PRNGKey``; the
    reference's ``jax.random.randint`` draw, bit for bit), drawn on
    ``device``: automata sit just either side of the decision boundary.
    Padded clauses are pinned to ``-n_states`` (all-exclude, empty)
    forever."""
    from repro_torch import device as _device
    from repro_torch.core import prng

    dev = _device.resolve(device)
    shape = (config.n_clauses_total, config.n_literals)
    st = prng.randint(prng.as_key(rng, dev), shape, -1, 1, torch.int8)
    st[config.n_clauses_raw:] = -config.n_states
    return TMState(ta_state=st, steps=0)


def state_from_numpy(ta: np.ndarray, steps: int = 0, device="cuda") -> TMState:
    """A bank held as numpy int8 (the reference's ``np.asarray(state.
    ta_state)``, a checkpoint's ``ta``) -> a :class:`TMState` on ``device``.
    This is how the reference's weights enter the port."""
    from repro_torch import device as _device

    arr = np.ascontiguousarray(np.asarray(ta))
    if arr.dtype != np.int8 or arr.ndim != 2:
        raise ValueError(f"expected a 2-D int8 bank, got {arr.dtype} {arr.shape}")
    return TMState(ta_state=torch.from_numpy(arr.copy()).to(_device.resolve(device)),
                   steps=int(steps))


# ---------------------------------------------------------------------------
# Literals & clauses
# ---------------------------------------------------------------------------

def literals(x: torch.Tensor) -> torch.Tensor:
    """(B, F) {0,1} -> (B, 2F) uint8: each feature contributes x and ~x."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def include_mask(ta_state: torch.Tensor) -> torch.Tensor:
    """Boolean include/exclude actions of each automaton."""
    return ta_state >= 0


def clause_outputs(ta_state: torch.Tensor, lits: torch.Tensor, *,
                   training: bool) -> torch.Tensor:
    """Dense clause evaluation -> (B, C) uint8.

    A clause fires iff no included literal is 0.  Empty clauses output 1
    during training (vacuous AND) and 0 at inference (they are dropped from
    the compiled circuit, paper §III).  Builds a (B, C, L) field: for small
    banks and tests; the packed kernels serve the real widths.
    """
    inc = include_mask(ta_state)                        # (C, L)
    viol = inc[None, :, :] & (lits[:, None, :] == 0)    # (B, C, L)
    fire = ~torch.any(viol, dim=-1)                     # (B, C)
    if not training:
        fire = fire & torch.any(inc, dim=-1)[None, :]
    return fire.to(torch.uint8)


def polarity(config: TMConfig, device="cpu") -> torch.Tensor:
    """(C_total,) int32: +1/-1 alternating within each class; 0 on padded
    clauses."""
    j = torch.arange(config.n_clauses_total, device=device)
    pol = torch.where(j % 2 == 0, 1, -1).to(torch.int32)
    return torch.where(j < config.n_clauses_raw, pol, 0).to(torch.int32)


def clause_class(config: TMConfig, device="cpu") -> torch.Tensor:
    """(C_total,) int32 class id of each clause (padded clauses take the
    last class; their polarity 0 keeps them out of every sum)."""
    c = torch.arange(config.n_clauses_total, device=device)
    return torch.clamp(c // config.clauses_per_class, 0,
                       config.n_classes - 1).to(torch.int32)


def vote_matrix(config: TMConfig, device="cpu") -> torch.Tensor:
    """(C_total, n_classes) int32: class sum = clause outputs @ votes (the
    paper's class-sum adder bank)."""
    cls = clause_class(config, device).to(torch.int64)
    onehot = cls[:, None] == torch.arange(config.n_classes, device=device)[None, :]
    return onehot.to(torch.int32) * polarity(config, device)[:, None]


def class_sums(config: TMConfig, ta_state: torch.Tensor, lits: torch.Tensor, *,
               training: bool) -> torch.Tensor:
    """(B, n_classes) int32 polarity-weighted clause votes (dense path)."""
    from repro_torch.kernels import ref

    out = clause_outputs(ta_state, lits, training=training)
    return ref.class_sum_ref(out, vote_matrix(config, ta_state.device))


def predict(config: TMConfig, state: TMState, x: torch.Tensor) -> torch.Tensor:
    """Argmax classification of (B, F) features on ``x``'s device.

    The sums come from the dense fused kernel over packed literals (its
    plain version for CPU tensors), with empty clauses masked (inference
    semantics), as the reference's kernel path computes them.
    """
    from repro_torch.core import packetizer
    from repro_torch.kernels import ops

    ta = state.ta_state
    lw = packetizer.pack_literals(x)
    iw = packetizer.pack_include_masks(ta)
    nonempty = torch.any(ta >= 0, dim=-1).to(torch.int32)
    sums = ops.tm_forward_packed(lw, iw, vote_matrix(config, ta.device), nonempty)
    return torch.argmax(sums, dim=-1)


def accuracy(config: TMConfig, state: TMState, x: torch.Tensor,
             y: torch.Tensor) -> float:
    return float((predict(config, state, x) == y.to(x.device)).to(torch.float32).mean())
