"""Tsetlin Machine configuration (MATADOR / Granmo'18).

Only :class:`TMConfig` is ported so far: the serving path needs the
model's widths, and training (``init``, clause evaluation, feedback)
arrives with the training slice.
"""

from __future__ import annotations

import dataclasses


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
