"""Applying a Tsetlin-machine feedback delta to the automata bank.

The delta itself comes from the hash-RNG training step
(``kernels/ops.py:tm_train_step_kernel``).  The reference's per-sample
``jax.random`` step (``batch_feedback_delta``, ``engine="jnp"``) is not
ported: torch cannot reproduce its draws, so it needs distribution tests
rather than parity tests, and waits for a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import tm


def apply_delta(config: tm.TMConfig, ta_state: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """states <- clamp(states + delta) in int32, cast back to int8."""
    new = torch.clamp(ta_state.to(torch.int32) + delta,
                      -config.n_states, config.n_states - 1)
    return new.to(torch.int8)
