"""Tsetlin Automata feedback (Type I / Type II): the reference's per-sample
``jax.random`` training step, and applying a delta to the bank.

Semantics follow Granmo'18 at per-sample granularity (the reference's
``core/feedback.py``):

Type I (target-class positive clauses, negative-class negative clauses),
applied to clause j with probability ``(T - clamp(sum))/2T`` resp.
``(T + clamp(sum))/2T``:
  * clause=1, literal=1: state += 1  w.p. 1 (boost) else (s-1)/s
  * clause=1, literal=0: state -= 1  w.p. 1/s
  * clause=0:            state -= 1  w.p. 1/s   (all literals)

Type II (the polarity-mirrored clauses):
  * clause=1, literal=0, currently excluded: state += 1

Deltas are computed per sample from the bank at the start of the batch
and summed over the batch before they are applied.  Every draw is the
reference's: ``core/prng.py`` reproduces ``jax.random`` bit for bit, so
``batch_feedback_delta`` equals the reference's at tolerance 0.  The
hash-RNG step of ``kernels/ops.py`` (``tm_train_step_kernel``) is the
other trainer.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng, tm

# samples a pass of batch_feedback_delta takes at once
FEEDBACK_CHUNK = 32


def _clause_fire(ta_slice: torch.Tensor, lits: torch.Tensor) -> torch.Tensor:
    """(..., cpc, L) int8 x (..., L) {0,1} -> (..., cpc) uint8, training
    semantics (an empty clause fires)."""
    viol = (ta_slice >= 0) & (lits[..., None, :] == 0)
    return (~torch.any(viol, dim=-1)).to(torch.uint8)


def _clause_polarity(cpc: int, device="cpu") -> torch.Tensor:
    j = torch.arange(cpc, device=device)
    return torch.where(j % 2 == 0, 1, -1).to(torch.int32)


def _f32(value: float, device) -> torch.Tensor:
    """A Python double rounded to float32, as jax's weak types round it,
    held on ``device``: a tensor operand, so that CUDA divides by it
    instead of multiplying by a rounded reciprocal, as it does for a
    Python scalar."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _class_feedback_delta(
    config: tm.TMConfig,
    ta_slice: torch.Tensor,    # (E, cpc, L) int8: the automata of one class each
    lits: torch.Tensor,        # (E, L) {0,1}
    is_target: torch.Tensor,   # (E,) bool: True -> target-class roles
    rng: torch.Tensor,         # (E, 2) keys
) -> torch.Tensor:
    """Per-sample feedback deltas of ``E`` (sample, class) entries ->
    (E, cpc, L) int8; entry ``e`` is the reference's
    ``_class_feedback_delta`` of its own slice, literals, role and key.

    A Type I automaton reads one draw: ``r_act``'s where its clause fires
    and its literal is 1, ``r_inact``'s elsewhere.  So only the selected
    Type I clauses' rows are drawn, each automaton at its own counter of
    the (cpc, L) field, not the two whole fields the reference draws.
    """
    E, cpc, L = ta_slice.shape
    dev = ta_slice.device
    T = config.threshold
    pol = _clause_polarity(cpc, dev)

    fire = _clause_fire(ta_slice, lits)                             # (E, cpc)
    csum = torch.clamp((pol * fire.to(torch.int32)).sum(-1), -T, T)  # (E,)
    p = torch.where(is_target, T - csum, T + csum).to(torch.float32) / _f32(2.0 * T, dev)

    r_sel, r_act, r_inact = prng.split(rng, 3).unbind(-2)           # (E, 2) each
    sel = prng.uniform(r_sel, (cpc,)) < p[:, None]                  # (E, cpc)
    type1 = torch.where(is_target[:, None], pol > 0, pol < 0)      # (E, cpc)

    lit_on = lits == 1                                              # (E, L)
    fire_b = fire == 1
    # Type II: deterministic on the excluded automata of firing clauses
    d = ((sel & ~type1 & fire_b)[:, :, None] & ~lit_on[:, None, :]
         & (ta_slice < 0)).to(torch.int8)

    # Type I, on the selected clauses' rows only
    e, j = torch.nonzero(sel & type1, as_tuple=True)
    if e.numel():
        on = fire_b[e, j][:, None] & lit_on[e]                      # (n, L)
        key = torch.where(on[..., None], r_act[e][:, None, :], r_inact[e][:, None, :])
        idx = j[:, None] * L + torch.arange(L, device=dev)
        u = prng.bits_to_uniform(prng.bits_at(key, idx))
        p_act = 1.0 if config.boost_true_positive else (config.s - 1.0) / config.s
        hit = u < torch.where(on, _f32(p_act, dev), _f32(1.0 / config.s, dev))
        d[e, j] = torch.where(on, hit.to(torch.int8), -hit.to(torch.int8))
    return d


def batch_feedback_delta(
    config: tm.TMConfig,
    ta_state: torch.Tensor,   # (C_total, L) int8
    x: torch.Tensor,          # (B, F) {0,1}
    y: torch.Tensor,          # (B,) class ids
    rng: torch.Tensor,        # a key
) -> torch.Tensor:
    """Summed feedback deltas over the batch: (C_total, L) int32 on the
    bank's device, equal to the reference's.

    Sample ``b`` takes key ``split(rng, B)[b]``, splits it three ways
    (negative class, target, negative), samples its negative class as
    ``kn + (kn >= y)`` with ``kn = randint(r_neg, (), 0, K - 1)``, and adds
    the target's and the negative class's deltas.  Every sample reads the
    bank as it was at the start of the batch, so ``FEEDBACK_CHUNK`` (32)
    samples, 64 (sample, class) entries, are computed at once and their
    int32 deltas ``index_add_``-ed: at tm-mnist (200 clauses a class, 1568
    literals) a pass holds the 64 entries' (200, 1568) slices, their int8
    and int32 deltas and the selected Type I rows' draws: ~0.5 GB when
    half the clauses are selected, under 1 GB when all are.
    """
    cpc, K = config.clauses_per_class, config.n_classes
    dev = ta_state.device
    L = ta_state.shape[1]
    lits = tm.literals(x.to(dev))                                   # (B, L)
    y = y.to(device=dev, dtype=torch.int64)
    B = y.shape[0]
    keys = prng.split(prng.as_key(rng, dev), B)                      # (B, 2)
    r_neg, r_t, r_n = prng.split(keys, 3).unbind(-2)                 # (B, 2) each
    kn = prng.randint(r_neg, (), 0, K - 1, torch.int32).to(torch.int64)
    kn = kn + (kn >= y).to(torch.int64)
    acc = torch.zeros(ta_state.shape, dtype=torch.int32, device=dev)
    clause = torch.arange(cpc, device=dev)
    for lo in range(0, B, FEEDBACK_CHUNK):
        sl = slice(lo, lo + FEEDBACK_CHUNK)
        n = lits[sl].shape[0]
        rows = torch.cat([y[sl], kn[sl]])[:, None] * cpc + clause    # (2n, cpc)
        is_t = torch.arange(2 * n, device=dev) < n
        d = _class_feedback_delta(config, ta_state[rows], lits[sl].repeat(2, 1),
                                  is_t, torch.cat([r_t[sl], r_n[sl]]))
        acc.index_add_(0, rows.reshape(-1), d.reshape(-1, L).to(torch.int32))
    return acc


def apply_delta(config: tm.TMConfig, ta_state: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """states <- clamp(states + delta) in int32, cast back to int8."""
    new = torch.clamp(ta_state.to(torch.int32) + delta,
                      -config.n_states, config.n_states - 1)
    return new.to(torch.int8)
