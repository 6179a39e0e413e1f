"""Anytime-inference metadata: per-tile-prefix margin bounds + quality tiers.

TM class sums are monotone vote accumulations (PAPERS.md, "Runtime Tunable
Tsetlin Machines"): after walking a prefix of the tile schedule, the
not-yet-folded clause blocks can move any *pairwise* class margin by at
most the sum of their per-row vote swings.  That single scalar per tile
prefix — ``margin[t]`` = remaining maximum vote swing after tile ``t`` —
funds both runtime exit modes:

* **exact early-exit** — once the leading class's top1-top2 margin is
  *strictly* greater than ``margin[t]``, no remaining tile can change the
  argmax (strict: at equality a final tie could flip argmax toward a
  lower class index).  Predictions are bit-identical to the full walk.
* **budgeted mode** — run only the first ``P`` tiles and report
  ``margin[P - 1]`` as the error bound: every pairwise class-sum margin
  of the served answer is within ±bound of the full walk's, so the served
  class trails the true winner by at most ``bound`` votes.

Soundness of the per-row swing: an unfolded row ``r`` contributes either
``votes[r]`` (fires) or ``0`` to the class sums, so its contribution to
any pairwise delta ``S[a] - S[b]`` lies in ``{0, votes[r][a] -
votes[r][b]}`` — bounded in magnitude by ``votes[r].max() -
votes[r].min()``.  Rows whose clause block never folds (zero-tile blocks)
contribute to neither the full walk nor the bound.

``margin_order`` re-orders clause rows so high-|vote|-mass blocks fold
first (margins decay fast -> early exit fires sooner); ordering is purely
a performance lever — the bounds above hold for any order.

Everything here is plain numpy over schedule metadata; the kernels only
ever see the finished ``(T,)`` margin table or a sliced
prefix schedule.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Residual-swing fraction allowed per quality level (1 = mildest
# degradation .. 3 = deepest brownout).  Level 0 is always exact.
DEFAULT_QUALITY_FRACS = (0.05, 0.15, 0.35)
MAX_QUALITY = len(DEFAULT_QUALITY_FRACS)


def row_swing(votes: np.ndarray) -> np.ndarray:
    """(U, K) int votes -> (U,) int64 per-row max pairwise vote swing."""
    v = np.asarray(votes, dtype=np.int64)
    if v.ndim != 2 or v.shape[1] == 0:
        return np.zeros(v.shape[0], np.int64)
    return v.max(axis=1) - v.min(axis=1)


def total_swing(votes: np.ndarray) -> int:
    """Sum of all row swings — the margin "before tile 0"."""
    return int(row_swing(votes).sum())


def _fold_margins(fold_tiles: np.ndarray, block_swing: np.ndarray,
                  n_tiles: int) -> np.ndarray:
    """margin[t] = sum of block_swing over blocks whose fold tile > t."""
    margins = np.zeros(n_tiles, np.int64)
    if n_tiles == 0 or fold_tiles.size == 0:
        return margins
    folded_at = np.bincount(fold_tiles, weights=block_swing.astype(np.float64),
                            minlength=n_tiles)[:n_tiles]
    margins[:] = block_swing.sum() - np.cumsum(folded_at).astype(np.int64)
    return np.maximum(margins, 0)


def sparse_tile_margins(schedule, votes: np.ndarray) -> np.ndarray:
    """(T,) int64 residual-swing table for a :class:`SparseSchedule`.

    ``votes`` is the (U, K) vote table aligned with the schedule's row
    order (padded rows, if passed, are all-zero and contribute nothing).
    """
    T = schedule.n_tiles
    swing = row_swing(votes)
    bc = schedule.block_c
    n_cb = schedule.n_cblocks
    # per-clause-block swing over its real rows
    need = n_cb * bc
    sw = np.pad(swing, (0, max(0, need - len(swing))))[:need]
    block_swing = sw.reshape(n_cb, bc).sum(axis=1)
    counts = np.asarray(schedule.counts, np.int64)
    fold = np.asarray(schedule.indptr, np.int64)[1:] - 1   # last tile per cb
    live = counts > 0                                      # zero-tile blocks never fold
    return _fold_margins(fold[live], block_swing[:len(fold)][live], T)


def factorized_tile_margins(fschedule, votes: np.ndarray) -> np.ndarray:
    """(T,) int64 residual-swing table for a :class:`FactorizedSchedule`.

    Stage-1 term tiles (indices ``[0, n_term_tiles)``) fold no votes, so
    the margin there is the full total swing; clause-tile folds are offset
    by ``n_term_tiles``.
    """
    T = fschedule.n_tiles
    nt = fschedule.n_term_tiles
    swing = row_swing(votes)
    bc = fschedule.block_c
    counts = np.asarray(fschedule.counts, np.int64)
    n_cb = len(counts)
    need = n_cb * bc
    sw = np.pad(swing, (0, max(0, need - len(swing))))[:need]
    block_swing = sw.reshape(n_cb, bc).sum(axis=1)
    fold = nt + np.asarray(fschedule.indptr, np.int64)[1:] - 1
    live = counts > 0
    return _fold_margins(fold[live], block_swing[live], T)


def sparse_prefix_schedule(schedule, n_tiles: int):
    """Slice a sparse schedule to its first ``n_tiles`` tiles.

    Clause blocks cut mid-chain never reach their fold tile and so
    contribute exactly 0 votes — which is what the ``margin[P-1]`` bound
    already accounts for.
    """
    P = int(max(1, min(n_tiles, schedule.n_tiles)))
    if P == schedule.n_tiles:
        return schedule
    indptr = np.asarray(schedule.indptr, np.int64)
    counts_p = (np.clip(indptr[1:], 0, P)
                - np.clip(indptr[:-1], 0, P)).astype(schedule.counts.dtype)
    indptr_p = np.concatenate([[0], np.cumsum(counts_p)]).astype(
        schedule.indptr.dtype)
    return dataclasses.replace(
        schedule,
        tile_cb=schedule.tile_cb[:P], tile_jb=schedule.tile_jb[:P],
        tile_first=schedule.tile_first[:P], tile_last=schedule.tile_last[:P],
        counts=counts_p, indptr=indptr_p,
    )


def factorized_prefix_schedule(fschedule, n_tiles: int):
    """Slice a factorized schedule to its first ``n_tiles`` tiles.

    Every stage-1 term tile is always retained (clause chains read the
    term scratch, which must be fully populated), so the effective prefix
    is clamped to ``n_term_tiles + 1``.
    """
    nt = fschedule.n_term_tiles
    P = int(max(nt + 1, min(n_tiles, fschedule.n_tiles)))
    if P >= fschedule.n_tiles:
        return fschedule
    indptr = np.asarray(fschedule.indptr, np.int64)
    Pc = P - nt                                  # clause tiles kept
    counts_p = (np.clip(indptr[1:], 0, Pc)
                - np.clip(indptr[:-1], 0, Pc)).astype(fschedule.counts.dtype)
    indptr_p = np.concatenate([[0], np.cumsum(counts_p)]).astype(
        fschedule.indptr.dtype)
    return dataclasses.replace(
        fschedule,
        tile_stage=fschedule.tile_stage[:P], tile_tb=fschedule.tile_tb[:P],
        tile_cb=fschedule.tile_cb[:P], tile_jb=fschedule.tile_jb[:P],
        tile_first=fschedule.tile_first[:P], tile_last=fschedule.tile_last[:P],
        counts=counts_p, indptr=indptr_p,
    )


def quality_prefixes(margins: np.ndarray, total: int,
                     fracs=DEFAULT_QUALITY_FRACS,
                     min_tiles: int = 1) -> list:
    """Map quality levels to tile prefixes.

    Returns ``[{level, n_tiles, bound, frac}, ...]`` for levels ``1..N``:
    the smallest prefix whose residual margin is at most ``frac * total``
    swing.  Level 0 (exact, full walk, bound 0) is implicit.
    """
    m = np.asarray(margins, np.int64)
    out = []
    for lvl, frac in enumerate(fracs, start=1):
        if m.size == 0:
            out.append(dict(level=lvl, n_tiles=0, bound=0, frac=frac))
            continue
        target = int(frac * total)
        ok = m <= target                 # monotone: False..False True..True
        first = int(np.argmax(ok)) if ok.any() else m.size - 1
        # clamp to the table: a factorized schedule with no clause tiles
        # (the all-empty artifact) has fewer tiles than min_tiles, where the
        # reference indexes past the end
        P = min(max(min_tiles, first + 1), m.size)
        out.append(dict(level=lvl, n_tiles=P, bound=int(m[P - 1]), frac=frac))
    return out


def margin_order(include_words: np.ndarray, votes: np.ndarray,
                 cluster_fn=None, n_bands: int = 8) -> np.ndarray:
    """Row permutation: vote-mass (|polarity x multiplicity|) bands
    descending, density-clustered within each band.

    High-mass blocks fold first so ``margins`` decays steeply (early exit
    certifies sooner, short budgeted prefixes carry most of the vote
    mass), while in-band clustering keeps chain lengths homogeneous so
    tile counts stay near the pure-clustered layout.
    """
    votes = np.asarray(votes)
    U = votes.shape[0]
    if U <= 1:
        return np.arange(U)
    mass = np.abs(votes.astype(np.int64)).sum(axis=1)
    top = int(mass.max())
    if top <= 0:
        band = np.zeros(U, np.int64)
    else:
        # log2-spaced bands below the max mass; zero-mass rows last
        with np.errstate(divide="ignore"):
            band = np.floor(np.log2(top / np.maximum(mass, 1))).astype(np.int64)
        band = np.clip(band, 0, n_bands - 1)
        band[mass == 0] = n_bands
    order = []
    for b in np.unique(band):
        rows = np.nonzero(band == b)[0]
        if cluster_fn is not None and len(rows) > 1:
            rows = rows[cluster_fn(include_words[rows])]
        order.append(rows)
    return np.concatenate(order)
