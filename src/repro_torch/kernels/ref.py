"""Plain PyTorch oracles for the port's kernels.

Each function defines the exact semantics its kernel must reproduce, on
int32 bit patterns of packed words (``core/packetizer.py``).  The training
oracle draws from the same counter-based integer hash as the kernels
(``hash_u32``), so a training step is reproducible bit for bit on any
device and equals the reference's.

torch has no uint32 ``+``, ``>>`` or ``<``, so the hash runs in int64 on
values in [0, 2**32), masked back to 32 bits after every add and multiply;
each 32 x 32-bit multiply is split into 16-bit halves so no int64 product
overflows.
"""

from __future__ import annotations

import torch


def clause_fire_ref(lit_words: torch.Tensor, inc_words: torch.Tensor) -> torch.Tensor:
    """(B, W) literals x (C, W) includes (int32 bit patterns) -> (B, C) int8.

    fire[b, c] = 1 iff every include bit of clause c sees literal 1:
    AND_w ((inc[c, w] & ~lit[b, w]) == 0).  Vacuous AND (empty clause) = 1;
    empty-clause masking is the caller's concern (inference drops them).
    """
    viol = inc_words[None, :, :] & ~lit_words[:, None, :]      # (B, C, W)
    return (~torch.any(viol != 0, dim=-1)).to(torch.int8)


def class_sum_ref(fired: torch.Tensor, votes: torch.Tensor) -> torch.Tensor:
    """(B, C) {0,1} x (C, K) int32 -> (B, K) int32.

    The product runs in float64, which holds every partial sum exactly
    (|sum| <= C * max|vote| < 2**53) and has a matrix product on both the
    CPU and CUDA, where torch has none for int32.
    """
    return (fired.to(torch.float64) @ votes.to(torch.float64)).to(torch.int32)


# -- counter-based RNG: xxhash-style avalanche, identical in kernel and oracle

M32 = 0xFFFFFFFF
_H1, _H2, _H3 = 2654435761, 2246822519, 3266489917


def mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant k."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_u32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic uint32 hash of (index, seed), the kernels' RNG.

    ``idx``: integer tensor whose values are taken mod 2**32; ``seed``: an
    int (mod 2**32).  Returns int64 values in [0, 2**32).
    """
    x = (mul_u32(idx.to(torch.int64) & M32, _H1) + (int(seed) & M32)) & M32
    x = x ^ (x >> 16)
    x = mul_u32(x, _H2)
    x = x ^ (x >> 13)
    x = mul_u32(x, _H3)
    return x ^ (x >> 16)


def prob_to_u32(p: float) -> int:
    """Threshold such that P[hash < t] == p (up to 2^-32).  ``p = 1``
    gives 0xFFFFFFFF, so a draw of 0xFFFFFFFF is never below it."""
    return min(int(round(p * 2 ** 32)), 2 ** 32 - 1)


def ta_delta_ref(
    ta: torch.Tensor,       # (C, L) int8 automata states
    lits: torch.Tensor,     # (B, L) uint8 {0,1}
    fire: torch.Tensor,     # (B, C) uint8 clause outputs (training semantics)
    ftype: torch.Tensor,    # (B, C) uint8: 0 = none, 1 = Type I, 2 = Type II
    seed: int,
    *,
    p_act: float,
    p_inact: float,
    b_offset: int = 0,      # global index of lits[0] (batch-chunked training)
    c_offset: int = 0,      # global index of ta[0] (clause-sharded training)
    c_total: int | None = None,  # global clause count when ta is a shard
) -> torch.Tensor:
    """Summed feedback delta over the batch -> (C, L) int32.

    The draw of automaton (c, l) for sample b is ``hash_u32(gidx, seed)``
    with gidx = ((b + b_offset) * Cg + c') * L + l mod 2**32, where
    c' = c and Cg = C by default, and c' = c + c_offset, Cg = c_total when
    ``c_total`` is set (global clause ids, so a clause shard reproduces the
    full bank's draws for its rows).  Per (sample, clause) with Type I
    feedback: +1 with probability p_act on included-and-lit literals of a
    fired clause, else -1 with probability p_inact; with Type II: +1 on
    excluded, unlit literals of a fired clause.

    Loops over samples, accumulating (C, L) int32, and draws only the rows
    with Type I feedback: it never builds the (B, C, L) field (1.6 GB per
    int64 temporary at tm-mnist, batch 64).
    """
    B, L = lits.shape
    C = ta.shape[0]
    Cg = C if c_total is None else c_total
    t_act, t_inact = prob_to_u32(p_act), prob_to_u32(p_inact)
    dev = ta.device
    c_idx = torch.arange(C, dtype=torch.int64, device=dev)
    if c_total is not None:
        c_idx = c_idx + c_offset
    l_idx = torch.arange(L, dtype=torch.int64, device=dev)
    excl = ta < 0
    delta = torch.zeros((C, L), dtype=torch.int32, device=dev)
    # on ``meta`` (the dry-run) no value is known: every row is drawn, the
    # data-independent bound the reference's dense oracle field computes
    meta = dev.type == "meta"
    for b in range(B):
        ft = ftype[b]
        if not meta and not bool((ft != 0).any()):
            continue
        lit_on = lits[b] == 1                                   # (L,)
        fire_b = fire[b] == 1                                   # (C,)
        rows = (torch.arange(C, device=dev) if meta
                else torch.nonzero(ft == 1).flatten())
        if meta or rows.numel():
            bu = (b + b_offset) & M32
            cg = mul_u32((((bu * Cg) & M32) + c_idx[rows]) & M32, L)
            r = hash_u32(cg[:, None] + l_idx[None, :], seed)    # (n, L)
            act = (r < t_act).to(torch.int32)
            inact = (r < t_inact).to(torch.int32)
            d1 = torch.where(fire_b[rows, None] & lit_on[None, :], act, -inact)
            delta[rows] += d1
        if not meta:
            rows = torch.nonzero(ft == 2).flatten()
        if meta or rows.numel():
            d2 = fire_b[rows, None] & ~lit_on[None, :] & excl[rows]
            delta[rows] += d2.to(torch.int32)
    return delta


# -- xnor_popcount: the BNN baseline's binarized matmul

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns or int64 values) ->
    int64.  torch has no popcount: a SWAR count in int64, masked to 32 bits."""
    v = x.to(torch.int64) & M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def xnor_popcount_ref(a_words: torch.Tensor, w_words: torch.Tensor,
                      n_bits: int) -> torch.Tensor:
    """(B, W) x (O, W) int32 bit patterns -> (B, O) int32 of +1/-1 dots.

    Bits encode {-1: 0, +1: 1}; dot = matches - mismatches
    = 2 * popcount(~(a ^ w)) - n_bits, where the W * 32 - n_bits padding
    bits (zero in both) match and are taken out again.  Loops over words,
    so it holds (B, O) int64, never the (B, O, W) field.
    """
    pop = torch.zeros((a_words.shape[0], w_words.shape[0]), dtype=torch.int64,
                      device=a_words.device)
    for i in range(a_words.shape[1]):
        pop += popcount32(~(a_words[:, i, None] ^ w_words[None, :, i]))
    matches = pop - (a_words.shape[1] * 32 - n_bits)
    return (2 * matches - n_bits).to(torch.int32)
