"""The plain reference of both TM configurations: inference class sums and
one hash-RNG training step, in plain PyTorch on any device.

It imports nothing of the program.  Inference reads the trained automata
bank that the serving artifact was compiled from, and derives every
clause's include mask, class and polarity from it, never from the
artifact's merged rows, pruned words or schedules.  Training follows the
Tsetlin machine's feedback rules with a frozen copy of the port's
counter-based hash draws (``hash_u32``, the xxhash-style avalanche), so
its banks are the port's bits.

Semantics (Granmo 2018, as MATADOR runs it):

* a clause includes a literal iff its automaton's state is >= 0; clause
  ``j`` belongs to class ``j // clauses_per_class`` and votes +1 when ``j``
  is even, -1 when odd; the clauses past ``n_classes x
  clauses_per_class`` pad the bank and vote nothing;
* a literal list is the features then their complements; a clause fires
  iff every included literal is 1.  At inference an empty clause is 0; in
  training it fires (vacuous AND);
* class sums are the sums of the fired clauses' votes;
* a training step clamps the sums to [-T, T], hashes a negative class per
  sample, selects each (sample, clause) pair of the target class with
  probability (T - sum_y) / 2T and of the negative class with (T + sum_n) /
  2T (float32), gives Type I feedback to positive target and negative
  negative clauses and Type II to the others, and sums the automata's
  changes over the batch: Type I, +1 with probability p_act on a fired
  clause's lit literal and else -1 with probability 1/s; Type II, +1 on a
  fired clause's unlit excluded literal.

Every matrix product is float64, which holds the integer counts exactly.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_H1, _H2, _H3 = 2654435761, 2246822519, 3266489917
_NEG_XOR = 0x9E3779B9
_SEL_MIX = 0x9E3779B1
_SEL_XOR = 0x85EBCA6B
WORD_BITS = 32
# rows of a batch evaluated at a time (bounds the float64 temporaries)
BLOCK_ROWS = 8192
# Type I pairs drawn at a time in a training step
BLOCK_PAIRS = 8192


# -- bits -------------------------------------------------------------------

def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 bit patterns -> (N, 32 W) uint8 bits, LSB first."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1).to(torch.uint8)


def literals(x: torch.Tensor) -> torch.Tensor:
    """(B, F) {0,1} -> (B, 2F) uint8: the features, then their complements."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=1)


# -- inference --------------------------------------------------------------

def clause_fire(inc: torch.Tensor, nonempty: torch.Tensor, lits: torch.Tensor):
    """(b, U) bool inference outputs of U clauses, ``inc`` (U, n) float64
    include masks, on (b, n) 0/1 literals: every included literal lit, and
    the clause not empty."""
    unlit = 1.0 - lits.to(torch.float64)
    return ((unlit @ inc.T) == 0) & nonempty[None, :]


class Bank:
    """A serving artifact's trained bank (``ta_state``, (C, L) int8, of the
    bank file) as the reference serves it: ``inc`` (C_raw, L) float64
    include masks, ``nonempty`` (C_raw,), ``votes`` (C_raw, K) float64."""

    def __init__(self, path: str, tmc: TM, device):
        with np.load(path) as z:
            ta = torch.from_numpy(np.asarray(z["ta_state"], np.int8)).to(device)
        if tuple(ta.shape) != (tmc.C, tmc.L):
            raise ValueError(f"bank {path} is {tuple(ta.shape)}, not {(tmc.C, tmc.L)}")
        inc = ta[:tmc.C_raw] >= 0
        self.inc = inc.to(torch.float64)
        self.nonempty = inc.any(1)
        self.votes = tmc.clause_meta(device)[2][:tmc.C_raw]
        self.L = tmc.L

    def keep_all_but_every(self, n: int) -> torch.Tensor:
        """(C_raw,) bool: every clause but each ``n``-th (the control)."""
        j = torch.arange(self.inc.shape[0], device=self.inc.device)
        return j % n != n - 1


def infer_fire(bank: Bank, lit_words: torch.Tensor, keep: torch.Tensor | None = None):
    """Yield ``(lo, fire)`` blocks of the (B, C') bool inference clause
    outputs of (B, W) packed literals; ``keep`` serves only the clauses it
    marks (the control)."""
    inc, nonempty = bank.inc, bank.nonempty
    if keep is not None:
        inc, nonempty = inc[keep], nonempty[keep]
    for lo in range(0, lit_words.shape[0], BLOCK_ROWS):
        lits = unpack_words(lit_words[lo:lo + BLOCK_ROWS])[:, :bank.L]
        yield lo, clause_fire(inc, nonempty, lits)


def infer_class_sums(bank: Bank, lit_words: torch.Tensor,
                     keep: torch.Tensor | None = None) -> torch.Tensor:
    """(B, W) packed literals -> (B, K) int64 class sums.  ``keep`` serves
    only the clauses it marks (the control)."""
    votes = bank.votes if keep is None else bank.votes[keep]
    out = torch.empty((lit_words.shape[0], votes.shape[1]), dtype=torch.int64,
                      device=lit_words.device)
    for lo, fire in infer_fire(bank, lit_words, keep):
        out[lo:lo + fire.shape[0]] = torch.round(fire.to(torch.float64) @ votes).to(torch.int64)
    return out


# -- the hash draws (frozen copy of the port's hash_u32) --------------------

def mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_u32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """uint32 avalanche of (index, seed) as int64 values in [0, 2**32)."""
    x = (mul_u32(idx.to(torch.int64) & M32, _H1) + (int(seed) & M32)) & M32
    x = x ^ (x >> 16)
    x = mul_u32(x, _H2)
    x = x ^ (x >> 13)
    x = mul_u32(x, _H3)
    return x ^ (x >> 16)


def prob_threshold(p: float) -> int:
    """Draws below this threshold succeed: P = p up to 2**-32."""
    return min(int(round(p * 2 ** 32)), 2 ** 32 - 1)


# -- training ---------------------------------------------------------------

class TM:
    """The sizes a training step needs, from a configuration's ``model``."""

    def __init__(self, model: dict):
        self.F = int(model["n_features"])
        self.K = int(model["n_classes"])
        self.cpc = int(model["clauses_per_class"])
        self.T = int(model["threshold"])
        self.s = float(model["s"])
        self.n_states = int(model["n_states"])
        self.boost = bool(model["boost_true_positive"])
        m = int(model["clause_pad_multiple"])
        self.C_raw = self.K * self.cpc
        self.C = -(-self.C_raw // m) * m
        self.L = 2 * self.F

    def clause_meta(self, device):
        """(class id, polarity, votes) of the C clauses; padded clauses
        take the last class and polarity 0."""
        j = torch.arange(self.C, device=device)
        cls = torch.clamp(j // self.cpc, 0, self.K - 1)
        pol = torch.where(j % 2 == 0, 1, -1) * (j < self.C_raw)
        votes = (cls[:, None] == torch.arange(self.K, device=device)[None, :]) * pol[:, None]
        return cls, pol, votes.to(torch.float64)


def train_feedback(tmc: TM, bank: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   seed: int, probs_dtype=torch.float32):
    """The (B, C) training clause outputs and feedback types (0 none, 1
    Type I, 2 Type II) of one step on ``bank`` (C, L) int8.  ``probs_dtype``
    is the precision of the selection probabilities and draws (float32;
    the control takes bfloat16)."""
    dev = bank.device
    B = x.shape[0]
    cls, pol, votes = tmc.clause_meta(dev)
    inc = (bank >= 0).to(torch.float64)
    everything = torch.ones(bank.shape[0], dtype=torch.bool, device=dev)
    fire = clause_fire(inc, everything, literals(x))                     # (B, C)
    sums = torch.round(fire.to(torch.float64) @ votes).to(torch.int64)
    sums = torch.clamp(sums, -tmc.T, tmc.T)
    y = y.to(torch.int64)
    b_idx = torch.arange(B, dtype=torch.int64, device=dev)
    kn = hash_u32(b_idx, (int(seed) ^ _NEG_XOR) & M32) % (tmc.K - 1)
    kn = kn + (kn >= y).to(torch.int64)
    two_t = torch.tensor(2.0 * tmc.T, dtype=probs_dtype, device=dev)
    p_t = (tmc.T - sums.gather(1, y[:, None])[:, 0]).to(probs_dtype) / two_t
    p_n = (tmc.T + sums.gather(1, kn[:, None])[:, 0]).to(probs_dtype) / two_t
    mixed = (mul_u32(b_idx, _SEL_MIX)[:, None]
             + torch.arange(tmc.C, dtype=torch.int64, device=dev)[None, :]) & M32
    r_sel = hash_u32(mixed, (int(seed) ^ _SEL_XOR) & M32).to(probs_dtype) / 2 ** 32
    is_t = cls[None, :] == y[:, None]
    is_n = cls[None, :] == kn[:, None]
    zero = torch.zeros((), dtype=probs_dtype, device=dev)
    p = torch.where(is_t, p_t[:, None], torch.where(is_n, p_n[:, None], zero))
    pos, neg = (pol > 0)[None, :], (pol < 0)[None, :]
    ftype = torch.where((is_t & pos) | (is_n & neg), 1,
                        torch.where((is_t & neg) | (is_n & pos), 2, 0))
    ftype = torch.where(r_sel < p, ftype, 0).to(torch.uint8)
    return fire, ftype


def train_step(tmc: TM, bank: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               seed: int, probs_dtype=torch.float32):
    """One training step -> ``(new_bank, fire, ftype)``: the (C, L) int8
    bank after the batch's summed feedback."""
    dev = bank.device
    C, L = bank.shape
    fire, ftype = train_feedback(tmc, bank, x, y, seed, probs_dtype)
    lits = literals(x).to(torch.bool)
    excl = bank < 0
    t_act = prob_threshold(1.0 if tmc.boost else (tmc.s - 1.0) / tmc.s)
    t_inact = prob_threshold(1.0 / tmc.s)
    l_idx = torch.arange(L, dtype=torch.int64, device=dev)
    delta = torch.zeros((C, L), dtype=torch.int32, device=dev)
    b1, c1 = torch.nonzero(ftype == 1, as_tuple=True)
    for lo in range(0, b1.numel(), BLOCK_PAIRS):
        b, c = b1[lo:lo + BLOCK_PAIRS], c1[lo:lo + BLOCK_PAIRS]
        base = mul_u32((((b * C) & M32) + c) & M32, L)
        r = hash_u32(base[:, None] + l_idx[None, :], seed)              # (P, L)
        on = fire[b, c][:, None] & lits[b]
        d = torch.where(on, (r < t_act).to(torch.int32), -(r < t_inact).to(torch.int32))
        delta.index_add_(0, c, d)
    b2, c2 = torch.nonzero((ftype == 2) & fire, as_tuple=True)
    for lo in range(0, b2.numel(), BLOCK_PAIRS):
        b, c = b2[lo:lo + BLOCK_PAIRS], c2[lo:lo + BLOCK_PAIRS]
        delta.index_add_(0, c, (~lits[b] & excl[c]).to(torch.int32))
    new = torch.clamp(bank.to(torch.int32) + delta, -tmc.n_states, tmc.n_states - 1)
    return new.to(torch.int8), fire, ftype
