"""Operations and bytes that a batch's work needs, counted from the
artifact's or the bank's arrays, the batch's shapes and the reference's
clause outputs and feedback, never from the program's schedules or
launches, so a change of route, factorization or kernel leaves the count
as it is.  A bound is max(operations / integer peak, bytes / HBM rate)
(``peaks.json``).

Operations are 32-bit integer operations.  The kernels evaluate clauses
bit-sliced, 32 datapoints to a word, so an operation that decides a clause
covers 32 datapoints; counting one a datapoint would let a bit-sliced
kernel pass its bound.

* Inference of a batch of B datapoints over an artifact of U rows, Wa
  active words and K classes.  Bytes: the batch's active literal words read
  once (B Wa 4), the artifact read once (include words, word ids, votes)
  and the (B, K) int32 sums written once.  Operations: one add for each
  nonzero vote of a clause that fires in a 32-datapoint word: the adds no
  evaluation order can skip.  Deciding the clauses themselves is not
  counted, because a walk that stops early needs data-dependent work no
  count from the arrays can state as a bound.
* The fused training kernel, one step at batch B over C clauses, L
  literals in W words.  Every literal of a Type I pair needs a hash draw
  (exactness: even p = 1 fails on the top draw), 10 operations each (the
  hash's multiply-by-add, two multiplies, three shifts and three xors, and
  the compare), plus a selection draw, 10 operations, for each pair of the
  sample's target and negative classes and one operation for each selected
  pair.  Bytes: the bank read (C L), the int32 delta written (4 C L), the
  literal words (4 B W) and include words (4 C W) read, the per-sample
  scalars (4 x 4 B) and per-clause metadata (2 x 4 C).
* The whole training step: the fused kernel's operations and one operation
  a clause and 32-sample word for the class sums; bytes: the bank read and
  the new bank written (2 C L), the batch's features and labels read.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tmbench.reference import tm_reference

OPS_PER_DRAW = 10
PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def bound_s(ops: float, n_bytes: float, pk: dict) -> float:
    return max(ops / pk["int32_ops_per_s"], n_bytes / pk["hbm_bytes_per_s"])


def words32(n: int) -> int:
    return (n + 31) // 32


class ArtifactRows:
    """The arrays of a compiled artifact file that the inference count
    reads: ``include_words`` (U, Wa) uint32 over the ``word_ids`` (Wa,) of
    the dense literal words, and ``votes`` (U, K)."""

    def __init__(self, path: str, device):
        with np.load(path) as z:
            inc = np.ascontiguousarray(z["include_words"], np.uint32).view(np.int32)
            self.word_ids = torch.from_numpy(np.asarray(z["word_ids"], np.int64)).to(device)
            self.votes = torch.from_numpy(np.asarray(z["votes"], np.int64)).to(device)
        bits = tm_reference.unpack_words(torch.from_numpy(inc.copy()).to(device))
        self.inc = bits.to(torch.float64)                                # (U, 32 Wa)
        self.nonempty = bits.any(1)
        self.n_active_words = inc.shape[1]

    def fire(self, lit_words: torch.Tensor) -> torch.Tensor:
        """(B, U) bool outputs of the rows on (B, W) packed literals."""
        out = []
        for lo in range(0, lit_words.shape[0], tm_reference.BLOCK_ROWS):
            words = lit_words[lo:lo + tm_reference.BLOCK_ROWS].index_select(1, self.word_ids)
            out.append(tm_reference.clause_fire(self.inc, self.nonempty,
                                                tm_reference.unpack_words(words)))
        return torch.cat(out)


def infer_batch(fire: torch.Tensor, votes: torch.Tensor, n_active_words: int) -> dict:
    """Work of one inference batch: ``fire`` (B, U) bool outputs of the
    artifact's rows (``ArtifactRows.fire``), ``votes`` (U, K)."""
    B, U = fire.shape
    K = votes.shape[1]
    pad = words32(B) * 32 - B
    f = torch.nn.functional.pad(fire, (0, 0, 0, pad)) if pad else fire
    fired_words = f.view(-1, 32, U).any(1).sum(0)                       # (U,)
    nnz = (votes != 0).sum(1)
    ops = int((fired_words * nnz).sum())
    n_bytes = 4 * (B * n_active_words + U * n_active_words + n_active_words
                   + U * K + B * K)
    return dict(ops=ops, bytes=n_bytes)


def train_step(fire: torch.Tensor, ftype: torch.Tensor, y: torch.Tensor,
               n_features: int, n_literals: int, n_classes: int,
               clauses_per_class: int) -> dict:
    """Work of one training step from the reference's (B, C) clause
    outputs and feedback types: ``{"fused_train": {ops, bytes}, "step":
    {ops, bytes}}``."""
    B, C = ftype.shape
    L, W = n_literals, words32(n_literals)
    type1 = int((ftype == 1).sum())
    selected = int((ftype != 0).sum())
    candidates = B * 2 * clauses_per_class
    ops_train = OPS_PER_DRAW * (type1 * L + candidates) + selected
    bytes_train = C * L + 4 * C * L + 4 * B * W + 4 * C * W + 16 * B + 8 * C
    ops_step = ops_train + words32(B) * C
    bytes_step = 2 * C * L + B * n_features + 4 * B
    return {"fused_train": dict(ops=ops_train, bytes=bytes_train),
            "step": dict(ops=ops_step, bytes=bytes_step)}
