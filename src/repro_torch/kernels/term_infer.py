"""Shared-term FACTORIZED compiled TM inference (two stages).

On a trained bank the same word-level AND term (an (active-word,
include-pattern) pair) appears in many clauses: MATADOR's Fig. 5 logic
absorption collapses those to ONE gate, and
``CompileStats.partial_term_sharing`` measures the opportunity.  The
factorized schedule exploits it:

  * **term table** — the unique nonzero ``(word, include-value)`` pairs of
    the deduped bank, each a literal-bit chain of ``<= term_w`` steps;
  * **clause chains** — every clause rewritten as a chain of *term ids*
    (one per active word piece), tiled like the sparse chain schedule.

Stage 1 evaluates each unique term once per sample word into a term bit
table; stage 2 walks the clause chains over that table and folds the
votes.  :func:`factorized_tm_forward_tables` runs the CUDA kernel
(``csrc/term_infer.cu``: bit transpose, stage 1 and stage 2 as three
launches on one stream) for CUDA tensors and
:func:`factorized_tables_plain` for CPU tensors.  Padding terms (rows past
``n_terms``) have all-sentinel chains and evaluate to all ones, so
sentinel-padded clause chains are exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packetizer
from repro_torch.kernels import _build
from repro_torch.kernels.ref import class_sum_ref
from repro_torch.kernels.sparse_infer import (_check_tables, _rup, and_reduce,
                                              bit_transpose_literals,
                                              chain_fold_plain)

# default factorized tiling (the reference's, so shipped schedules are
# memoized under the same key); small artifacts clip
DEFAULT_BLOCK_C = 1024
DEFAULT_BLOCK_J = 64
DEFAULT_BLOCK_T = 32768

# kernel launches (stage 1 + stage 2 pairs) through
# factorized_tm_forward_tables on CUDA tensors
launches = 0


@dataclasses.dataclass(frozen=True, eq=False)
class FactorizedSchedule:
    """Two-level factorized execution schedule for one clause bank.

    ``term_chain[t, i]`` is the literal BIT id of term ``t``'s ``i``-th
    include bit (sentinel ``n_lit_bits`` past the term's popcount); rows
    past ``n_terms`` are all-sentinel padding terms that evaluate to all
    ones.  ``clause_chain[c, j]`` is the TERM id of clause ``c``'s ``j``-th
    piece (sentinel ``n_terms``, a padding term).  The flat tile table
    holds the stage-1 term tiles first (``tile_stage == 0``) and then the
    stage-2 clause tiles in clause-block order; ``counts``/``indptr`` are
    the CSR view over CLAUSE tiles per clause block.
    """

    block_c: int
    block_j: int                # term-chain positions per clause tile
    block_t: int                # term rows per stage-1 tile
    term_w: int                 # bit-chain positions per term row
    n_rows: int                 # unique clauses covered (pre-padding)
    n_terms: int                # unique (word, value) terms (pre-padding)
    n_lit_bits: int             # literal-bit sentinel id
    term_word: np.ndarray       # (n_terms,) int32 active-word index per term
    term_val: np.ndarray        # (n_terms,) uint32 include-word value
    term_chain: np.ndarray      # (Tp, term_w) int32 literal bit ids
    clause_chain: np.ndarray    # (Cp, Jp) int32 term ids
    tile_stage: np.ndarray      # (T,) int32 0 = term tile, 1 = clause tile
    tile_tb: np.ndarray         # (T,) int32 term-block id (stage-1 tiles)
    tile_cb: np.ndarray         # (T,) int32 clause-block id (stage-2 tiles)
    tile_jb: np.ndarray         # (T,) int32 chain-block id (stage-2 tiles)
    tile_first: np.ndarray      # (T,) int32 1 = first clause tile of block
    tile_last: np.ndarray       # (T,) int32 1 = last clause tile of block
    counts: np.ndarray          # (n_cblocks,) int32 clause tiles per block
    indptr: np.ndarray          # (n_cblocks + 1,) int32 CSR row pointers
    _dev: dict = dataclasses.field(default_factory=dict, init=False,
                                   repr=False, compare=False)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_stage.shape[0])

    @property
    def n_term_tiles(self) -> int:
        return int((self.tile_stage == 0).sum())

    @property
    def n_cblocks(self) -> int:
        return int(self.counts.shape[0])

    @property
    def n_term_refs(self) -> int:
        """Total term references across all clause chains."""
        return int((self.clause_chain[: self.n_rows] != self.n_terms).sum())

    @property
    def realized_term_sharing(self) -> float:
        """1 - terms_evaluated / terms_pre_factorization."""
        dense = self.n_term_refs
        if dense == 0:
            return 0.0
        return 1.0 - self.n_terms / dense

    def tensors(self, device) -> dict:
        """Term, clause, tile and CSR tables as int32 tensors on ``device``."""
        key = str(device)
        if key not in self._dev:
            tiles = np.stack([self.tile_stage, self.tile_tb, self.tile_cb,
                              self.tile_jb, self.tile_first,
                              self.tile_last]).astype(np.int32).reshape(6, -1)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

            self._dev[key] = dict(term_chain=t(self.term_chain),
                                  clause_chain=t(self.clause_chain),
                                  tiles=t(tiles), indptr=t(self.indptr))
        return self._dev[key]


def pick_term_width(include_words: np.ndarray) -> int:
    """Auto bit-chain width for an artifact's term table: the smallest
    power of two covering the 95th-percentile popcount of its unique
    (word, value) terms, clipped to [2, 32]."""
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    act_c, act_w = np.nonzero(iw)
    if act_c.size == 0:
        return 2
    key = (act_w.astype(np.uint64) << np.uint64(32)) \
        | iw[act_c, act_w].astype(np.uint64)
    vals = (np.unique(key) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pcs = np.array([int(v).bit_count() for v in vals])
    p95 = int(np.percentile(pcs, 95))
    w = 2
    while w < min(max(p95, 2), 32):
        w *= 2
    return w


def build_factorized_schedule(
    include_words: np.ndarray,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
    block_t: int = DEFAULT_BLOCK_T,
    term_w: int | None = None,
) -> FactorizedSchedule:
    """Compile ``(U, Wa)`` packed include rows into a factorized schedule.

    Terms are ordered by (word, value); a term whose popcount exceeds
    ``term_w`` splits into deduped pieces of ``<= term_w`` bits, and the
    owning clauses chain every piece.  Identical, table for table, to the
    reference ``build_factorized_schedule`` without shard padding.
    """
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    U, Wa = iw.shape
    n_lit_bits = Wa * 32
    if term_w is None:
        term_w = pick_term_width(iw)

    act_c, act_w = np.nonzero(iw)
    vals = iw[act_c, act_w]
    key = (act_w.astype(np.uint64) << np.uint64(32)) | vals.astype(np.uint64)
    uniq_key, wterm_of_entry = np.unique(key, return_inverse=True)
    piece_id: dict = {}
    term_word_l: list = []
    term_val_l: list = []
    term_chain_l: list = []
    pieces_of_wterm: list = []
    for k in uniq_key:
        w = int(k >> np.uint64(32))
        v = int(k & np.uint64(0xFFFFFFFF))
        bits = [i for i in range(32) if v >> i & 1]
        ids = []
        for lo in range(0, len(bits), term_w):
            chunk = tuple(bits[lo:lo + term_w])
            pk = (w, chunk)
            if pk not in piece_id:
                piece_id[pk] = len(term_chain_l)
                term_word_l.append(w)
                term_val_l.append(sum(1 << b for b in chunk))
                term_chain_l.append([32 * w + b for b in chunk])
            ids.append(piece_id[pk])
        pieces_of_wterm.append(ids)
    n_terms = len(term_chain_l)
    term_word = np.asarray(term_word_l, np.int32).reshape(-1)
    term_val = np.asarray(term_val_l, np.uint32).reshape(-1)

    block_t = max(min(block_t, _rup(max(n_terms + 1, 1), 8)), 1)
    Tp = _rup(n_terms + 1, block_t)   # >= 1 all-ones padding term (sentinel)
    term_chain = np.full((Tp, term_w), n_lit_bits, np.int32)
    for t, lids in enumerate(term_chain_l):
        term_chain[t, : len(lids)] = lids

    chain_of_clause: list = [[] for _ in range(U)]
    for c, wt in zip(act_c, wterm_of_entry.reshape(-1)):
        chain_of_clause[c].extend(pieces_of_wterm[wt])
    block_c = max(min(block_c, _rup(max(U, 1), 8)), 1)
    Cp = _rup(max(U, 1), block_c)
    per_clause = np.zeros(Cp, np.int32)
    for c in range(U):
        per_clause[c] = len(chain_of_clause[c])

    n_cblocks = Cp // block_c
    counts = np.zeros(n_cblocks, np.int32)
    for b in range(n_cblocks):
        j_max = int(per_clause[b * block_c:(b + 1) * block_c].max())
        counts[b] = -(-j_max // block_j)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    n_term_tiles = Tp // block_t
    T_clause = int(counts.sum())
    T = n_term_tiles + T_clause
    n_jblocks = int(counts.max()) if T_clause else 0
    if n_jblocks == 0:
        n_jblocks = 1                     # one all-sentinel block
    Jp = n_jblocks * block_j

    clause_chain = np.full((Cp, Jp), n_terms, np.int32)
    for c in range(U):
        ids = chain_of_clause[c]
        clause_chain[c, : len(ids)] = sorted(ids)

    tile_stage = np.ones(T, np.int32)
    tile_tb = np.zeros(T, np.int32)
    tile_cb = np.zeros(T, np.int32)
    tile_jb = np.zeros(T, np.int32)
    tile_first = np.zeros(T, np.int32)
    tile_last = np.zeros(T, np.int32)
    # stage 1 first: every term is evaluated before any clause tile reads it
    for t in range(n_term_tiles):
        tile_stage[t] = 0
        tile_tb[t] = t
    t = n_term_tiles
    for b in range(n_cblocks):
        n = int(counts[b])
        for j in range(n):
            tile_cb[t], tile_jb[t] = b, j
            tile_first[t] = int(j == 0)
            tile_last[t] = int(j == n - 1)
            t += 1

    return FactorizedSchedule(
        block_c=block_c, block_j=block_j, block_t=block_t, term_w=term_w,
        n_rows=U, n_terms=n_terms, n_lit_bits=n_lit_bits,
        term_word=term_word, term_val=term_val,
        term_chain=term_chain, clause_chain=clause_chain,
        tile_stage=tile_stage, tile_tb=tile_tb, tile_cb=tile_cb,
        tile_jb=tile_jb, tile_first=tile_first, tile_last=tile_last,
        counts=counts, indptr=indptr,
    )


def _check_terms(lit_words, term_chain):
    if term_chain.dtype != torch.int32 or term_chain.dim() != 2:
        raise TypeError("term_chain must be a 2-D int32 tensor")
    if term_chain.device != lit_words.device or not term_chain.is_contiguous():
        raise ValueError("term_chain must be contiguous on lit_words' device")


def factorized_tables_plain(lit_words, term_chain, clause_chain, votes, tiles,
                            indptr, *, block_c, block_j, n_term_tiles,
                            tile_margin=None):
    """Plain PyTorch version of :func:`factorized_tables_cuda` (any device)."""
    _check_tables(lit_words, clause_chain, votes, tiles, indptr, tile_margin, 6)
    _check_terms(lit_words, term_chain)
    B, W = lit_words.shape
    lit_t = bit_transpose_literals(lit_words, W * 32)
    term_bits = and_reduce(lit_t[term_chain.long()])          # (Tp, Sw)
    sums = chain_fold_plain(term_bits, clause_chain, votes, tiles[3], tiles[5],
                            indptr, tile_off=n_term_tiles, block_c=block_c,
                            block_j=block_j, n_samples=B, tile_margin=tile_margin)
    return sums[:B]


def factorized_tables_cuda(lit_words, term_chain, clause_chain, votes, tiles,
                           indptr, *, block_c, block_j, n_term_tiles,
                           tile_margin=None):
    """Launch ``csrc/term_infer.cu`` (bit transpose, stage 1 into a term
    buffer allocated here, then stage 2) on CUDA tensors -> (B, K) int32."""
    global launches
    _check_tables(lit_words, clause_chain, votes, tiles, indptr, tile_margin, 6)
    _check_terms(lit_words, term_chain)
    if not lit_words.is_cuda:
        raise ValueError("factorized_tables_cuda takes CUDA tensors")
    B, W = lit_words.shape
    U, K = votes.shape
    Tp, term_w = term_chain.shape
    Sw = packetizer.n_words(B)
    dev = lit_words.device
    # scratch: the kernel's bit-transposed literals and stage-1 term table
    lit_t = torch.empty((W * 32 + 1, Sw), dtype=torch.int32, device=dev)
    term_bits = torch.empty((Tp, Sw), dtype=torch.int32, device=dev)
    out = torch.zeros((Sw * 32, K), dtype=torch.int32, device=dev)
    jb, last = tiles[3].contiguous(), tiles[5].contiguous()
    P, I = _build.P, _build.I
    fn = _build.entry("term_infer", "term_infer_launch",
                      [P, I, I, P, I, P, I, I, P, P, I, P, I, I, P, I, P, P, I,
                       P, I, I, P, P])
    err = fn(_build.ptr(lit_words), B, W, _build.ptr(lit_t), Sw,
             _build.ptr(term_chain), Tp, term_w, _build.ptr(term_bits),
             _build.ptr(clause_chain), clause_chain.shape[1], _build.ptr(votes),
             U, K, _build.ptr(indptr), indptr.shape[0] - 1, _build.ptr(jb),
             _build.ptr(last), n_term_tiles,
             None if tile_margin is None else _build.ptr(tile_margin),
             block_c, block_j, _build.ptr(out), _build.stream_ptr(dev))
    _build.check("term_infer", err)
    launches += 1
    return out[:B]


def factorized_tm_forward_tables(lit_words, term_chain, clause_chain, votes,
                                 tiles, indptr, *, block_c, block_j,
                                 n_term_tiles, tile_margin=None):
    """Packed literals (B, W) int32 -> (B, K) int32 class sums over the
    factorized tables: ``tiles`` is (6, T) (stage, tb, cb, jb, first,
    last), ``indptr`` the CSR clause-tile pointers, and the clause tiles
    start at ``n_term_tiles``.  The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = factorized_tables_cuda if lit_words.is_cuda else factorized_tables_plain
    return fn(lit_words, term_chain, clause_chain, votes, tiles, indptr,
              block_c=block_c, block_j=block_j, n_term_tiles=n_term_tiles,
              tile_margin=tile_margin)


def factorized_tm_forward(lit_words: torch.Tensor, votes: torch.Tensor,
                          schedule: FactorizedSchedule, *,
                          tile_margin=None) -> torch.Tensor:
    """Packed literals -> (B, K) int32 class sums via the factorized
    schedule; with ``tile_margin`` argmax-identical (exact early exit)."""
    B, W = lit_words.shape
    K = votes.shape[1]
    if schedule.n_lit_bits != W * 32:
        raise ValueError(f"schedule covers {schedule.n_lit_bits} literal bits, "
                         f"lit_words has {W} words")
    if schedule.n_tiles == 0:     # degenerate all-empty schedule: nothing votes
        return torch.zeros((B, K), dtype=torch.int32, device=lit_words.device)
    tabs = schedule.tensors(lit_words.device)
    return factorized_tm_forward_tables(
        lit_words.contiguous(), tabs["term_chain"], tabs["clause_chain"], votes,
        tabs["tiles"], tabs["indptr"], block_c=schedule.block_c,
        block_j=schedule.block_j, n_term_tiles=schedule.n_term_tiles,
        tile_margin=tile_margin)


def factorized_class_sums_ref(lit_words, term_chain, clause_chain, votes):
    """Oracle over the factorized tables: terms fire iff every chain
    literal is 1, clauses fire iff every chained term fires."""
    B, W = lit_words.shape
    bits = packetizer.unpack_bits(lit_words, W * 32)          # (B, L)
    padded = torch.cat([bits, torch.ones((B, 1), dtype=bits.dtype,
                                         device=bits.device)], dim=1)
    tg = padded[:, term_chain.reshape(-1).long()]
    term_bits = torch.all(tg.reshape(B, *term_chain.shape) != 0, dim=2)
    cg = term_bits[:, clause_chain.reshape(-1).long()]
    fired = torch.all(cg.reshape(B, *clause_chain.shape), dim=2)
    return class_sum_ref(fired, votes)
