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
(``csrc/term_infer.cu``) for CUDA tensors and
:func:`factorized_tables_plain` for CPU tensors.  On the card a call takes
one of two designs, by :func:`slab_words_for` from what it can observe
(the batch, the tables' shapes, the card's SMs and shared memory): at
large batches in exact mode ONE launch, a CTA a slab of sample words with
its literal rows and term table in shared memory; else bit transpose,
stage 1 and the stage-2 walk of ``csrc/chain_walk.cuh`` as three launches
on one stream (a fourth that folds in order with early exit).  Padding
terms (rows past ``n_terms``) have all-sentinel chains and evaluate to all
ones, so sentinel-padded clause chains are exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import packetizer
from repro_torch.kernels import _build
from repro_torch.kernels.ref import class_sum_ref
from repro_torch.kernels.sparse_infer import (_check_tables, _rup, and_reduce,
                                              artifact_tag, bit_transpose_literals,
                                              chain_fold_plain, chain_lengths,
                                              slab_words)

# default factorized tiling (the reference's, so shipped schedules are
# memoized under the same key); small artifacts clip
DEFAULT_BLOCK_C = 1024
DEFAULT_BLOCK_J = 64
DEFAULT_BLOCK_T = 32768

# what the occupancy entry point writes after the common fields: the
# stage-2 exact walk's grid and the threads that walk one clause's chain
# for one word
GRID_FIELDS = ("grid_x", "grid_y", "chain_threads")

# calls that launched the kernel (either design) on CUDA tensors
launches = 0

# host spans (``repro_torch/spans.py``): what precedes a launch (the device
# tables, the checks, the scratch buffers, the entry point and the ctypes
# arguments), the launch call itself and, inside it, the slab design's
PREP_RANGE = "term_infer.prep"
LAUNCH_RANGE = "term_infer.launch"
SLAB_RANGE = "term_infer.slab"

# the slab design: sample words a CTA, largest first, and the slabs an SM
# the batch must give at that size (its ceil(B / 32) sample words over S).
# A CTA's time grows slower than S (on an H100 a wave of CTAs took 14, 17
# and 26 us at S 1, 2 and 4 on tm-mnist), so half a wave of large slabs
# beats a wave of small ones; the three launches stay faster at 16 sample
# words and slower from 64 on (PERF.md, the crossover sweep)
SLAB_SIZES = (8, 4, 2, 1)
SLAB_MIN_SLABS_PER_SM = 0.5


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
            with spans.span(spans.BUILD_RANGE):
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
    pad_tiles_to: int | None = None,
) -> FactorizedSchedule:
    """Compile ``(U, Wa)`` packed include rows into a factorized schedule.

    Terms are ordered by (word, value); a term whose popcount exceeds
    ``term_w`` splits into deduped pieces of ``<= term_w`` bits, and the
    owning clauses chain every piece.  ``pad_tiles_to`` appends no-op
    clause tiles so shards of one artifact can share a common tile-table
    shape.  Identical, table for table, to the reference
    ``build_factorized_schedule``.
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
    T_real = n_term_tiles + T_clause
    T = max(T_real, pad_tiles_to or 0)
    n_jblocks = int(counts.max()) if T_clause else 0
    pad_jblock = n_jblocks if T > T_real or n_jblocks == 0 else None
    if pad_jblock is not None:
        n_jblocks += 1                    # an all-sentinel block (no-op tiles)
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
    # no-op padding tiles: the all-sentinel clause chain block, never first/last
    tile_jb[t:] = pad_jblock if pad_jblock is not None else 0

    return FactorizedSchedule(
        block_c=block_c, block_j=block_j, block_t=block_t, term_w=term_w,
        n_rows=U, n_terms=n_terms, n_lit_bits=n_lit_bits,
        term_word=term_word, term_val=term_val,
        term_chain=term_chain, clause_chain=clause_chain,
        tile_stage=tile_stage, tile_tb=tile_tb, tile_cb=tile_cb,
        tile_jb=tile_jb, tile_first=tile_first, tile_last=tile_last,
        counts=counts, indptr=indptr,
    )


# content-keyed memo of build_factorized_schedule_cached (see
# sparse_infer._SCHEDULE_CACHE)
_FSCHEDULE_CACHE: dict = {}


def build_factorized_schedule_cached(
    include_words: np.ndarray,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
    block_t: int = DEFAULT_BLOCK_T,
    term_w: int | None = None,
) -> FactorizedSchedule:
    """Content-memoized :func:`build_factorized_schedule` for callers
    without a ``CompiledTM`` to memoize on."""
    if term_w is None:
        term_w = pick_term_width(include_words)
    key = (artifact_tag(include_words), block_c, block_j, block_t, term_w)
    if key not in _FSCHEDULE_CACHE:
        _FSCHEDULE_CACHE[key] = build_factorized_schedule(
            np.asarray(include_words, dtype=np.uint32),
            block_c=block_c, block_j=block_j, block_t=block_t,
            term_w=term_w)
    return _FSCHEDULE_CACHE[key]


def stack_shard_factorized(
    include_words: np.ndarray,      # (U, Wa) — compile_tm row order
    votes: np.ndarray,              # (U, K)
    n_shards: int,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
    block_t: int = DEFAULT_BLOCK_T,
    term_w: int | None = None,
):
    """Clause-shard a factorized schedule: each shard carries its OWN term
    table (terms extracted from its own rows) and tile table, padded to
    common shapes so the stacks split over ``model``.  ``term_w`` defaults
    to the FULL artifact's :func:`pick_term_width`; ``block_t`` is the
    smallest any shard clips it to, and every shard is built at it.

    Returns ``(schedules, term_stack, chain_stack, votes_stack, tile_stack,
    C_loc)``, the reference's arrays: the ``(n_shards, Tp, term_w)`` term
    stack (padding rows all sentinel: they evaluate to all ones), the
    ``(n_shards, Cp, Jp)`` clause-chain stack (each shard's own sentinel,
    its ``n_terms``, everywhere past its chains), the vote stack and the
    ``(n_shards, 6, T)`` tile table.  No-op padding tiles follow each
    shard's real ones; ``sparse_infer.tile_indptr`` leaves them out.
    """
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    U, Wa = iw.shape
    K = votes.shape[1]
    if term_w is None:
        term_w = pick_term_width(iw)
    C_loc = _rup(-(-max(U, 1) // n_shards), 8)
    Up = C_loc * n_shards
    iw = np.pad(iw, ((0, Up - U), (0, 0)))
    vt = np.pad(np.asarray(votes, np.int32), ((0, Up - U), (0, 0)))

    def build_all(bt, pad=None):
        return [build_factorized_schedule(iw[s * C_loc:(s + 1) * C_loc],
                                          block_c=block_c, block_j=block_j,
                                          block_t=bt, term_w=term_w,
                                          pad_tiles_to=pad)
                for s in range(n_shards)]

    # one block_t serves every shard's term tiles: the smallest post-clip
    # value, then every shard is rebuilt at it
    block_t = min(s.block_t for s in build_all(block_t))
    schedules = build_all(block_t)
    T = max(max(s.n_tiles for s in schedules), 1)
    schedules = build_all(block_t, pad=T)
    Tp = max(s.term_chain.shape[0] for s in schedules)
    Jp = max(s.clause_chain.shape[1] for s in schedules)
    Cp = max(s.clause_chain.shape[0] for s in schedules)

    term_stack = np.full((n_shards, Tp, term_w), Wa * 32, np.int32)
    chain_stack = np.zeros((n_shards, Cp, Jp), np.int32)
    votes_stack = np.zeros((n_shards, Cp, K), np.int32)
    tile_stack = np.zeros((n_shards, 6, T), np.int32)
    for s, sched in enumerate(schedules):
        cp, jp = sched.clause_chain.shape
        term_stack[s, :sched.term_chain.shape[0]] = sched.term_chain
        chain_stack[s] = sched.n_terms   # the shard's own sentinel everywhere
        chain_stack[s, :cp, :jp] = sched.clause_chain
        votes_stack[s, :C_loc] = vt[s * C_loc:(s + 1) * C_loc]
        tile_stack[s] = np.stack([sched.tile_stage, sched.tile_tb, sched.tile_cb,
                                  sched.tile_jb, sched.tile_first, sched.tile_last])
    return schedules, term_stack, chain_stack, votes_stack, tile_stack, C_loc


def _check_terms(lit_words, term_chain):
    if term_chain.dtype != torch.int32 or term_chain.dim() != 2:
        raise TypeError("term_chain must be a 2-D int32 tensor")
    if term_chain.device != lit_words.device or not term_chain.is_contiguous():
        raise ValueError("term_chain must be contiguous on lit_words' device")


def factorized_tables_plain(lit_words, term_chain, clause_chain, votes, tiles,
                            indptr, *, block_c, block_j, n_term_tiles,
                            tile_margin=None, block_s=None):
    """Plain PyTorch version of :func:`factorized_tables_cuda` (any device);
    ``block_s`` is checked and has nothing to tile here."""
    _check_tables(lit_words, clause_chain, votes, tiles, indptr, tile_margin, 6)
    _check_terms(lit_words, term_chain)
    slab_words(block_s)
    B, W = lit_words.shape
    lit_t = bit_transpose_literals(lit_words, W * 32)
    term_bits = and_reduce(lit_t[term_chain.long()])          # (Tp, Sw)
    sums = chain_fold_plain(term_bits, clause_chain, votes, tiles[3], tiles[5],
                            indptr, tile_off=n_term_tiles, block_c=block_c,
                            block_j=block_j, n_samples=B, tile_margin=tile_margin)
    return sums[:B]


def slab_shared_words(S: int, W: int, Tp: int, K: int, U: int, n_cblocks: int,
                      n_planes: int) -> int:
    """4-byte words of shared memory the slab design needs at ``S`` sample
    words a CTA (``csrc/term_infer.cu:slab_layout``): the literal rows
    (32 W x S), the term rows (Tp x S, at least the slab's raw literal
    words, 32 rows of ``W | 1``), an int4 walk plan a clause block, the
    (32 S, K) class sums, the fired table (32 S rows of the ``U`` clauses'
    32-clause chunks, padded to 8, and one word more) and the votes' bit
    planes (``K n_planes`` rows, padded to 8, of those chunks)."""
    term_rows = max(Tp, 32 * (W | 1))
    ncp = _rup(-(-U // 32), 8)
    return (_rup(32 * W * S, 4) + _rup(term_rows * S, 4) + 4 * n_cblocks
            + _rup(32 * S * K, 4) + _rup(32 * S * (ncp + 1), 4) + _rup(K * n_planes, 8) * ncp)


def slab_words_for(B: int, W: int, Tp: int, K: int, U: int, n_cblocks: int, n_planes: int, *,
                   tile_margin, block_s, sm_count: int, shared_bytes: int) -> int:
    """The slab design's sample words a CTA for one call, or 0 for the three
    launches.  A pure function of what the call observes: ``B`` samples of
    ``W`` literal words, ``Tp`` term rows, ``K`` classes, ``U`` vote rows,
    ``n_cblocks`` clause blocks, the ``n_planes`` bit planes that hold the
    votes, the card's ``sm_count`` and the ``shared_bytes`` a block may opt
    in to.  Only in exact mode (no ``tile_margin``) with the kernel's own
    tiling (``block_s`` None): the largest S of :data:`SLAB_SIZES` whose
    tables fit and whose slabs give every SM :data:`SLAB_MIN_SLABS_PER_SM`
    of them; 0 where none does."""
    if tile_margin is not None or block_s is not None:
        return 0
    sw_total = packetizer.n_words(B)
    for S in SLAB_SIZES:
        if (4 * slab_shared_words(S, W, Tp, K, U, n_cblocks, n_planes) <= shared_bytes
                and sw_total >= SLAB_MIN_SLABS_PER_SM * S * sm_count):
            return S
    return 0


def vote_planes(votes: torch.Tensor) -> tuple:
    """The (U, K) votes as the slab design's fold reads them: ``(planes,
    n_planes)``, planes a (K, 32, ceil(U / 32)) int32 table whose word j of
    class kk's plane p has bit c set iff bit p of ``votes[32 j + c, kk]``
    is (two's complement; rows past U are 0), and n_planes the fewest
    planes that hold every vote (at least 1).  Derived on the votes'
    device once per votes tensor and version (``_build.derived``); reading
    n_planes is its one copy to the host."""
    return _build.derived("vote_planes", votes, _vote_planes)


def _vote_planes(votes: torch.Tensor) -> tuple:
    U, K = votes.shape
    n = -(-U // 32)
    v = torch.zeros((n * 32, K), dtype=torch.int64, device=votes.device)
    v[:U] = votes
    p = torch.arange(32, device=votes.device)
    bits = (v.view(n, 32, K, 1) >> p) & 1                     # (n, clause, K, plane)
    words = (bits << p.view(1, 32, 1, 1)).sum(1)              # (n, K, plane)
    planes = (words - (words >> 31 << 32)).to(torch.int32).permute(1, 2, 0).contiguous()
    mag = (v ^ (v >> 31)).max()
    return planes, int(1 + (mag >= (1 << p[:31])).sum())


# device index -> (SM count, opt-in shared bytes a block)
_LIMITS: dict = {}


def _limits(dev) -> tuple:
    """The card's SM count and the shared bytes a block may opt in to."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _LIMITS:
        props = torch.cuda.get_device_properties(idx)
        _LIMITS[idx] = (props.multi_processor_count, props.shared_memory_per_block_optin)
    return _LIMITS[idx]


def factorized_tables_cuda(lit_words, term_chain, clause_chain, votes, tiles,
                           indptr, *, block_c, block_j, n_term_tiles,
                           tile_margin=None, block_s=None):
    """Launch ``csrc/term_infer.cu`` on CUDA tensors -> (B, K) int32: the
    slab design where :func:`slab_words_for` picks it, else bit transpose,
    stage 1 into a term buffer allocated here, then the stage-2 walk at
    ``block_s`` sample words a block (``sparse_infer.slab_words``)."""
    with spans.span(PREP_RANGE):
        call = _launch_args(lit_words, term_chain, clause_chain, votes, tiles, indptr,
                            block_c=block_c, block_j=block_j, n_term_tiles=n_term_tiles,
                            tile_margin=tile_margin, block_s=block_s)
    return _launch(*call)


def _launch_args(lit_words, term_chain, clause_chain, votes, tiles, indptr, *,
                 block_c, block_j, n_term_tiles, tile_margin, block_s):
    """The checks, scratch buffers and entry point of one launch of
    :func:`factorized_tables_cuda` -> ``(fn, args, keep, out, slab)``: the
    ctypes entry, its arguments, the tensors they point into (held until
    the launch returns), the (B, K) view of the output it fills and whether
    it is the slab design."""
    _check_tables(lit_words, clause_chain, votes, tiles, indptr, tile_margin, 6)
    _check_terms(lit_words, term_chain)
    slab = slab_words(block_s)
    if not lit_words.is_cuda:
        raise ValueError("factorized_tables_cuda takes CUDA tensors")
    B, W = lit_words.shape
    U, K = votes.shape
    Tp, term_w = term_chain.shape
    Sw = packetizer.n_words(B)
    dev = lit_words.device
    n_cblocks = indptr.shape[0] - 1
    # the clause chains' sentinel is the first padding term, whose
    # literal chain is all sentinels (real terms hold at least one bit)
    lens = chain_lengths(clause_chain, lambda tc: (tc[:, 0] != W * 32).sum(),
                         term_chain)
    jb, last = tiles[3].contiguous(), tiles[5].contiguous()
    P, I = _build.P, _build.I
    sm_count, shared_bytes = _limits(dev)
    planes, n_planes = vote_planes(votes)
    S = slab_words_for(B, W, Tp, K, U, n_cblocks, n_planes, tile_margin=tile_margin,
                       block_s=block_s, sm_count=sm_count, shared_bytes=shared_bytes)
    if S:
        out = torch.empty((B, K), dtype=torch.int32, device=dev)
        fn = _build.entry("term_infer", "term_infer_slab_launch",
                          [P, I, I, P, I, I, P, P, I, P, I, I, I, P, I, P, P, I, I, I, I, I,
                           P, P])
        args = (_build.ptr(lit_words), B, W, _build.ptr(term_chain), Tp, term_w,
                _build.ptr(clause_chain), _build.ptr(lens), clause_chain.shape[1],
                _build.ptr(planes), n_planes, U, K, _build.ptr(indptr), n_cblocks,
                _build.ptr(jb), _build.ptr(last), n_term_tiles, block_c, block_j, S,
                shared_bytes, _build.ptr(out), _build.stream_ptr(dev))
        keep = (lit_words, term_chain, clause_chain, lens, planes, indptr, jb, last, out)
        return fn, args, keep, out, True
    # scratch: the kernel's bit-transposed literals, stage-1 term table
    # (rows of Sw words padded to a multiple of 4, for its 16-byte loads)
    # and, with early exit, the fired words the walk stores for the
    # in-order fold (the transpose launch zeroes `out` before the walk adds
    # into it)
    stride = _rup(Sw, 4)
    lit_t = torch.empty((W * 32 + 1, stride), dtype=torch.int32, device=dev)
    term_bits = torch.empty((Tp, stride), dtype=torch.int32, device=dev)
    out = torch.empty((Sw * 32, K), dtype=torch.int32, device=dev)
    fired = None if tile_margin is None else torch.empty((Sw, U), dtype=torch.int32, device=dev)
    fn = _build.entry("term_infer", "term_infer_launch",
                      [P, I, I, P, I, I, P, I, I, P, P, P, I, P, I, I, P, I, P, P,
                       I, P, I, I, I, P, P, P])
    args = (_build.ptr(lit_words), B, W, _build.ptr(lit_t), Sw, stride,
            _build.ptr(term_chain), Tp, term_w, _build.ptr(term_bits),
            _build.ptr(clause_chain), _build.ptr(lens), clause_chain.shape[1],
            _build.ptr(votes), U, K, _build.ptr(indptr), n_cblocks,
            _build.ptr(jb), _build.ptr(last), n_term_tiles,
            None if tile_margin is None else _build.ptr(tile_margin),
            block_c, block_j, slab, _build.ptr(out),
            None if fired is None else _build.ptr(fired), _build.stream_ptr(dev))
    keep = (lit_words, lit_t, term_chain, term_bits, clause_chain, lens, votes, indptr,
            jb, last, tile_margin, out, fired)
    return fn, args, keep, out[:B], False


def _launch(fn, args, keep, out, slab):
    """Call the entry point of :func:`_launch_args` while ``keep`` holds
    the tensors its pointers address, check its error code and count the
    launch -> ``out``."""
    global launches
    with spans.span(LAUNCH_RANGE):
        if slab:
            with spans.span(SLAB_RANGE):
                err = fn(*args)
        else:
            err = fn(*args)
        _build.check("term_infer", err)
    launches += 1
    return out


def occupancy(B: int, n_cblocks: int, block_c: int, K: int, block_s=None) -> dict:
    """The stage-2 exact walk's registers a thread, threads a block, resident blocks
    per SM, shared and spill bytes, grid and threads a chain at batch
    ``B`` over ``n_cblocks`` clause blocks of ``block_c``, ``K`` classes
    (``K`` decides whether the votes are staged in shared memory) and
    ``block_s`` sample words a block (None: the kernel's choice)."""
    return _build.occupancy("term_infer", B, n_cblocks, block_c, K,
                            slab_words(block_s), extra=GRID_FIELDS)


def factorized_tm_forward_tables(lit_words, term_chain, clause_chain, votes,
                                 tiles, indptr, *, block_c, block_j,
                                 n_term_tiles, tile_margin=None, block_s=None):
    """Packed literals (B, W) int32 -> (B, K) int32 class sums over the
    factorized tables: ``tiles`` is (6, T) (stage, tb, cb, jb, first,
    last), ``indptr`` the CSR clause-tile pointers, and the clause tiles
    start at ``n_term_tiles``.  The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = factorized_tables_cuda if lit_words.is_cuda else factorized_tables_plain
    return fn(lit_words, term_chain, clause_chain, votes, tiles, indptr,
              block_c=block_c, block_j=block_j, n_term_tiles=n_term_tiles,
              tile_margin=tile_margin, block_s=block_s)


def factorized_tm_forward(lit_words: torch.Tensor, votes: torch.Tensor,
                          schedule: FactorizedSchedule, *,
                          tile_margin=None, block_s=None) -> torch.Tensor:
    """Packed literals -> (B, K) int32 class sums via the factorized
    schedule, the stage-2 walk at ``block_s`` sample words a block; with
    ``tile_margin`` argmax-identical (exact early exit)."""
    with spans.span(PREP_RANGE):
        B, W = lit_words.shape
        K = votes.shape[1]
        if schedule.n_lit_bits != W * 32:
            raise ValueError(f"schedule covers {schedule.n_lit_bits} literal bits, "
                             f"lit_words has {W} words")
        slab_words(block_s)
        if schedule.n_tiles == 0:     # degenerate all-empty schedule: nothing votes
            return torch.zeros((B, K), dtype=torch.int32, device=lit_words.device)
        tabs = schedule.tensors(lit_words.device)
        args = (lit_words.contiguous(), tabs["term_chain"], tabs["clause_chain"], votes,
                tabs["tiles"], tabs["indptr"])
        kw = dict(block_c=schedule.block_c, block_j=schedule.block_j,
                  n_term_tiles=schedule.n_term_tiles, tile_margin=tile_margin,
                  block_s=block_s)
        call = _launch_args(*args, **kw) if lit_words.is_cuda else None
    if call is None:
        return factorized_tables_plain(*args, **kw)
    return _launch(*call)


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
