"""Block-sparse compiled TM inference over a chain schedule.

A trained clause includes a tiny fraction of its literals (MATADOR paper
§II), so its AND chain needs only the included bits.  ``core/compiler.py``
emits a **chain schedule**: unique clauses clustered by chain structure,
each clause's include bits compacted into a list of literal ids padded
with a sentinel id (the all-ones literal row, an AND identity), and the
chains tiled into ``(block_c, block_j)`` tiles with a CSR table of tiles
per clause block.

The datapath is bit-parallel over SAMPLES: literals are bit-transposed so
row ``l`` of ``litT`` packs literal ``l`` of 32 consecutive datapoints into
one word, and one chain step is ``ok &= litT[chain_id]``.  Work scales with
the artifact's include bits, not with ``C x W``.  When a clause block's
walk ends on its last tile, the fired bits fold into int32 class sums
through the deduped multiplicity x polarity vote matrix.

A schedule runs placed: :func:`place` puts its tables on a device as a
:class:`PlacedSchedule`, checked once, and :func:`sparse_tm_forward` runs
the CUDA kernel (``csrc/sparse_infer.cu``) over it for CUDA literals and a
plain PyTorch version for CPU ones.  With a margin table in the placement
it runs exact early exit: a 32-sample slab stops once every sample's lead
strictly beats the residual vote swing (``kernels/anytime.py``), so the
argmax is the full walk's while the sums may be cut short.

Correctness contract: all-zero include rows FIRE (vacuous AND), so their
vote rows must be zero — true for every ``compile_tm`` artifact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import packetizer
from repro_torch.kernels import _build
from repro_torch.kernels.ref import class_sum_ref

# default chain tiling: 512-clause banks, 32-bit chain tiles (the same
# defaults as the reference, so shipped schedules are memoized under them)
DEFAULT_BLOCK_C = 512
DEFAULT_BLOCK_J = 32

# Sentinel for the early-exit lead: far below any real class sum while
# keeping top1 - second inside int32.
_NEG_SUM = -(2 ** 28)

# what the occupancy entry point writes after the common fields: the exact
# walk's grid and the threads that walk one clause's chain for one word
GRID_FIELDS = ("grid_x", "grid_y", "chain_threads")

# kernel launches through sparse_tm_forward on CUDA tensors
launches = 0

# sample words (32 samples each) a CUDA block of the walk takes: the
# reference's block_s, a power of two up to 8 (csrc/chain_walk.cuh); None
# lets the kernel take the smallest that covers the bucket, capped at 8
WALK_WORDS = (1, 2, 4, 8)


def _rup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class SparseSchedule:
    """Compiled block-sparse execution schedule for one clause bank.

    ``chain_ids[c, j]`` is the literal BIT id of clause ``c``'s ``j``-th
    chain step (literal ``32*w + i`` = bit ``i`` of word ``w``); entries past
    the clause's include count hold the sentinel ``n_lit_bits``, whose
    transposed literal row is all ones.  ``counts``/``indptr`` are the CSR
    view over chain tiles per clause block; ``tile_*`` is the flat tile
    table, clause blocks in order.
    """

    block_c: int
    block_j: int
    n_rows: int                 # unique clauses covered (pre-padding)
    n_lit_bits: int             # sentinel id == index of the all-ones row
    chain_ids: np.ndarray       # (Cp, Jp) int32
    tile_cb: np.ndarray         # (T,) int32 clause-block id per tile
    tile_jb: np.ndarray         # (T,) int32 chain-block id per tile
    tile_first: np.ndarray      # (T,) int32 1 = first tile of its block
    tile_last: np.ndarray       # (T,) int32 1 = last tile of its block
    counts: np.ndarray          # (n_cblocks,) int32 tiles per clause block
    indptr: np.ndarray          # (n_cblocks + 1,) int32 CSR row pointers

    @property
    def n_tiles(self) -> int:
        return int(self.tile_cb.shape[0])

    @property
    def n_cblocks(self) -> int:
        return int(self.counts.shape[0])


def cluster_order(include_words: np.ndarray) -> np.ndarray:
    """Clause permutation that clusters rows by chain structure.

    Primary key: include-bit count (chain length), so clause blocks are
    chain-length homogeneous.  Secondary: active-word signature then word
    values, lexicographic — clauses sharing sub-chains become neighbours.
    """
    iw = np.ascontiguousarray(include_words)
    U, Wa = iw.shape
    if U <= 1:
        return np.arange(U)
    act = iw != 0
    nbits = packetizer.unpack_bits_np(iw, Wa * 32).sum(axis=1)
    # np.lexsort: LAST key is primary
    keys = [iw[:, j] for j in range(Wa - 1, -1, -1)]
    keys += [act[:, j].astype(np.uint8) for j in range(Wa - 1, -1, -1)]
    keys.append(nbits)
    return np.lexsort(keys)


def artifact_tag(include_words) -> str:
    """Content hash of an artifact's include rows: the identity of a
    compiled bank for schedule memoization (two same-shape artifacts with
    different sparsity must never share)."""
    import hashlib

    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    h = hashlib.sha1(iw.tobytes())
    h.update(str(iw.shape).encode())
    return h.hexdigest()


# content-keyed memo of build_schedule_cached: repeated builds for the same
# include rows and tiling return the SAME object
_SCHEDULE_CACHE: dict = {}


def build_schedule_cached(
    include_words: np.ndarray,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
) -> SparseSchedule:
    """Content-memoized :func:`build_schedule` for callers without a
    ``CompiledTM`` to memoize on (e.g. raw include rows in a serving loop)."""
    key = (artifact_tag(include_words), block_c, block_j)
    if key not in _SCHEDULE_CACHE:
        _SCHEDULE_CACHE[key] = build_schedule(
            np.asarray(include_words, dtype=np.uint32),
            block_c=block_c, block_j=block_j)
    return _SCHEDULE_CACHE[key]


def _layout(iw: np.ndarray, block_c: int, block_j: int, pad_tiles_to=None):
    """What a chain schedule of ``iw`` holds besides its chains: the
    effective ``block_c``, the padded include bits, the tile counts and
    CSR pointers, the chain width and the flat tile table, padded with
    no-op tiles to ``pad_tiles_to``."""
    U, Wa = iw.shape
    n_lit_bits = Wa * 32
    block_c = max(min(block_c, _rup(max(U, 1), 8)), 1)
    Cp = _rup(max(U, 1), block_c)
    bits = np.zeros((Cp, n_lit_bits), np.uint8)
    if U:
        bits[:U] = packetizer.unpack_bits_np(iw, n_lit_bits)

    n_cblocks = Cp // block_c
    counts = np.zeros(n_cblocks, np.int32)
    per_clause = bits.sum(axis=1)
    for b in range(n_cblocks):
        j_max = int(per_clause[b * block_c:(b + 1) * block_c].max())
        counts[b] = -(-j_max // block_j)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    T_real = int(counts.sum())
    T = max(T_real, pad_tiles_to or 0)
    n_jblocks = int(counts.max()) if T_real else 0
    pad_jblock = n_jblocks if T > T_real or n_jblocks == 0 else None
    if pad_jblock is not None:
        n_jblocks += 1                    # an all-sentinel block (no-op tiles)
    Jp = n_jblocks * block_j

    tiles = np.zeros((4, T), np.int32)    # clause block, chain block, first, last
    t = 0
    for b in range(n_cblocks):
        n = int(counts[b])
        for j in range(n):
            tiles[:, t] = (b, j, int(j == 0), int(j == n - 1))
            t += 1
    # no-op padding tiles: the all-sentinel chain block, never first/last
    tiles[1, t:] = pad_jblock if pad_jblock is not None else 0
    return block_c, bits, counts, indptr, Jp, tiles


def _schedule(block_c, block_j, U, bits, counts, indptr, chain_ids, tiles):
    return SparseSchedule(
        block_c=block_c, block_j=block_j, n_rows=U, n_lit_bits=bits.shape[1],
        chain_ids=chain_ids, tile_cb=tiles[0], tile_jb=tiles[1],
        tile_first=tiles[2], tile_last=tiles[3],
        counts=counts, indptr=indptr,
    )


def build_schedule(
    include_words: np.ndarray,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
    pad_tiles_to: int | None = None,
) -> SparseSchedule:
    """Compile ``(U, Wa)`` packed include rows into a chain schedule.

    Rows are taken in the given order (``compile_tm`` has already applied
    :func:`cluster_order`).  ``pad_tiles_to`` appends no-op tiles so shards
    of one artifact can share a common tile-table shape.  Identical, table
    for table, to the reference ``build_schedule``.
    """
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    block_c, bits, counts, indptr, Jp, tiles = _layout(iw, block_c, block_j,
                                                       pad_tiles_to)
    chain_ids = np.full((bits.shape[0], Jp), bits.shape[1], np.int32)
    for c in range(bits.shape[0]):
        (lids,) = np.nonzero(bits[c])
        chain_ids[c, : lids.shape[0]] = lids
    return _schedule(block_c, block_j, iw.shape[0], bits, counts, indptr,
                     chain_ids, tiles)


def build_schedule_incremental(
    include_words: np.ndarray,
    prev: SparseSchedule,
    prev_include_words: np.ndarray,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
) -> tuple[SparseSchedule, dict]:
    """Rebuild a chain schedule, reusing ``prev``'s chain rows where the
    include bits did not move.

    The expensive part of :func:`build_schedule` is the per-clause
    ``nonzero`` loop that compacts include bits into literal-id chains;
    online drift touches a small fraction of clauses, so rows whose packed
    include words equal ``prev_include_words`` copy their chain out of
    ``prev.chain_ids`` (the literal space and tiling are checked first, so
    the sentinel padding agrees).  The tile table and CSR counts are always
    rebuilt: they are cheap and depend on the longest chain.

    Returns ``(schedule, info)`` with ``rows_reused`` / ``rows_rebuilt`` /
    ``tiles_reused`` (tiles of clause blocks with no changed row).  The
    result equals a from-scratch :func:`build_schedule`; a different row
    count, word count or effective tiling falls back to the full build
    with zero reuse.
    """
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    piw = np.ascontiguousarray(np.asarray(prev_include_words, dtype=np.uint32))
    U, Wa = iw.shape
    eff_block_c = max(min(block_c, _rup(max(U, 1), 8)), 1)
    if (piw.shape != iw.shape
            or prev.block_c != eff_block_c or prev.block_j != block_j
            or prev.n_rows != U or prev.n_lit_bits != Wa * 32):
        full = build_schedule(iw, block_c=block_c, block_j=block_j)
        return full, dict(rows_reused=0, rows_rebuilt=U, tiles_reused=0)

    block_c, bits, counts, indptr, Jp, tiles = _layout(iw, block_c, block_j)
    Cp = bits.shape[0]
    row_same = np.zeros(Cp, bool)
    row_same[:U] = (iw == piw).all(axis=1)
    row_same[U:] = True                  # padding rows are sentinel in both

    chain_ids = np.full((Cp, Jp), bits.shape[1], np.int32)
    copy_w = min(Jp, prev.chain_ids.shape[1])
    # a reused row's chain fits the new width: its include count bounds the
    # new longest chain, and entries past a chain are sentinel either way
    chain_ids[row_same, :copy_w] = prev.chain_ids[row_same, :copy_w]
    for c in np.nonzero(~row_same)[0]:
        (lids,) = np.nonzero(bits[c])
        chain_ids[c, :lids.shape[0]] = lids

    block_clean = row_same.reshape(-1, block_c).all(axis=1)
    sched = _schedule(block_c, block_j, U, bits, counts, indptr, chain_ids, tiles)
    info = dict(
        rows_reused=int(row_same[:U].sum()),
        rows_rebuilt=int(U - row_same[:U].sum()),
        tiles_reused=int(counts[block_clean].sum()),
    )
    return sched, info


def stack_shard_schedules(
    include_words: np.ndarray,      # (U, Wa) — compile_tm row order
    votes: np.ndarray,              # (U, K)
    n_shards: int,
    *,
    block_c: int = DEFAULT_BLOCK_C,
    block_j: int = DEFAULT_BLOCK_J,
):
    """Clause-shard a compiled schedule: each shard carries its own tile
    table, padded to common shapes so the stacks split over ``model``.

    Returns ``(schedules, chain_stack, votes_stack, tile_stack, C_loc)``:
    per-shard :class:`SparseSchedule` objects, the ``(n_shards, Cp, Jp)``
    chain-id stack, the matching vote stack and the ``(n_shards, 4, T)``
    tile table (cb, jb, first, last), the reference's arrays.  Shards with
    fewer real tiles carry no-op padding tiles after them, which the walk
    never reaches: :func:`tile_indptr` gives each shard's CSR pointers over
    its real tiles.
    """
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    U, Wa = iw.shape
    K = votes.shape[1]
    C_loc = _rup(-(-max(U, 1) // n_shards), 8)
    Up = C_loc * n_shards
    iw = np.pad(iw, ((0, Up - U), (0, 0)))
    vt = np.pad(np.asarray(votes, np.int32), ((0, Up - U), (0, 0)))

    def build_all(pad=None):
        return [build_schedule(iw[s * C_loc:(s + 1) * C_loc], block_c=block_c,
                               block_j=block_j, pad_tiles_to=pad)
                for s in range(n_shards)]

    schedules = build_all()
    T = max(max(s.n_tiles for s in schedules), 1)
    Jp = max(max(s.chain_ids.shape[1] for s in schedules), block_j)
    schedules = build_all(T)
    Jp = max(max(s.chain_ids.shape[1] for s in schedules), Jp)
    Cp = max(s.chain_ids.shape[0] for s in schedules)

    chain_stack = np.full((n_shards, Cp, Jp), Wa * 32, np.int32)
    votes_stack = np.zeros((n_shards, Cp, K), np.int32)
    tile_stack = np.zeros((n_shards, 4, T), np.int32)
    for s, sched in enumerate(schedules):
        cp, jp = sched.chain_ids.shape
        chain_stack[s, :cp, :jp] = sched.chain_ids
        votes_stack[s, :C_loc] = vt[s * C_loc:(s + 1) * C_loc]
        tile_stack[s] = np.stack([sched.tile_cb, sched.tile_jb,
                                  sched.tile_first, sched.tile_last])
    return schedules, chain_stack, votes_stack, tile_stack, C_loc


def tile_indptr(tile_cb: np.ndarray, tile_last: np.ndarray, n_cblocks: int,
                tile_off: int = 0) -> np.ndarray:
    """(n_cblocks + 1,) int32 CSR pointers of a (possibly padded) tile
    table, relative to ``tile_off``: the real tiles end at the last tile
    flagged last, and the no-op padding after them is left out, so the
    walk folds nothing from it.  Raises ``ValueError`` on a table whose
    real tiles are not in clause-block order."""
    cb = np.asarray(tile_cb)[tile_off:]
    (ends,) = np.nonzero(np.asarray(tile_last)[tile_off:])
    cb = cb[:int(ends[-1]) + 1 if ends.size else 0]
    if cb.size and (cb.min() < 0 or cb.max() >= n_cblocks or (np.diff(cb) < 0).any()):
        raise ValueError(f"tile table's clause blocks {np.unique(cb).tolist()} "
                         f"are not in order over {n_cblocks} blocks")
    counts = np.bincount(cb, minlength=n_cblocks)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def bit_transpose_literals(lit_words: torch.Tensor, n_lit_bits: int) -> torch.Tensor:
    """(B, W) packed literal words -> (n_lit_bits + 1, ceil(B/32)) int32.

    Row ``l`` packs literal ``l`` of 32 consecutive samples per word
    (LSB-first); the appended final row is all ones — the chain sentinel's
    AND identity.  Padding samples beyond ``B`` read as literal 0.  The
    plain versions run this; the CUDA wrappers transpose inside the kernel
    launch (``csrc/chain_walk.cuh``).
    """
    bits = packetizer.unpack_bits(lit_words, n_lit_bits)      # (B, L)
    lit_t = packetizer.pack_bits(bits.T)                      # (L, Sw)
    ones = torch.full((1, lit_t.shape[1]), -1, dtype=torch.int32,
                      device=lit_words.device)
    return torch.cat([lit_t, ones], dim=0).contiguous()


def and_reduce(g: torch.Tensor) -> torch.Tensor:
    """Tree-AND of (N, n, S) int32 rows over axis 1 -> (N, S); all ones
    for n == 0 (the empty AND)."""
    if g.shape[1] == 0:
        return torch.full((g.shape[0], g.shape[2]), -1, dtype=torch.int32,
                          device=g.device)
    while g.shape[1] > 1:
        if g.shape[1] % 2:
            g = torch.cat([g, torch.full_like(g[:, :1], -1)], dim=1)
        g = g[:, 0::2] & g[:, 1::2]
    return g[:, 0]


def lead_margin(sums: torch.Tensor) -> torch.Tensor:
    """(R, K) class sums -> (R,) int64 top1 - top2; 0 on a tie."""
    s = sums.to(torch.int64)
    top1 = s.max(dim=1).values.clamp(min=_NEG_SUM)
    is_top = s == top1[:, None]
    second = torch.where(is_top, _NEG_SUM, s).max(dim=1).values.clamp(min=_NEG_SUM)
    tied = is_top.sum(dim=1) > 1
    return torch.where(tied, 0, top1 - second)


def chain_fold_plain(rows, chain_ids, votes, tile_jb, tile_last, indptr, *,
                     tile_off, block_c, block_j, n_samples, tile_margin=None):
    """Plain version of the chain walk and vote fold (``csrc/chain_walk.cuh``).

    ``rows`` is the (R, Sw) int32 sample-parallel bit table the chain ids
    index.  Returns the (Sw * 32, K) int32 class sums of every sample slot.
    With ``tile_margin`` each 32-sample slab stops folding once certified,
    exactly where the kernel's early-exit walk stops.
    """
    dev = rows.device
    Sw = rows.shape[1]
    U, K = votes.shape
    jb, last, ip = tile_jb.tolist(), tile_last.tolist(), indptr.tolist()
    margin = None if tile_margin is None else tile_margin.tolist()
    sums = torch.zeros((Sw * 32, K), dtype=torch.int32, device=dev)
    real = torch.arange(Sw * 32, device=dev) < n_samples
    done = torch.zeros(Sw, dtype=torch.bool, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    for cb in range(len(ip) - 1):
        t0, t1 = tile_off + ip[cb], tile_off + ip[cb + 1]
        if t1 <= t0 or last[t1 - 1] != 1:
            continue                      # no tiles, or cut before its fold
        lo, hi = cb * block_c, min((cb + 1) * block_c, U)
        if hi > lo:
            cols = torch.cat([torch.arange(j * block_j, (j + 1) * block_j, device=dev)
                              for j in jb[t0:t1]])
            ids = chain_ids[lo:hi].index_select(1, cols).long()
            ok = and_reduce(rows[ids])                        # (hi-lo, Sw)
            fired = ((ok[:, :, None] >> shifts) & 1).reshape(hi - lo, Sw * 32)
            fold = class_sum_ref(fired.T, votes[lo:hi])
            if margin is not None:
                fold = fold * (~done).repeat_interleave(32)[:, None]
            sums += fold
        if margin is not None:
            lead = torch.where(real, lead_margin(sums), -_NEG_SUM)
            done |= (lead > margin[t1 - 1]).view(Sw, 32).all(dim=1)
    return sums


def chain_lengths(chain: torch.Tensor, sentinel) -> torch.Tensor:
    """(rows,) int32: how many ids each row of ``chain`` holds that are not
    ``sentinel`` (an id, or a 0-dim tensor on the chain's device), which is
    the length of that clause's own chain: :func:`build_schedule` and
    ``term_infer.build_factorized_schedule`` put a row's real ids first and
    the sentinel after them (``tests/test_torch_compiler.py`` holds them to
    it)."""
    return (chain != sentinel).sum(1, dtype=torch.int32)


def walk_words(block_s) -> int:
    """The sample words a block of the walk takes for ``block_s`` (0: the
    kernel's choice, for None).  Any value but 1, 2, 4 or 8 raises
    ``ValueError``: the walk's grid and the fold's staging assume one of
    them, and a value is never clamped to one."""
    if block_s is None:
        return 0
    if int(block_s) not in WALK_WORDS:
        raise ValueError(f"block_s={block_s}: the chain walk takes {WALK_WORDS} "
                         "sample words a block")
    return int(block_s)


def covering_walk_words(B: int) -> int:
    """The sample words the walk takes at batch ``B`` when ``block_s`` is None:
    the smallest power of two that covers the bucket's ceil(B / 32) sample
    words, capped at 8 (``csrc/chain_walk.cuh:slab_words``)."""
    sw_total, sw = -(-B // 32), 1
    while sw < sw_total and sw < WALK_WORDS[-1]:
        sw *= 2
    return sw


def _check_tables(chain_ids, votes, tiles, indptr, tile_margin, n_tile_rows,
                  term_chain=None):
    """Raise unless the tables of a placement are contiguous int32 tensors on
    ``votes``' device, the chains and votes 2-D, ``tiles`` ``n_tile_rows``
    rows, the votes no more rows than the chains and ``tile_margin`` (or
    None) one entry a tile."""
    tensors = dict(chain_ids=chain_ids, votes=votes, tiles=tiles, indptr=indptr,
                   tile_margin=tile_margin, term_chain=term_chain)
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != votes.device:
            raise ValueError(f"{name} is on {t.device}, votes on {votes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(t is not None and t.dim() != 2 for t in (chain_ids, votes, term_chain)):
        raise ValueError("the chains and votes must be 2-D")
    if tiles.dim() != 2 or tiles.shape[0] != n_tile_rows:
        raise ValueError(f"tiles must be ({n_tile_rows}, T), got {tuple(tiles.shape)}")
    if votes.shape[0] > chain_ids.shape[0]:
        raise ValueError(f"{votes.shape[0]} vote rows but only "
                         f"{chain_ids.shape[0]} chain rows")
    if tile_margin is not None and tile_margin.shape != (tiles.shape[1],):
        raise ValueError(f"tile_margin shape {tuple(tile_margin.shape)} != "
                         f"({tiles.shape[1]},)")


def _check_literals(lit_words, placed, block_s) -> int:
    """What a schedule forward checks of each call: ``lit_words`` a
    contiguous (B, W) int32 tensor on the placement's device whose W words
    are its ``n_lit_bits``, and ``block_s`` (:func:`walk_words`, returned)."""
    if lit_words.dtype != torch.int32:
        raise TypeError(f"lit_words must be int32, got {lit_words.dtype}")
    if lit_words.dim() != 2 or not lit_words.is_contiguous():
        raise ValueError("lit_words must be a contiguous 2-D tensor")
    if lit_words.device != placed.votes.device:
        raise ValueError(f"lit_words is on {lit_words.device}, the schedule on "
                         f"{placed.votes.device}")
    if lit_words.shape[1] * 32 != placed.n_lit_bits:
        raise ValueError(f"schedule covers {placed.n_lit_bits} literal bits, "
                         f"lit_words has {lit_words.shape[1]} words")
    return walk_words(block_s)


def _upload(device, *arrays):
    """Host tables as contiguous int32 tensors on ``device`` (None stays None)."""
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in arrays]


@dataclasses.dataclass(frozen=True, eq=False)
class PlacedSchedule:
    """A chain schedule on one device, as a launch of the walk reads it:
    made and checked once by :func:`place_tables`, so that a call checks
    only its literal words.  ``jb`` and ``last`` are the tile table's two
    rows the walk reads, ``lens`` each chain row's length (the walk stops at
    a clause's own end) and ``tile_margin`` the early-exit margin table, or
    None for the exact walk."""

    chain_ids: torch.Tensor     # (Cp, Jp) int32 literal bit ids
    votes: torch.Tensor         # (U, K) int32
    indptr: torch.Tensor        # (n_cblocks + 1,) int32 CSR tile pointers
    jb: torch.Tensor            # (T,) int32 chain-block id per tile
    last: torch.Tensor          # (T,) int32 1 = last tile of its block
    lens: torch.Tensor          # (Cp,) int32
    block_c: int
    block_j: int
    n_lit_bits: int             # the chains' sentinel id
    tile_margin: torch.Tensor | None = None     # (T,) int32


def place_tables(chain_ids, votes, tiles, indptr, *, block_c, block_j, n_lit_bits,
                 tile_margin=None) -> PlacedSchedule:
    """A chain schedule's device tables as a :class:`PlacedSchedule` on their
    device: ``tiles`` is (4, T) (cb, jb, first, last), ``indptr`` the CSR
    tile pointers a clause block and ``n_lit_bits`` the chains' sentinel.
    Checks the tables and counts the chain lengths, in a build span."""
    with spans.span(spans.BUILD_RANGE):
        _check_tables(chain_ids, votes, tiles, indptr, tile_margin, 4)
        return PlacedSchedule(chain_ids, votes, indptr, tiles[1].contiguous(),
                              tiles[3].contiguous(), chain_lengths(chain_ids, n_lit_bits),
                              block_c, block_j, n_lit_bits, tile_margin)


def place(schedule: SparseSchedule, votes: torch.Tensor, *,
          tile_margin=None) -> PlacedSchedule:
    """``schedule``'s tables on ``votes``' device, then :func:`place_tables`;
    ``tile_margin`` is a host margin table (early exit) or None."""
    with spans.span(spans.BUILD_RANGE):
        tiles = np.stack([schedule.tile_cb, schedule.tile_jb, schedule.tile_first,
                          schedule.tile_last]).reshape(4, -1)
        chain, tiles, indptr, margin = _upload(votes.device, schedule.chain_ids, tiles,
                                               schedule.indptr, tile_margin)
    return place_tables(chain, votes, tiles, indptr, block_c=schedule.block_c,
                        block_j=schedule.block_j, n_lit_bits=schedule.n_lit_bits,
                        tile_margin=margin)


def _plain(lit_words, placed: PlacedSchedule):
    B, W = lit_words.shape
    lit_t = bit_transpose_literals(lit_words, W * 32)
    sums = chain_fold_plain(lit_t, placed.chain_ids, placed.votes, placed.jb, placed.last,
                            placed.indptr, tile_off=0, block_c=placed.block_c,
                            block_j=placed.block_j, n_samples=B,
                            tile_margin=placed.tile_margin)
    return sums[:B]


def _cuda(lit_words, placed: PlacedSchedule, walk: int):
    global launches
    B, W = lit_words.shape
    U, K = placed.votes.shape
    Sw = packetizer.n_words(B)
    # scratch for the kernel's own bit transpose of the literals (the
    # transpose launch zeroes `out` before the walk adds into it) and, with
    # early exit, for the fired words the walk stores for the in-order fold
    dev = lit_words.device
    lit_t = torch.empty((W * 32 + 1, Sw), dtype=torch.int32, device=dev)
    out = torch.empty((Sw * 32, K), dtype=torch.int32, device=dev)
    margin = placed.tile_margin
    fired = None if margin is None else torch.empty((Sw, U), dtype=torch.int32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.entry("sparse_infer", "sparse_infer_launch",
                      [P, I, I, P, I, P, P, I, P, I, I, P, I, P, P, P, I, I, I, P, P, P])
    err = fn(_build.ptr(lit_words), B, W, _build.ptr(lit_t), Sw,
             _build.ptr(placed.chain_ids), _build.ptr(placed.lens), placed.chain_ids.shape[1],
             _build.ptr(placed.votes), U, K, _build.ptr(placed.indptr),
             placed.indptr.shape[0] - 1, _build.ptr(placed.jb), _build.ptr(placed.last),
             None if margin is None else _build.ptr(margin),
             placed.block_c, placed.block_j, walk, _build.ptr(out),
             None if fired is None else _build.ptr(fired), _build.stream_ptr(dev))
    _build.check("sparse_infer", err)
    launches += 1
    return out[:B]


def occupancy(B: int, n_cblocks: int, block_c: int, K: int, block_s=None) -> dict:
    """The exact walk's registers a thread, threads a block, resident blocks
    per SM, shared and spill bytes, grid and threads a chain at batch
    ``B`` over ``n_cblocks`` clause blocks of ``block_c``, ``K`` classes
    (``K`` decides whether the votes are staged in shared memory) and
    ``block_s`` sample words a block (None: the kernel's choice)."""
    return _build.occupancy("sparse_infer", B, n_cblocks, block_c, K,
                            walk_words(block_s), extra=GRID_FIELDS)


def sparse_tm_forward(lit_words: torch.Tensor, placed: PlacedSchedule, *,
                      block_s=None) -> torch.Tensor:
    """Packed literals (B, W) int32 -> (B, K) int32 class sums over a placed
    chain schedule, the walk at ``block_s`` sample words a block
    (:func:`walk_words`): the kernel for CUDA literals, the plain version
    for CPU ones.

    Bit-identical to ``class_sum_ref(clause_fire_ref(lit, include_words),
    votes)`` for the include rows the schedule was built from; with a
    margin table in the placement argmax-identical (exact early exit).
    """
    walk = _check_literals(lit_words, placed, block_s)
    if placed.jb.shape[0] == 0:   # degenerate all-empty schedule: nothing votes
        return torch.zeros((lit_words.shape[0], placed.votes.shape[1]), dtype=torch.int32,
                           device=lit_words.device)
    return _cuda(lit_words, placed, walk) if lit_words.is_cuda else _plain(lit_words, placed)


def schedule_class_sums_ref(lit_words, chain_ids, votes):
    """Oracle over chain tables: fire iff every chain literal is 1, sentinel
    ids read constant 1.  (B, W), (Cp, Jp), (Cp, K) -> (B, K) int32."""
    B, W = lit_words.shape
    bits = packetizer.unpack_bits(lit_words, W * 32)          # (B, L)
    padded = torch.cat([bits, torch.ones((B, 1), dtype=bits.dtype,
                                         device=bits.device)], dim=1)
    g = padded[:, chain_ids.reshape(-1).long()]
    fired = torch.all(g.reshape(B, *chain_ids.shape) != 0, dim=2)
    return class_sum_ref(fired, votes)
