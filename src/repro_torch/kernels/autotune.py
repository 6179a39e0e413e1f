"""Launch-configuration autotuner for the port's four tuned TM kernels.

The port of ``repro.kernels.autotune``.  A kernel's speed depends on how
it is launched, and the best launch depends on the problem's shape and
on the device.  All four tuned kernels (``fused_infer``, ``fused_train``,
``sparse_infer``, ``term_infer``) register here (:data:`_REGISTRY`) and are
tuned through ONE facade::

    tune("sparse_infer", B=512, K=10, include_words=iw,
         device=torch.device("cuda"), policy="verify")

with a three-mode ``policy``:

* ``"sweep"`` -- time every candidate, memoize the winner in the on-disk
  cache, and log every ``(basis, tiling, measured_us)`` observation into
  the cost model's sidecar (``kernels/cost_model.py``).
* ``"verify"`` (default) -- rank candidates with the cost model, then time
  only the predicted top-``k``.
* ``"predict"`` -- trust the model outright: ZERO timing runs (the
  module-level :data:`TIMING_RUNS` counter proves it), which is what a
  multi-tenant zoo cold load needs.

Candidates keep the reference's block names, with their CUDA meaning.
``fused_infer`` and ``fused_train``: ``block_b`` samples a CUDA block (for
``fused_train`` the samples of one segment of its walk), ``block_c``
clauses a CUDA block and ``block_w`` the words one warp walks; their
candidates are the kernels' word splits 1, 2 and 4 and clauses a block 2,
4 and 8.  ``sparse_infer`` and ``term_infer``: ``block_c``, ``block_j``
(and ``block_t``, ``term_w``) are the schedule tiling, as in the
reference, and ``block_s`` the sample words a block of the walk takes (1,
2, 4 or 8).  So the reference's basis formulas, unchanged, count the CUDA
grid.  Every candidate launches differently and gives the same bits.

On the card a timing run is the CUDA-event time of a call on an idle
stream after a warm-up call; on the CPU the wall time of a call of the
plain versions.  Every call the tuner makes counts in ``TIMING_RUNS``.  A
candidate that fails to launch fails the sweep.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json`` (the reference's cache is never
read).  The file is ``{"schema": N, "entries": {...}}``; a schema mismatch
or a corrupt file invalidates the whole cache.  Entries are keyed by
``<kernel>:v1:<mode>:<shape>:cands[...]``, the reference's layout with the
mode ``torch-cuda`` or ``torch-cpu``; model-assisted policies add a
``:p<policy>`` tag so a prediction never masquerades as a measurement.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.kernels import (cost_model, fused_infer, fused_train, sparse_infer,
                                 term_infer)

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_KEY_VERSION = "v1"
# the reference's schema: 3 (policy-tagged entries)
_SCHEMA_VERSION = 3

POLICIES = ("sweep", "verify", "predict")

# Every kernel call the tuner makes (warm-up included) increments this:
# ``policy="predict"`` leaving it untouched is the zero-timing-runs
# guarantee.
TIMING_RUNS = 0

# Within this factor of the fastest reading the largest tiling wins (fewer
# grid steps is the structurally better launch when readings cannot part
# the candidates): the reference's 5% for the CPU's wall clock; the card's
# event readings repeat to well under 1%, and its candidates differ by a
# few percent, so there 5% would crown the largest tiling over a faster one
_TIE = {cost_model.CPU_MODE: 1.05, cost_model.CUDA_MODE: 1.01}

# calls between the two events of one timing run on the card, queued behind
# a sleep so that the stream runs them back to back (the host's launch
# work stays out of the reading)
_CALLS_PER_READ = 10
_SLEEP_CYCLES = 4_000_000          # ~2 ms at 1.98 GHz: covers the queueing

# fused_infer: (samples a block, clauses a block, words a warp walks) for
# word splits 1, 2 and 4; a 0 is resolved from the shape by the clip
_DENSE_CANDIDATES = (
    (fused_infer.BLOCK_B, 64, 0),   # split 1: the widest block
    (fused_infer.BLOCK_B, 32, 0),   # split 2
    (fused_infer.BLOCK_B, 16, 0),   # split 4: most blocks, for small batches
)

# fused_train: (samples a segment, clauses a block, words a warp walks);
# the default (4 clauses, csrc/ta_delta.cuh:kCT) first
_TRAIN_CANDIDATES = tuple((0, c, 0) for c in (4, 2, 8))

# the walks' sample words a block: each schedule tiling is crossed with them
_SLABS = (8, 4, 2)

# sparse_infer: the reference's chain tilings (block_c, block_j) crossed
# with the slabs
_SPARSE_TILINGS = (
    (512, 32),    # sparse_infer.py defaults
    (1024, 32),
    (512, 64),
    (256, 32),
    (1024, 64),
    (512, 16),
    (2048, 128),  # long-chain trained banks: few big whole-chain tiles
    (4096, 128),
)
_SPARSE_CANDIDATES = tuple((bc, bj, bs) for bc, bj in _SPARSE_TILINGS
                           for bs in _SLABS)

# term_infer: the reference's factorized tilings (block_c, block_j,
# block_t, term_w; term_w 0 = the artifact's auto width) crossed with the
# slabs
_TERM_TILINGS = (
    (1024, 64, 32768, 0),   # term_infer.py defaults, auto width
    (1024, 64, 32768, 2),   # narrowest rows: fat terms split to pieces
    (1024, 128, 32768, 2),
    (2048, 128, 32768, 2),
    (4096, 64, 32768, 2),
    (1024, 32, 16384, 0),
    (512, 32, 4096, 0),     # small-artifact shapes clip here
)
_TERM_CANDIDATES = tuple((bc, bj, bt, bs, tw) for bc, bj, bt, tw in _TERM_TILINGS
                         for bs in _SLABS)


def cache_path() -> str:
    p = os.environ.get(_CACHE_ENV)
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _load_cache() -> dict:
    """Entry dict from disk; {} on missing, corrupt, or stale-schema files."""
    try:
        with open(cache_path()) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("schema") != _SCHEMA_VERSION:
        return {}   # stale schema: invalidate, never reuse or crash
    entries = raw.get("entries")
    return entries if isinstance(entries, dict) else {}


def _save_cache(entries: dict) -> None:
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"schema": _SCHEMA_VERSION, "entries": entries},
                  f, indent=1, sort_keys=True)
    # os.replace keeps the file whole; concurrent tuners are last-writer-wins
    os.replace(tmp, path)


def _time_call(run, device: torch.device) -> float:
    """Seconds of one call of ``run`` (one timing read)."""
    global TIMING_RUNS
    if device.type != "cuda":
        TIMING_RUNS += 1
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    # the calls queue behind a sleep, so the events time the device's work
    # of _CALLS_PER_READ calls back to back
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    a.record()
    for _ in range(_CALLS_PER_READ):
        TIMING_RUNS += 1
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / _CALLS_PER_READ


def _sweep(runs: dict, reps: int, device: torch.device) -> dict:
    """Min seconds per candidate, read round-robin so drift in the
    machine's state falls on every candidate equally.  A candidate that
    fails to launch raises."""
    global TIMING_RUNS
    for run in runs.values():
        TIMING_RUNS += 1
        run()                              # build + warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    best = {k: float("inf") for k in runs}
    for _ in range(reps):
        for k, run in runs.items():
            best[k] = min(best[k], _time_call(run, device))
    return best


# in-process memo so hot loops never re-read the on-disk JSON; keyed by
# (cache file, entry) so switching $REPRO_TORCH_AUTOTUNE_CACHE mid-process
# works
_PROC_CACHE: dict = {}

_DENSE_KEYS = ("block_b", "block_c", "block_w")


def _memoized_best(key: str, make_runs, reps: int, refresh: bool, device,
                   block_names=_DENSE_KEYS, observe=None) -> dict:
    """Sweep (or recall) the best block dict for ``key``.
    ``observe(timings)`` fires only when a sweep actually ran."""
    pkey = (cache_path(), key)
    if not refresh and pkey in _PROC_CACHE:
        return dict(_PROC_CACHE[pkey])
    cache = _load_cache()
    if not refresh and key in cache:
        _PROC_CACHE[pkey] = dict(cache[key]["blocks"])
        return dict(cache[key]["blocks"])

    timings = _sweep(make_runs(), reps, device)
    if observe is not None:
        observe(timings)
    t_min = min(timings.values())
    best_blocks = max(
        (blk for blk, t in timings.items() if t <= t_min * _TIE[_mode_backend(device)]),
        key=lambda blk: math.prod(blk),
    )
    result = dict(zip(block_names, best_blocks))
    cache = _load_cache()   # re-read to narrow the concurrent-writer window
    cache[key] = dict(blocks=result, us_per_call=timings[best_blocks] * 1e6)
    _save_cache(cache)
    _PROC_CACHE[pkey] = dict(result)
    return result


def _mode_backend(device) -> str:
    """The mode tag of keys and sidecar rows: ``torch-cuda`` for a CUDA
    device, ``torch-cpu`` (the plain versions) otherwise."""
    dev = torch.device(device)
    return cost_model.CUDA_MODE if dev.type == "cuda" else cost_model.CPU_MODE


def _cands_tag(clipped) -> str:
    # the candidate set is part of the key: a sweep over a restricted custom
    # candidate list must not answer for the default sweep (or vice versa)
    return ",".join("x".join(map(str, c)) for c in clipped)


def _artifact_tag(include_words) -> str:
    """Short content hash of an artifact's include rows: two same-shape
    artifacts with different sparsity must not share a cache entry."""
    return sparse_infer.artifact_tag(include_words)[:10]


def _lit_tag(lit_words) -> str:
    """Key fragment for a caller-supplied representative literal stream."""
    if lit_words is None:
        return ""
    lw = lit_words.cpu().numpy() if isinstance(lit_words, torch.Tensor) else lit_words
    return ":lit" + sparse_infer.artifact_tag(np.asarray(lw).view(np.uint32))[:10]


def _dedup(cands) -> list:
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
    return out


def _clip_slab(bs: int, B: int) -> int:
    """The reference clips the slab to the bucket's sample words; the walk
    takes powers of two, so the port clips to the one that covers them
    (equal wherever the bucket's words are a power of two)."""
    return max(min(int(bs), sparse_infer.covering_walk_words(B)), 1)


def _clip_sparse_candidate(blocks, B: int, U: int):
    bc, bj, bs = blocks
    bc = min(bc, sparse_infer._rup(max(U, 1), 8))
    return bc, bj, _clip_slab(bs, B)


def _clip_term_candidate(blocks, B: int, U: int, iw, n_pieces_bound: int) -> tuple:
    bc, bj, bt, bs, tw = blocks
    bc = min(bc, sparse_infer._rup(max(U, 1), 8))
    if tw == 0:   # 0 = the artifact's auto width (resolved so duplicate
        tw = term_infer.pick_term_width(iw)   # post-clip candidates dedup)
    # the schedule builder clips block_t to its term count; apply the same
    # bound here (pieces <= total include bits) so small artifacts dedup
    # candidates that only differ in an unreachable block_t
    bt = max(min(bt, sparse_infer._rup(n_pieces_bound + 1, 8)), 1)
    return bc, bj, bt, _clip_slab(bs, B), tw


def _random_words(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Kernel registry: candidates, cache keys, timed runs, and cost-model basis
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // max(b, 1))


@dataclasses.dataclass(frozen=True)
class KernelTuner:
    """One tuned kernel's registration: how to clip/dedup its candidate
    tuples, key its cache entries, build timed runs, and featurize a
    candidate into the cost model's basis terms.  All callables take the
    normalized ``problem`` dict built by ``prepare`` from ``tune(...)``'s
    shape kwargs."""
    name: str
    block_names: tuple
    default_candidates: tuple
    default_reps: int
    prepare: callable       # (**shape_kwargs) -> problem dict
    clip: callable          # (candidates, problem) -> unique clipped tuples
    cache_key: callable     # (problem, clipped, mode) -> sweep cache key
    make_runs: callable     # (problem, clipped, device) -> {cand: thunk}
    basis: callable         # (problem, cand) -> {basis_term: float}


_REGISTRY: dict = {}


def register(tuner: KernelTuner) -> None:
    _REGISTRY[tuner.name] = tuner


def kernels() -> tuple:
    """Registered tunable kernel names."""
    return tuple(_REGISTRY)


# -- fused dense inference ---------------------------------------------------

def _dense_prepare(*, B, C, W, K):
    return dict(B=int(B), C=int(C), W=int(W), K=int(K))


def _dense_clip(candidates, p):
    out = []
    for bb, bc, bw in candidates:
        if bw == 0:       # the words one warp walks at this split
            bw = fused_infer.blocks_for(64 // max(int(bc), 1), p["W"])["block_w"]
        fused_infer.word_split(p["W"], bb, bc, bw)   # raises if not launchable
        out.append((int(bb), int(bc), int(bw)))
    return _dedup(out)


def _dense_key(p, clipped, mode):
    return (f"fused_infer:{_KEY_VERSION}:{mode}:"
            f"B{p['B']}:C{p['C']}:W{p['W']}:K{p['K']}:"
            f"cands[{_cands_tag(clipped)}]")


def _dense_runs(p, clipped, device):
    B, C, W, K = p["B"], p["C"], p["W"], p["K"]
    rng = np.random.default_rng(0)
    lit = _random_words(rng, (B, W), device)
    inc = _random_words(rng, (C, W), device)
    votes = torch.from_numpy(rng.integers(-2, 3, (C, K), dtype=np.int32)).to(device)
    nonempty = torch.ones((C,), dtype=torch.int32, device=device)
    return {
        (bb, bc, bw): functools.partial(
            fused_infer.fused_tm_forward, lit, inc, votes, nonempty,
            block_b=bb, block_c=bc, block_w=bw)
        for bb, bc, bw in clipped
    }


def _dense_basis(p, cand):
    """Roofline terms for one (block_b, block_c, block_w): grid steps,
    padded clause-eval volume, class-sum fold volume, and tile traffic."""
    B, C, W, K = p["B"], p["C"], p["W"], p["K"]
    bb, bc, bw = cand
    nb, nc, nw = _ceil_div(B, bb), _ceil_div(C, bc), _ceil_div(W, bw)
    steps = nb * nc * nw
    return dict(
        steps=float(steps),
        work_melem=steps * bb * bc * bw / 1e6,
        fold_melem=nb * nc * bb * bc * K / 1e6,
        bytes_mb=steps * (bb * bw + bc * bw) * 4 / 1e6,
    )


register(KernelTuner(
    name="fused_infer", block_names=_DENSE_KEYS,
    default_candidates=_DENSE_CANDIDATES, default_reps=5,
    prepare=_dense_prepare, clip=_dense_clip, cache_key=_dense_key,
    make_runs=_dense_runs, basis=_dense_basis,
))


# -- fused training ----------------------------------------------------------

def _train_prepare(*, B, C, W, L, K):
    return dict(B=int(B), C=int(C), W=int(W), L=int(L), K=int(K))


def _train_clip(candidates, p):
    out = []
    for bb, bc, bw in candidates:
        want = fused_train.blocks_for(int(bc), p["B"], p["W"])
        bb, bw = bb or want["block_b"], bw or want["block_w"]
        fused_train.clauses_a_block(p["B"], p["W"], bb, bc, bw)   # raises if not launchable
        out.append((int(bb), int(bc), int(bw)))
    return _dedup(out)


def _train_key(p, clipped, mode):
    return (f"fused_train:{_KEY_VERSION}:{mode}:"
            f"B{p['B']}:C{p['C']}:W{p['W']}:L{p['L']}:K{p['K']}:"
            f"cands[{_cands_tag(clipped)}]")


def _train_runs(p, clipped, device):
    from repro_torch.core import packetizer

    B, C, W, L, K = p["B"], p["C"], p["W"], p["L"], p["K"]
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (B, L), dtype=np.uint8)
    lits = torch.from_numpy(bits).to(device)
    lit_words = packetizer.words_to_tensor(packetizer.pack_bits_np(bits), device)
    inc_bits = (rng.random((C, L)) < 0.05).astype(np.uint8)
    inc_full = np.zeros((C, W * 32), np.uint8)
    inc_full[:, :L] = inc_bits
    inc_words = packetizer.words_to_tensor(packetizer.pack_bits_np(inc_full), device)
    ta = torch.from_numpy(rng.integers(-64, 64, (C, L), dtype=np.int8)).to(device)
    y_np = rng.integers(0, K, B, dtype=np.int32)
    y = torch.from_numpy(y_np).to(device)
    kn = torch.from_numpy(((y_np + 1) % K).astype(np.int32)).to(device)
    p_t = torch.from_numpy(rng.random(B, dtype=np.float32)).to(device)
    p_n = torch.from_numpy(rng.random(B, dtype=np.float32)).to(device)
    cpc = max(1, C // K)
    cls = torch.from_numpy(np.clip(np.arange(C) // cpc, 0, K - 1).astype(np.int32)).to(device)
    pol = torch.from_numpy(np.where(np.arange(C) % 2 == 0, 1, -1).astype(np.int32)).to(device)
    return {
        (bb, bc, bw): functools.partial(
            fused_train.fused_tm_train_delta,
            ta, lits, lit_words, inc_words, y, kn, p_t, p_n, cls, pol,
            0, p_act=1.0, p_inact=0.1, block_b=bb, block_c=bc, block_w=bw)
        for bb, bc, bw in clipped
    }


def _train_basis(p, cand):
    """Dense-inference terms plus the (block_c, L) delta and (block_b, L)
    literal-slab traffic the training kernel adds."""
    B, C, W, L, K = p["B"], p["C"], p["W"], p["L"], p["K"]
    bb, bc, bw = cand
    nb, nc, nw = _ceil_div(B, bb), _ceil_div(C, bc), _ceil_div(W, bw)
    steps = nb * nc * nw
    return dict(
        steps=float(steps),
        work_melem=steps * bb * bc * bw / 1e6,
        l_work_melem=nb * nc * (bc + bb) * L / 1e6,
        bytes_mb=(steps * (bb * bw + bc * bw) + nb * nc * bc * L) * 4 / 1e6,
    )


register(KernelTuner(
    name="fused_train", block_names=_DENSE_KEYS,
    default_candidates=_TRAIN_CANDIDATES, default_reps=3,
    prepare=_train_prepare, clip=_train_clip, cache_key=_train_key,
    make_runs=_train_runs, basis=_train_basis,
))


# -- sparse chain-schedule inference -----------------------------------------

def _sparse_prepare(*, B, K, include_words, lit_words=None):
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    U, Wa = iw.shape
    return dict(B=int(B), K=int(K), iw=iw, U=U, Wa=Wa, lit_words=lit_words)


def _sparse_clip(candidates, p):
    return _dedup(_clip_sparse_candidate(c, p["B"], p["U"]) for c in candidates)


def _sparse_key(p, clipped, mode):
    return (f"sparse_infer:{_KEY_VERSION}:{mode}:"
            f"B{p['B']}:U{p['U']}:W{p['Wa']}:K{p['K']}:"
            f"sig{_artifact_tag(p['iw'])}{_lit_tag(p['lit_words'])}:"
            f"cands[{_cands_tag(clipped)}]")


def _schedule_inputs(p, device):
    """The literal stream (the caller's, else uniform random) and random
    votes of a walk's timed runs."""
    rng = np.random.default_rng(0)
    lw = p["lit_words"]
    if lw is None:
        lit = _random_words(rng, (p["B"], p["Wa"]), device)
    elif isinstance(lw, torch.Tensor):
        lit = lw.to(device=device, dtype=torch.int32).contiguous()
    else:
        lit = torch.from_numpy(np.ascontiguousarray(lw).view(np.int32)).to(device)
    votes = torch.from_numpy(
        rng.integers(-2, 3, (p["U"], p["K"]), dtype=np.int32)).to(device)
    return lit, votes


def _sparse_runs(p, clipped, device):
    lit, votes = _schedule_inputs(p, device)
    runs, placed = {}, {}
    for bc, bj, bs in clipped:
        if (bc, bj) not in placed:          # one placement a schedule
            placed[bc, bj] = sparse_infer.place(
                sparse_infer.build_schedule_cached(p["iw"], block_c=bc, block_j=bj), votes)
        runs[(bc, bj, bs)] = functools.partial(
            sparse_infer.sparse_tm_forward, lit, placed[bc, bj], block_s=bs)
    return runs


def _sparse_basis(p, cand):
    """Terms from the REAL ragged schedule this candidate would execute
    (``build_schedule_cached``): actual tile and clause-block counts."""
    bc, bj, bs = cand
    sched = sparse_infer.build_schedule_cached(p["iw"], block_c=bc, block_j=bj)
    n_tiles = int(len(sched.tile_cb))
    n_cblocks = int(len(sched.counts))
    sw = _ceil_div(_ceil_div(p["B"], 32), bs)
    steps = sw * n_tiles
    return dict(
        steps=float(steps),
        chain_melem=steps * bc * bj * bs / 1e6,
        fold_melem=sw * n_cblocks * bc * p["K"] * bs / 1e6,
        bytes_mb=steps * bc * bj * 4 / 1e6,
    )


register(KernelTuner(
    name="sparse_infer", block_names=("block_c", "block_j", "block_s"),
    default_candidates=_SPARSE_CANDIDATES, default_reps=5,
    prepare=_sparse_prepare, clip=_sparse_clip, cache_key=_sparse_key,
    make_runs=_sparse_runs, basis=_sparse_basis,
))


# -- factorized two-level term-schedule inference ----------------------------

def _term_prepare(*, B, K, include_words, lit_words=None):
    iw = np.ascontiguousarray(np.asarray(include_words, dtype=np.uint32))
    U, Wa = iw.shape
    n_bits_total = int(np.unpackbits(iw.view(np.uint8)).sum())
    return dict(B=int(B), K=int(K), iw=iw, U=U, Wa=Wa,
                n_bits_total=n_bits_total, lit_words=lit_words)


def _term_clip(candidates, p):
    return _dedup(_clip_term_candidate(c, p["B"], p["U"], p["iw"], p["n_bits_total"])
                  for c in candidates)


def _term_key(p, clipped, mode):
    return (f"term_infer:{_KEY_VERSION}:{mode}:"
            f"B{p['B']}:U{p['U']}:W{p['Wa']}:K{p['K']}:"
            f"sig{_artifact_tag(p['iw'])}{_lit_tag(p['lit_words'])}:"
            f"cands[{_cands_tag(clipped)}]")


def _term_runs(p, clipped, device):
    lit, votes = _schedule_inputs(p, device)
    runs, placed = {}, {}
    for bc, bj, bt, bs, tw in clipped:
        if (bc, bj, bt, tw) not in placed:  # one placement a schedule
            placed[bc, bj, bt, tw] = term_infer.place(
                term_infer.build_factorized_schedule_cached(
                    p["iw"], block_c=bc, block_j=bj, block_t=bt, term_w=tw), votes)
        runs[(bc, bj, bt, bs, tw)] = functools.partial(
            term_infer.factorized_tm_forward, lit, placed[bc, bj, bt, tw], block_s=bs)
    return runs


def _term_basis(p, cand):
    """Terms from the real factorized schedule: the stage-1 (term eval) /
    stage-2 (clause chain) tile split and the term-table size."""
    bc, bj, bt, bs, tw = cand
    sched = term_infer.build_factorized_schedule_cached(
        p["iw"], block_c=bc, block_j=bj, block_t=bt, term_w=tw)
    stage = np.asarray(sched.tile_stage)
    n_tiles = int(len(stage))
    n_term_tiles = int((stage == 0).sum())
    n_clause_tiles = n_tiles - n_term_tiles
    n_cblocks = int(len(sched.counts))
    sw = _ceil_div(_ceil_div(p["B"], 32), bs)
    return dict(
        steps=float(sw * n_tiles),
        term_melem=sw * n_term_tiles * bt * tw * bs / 1e6,
        chain_melem=sw * n_clause_tiles * bc * bj * bs / 1e6,
        fold_melem=sw * n_cblocks * bc * p["K"] * bs / 1e6,
        bytes_mb=sw * (n_term_tiles * bt * tw
                       + n_clause_tiles * bc * bj) * 4 / 1e6,
    )


register(KernelTuner(
    name="term_infer",
    block_names=("block_c", "block_j", "block_t", "block_s", "term_w"),
    default_candidates=_TERM_CANDIDATES, default_reps=5,
    prepare=_term_prepare, clip=_term_clip, cache_key=_term_key,
    make_runs=_term_runs, basis=_term_basis,
))


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

def tune(
    kernel: str,
    *,
    device,
    policy: str = "verify",
    top_k: int = 3,
    candidates=None,
    reps: int | None = None,
    refresh: bool = False,
    features: dict | None = None,
    **shape,
) -> dict:
    """Best block dict for one registered kernel on ``device`` under a
    tuning policy.

    ``shape`` kwargs are per kernel: ``fused_infer`` takes ``B, C, W, K``;
    ``fused_train`` adds ``L``; ``sparse_infer``/``term_infer`` take
    ``B, K, include_words`` (+ optional ``lit_words`` representative
    stream).  ``features`` optionally attaches the artifact's
    candidate-independent feature dict to the sidecar rows a sweep logs.

    Policies: ``"sweep"`` times every candidate; ``"verify"`` times only
    the cost model's top-``top_k``; ``"predict"`` returns the model's
    top-1 with zero timing runs.  All three memoize on disk, predictions
    under a ``:ppredict``-tagged key.
    """
    try:
        tuner = _REGISTRY[kernel]
    except KeyError:
        raise ValueError(
            f"unknown kernel {kernel!r}; registered: {sorted(_REGISTRY)}")
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")

    device = torch.device(device)
    problem = tuner.prepare(**shape)
    clipped = tuner.clip(candidates or tuner.default_candidates, problem)
    mode = _mode_backend(device)
    base_key = tuner.cache_key(problem, clipped, mode)
    reps = tuner.default_reps if reps is None else reps

    def observe(timings):
        cost_model.record_observations([cost_model.make_observation(
            kernel, mode, dict(zip(tuner.block_names, cand)),
            tuner.basis(problem, cand), t * 1e6, features)
            for cand, t in timings.items()])

    if policy == "sweep":
        return _memoized_best(
            base_key, lambda: tuner.make_runs(problem, clipped, device),
            reps, refresh, device, block_names=tuner.block_names,
            observe=observe)

    ranked = cost_model.get_model(mode).rank(
        kernel, [(cand, tuner.basis(problem, cand)) for cand in clipped])

    if policy == "predict":
        key = f"{base_key}:ppredict"
        pkey = (cache_path(), key)
        if not refresh and pkey in _PROC_CACHE:
            return dict(_PROC_CACHE[pkey])
        cache = _load_cache()
        if not refresh and key in cache:
            _PROC_CACHE[pkey] = dict(cache[key]["blocks"])
            return dict(cache[key]["blocks"])
        best, pred_us = ranked[0]
        result = dict(zip(tuner.block_names, best))
        cache = _load_cache()
        cache[key] = dict(blocks=result, predicted_us=pred_us,
                          policy="predict")
        _save_cache(cache)
        _PROC_CACHE[pkey] = dict(result)
        return result

    # verify: time only the predicted top-k.  The shortlist is part of the
    # key: as the model refits, a new shortlist re-verifies
    short = [cand for cand, _ in ranked[:max(1, int(top_k))]]
    key = f"{base_key}:pverify:top[{_cands_tag(short)}]"
    return _memoized_best(
        key, lambda: tuner.make_runs(problem, short, device),
        reps, refresh, device, block_names=tuner.block_names,
        observe=observe)


def candidates_for(kernel: str, candidates=None, **shape) -> list:
    """The clipped candidates of a shape as block dicts, in sweep order."""
    tuner = _REGISTRY[kernel]
    problem = tuner.prepare(**shape)
    return [dict(zip(tuner.block_names, c))
            for c in tuner.clip(candidates or tuner.default_candidates, problem)]


def rank_candidates(kernel: str, *, device, candidates=None, **shape) -> list:
    """The cost model's full ranking for a shape --
    ``[(blocks_dict, predicted_us), ...]`` best-first, zero timing runs."""
    tuner = _REGISTRY[kernel]
    problem = tuner.prepare(**shape)
    clipped = tuner.clip(candidates or tuner.default_candidates, problem)
    ranked = cost_model.get_model(_mode_backend(device)).rank(
        kernel, [(cand, tuner.basis(problem, cand)) for cand in clipped])
    return [(dict(zip(tuner.block_names, cand)), us) for cand, us in ranked]


def plan_engine(compiled, B: int, *, device, policy: str = "predict",
                top_k: int = 3, refresh: bool = False) -> tuple:
    """Pick ``(engine_name, blocks)`` for serving a compiled artifact at
    batch ``B`` on ``device`` -- the zoo cold-load path: with
    ``policy="predict"`` this makes ZERO timing runs (engine by the
    compiler's sharing heuristic, tiling by the cost model)."""
    from repro_torch.core import compiler

    stats = getattr(compiled, "stats", None)
    sharing = float(getattr(stats, "partial_term_sharing", 0.0) or 0.0)
    engine = ("factorized" if sharing >= compiler.FACTORIZE_SHARING_THRESHOLD
              else "sparse")
    kernel = "term_infer" if engine == "factorized" else "sparse_infer"
    blocks = tune(
        kernel, B=B, K=int(compiled.n_classes),
        include_words=compiled.include_words, device=device,
        policy=policy, top_k=top_k, refresh=refresh,
        features=getattr(compiled, "features", None) or None)
    return engine, blocks


# ---------------------------------------------------------------------------
# Legacy entry points (thin wrappers; same cache keys, same results)
# ---------------------------------------------------------------------------

def autotune_fused_blocks(B: int, C: int, W: int, K: int, *, device,
                          candidates=None, reps: int = 5,
                          refresh: bool = False) -> dict:
    """Best ``{block_b, block_c, block_w}`` for a fused-INFERENCE shape:
    ``tune("fused_infer", ..., policy="sweep")``."""
    return tune("fused_infer", B=B, C=C, W=W, K=K, device=device,
                policy="sweep", candidates=candidates, reps=reps,
                refresh=refresh)


def autotune_sparse_infer_blocks(B: int, K: int, include_words, *, device,
                                 candidates=None, reps: int = 5,
                                 refresh: bool = False, lit_words=None) -> dict:
    """Best ``{block_c, block_j, block_s}`` for a SPARSE-schedule artifact:
    ``tune("sparse_infer", ..., policy="sweep")``, each candidate timed on
    the real schedule it would run; ``lit_words`` supplies a representative
    packed request stream (else uniform random literals)."""
    return tune("sparse_infer", B=B, K=K, include_words=include_words,
                lit_words=lit_words, device=device, policy="sweep",
                candidates=candidates, reps=reps, refresh=refresh)


def autotune_term_infer_blocks(B: int, K: int, include_words, *, device,
                               candidates=None, reps: int = 5,
                               refresh: bool = False, lit_words=None) -> dict:
    """Best ``{block_c, block_j, block_t, block_s, term_w}`` for a
    FACTORIZED-schedule artifact: ``tune("term_infer", ...,
    policy="sweep")``."""
    return tune("term_infer", B=B, K=K, include_words=include_words,
                lit_words=lit_words, device=device, policy="sweep",
                candidates=candidates, reps=reps, refresh=refresh)


def autotune_fused_train_blocks(B: int, C: int, W: int, L: int, K: int, *,
                                device, candidates=None, reps: int = 3,
                                refresh: bool = False) -> dict:
    """Best ``{block_b, block_c, block_w}`` for a fused-TRAINING shape:
    ``tune("fused_train", ..., policy="sweep")``, cached under its own
    key."""
    return tune("fused_train", B=B, C=C, W=W, L=L, K=K, device=device,
                policy="sweep", candidates=candidates, reps=reps,
                refresh=refresh)
