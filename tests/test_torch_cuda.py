"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU: bit for bit for the integer kernels, to a stated tolerance for
flash attention.  No JAX needed: run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from repro_torch.core import compiler, packetizer, tm

ENGINES = ("factorized", "sparse", "dense", "oracle")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bank(n_features, n_classes, cpc, density, seed):
    rng = np.random.default_rng(seed)
    C, L = n_classes * cpc, 2 * n_features
    ta = np.where(rng.random((C, L)) < density, rng.integers(0, 127, (C, L)),
                  rng.integers(-128, 0, (C, L))).astype(np.int8)
    cfg = tm.TMConfig(n_features=n_features, n_classes=n_classes,
                      clauses_per_class=cpc)
    return compiler.compile_tm(cfg, ta)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 33, 97, 300])
def test_cuda_engines_equal_plain_versions(cuda_device, batch):
    comp = _bank(48, 4, 40, 0.08, batch)
    x = np.random.default_rng(batch).integers(0, 2, (batch, 48), dtype=np.uint8)
    x_cpu = packetizer.pack_literals(torch.from_numpy(x))
    x_gpu = x_cpu.to(cuda_device)
    for eng in ENGINES:
        want = compiler.run_compiled(comp, x_cpu, engine=eng)
        got = compiler.run_compiled(comp, x_gpu, engine=eng)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=eng)
    for eng in ("sparse", "factorized"):
        for kw in (dict(early_exit=True), dict(quality=1), dict(quality=3),
                   dict(block_c=8, block_j=4), dict(block_c=8, early_exit=True)):
            want = compiler.run_compiled(comp, x_cpu, engine=eng, **kw)
            got = compiler.run_compiled(comp, x_gpu, engine=eng, **kw)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                          err_msg=f"{eng} {kw}")


@pytest.mark.cuda
def test_cuda_all_empty_and_wide_classes(cuda_device):
    empty = _bank(16, 2, 4, 0.0, 0)
    x = packetizer.pack_literals(torch.ones((5, 16), dtype=torch.uint8))
    for eng in ENGINES:
        assert not compiler.run_compiled(empty, x.to(cuda_device), engine=eng).any()
    wide = _bank(20, 32, 6, 0.1, 1)               # K = 32 classes
    x = packetizer.pack_literals(torch.from_numpy(
        np.random.default_rng(2).integers(0, 2, (70, 20), dtype=np.uint8)))
    for eng in ENGINES:
        for ee in (False, True):
            want = compiler.run_compiled(wide, x, engine=eng, early_exit=ee)
            got = compiler.run_compiled(wide, x.to(cuda_device), engine=eng,
                                        early_exit=ee)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# -- the dense clause chain (fused_infer, clause_eval) ----------------------------

def _chain_problem(B, C, W, seed):
    """Literals (B, W) and includes (C, W) as int32 bit patterns, with a mix
    of firing and failing pairs: most clauses hold 0-6 include bits, every
    5th is empty (fires on every sample), every 7th is all ones (fires only
    on an all-ones sample); every 9th sample is all ones."""
    rng = np.random.default_rng(seed)
    lit = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint32)
    lit[::9] = 0xFFFFFFFF
    inc = np.zeros((C, W), np.uint32)
    pos = rng.integers(0, 32 * W, (C, 6))
    keep = np.arange(6)[None, :] < rng.integers(0, 7, C)[:, None]
    rows = np.broadcast_to(np.arange(C)[:, None], pos.shape)
    np.bitwise_or.at(inc, (rows[keep], pos[keep] // 32),
                     np.left_shift(np.uint32(1), (pos[keep] % 32).astype(np.uint32)))
    inc[::5] = 0
    inc[3::7] = 0xFFFFFFFF
    as_t = lambda a: torch.from_numpy(a.view(np.int32).copy())
    return as_t(lit), as_t(inc)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2000, 2048, 2049])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 512, 1030])
def test_cuda_dense_chain_kernels_equal_plain_versions(cuda_device, B, C):
    """Both kernels of csrc/clause_chain.cuh against their plain versions,
    tolerance 0, at every word width and class count: every word split of
    the grid (B 64 and C 2048 take the narrowest), ragged sample, clause
    and word edges, more than one staged word chunk (W 49, 513), a
    `nonempty` mask that drops empty and some other clauses (any nonzero
    value keeps a clause), and the training semantics (`nonempty=None`)."""
    from repro_torch.kernels import clause_eval, fused_infer
    g = lambda t: t.to(cuda_device)
    ones = torch.ones(C, dtype=torch.int32, device=cuda_device)
    for W in (1, 17, 49, 513):
        lit, inc = (g(t) for t in _chain_problem(B, C, W, B * 7 + C + W))
        # the plain versions run on the card too (the largest case's
        # (B, C, W) intermediate is 4.3 GB)
        fire = clause_eval.clause_fire_plain(lit, inc)
        if B > 1 and C > 1:   # empty rows fire, all-ones rows only on all-ones samples
            assert 0 < int(fire.sum()) < fire.numel()
        np.testing.assert_array_equal(clause_eval.clause_fire_cuda(lit, inc).cpu().numpy(),
                                      fire.cpu().numpy(), err_msg=f"clause_eval W={W}")
        rng = np.random.default_rng(W)
        ne = g(torch.from_numpy(((inc != 0).any(1).cpu().numpy()
                                 * rng.choice([0, 1, 5], C, p=[0.2, 0.6, 0.2])).astype(np.int32)))
        for K in (1, 10, 32):
            votes = g(torch.from_numpy(rng.integers(-3, 4, (C, K)).astype(np.int32)))
            for nonempty in (ne, None):
                want = fused_infer.fused_forward_plain(lit, inc, votes,
                                                       ones if nonempty is None else nonempty)
                got = fused_infer.fused_tm_forward(lit, inc, votes, nonempty)
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.cpu().numpy(),
                    err_msg=f"fused_infer W={W} K={K} nonempty={nonempty is not None}")


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["zero", "ones"])
def test_cuda_dense_chain_all_or_none_fire(cuda_device, fill):
    """All-zero include rows: every clause fires (a masked clause adds
    nothing); all-ones rows: none fires unless the sample is all ones."""
    from repro_torch.kernels import clause_eval, fused_infer
    B, C, W, K = 97, 2049, 49, 10
    lit, _ = _chain_problem(B, C, W, 3)
    inc = torch.full((C, W), 0 if fill == "zero" else -1, dtype=torch.int32)
    votes = torch.from_numpy(np.random.default_rng(4).integers(-3, 4, (C, K)).astype(np.int32))
    nonempty = torch.from_numpy(np.arange(C) % 3 != 0).to(torch.int32)
    g = lambda t: t.to(cuda_device)
    want = clause_eval.clause_fire_plain(lit, inc)
    assert bool(want.all()) if fill == "zero" else int(want.sum()) == C * len(range(0, B, 9))
    np.testing.assert_array_equal(clause_eval.clause_fire_cuda(g(lit), g(inc)).cpu().numpy(),
                                  want.numpy())
    for ne in (nonempty, None):
        want = fused_infer.fused_tm_forward(lit, inc, votes, ne)
        got = fused_infer.fused_tm_forward(g(lit), g(inc), g(votes), None if ne is None else g(ne))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_cuda_dense_chain_occupancy(cuda_device):
    """The grid and word split each main-path shape gets: the widest block
    (32 x 64) at the serve bucket, the word split across 4 warps at
    training's batch 64, at least one block an SM at both."""
    from repro_torch.kernels import clause_eval, fused_infer
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for occ, (B, C) in ((fused_infer.occupancy(512, 2000), (512, 2000)),
                        (fused_infer.occupancy(64, 2048), (64, 2048)),
                        (clause_eval.occupancy(64, 2048), (64, 2048))):
        assert occ["grid_x"] == -(-B // 32)
        assert occ["grid_x"] * occ["grid_y"] >= sms, occ
        assert occ["grid_y"] == -(-C // (64 // occ["word_split"]))
        assert occ["blocks_per_sm"] >= 1 and occ["local_bytes"] == 0, occ
    assert fused_infer.occupancy(512, 2000)["word_split"] == 1


# -- the schedule walks (sparse_infer, term_infer: csrc/chain_walk.cuh) -----------

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "src", "repro_torch", "assets", "tm_mnist_e1.npz")


def _schedule_bank(case):
    """(include words (U, Wa) uint32, votes (U, K) int32) of a synthetic
    bank: 1-6 include bits a clause, plus what the case adds."""
    U, Wa, K = dict(empty_clause=(150, 5, 10), long_clause=(150, 8, 10),
                    ragged_U=(37, 3, 10), k32=(100, 4, 32))[case]
    rng = np.random.default_rng(len(case))
    bits = np.zeros((U, Wa * 32), np.uint8)
    for c in range(U):
        bits[c, rng.choice(Wa * 32, rng.integers(1, 7), replace=False)] = 1
    if case == "empty_clause":        # they fire on every sample and carry votes
        bits[::37] = 0
    if case == "long_clause":         # one chain far longer than its block's others
        bits[70, rng.choice(Wa * 32, 200, replace=False)] = 1
    iw = packetizer.pack_bits_np(bits).view(np.uint32)
    return iw, rng.integers(-4, 5, (U, K)).astype(np.int32)


def _requests(kind, B, Wa, seed):
    """(B, Wa) int32 literal words: random with 9 in 10 bits set (so short
    chains fire), all ones (every chain fires) or all zero (only empty
    chains fire)."""
    if kind == "ones":
        return torch.full((B, Wa), -1, dtype=torch.int32)
    if kind == "zero":
        return torch.zeros((B, Wa), dtype=torch.int32)
    bits = np.random.default_rng(seed).random((B, Wa * 32)) < 0.9
    return torch.from_numpy(packetizer.pack_bits_np(bits.astype(np.uint8)).view(np.int32))


def _schedule_kernels_agree(dev, lit, iw, votes, **tiling):
    """Both schedule kernels against their plain versions, tolerance 0, on
    the full schedules (exact and early exit), every quality prefix and a
    tile table whose clause blocks list their tiles in reverse order."""
    from repro_torch.kernels import anytime, sparse_infer, term_infer
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    lit, v = lit.to(dev).contiguous(), g(votes)
    swing = anytime.total_swing(votes)
    sched = sparse_infer.build_schedule(iw, **tiling)
    fs = term_infer.build_factorized_schedule(iw, **tiling)
    for kind, full, margins, min_tiles, prefix in (
            ("sparse", sched, anytime.sparse_tile_margins(sched, votes), 1,
             anytime.sparse_prefix_schedule),
            ("factorized", fs, anytime.factorized_tile_margins(fs, votes),
             fs.n_term_tiles + 1, anytime.factorized_prefix_schedule)):
        levels = [q["n_tiles"] for q in anytime.quality_prefixes(margins, swing,
                                                                 min_tiles=min_tiles)]
        for n_tiles, margin in [(full.n_tiles, None), (full.n_tiles, margins)] + [
                (n, None) for n in levels]:
            s = full if n_tiles == full.n_tiles else prefix(full, n_tiles)
            t = s.tensors(dev)
            m = None if margin is None else g(margin)
            if kind == "sparse":
                args = (lit, t["chain_ids"], v, t["tiles"], t["indptr"])
                kw = dict(block_c=s.block_c, block_j=s.block_j, tile_margin=m)
                want = sparse_infer.sparse_tables_plain(*args, **kw)
                got = sparse_infer.sparse_tables_cuda(*args, **kw)
            else:
                args = (lit, t["term_chain"], t["clause_chain"], v, t["tiles"], t["indptr"])
                kw = dict(block_c=s.block_c, block_j=s.block_j,
                          n_term_tiles=s.n_term_tiles, tile_margin=m)
                want = term_infer.factorized_tables_plain(*args, **kw)
                got = term_infer.factorized_tables_cuda(*args, **kw)
            np.testing.assert_array_equal(
                got.cpu().numpy(), want.cpu().numpy(),
                err_msg=f"{kind} {tiling} tiles {n_tiles}/{full.n_tiles} early={m is not None}")
    # a clause block's tiles in reverse order: the walk's tile-by-tile path
    t = sched.tensors(dev)
    tiles = t["tiles"].clone()
    for cb in range(sched.n_cblocks):
        lo, hi = int(sched.indptr[cb]), int(sched.indptr[cb + 1])
        tiles[1, lo:hi] = tiles[1, lo:hi].flip(0)
    args = (lit, t["chain_ids"], v, tiles, t["indptr"])
    for m in (None, g(anytime.sparse_tile_margins(sched, votes))):
        kw = dict(block_c=sched.block_c, block_j=sched.block_j, tile_margin=m)
        np.testing.assert_array_equal(sparse_infer.sparse_tables_cuda(*args, **kw).cpu().numpy(),
                                      sparse_infer.sparse_tables_plain(*args, **kw).cpu().numpy(),
                                      err_msg=f"tiles reversed {tiling} early={m is not None}")


@pytest.mark.cuda
@pytest.mark.parametrize("case,kind,B", [
    *[("asset", "random", B) for B in (1, 31, 32, 33, 97, 512, 513, 1030)],
    ("asset", "ones", 97), ("asset", "zero", 97),
    *[(case, kind, B) for case, B in (("empty_clause", 97), ("long_clause", 33),
                                      ("ragged_U", 513), ("k32", 70))
      for kind in ("random", "ones", "zero")],
])
def test_cuda_schedule_kernels_equal_plain_versions(cuda_device, case, kind, B):
    """sparse_tables_cuda and factorized_tables_cuda against their plain
    versions, tolerance 0, exact and early exit and at every quality
    prefix: on the committed tm-mnist artifact at the serve shapes (B 1 to
    1030: one to more than two 16-word slabs), and on synthetic banks with
    empty clauses that carry votes, one chain 200 long in a block of short
    ones, U not a multiple of block_c and K 32, at the default tiling and
    at block_c 8 / block_j 4; requests random, all ones and all zero."""
    if case == "asset":
        from repro_torch.data.synthetic import make_boolean_classification
        comp = compiler.CompiledTM.load(ASSET)
        iw, votes = comp.include_words, np.asarray(comp.votes, np.int32)
        if kind == "random":
            X, _ = make_boolean_classification(B, 784, 10, seed=B)
            lit = packetizer.pack_literals(torch.from_numpy(X))[:, torch.from_numpy(
                np.asarray(comp.word_ids, np.int64))]
        else:
            lit = _requests(kind, B, iw.shape[1], B)
        tilings = [dict()]
    else:
        iw, votes = _schedule_bank(case)
        lit = _requests(kind, B, iw.shape[1], B)
        tilings = [dict(), dict(block_c=8, block_j=4)]
    for tiling in tilings:
        _schedule_kernels_agree(cuda_device, lit, iw, votes, **tiling)


@pytest.mark.cuda
def test_cuda_schedule_occupancy(cuda_device):
    """The exact walks' grid at the serve bucket and past it (B 512 and
    1030: 2 and 5 slabs of 8 words, 32 clauses a block), a thread a chain,
    no spills."""
    from repro_torch.kernels import sparse_infer, term_infer
    for mod, n_cblocks, block_c in ((sparse_infer, 4, 512), (term_infer, 2, 1024)):
        for B, grid_y in ((512, 2), (1030, 5)):
            occ = mod.occupancy(B, n_cblocks, block_c, 10)
            assert (occ["grid_x"], occ["grid_y"]) == (n_cblocks * block_c // 32, grid_y), occ
            assert occ["chain_threads"] == 1 and occ["local_bytes"] == 0, occ
            assert occ["blocks_per_sm"] >= 1, occ


# -- training kernels -----------------------------------------------------------

def _train_problem(B, F, K, cpc, seed, pad=1):
    from repro_torch.core import packetizer as pk
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(n_features=F, n_classes=K, clauses_per_class=cpc,
                      threshold=9, s=4.0, clause_pad_multiple=pad)
    ta = torch.from_numpy(rng.integers(-30, 30, (cfg.n_clauses_total, cfg.n_literals),
                                       dtype=np.int8))
    ta[cfg.n_clauses_raw:] = -cfg.n_states
    x = torch.from_numpy(rng.integers(0, 2, (B, F), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, K, B, dtype=np.int32))
    lits = tm.literals(x)
    return cfg, ta, x, y, lits, pk.pack_bits(lits), pk.pack_include_masks(ta)


def _fused_inputs(cfg, ta, y, lits, lw, iw, seed, b_off, c_off, sl):
    from repro_torch.kernels import ops, ref
    T = cfg.threshold
    votes = tm.vote_matrix(cfg)
    sums = torch.clamp(ref.class_sum_ref(ref.clause_fire_ref(lw, iw), votes), -T, T)
    kn, p_t, p_n = ops.feedback_probs(sums, y, cfg.n_classes, T, seed, b_offset=b_off)
    return (ta[sl], lits, lw, iw[sl], y, kn, p_t, p_n, tm.clause_class(cfg)[sl],
            tm.polarity(cfg)[sl], seed)


def _case(B, F, K, cpc, pad, p=None, name=None):
    """One shape; ``p`` sets every sample's selection probabilities p_t and
    p_n (1.0: every target and negative pair has feedback; 0.0: none)."""
    return pytest.param(B, F, K, cpc, pad, p, id=name or f"{B}-{F}-{K}-{cpc}-{pad}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,K,cpc,pad,p", [
    _case(13, 17, 3, 7, 1), _case(33, 9, 2, 50, 1), _case(97, 784, 10, 200, 256),
    _case(1, 40, 4, 5, 1), _case(1030, 12, 3, 6, 1),
    _case(3, 8200, 2, 8, 1),                                  # W = 513 words
    _case(64, 784, 10, 200, 1, 1.0, "saturated-tm-mnist"),
    _case(1030, 12, 3, 6, 1, 1.0, "saturated-1030"),         # lists span segments
    _case(40, 21, 3, 11, 1, 0.0, "no-feedback"),
    _case(70, 33, 3, 9, 1, 1.0, "odd-L-ragged-C"),           # L = 66, C = 27
])
def test_cuda_training_kernels_equal_plain_versions(cuda_device, B, F, K, cpc, pad, p):
    from repro_torch.kernels import class_sum, clause_eval, fused_train, ta_update
    cfg, ta, x, y, lits, lw, iw = _train_problem(B, F, K, cpc, B, pad)
    C = cfg.n_clauses_total
    g = lambda t: t.to(cuda_device)
    fire = clause_eval.clause_fire(lw, iw)
    np.testing.assert_array_equal(clause_eval.clause_fire(g(lw), g(iw)).cpu().numpy(),
                                  fire.numpy())
    votes = tm.vote_matrix(cfg)
    np.testing.assert_array_equal(class_sum.class_sum(g(fire), g(votes)).cpu().numpy(),
                                  class_sum.class_sum(fire, votes).numpy())
    for b_off, c_off, n_loc, c_total in [(0, 0, C, None), (37, 0, C, None),
                                          (5, C // 2, C - C // 2, None),
                                          (2 ** 32 - 3, C // 2, C - C // 2, C)]:
        sl = slice(c_off, c_off + n_loc)
        args = _fused_inputs(cfg, ta, y, lits, lw, iw, 55, b_off, c_off, sl)
        if p is not None:
            args = args[:6] + (torch.full((B,), p), torch.full((B,), p)) + args[8:]
        kw = dict(p_act=1.0, p_inact=0.25, b_offset=b_off, c_offset=c_off,
                  c_total=c_total)
        want = fused_train.fused_tm_train_delta(*args, **kw)
        if p is not None:
            assert bool(want.any()) == (p > 0)
        got = fused_train.fused_tm_train_delta(*[g(a) if torch.is_tensor(a) else a
                                                 for a in args], **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        from repro_torch.kernels import ops
        ftype = ops.feedback_select(*args[4:], b_offset=b_off, c_offset=c_off)
        f_loc = fire[:, sl].to(torch.uint8)
        want = ta_update.ta_delta(ta[sl], lits, f_loc, ftype, 55, **kw)
        got = ta_update.ta_delta(g(ta[sl]), g(lits), g(f_loc), g(ftype), 55, **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("chunk", [None, 8, 5])
def test_cuda_train_step_equals_cpu(cuda_device, fuse, chunk):
    from repro_torch.kernels import ops
    cfg, ta, x, y, *_ = _train_problem(21, 19, 3, 11, 4)
    want = ops.tm_train_step_kernel(cfg, ta, x, y, 9, chunk, fuse=fuse)
    got = ops.tm_train_step_kernel(cfg, ta.to(cuda_device), x.to(cuda_device),
                                   y.to(cuda_device), 9, chunk, fuse=fuse)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert int(want[1].abs().sum()) > 0


# -- the BNN baseline's and the LM substrate's kernels ----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,O,W,pad", [(4, 6, 2, 0), (33, 65, 4, 13), (128, 256, 8, 31),
                                       (1000, 256, 25, 16), (3, 10, 8, 0)])
def test_cuda_xnor_popcount_equals_plain(cuda_device, B, O, W, pad):
    from repro_torch.kernels import xnor_popcount
    rng = np.random.default_rng(B)
    n_bits = W * 32 - pad
    a = packetizer.pack_bits(torch.from_numpy(rng.integers(0, 2, (B, n_bits), dtype=np.uint8)))
    w = packetizer.pack_bits(torch.from_numpy(rng.integers(0, 2, (O, n_bits), dtype=np.uint8)))
    want = xnor_popcount.xnor_popcount_plain(a, w, n_bits)
    got = xnor_popcount.xnor_popcount_cuda(a.to(cuda_device), w.to(cuda_device), n_bits)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _pad_ones(words, n_bits):
    """Set the bits of the last word past ``n_bits`` (int32 bit patterns)."""
    if n_bits % 32:
        words = words.clone()
        words[:, -1] |= torch.tensor(~((1 << (n_bits % 32)) - 1) & 0xFFFFFFFF,
                                     dtype=torch.int64).to(torch.int32)
    return words


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 15, 17, 64, 10000])
@pytest.mark.parametrize("O", [1, 8, 10, 256, 257])
def test_cuda_xnor_popcount_shapes_and_pads(cuda_device, B, O):
    """The tensor-core kernel at every edge the wrapper takes: B not a
    multiple of a block's samples, O past a block's 256 outputs or not a
    multiple of 4, one word, a ragged last word (pad 31), pad bits set in
    both operands (they agree, so the plain version counts them as
    matches), and W past one 32-word slab (40, 70) at two batch sizes."""
    from repro_torch.kernels import xnor_popcount
    rng = np.random.default_rng(B * 1000 + O)
    for W in (1, 8, 25, 26) + ((40, 70) if B in (17, 10000) else ()):
        for pad, ones in ((0, False), (31, False), (31, True), (13, True)):
            n_bits = W * 32 - pad
            a = packetizer.pack_bits(torch.from_numpy(
                rng.integers(0, 2, (B, n_bits), dtype=np.uint8))).to(cuda_device)
            w = packetizer.pack_bits(torch.from_numpy(
                rng.integers(0, 2, (O, n_bits), dtype=np.uint8))).to(cuda_device)
            if ones:
                a, w = _pad_ones(a, n_bits), _pad_ones(w, n_bits)
            want = xnor_popcount.xnor_popcount_plain(a, w, n_bits)
            got = xnor_popcount.xnor_popcount_cuda(a, w, n_bits)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (W, pad, ones)


@pytest.mark.cuda
def test_cuda_xnor_popcount_occupancy(cuda_device):
    """The BNN's layers: 48 samples x 256 outputs a block at O 256 (one wave
    at B 10,000), 256 x 32 at O 10, one block column, no spills."""
    from repro_torch.kernels import xnor_popcount
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for O in (256, 10):
        occ = xnor_popcount.occupancy(10000, O, 8)
        assert (occ["grid_x"], occ["grid_y"]) == (-(-10000 // occ["block_rows"]), 1), occ
        assert (occ["warp_cols"], occ["block_rows"]) == ((8, 48) if O == 256 else (1, 256)), occ
        assert occ["grid_x"] <= occ["blocks_per_sm"] * sms and occ["local_bytes"] == 0, occ


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 64, 65, 512, 1030])
@pytest.mark.parametrize("C", [1, 15, 16, 2000, 2048, 2049])
def test_cuda_class_sum_shapes_and_byte_types(cuda_device, B, C):
    """class_sum against its plain version (on the CPU) at every K tiling
    (1, 10, 16, 17, 32 classes), general votes up to +-2^20, fired as int8
    and as uint8; then arbitrary bytes (signed and not) with smaller votes."""
    from repro_torch.kernels import class_sum
    rng = np.random.default_rng(B * 10000 + C)
    for K in (1, 10, 16, 17, 32):
        votes = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20 + 1, (C, K), dtype=np.int32))
        fired = torch.from_numpy(rng.integers(0, 2, (B, C), dtype=np.int8))
        for dt in (torch.int8, torch.uint8):
            want = class_sum.class_sum_plain(fired.to(dt), votes)
            got = class_sum.class_sum(fired.to(dt).to(cuda_device), votes.to(cuda_device))
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    votes = torch.from_numpy(rng.integers(-2 ** 10, 2 ** 10 + 1, (C, 10), dtype=np.int32))
    raw = rng.integers(0, 256, (B, C), dtype=np.uint8)
    for f in (torch.from_numpy(raw), torch.from_numpy(raw.view(np.int8))):
        want = class_sum.class_sum_plain(f, votes)
        got = class_sum.class_sum(f.to(cuda_device), votes.to(cuda_device))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_cuda_class_sum_occupancy(cuda_device):
    """The unfused training step's shape (B 64, 2048 clauses) splits the
    clause axis over a cluster, so the grid covers more than 64 SMs; no
    spills."""
    from repro_torch.kernels import class_sum
    occ = class_sum.occupancy(64, 2048, 10)
    assert occ["split"] > 1 and occ["grid_x"] > 64, occ
    assert occ["grid_x"] == occ["split"] * -(-64 // occ["samples_per_block"]), occ
    assert occ["blocks_per_sm"] >= 1 and occ["local_bytes"] == 0, occ


@pytest.mark.cuda
def test_cuda_bnn_predict_equals_cpu(cuda_device):
    from repro_torch.baselines import bnn
    cfg = bnn.BNNConfig()
    params = bnn.bnn_init(cfg, torch.Generator().manual_seed(3), "cpu")
    packed = bnn.bnn_pack(params)
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 2, (300, 784), dtype=np.uint8))
    want = bnn.bnn_layer_dots(packed, x)
    got = bnn.bnn_layer_dots([(w.to(cuda_device), n) for w, n in packed], x.to(cuda_device))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


def flash_bf16_tolerance(v, want):
    """The two versions round the unnormalized probabilities to bf16 against
    different running maxima (each rounding <= 2^-8 relative, so the
    weights differ by <= 2^-7 of the row's sum, times at most max|v|), and
    round the output to bf16 (one unit in the last place <= 2^-7 x |out|)."""
    return 2 ** -7 * (float(v.abs().max()) + float(want.abs().max()))


def flash_bf16_elem_tolerance(fa, q, k, v, want, causal):
    """Per output element: the output's bf16 rounding on both sides (<= 2^-7
    x |out| together) and p's (<= 2^-7 of the p-weighted mean of |v|, the
    plain version's attention over |v| in float32), with 2^-6 of that for
    the float32 sums and the kernel's ex2.approx."""
    w = fa.flash_forward_plain(q.float(), k.float(), v.float().abs(), causal=causal)
    return 2 ** -7 * (1 + 2 ** -6) * (want.abs() + w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (2, 64, 64, 3, 3, 16, True), (1, 128, 128, 2, 2, 32, False),
    (2, 100, 100, 4, 2, 20, True), (1, 64, 130, 4, 1, 64, True),
    (2, 256, 256, 8, 2, 64, True), (1, 192, 192, 4, 4, 128, True),
    (1, 70, 40, 2, 1, 64, False),
    (2, 1024, 1024, 32, 4, 64, True),      # tinyllama's grouping
    (1, 512, 512, 16, 2, 128, True),       # hd 128, 8 query heads per kv head
    (1, 1000, 1000, 4, 2, 64, True),       # ragged: neither tile divides S
    (2, 1, 1, 4, 2, 64, True), (1, 17, 17, 4, 4, 32, True),   # under one tile
    (1, 48, 48, 2, 1, 12, True), (1, 80, 80, 4, 2, 20, False)])   # padded hd
def test_cuda_flash_forward_equals_plain(cuda_device, dtype, B, S, T, H, K, hd, causal):
    """Float32 (the CUDA-core kernel): atol 2e-5, as the reference holds its
    kernel to flash_ref (tests/test_kernels.py); bf16 (the tensor-core
    kernel): flash_bf16_tolerance on the whole tensor and
    flash_bf16_elem_tolerance on each element."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(S + T + hd)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32)).to(dt)
    k = torch.from_numpy(rng.normal(size=(B, T, K, hd)).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.normal(size=(B, T, K, hd)).astype(np.float32)).to(dt)
    g = [t.to(cuda_device) for t in (q, k, v)]
    want = fa.flash_forward_plain(*g, causal=causal).float()
    got = fa.flash_forward_cuda(*g, causal=causal).float()
    tol = 2e-5 if dtype == "float32" else flash_bf16_tolerance(g[2].float(), want)
    assert float((got - want).abs().max()) <= tol
    if dtype == "bfloat16":
        elem_tol = flash_bf16_elem_tolerance(fa, *g, want, causal)
        assert bool(((got - want).abs() <= elem_tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,dv,causal", [
    (1, 256, 4, 4, 192, 128, True),       # DeepSeek-V2's MLA: 128 + 64 over 128
    (2, 200, 4, 2, 192, 128, True),       # ragged, grouped
    (1, 130, 2, 2, 160, 96, False),       # padded to (192, 128)
    (2, 100, 4, 4, 24, 16, True),         # the MLA smoke widths
    (1, 64, 2, 1, 64, 40, True), (1, 70, 3, 3, 128, 64, True)])
def test_cuda_flash_qk_wider_than_v_equals_plain(cuda_device, dtype, B, S, H, K, hd, dv,
                                                 causal):
    """qk width hd over a narrower v width dv: the output (B, S, H, dv) and,
    causal, each row's lse against the plain version, at the tolerances of
    test_cuda_flash_forward_equals_plain and test_cuda_flash_lse_equals_plain;
    with or without the lse pointer, the same bits."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(S + hd + dv)
    dt = getattr(torch, dtype)
    g = [torch.from_numpy(rng.normal(size=(B, S, h, w)).astype(np.float32)).to(dt)
         .to(cuda_device) for h, w in ((H, hd), (K, hd), (K, dv))]
    want = fa.flash_forward_plain(*g, causal=causal).float()
    got = fa.flash_forward_cuda(*g, causal=causal)
    assert got.shape == (B, S, H, dv) and got.dtype == dt
    diff = (got.float() - want).abs()
    tol = 2e-5 if dtype == "float32" else flash_bf16_tolerance(g[2].float(), want)
    assert float(diff.max()) <= tol
    if dtype == "bfloat16":
        assert bool((diff <= flash_bf16_elem_tolerance(fa, *g, want, causal)).all())
    if causal:
        out, lse = fa.flash_forward_cuda(*g, return_lse=True)
        _, want_lse = fa.flash_forward_plain(*g, return_lse=True)
        assert torch.equal(out, got)
        assert float((lse - want_lse).abs().max()) <= (2e-5 if dtype == "float32"
                                                       else LSE_BF16_ATOL)


@pytest.mark.cuda
def test_cuda_flash_forward_counts_each_kernel(cuda_device):
    """bf16 goes to the tensor-core kernel and float32 to the CUDA-core one,
    each counted; other types and head widths the kernels do not take
    (``flash_attention.takes``) raise."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(0)
    shapes = ((1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32))
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
            for s in shapes]
    names = ("launches", "launches_wgmma", "launches_simt")
    for dtype, counter in ((torch.bfloat16, "launches_wgmma"),
                           (torch.float32, "launches_simt")):
        before = {n: getattr(fa, n) for n in names}
        fa.flash_forward(*(t.to(dtype) for t in base))
        torch.cuda.synchronize()
        moved = {n: getattr(fa, n) - before[n] for n in names}
        assert moved == {n: int(n in ("launches", counter)) for n in names}
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_forward(*(t.to(torch.float16) for t in base))
    wide = [torch.zeros(1, 8, 2, 160, dtype=torch.bfloat16, device=cuda_device)] * 3
    with pytest.raises(ValueError, match="hd <= 128"):
        fa.flash_forward(*wide)
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="hd <= 128"):      # v wider than q and k
        fa.flash_forward(q, q, torch.zeros(1, 8, 2, 24, dtype=torch.bfloat16,
                                           device=cuda_device))


# bf16 lse: both versions read the same bf16 inputs and sum the scores and
# l in float32 in other orders, the kernel with ex2.approx (relative error
# under 2^-22): a few float32 units of lse, far under 1e-3
LSE_BF16_ATOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd", [
    (2, 64, 3, 3, 16), (2, 100, 4, 2, 20), (2, 256, 8, 2, 64), (1, 192, 4, 4, 128),
    (1, 1000, 4, 2, 64), (2, 1, 4, 2, 64), (1, 48, 2, 1, 12)])
def test_cuda_flash_lse_equals_plain(cuda_device, dtype, B, S, H, K, hd):
    """The kernels' lse output (causal self-attention, the training
    forward) against the plain version's: float32 atol 2e-5, bf16
    ``LSE_BF16_ATOL``; the output to the forward's tolerances and, with or
    without the lse pointer, the same bits."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(S + H + hd)
    dt = getattr(torch, dtype)
    g = [torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32)).to(dt)
         .to(cuda_device) for h in (H, K, K)]
    out, lse = fa.flash_forward_cuda(*g, return_lse=True)
    want, want_lse = fa.flash_forward_plain(*g, return_lse=True)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    assert torch.equal(out, fa.flash_forward_cuda(*g))
    tol = 2e-5 if dtype == "float32" else flash_bf16_tolerance(g[2].float(), want.float())
    assert float((out.float() - want.float()).abs().max()) <= tol
    assert float((lse - want_lse).abs().max()) <= (2e-5 if dtype == "float32"
                                                   else LSE_BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-large", "deepseek-v2-236b"])
def test_cuda_lm_train_step_equals_cpu(cuda_device, arch):
    """One train step of the float32 smoke LM on the card (the CUDA-core
    flash kernel with its lse in every layer's forward and again in the
    remat recompute) against the CPU (the chunked route) from the same
    weights and batch: loss atol 1e-5, grad_norm rtol 1e-5, params atol
    5e-6 (AdamW eps 1e-3, as tests/test_torch_lm_train.py states why).
    deepseek-v2's smoke attends with MLA's qk width 24 over v width 16."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import steps, transformer
    from repro_torch.optim import adamw
    cfg = get_smoke_config(arch)
    batch = lm_batch(cfg, np.random.default_rng(2), 4, 64)
    step = steps.make_train_step(cfg, opt_cfg=adamw.AdamWConfig(
        lr=1e-2, warmup_steps=1, eps=1e-3))
    res = []
    for dev in ("cpu", cuda_device):
        model = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
        opt = adamw.adamw_init(model.parameters())
        n0 = fa.launches
        opt, info = step(model, opt, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        res.append((info, [p.detach().cpu() for p in model.parameters()], fa.launches - n0))
    (ci, cp, cn), (gi, gp, gn) = res
    assert cn == 0 and gn == 2 * cfg.n_layers
    np.testing.assert_allclose(float(gi["loss"]), float(ci["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(gi["grad_norm"]), float(ci["grad_norm"]), rtol=1e-5)
    for a, b in zip(gp, cp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "smollm-360m", "deepseek-v2-236b",
                                  "qwen3-moe-235b-a22b", "recurrentgemma-2b", "xlstm-1.3b"])
def test_cuda_lm_prefill_decode_equal_cpu(cuda_device, arch):
    """The smoke LM on the card (flash kernel in the prefill of each global
    attention layer) against the CPU (chunked online softmax), float32,
    atol 1e-4 on the logits: the same function with sums in other orders;
    greedy tokens identical.  recurrentgemma's layers are recurrent or
    local (windowed: the chunked route on the card too), so it launches no
    flash kernel; xlstm has no attention."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import steps, transformer
    cfg = get_smoke_config(arch)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 20)))
    outs = []
    for dev in ("cpu", cuda_device):
        m = model.to(dev)
        n0 = fa.launches
        caches = m.init_caches(3, 32)
        logits, caches = prefill(m, {"tokens": toks.to(dev)}, caches)
        seq = [logits.cpu()]
        tok = logits.argmax(-1)[:, None]
        for i in range(6):
            logits, caches = decode(m, caches, {"tokens": tok}, 20 + i)
            seq.append(logits.cpu())
            tok = logits.argmax(-1)[:, None]
        outs.append((seq, fa.launches - n0))
    (cpu, n_cpu), (gpu, n_gpu) = outs
    assert n_cpu == 0 and n_gpu == sum(kind == "attn" for kind in cfg.layer_kinds)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(a.argmax(-1).numpy(), b.argmax(-1).numpy())


def _online_pair(dev, threshold):
    """An updater on the CPU and one on ``dev`` from the same bank, each
    over its own zoo, promoting at once."""
    from repro_torch.runtime import online
    from repro_torch.runtime.zoo import ArtifactZoo

    cfg = tm.TMConfig(n_features=48, n_classes=4, clauses_per_class=24,
                      threshold=10, s=5.0, clause_pad_multiple=32)
    rng = np.random.default_rng(3)
    ta = rng.integers(-40, 12, (cfg.n_clauses_total, cfg.n_literals)).astype(np.int8)
    ta[cfg.n_clauses_raw:] = -cfg.n_states
    out = []
    for d in ("cpu", dev):
        compiled = compiler.compile_tm(cfg, ta)
        compiled.schedule()
        zoo = ArtifactZoo(lambda t, c=compiled: ({"compiled": c}, 1))
        out.append(online.OnlineUpdater(
            cfg, torch.from_numpy(ta.copy()).to(d), compiled,
            cfg=online.OnlineConfig(drift_threshold=threshold, batch_size=64,
                                    swap_policy="immediate"),
            zoo=zoo, clock=lambda: 0.0))
    return cfg, out


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_cuda_online_steps_and_promotions_equal_cpu(cuda_device, threshold):
    """Online steps on the card (fused_infer then fused_train) end on the
    CPU plain versions' bank after every step, with equal health and
    promoted artifacts; the promoted artifact's kernel sums equal the
    oracle on both schedule kernels."""
    from repro_torch.kernels import fused_train, sparse_infer, term_infer

    cfg, (cpu, gpu) = _online_pair(cuda_device, threshold)
    rng = np.random.default_rng(4)
    n0 = fused_train.launches
    for step in range(6):
        X = rng.integers(0, 2, (64, cfg.n_features)).astype(np.uint8)
        y = rng.integers(0, cfg.n_classes, 64).astype(np.int32)
        for upd in (cpu, gpu):
            for i in range(64):
                upd.ingest(X[i], int(y[i]))
            assert upd.step()
        np.testing.assert_array_equal(gpu.bank.cpu().numpy(), cpu.bank.numpy(),
                                      err_msg=f"step {step}")
        assert gpu.health() == cpu.health()
        for f in ("include_words", "word_ids", "votes"):
            np.testing.assert_array_equal(getattr(gpu.deployed, f),
                                          getattr(cpu.deployed, f))
    assert fused_train.launches - n0 == 6
    assert gpu.promotions >= 1
    dep = gpu.deployed
    assert str(cuda_device) in dep._dev        # warmed before the swap
    x = packetizer.pack_literals(torch.from_numpy(
        rng.integers(0, 2, (512, cfg.n_features)).astype(np.uint8))).to(cuda_device)
    oracle = compiler.run_compiled(dep, x, engine="oracle")
    n_s, n_t = sparse_infer.launches, term_infer.launches
    for eng in ("factorized", "sparse"):
        got = compiler.run_compiled(dep, x, engine=eng)
        np.testing.assert_array_equal(got.cpu().numpy(), oracle.cpu().numpy(), err_msg=eng)
    assert sparse_infer.launches > n_s and term_infer.launches > n_t


# -- the autotuner's launches (kernels/autotune.py) ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64, 65, 512, 1030])
def test_cuda_fused_infer_every_split_equals_plain(cuda_device, B):
    """fused_infer at each word split the autotuner can pick (1, 2, 4 warps
    a pair's words: blocks of 32 x 64, 32 x 32, 32 x 16) against its plain
    version, tolerance 0, masked and unmasked, ragged clause and word
    edges; occupancy reports the grid of the split it was given."""
    from repro_torch.kernels import fused_infer
    g = lambda t: t.to(cuda_device)
    for C in (1, 2000, 2049):
        for W in (1, 49, 513):
            lit, inc = (g(t) for t in _chain_problem(B, C, W, B + C + W))
            rng = np.random.default_rng(C + W)
            votes = g(torch.from_numpy(rng.integers(-3, 4, (C, 10)).astype(np.int32)))
            ne = g(torch.from_numpy(rng.integers(0, 2, C).astype(np.int32)))
            for nonempty in (ne, None):
                want = fused_infer.fused_forward_plain(
                    lit, inc, votes, torch.ones_like(ne) if nonempty is None else nonempty)
                for split in fused_infer.SPLITS:
                    got = fused_infer.fused_tm_forward(lit, inc, votes, nonempty,
                                                       **fused_infer.blocks_for(split, W))
                    np.testing.assert_array_equal(
                        got.cpu().numpy(), want.cpu().numpy(),
                        err_msg=f"B={B} C={C} W={W} split={split}")
    for split in fused_infer.SPLITS:
        occ = fused_infer.occupancy(B, 2000, split)
        assert occ["word_split"] == split, occ
        assert (occ["grid_x"], occ["grid_y"]) == (-(-B // 32), -(-2000 // (64 // split))), occ
        assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,K,cpc,pad,p", [
    _case(13, 17, 3, 7, 1), _case(97, 784, 10, 200, 256),
    _case(3, 8200, 2, 8, 1),                                  # W = 513 words
    _case(64, 784, 10, 200, 1, 1.0, "saturated-tm-mnist"),
    _case(1030, 12, 3, 6, 1, 1.0, "saturated-1030"),
    _case(70, 33, 3, 9, 1, 1.0, "odd-L-ragged-C"),           # C = 27: ragged at 2, 4, 8
])
def test_cuda_fused_train_every_clause_count_equals_plain(cuda_device, B, F, K, cpc, pad, p):
    """fused_train at 2, 4 and 8 clauses a block (the autotuner's block_c)
    against its plain version, tolerance 0, with offsets and a clause
    shard; occupancy reports the launch it was given."""
    from repro_torch.kernels import fused_train
    cfg, ta, x, y, lits, lw, iw = _train_problem(B, F, K, cpc, B + 1, pad)
    C, W = cfg.n_clauses_total, lw.shape[1]
    g = lambda t: t.to(cuda_device) if torch.is_tensor(t) else t
    for b_off, c_off, n_loc, c_total in [(0, 0, C, None), (2 ** 32 - 3, C // 2, C - C // 2, C)]:
        sl = slice(c_off, c_off + n_loc)
        args = _fused_inputs(cfg, ta, y, lits, lw, iw, 56, b_off, c_off, sl)
        if p is not None:
            args = args[:6] + (torch.full((B,), p), torch.full((B,), p)) + args[8:]
        kw = dict(p_act=1.0, p_inact=0.25, b_offset=b_off, c_offset=c_off, c_total=c_total)
        want = fused_train.fused_tm_train_delta(*args, **kw).numpy()
        for clauses in fused_train.CLAUSES_A_BLOCK:
            got = fused_train.fused_tm_train_delta(
                *[g(a) for a in args], **kw, **fused_train.blocks_for(clauses, B, W))
            np.testing.assert_array_equal(got.cpu().numpy(), want,
                                          err_msg=f"clauses={clauses} c_off={c_off}")
    for clauses in fused_train.CLAUSES_A_BLOCK:
        occ = fused_train.occupancy(B, cfg.n_literals, W, clauses)
        assert occ["clauses_per_block"] == clauses, occ
        assert occ["segment_samples"] == fused_train.segment(B, W), occ
        assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


@pytest.mark.cuda
@pytest.mark.parametrize("case,B", [("asset", 1), ("asset", 97), ("asset", 512),
                                    ("asset", 1030), ("empty_clause", 97),
                                    ("long_clause", 33), ("ragged_U", 513), ("k32", 70)])
def test_cuda_schedule_walks_every_slab_equal_plain(cuda_device, case, B):
    """Both schedule kernels at 1, 2, 4 and 8 sample words a block (the
    autotuner's block_s) against their plain versions, tolerance 0, exact
    and early exit, at two tilings; occupancy reports the slab's grid."""
    from repro_torch.kernels import anytime, sparse_infer, term_infer
    if case == "asset":
        comp = compiler.CompiledTM.load(ASSET)
        iw, votes = comp.include_words, np.asarray(comp.votes, np.int32)
    else:
        iw, votes = _schedule_bank(case)
    lit = _requests("random", B, iw.shape[1], B).to(cuda_device)
    v = torch.from_numpy(votes).to(cuda_device)
    for tiling in (dict(), dict(block_c=256, block_j=16)):
        sched = sparse_infer.build_schedule(iw, **tiling)
        fs = term_infer.build_factorized_schedule(iw, **tiling)
        sm = torch.from_numpy(anytime.sparse_tile_margins(sched, votes).astype(np.int32))
        fm = torch.from_numpy(anytime.factorized_tile_margins(fs, votes).astype(np.int32))
        for margin_on in (False, True):
            for slab in sparse_infer.SLAB_WORDS:
                for mod, s, m in ((sparse_infer, sched, sm), (term_infer, fs, fm)):
                    fwd = (sparse_infer.sparse_tm_forward if mod is sparse_infer
                           else term_infer.factorized_tm_forward)
                    tm_ = m.to(cuda_device) if margin_on else None
                    want = fwd(lit.cpu(), v.cpu(), s, tile_margin=m if margin_on else None)
                    got = fwd(lit, v, s, tile_margin=tm_, block_s=slab)
                    np.testing.assert_array_equal(
                        got.cpu().numpy(), want.numpy(),
                        err_msg=f"{mod.__name__} {tiling} slab={slab} early={margin_on}")
    for mod in (sparse_infer, term_infer):
        for slab in sparse_infer.SLAB_WORDS:
            occ = mod.occupancy(B, 4, 512, 10, block_s=slab)
            assert occ["grid_y"] == -(-(-(-B // 32)) // slab), occ
            assert occ["grid_x"] == 4 * -(-512 // (256 // slab)), occ
            assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


# -- the slab-resident factorized walk (term_infer.cu: slab_term_eval_kernel) ---

BENCH_ASSETS = {name: os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "tmbench", "assets", f)
                for name, f in (("mnist", "tm_mnist_10k_e1.npz"),
                                ("cifar2", "tm_cifar2_e1.npz"))}


@contextlib.contextmanager
def _slab_spans():
    """Under the autograd profiler in its NVTX mode (the spans record
    under any profiler; this one starts no kineto session: after the
    kineto sessions of the wide-bank cases, a later CUDA trace in the same
    process recorded no device kernels), a function ``once(fn, *args,
    calls=1, **kw)`` -> fn's result, holding that the call made `calls`
    factorized launches and took the slab design in each (the span
    term_infer.slab once a launch)."""
    from repro_torch import spans
    from repro_torch.kernels import term_infer

    def once(fn, *args, calls=1, **kw):
        n0 = term_infer.launches
        s0 = spans.totals().get(term_infer.SLAB_RANGE, (0, 0))[0]
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert term_infer.launches - n0 == calls
        assert spans.totals().get(term_infer.SLAB_RANGE, (0, 0))[0] - s0 == calls
        return got

    spans.reset()
    with torch.autograd.profiler.emit_nvtx():
        yield once


def _dataset_literals(comp, name, B, seed):
    """(B, W) packed literals of the port's synthetic dataset of `name`'s
    widths, and their (B, Wa) words gathered to the artifact's active words."""
    from repro_torch.data.synthetic import paper_dataset
    X, _, _, _ = paper_dataset(name, n_train=B, n_test=0, seed=seed)
    lit = packetizer.pack_literals(torch.from_numpy(X))
    return lit, lit[:, torch.from_numpy(np.asarray(comp.word_ids, np.int64))].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mnist", "cifar2"])
@pytest.mark.parametrize("B", [65536, 65519])
def test_cuda_slab_walk_equals_plain_on_benchmark_artifacts(cuda_device, name, B):
    """The benchmark's artifacts at its batch and a ragged one, through the
    schedule wrapper and through run_compiled: one launch, the slab design,
    the plain version's sums at tolerance 0."""
    from repro_torch.kernels import term_infer
    comp = compiler.CompiledTM.load(BENCH_ASSETS[name])
    x, lit = _dataset_literals(comp, name, B, B)
    v = torch.from_numpy(np.asarray(comp.votes, np.int32))
    fs = comp.factorized_schedule()
    want = term_infer.factorized_tm_forward(lit, v, fs)
    assert 0 < int((want != 0).sum()) < want.numel()
    # votes of 13 bit planes (they fit beside tm-mnist's tables at 4 sample
    # words a CTA) and of 22 (they do not: the rule takes 2)
    scales = (3000, 1 << 20) if name == "mnist" and B == 65519 else ()
    wants = [term_infer.factorized_tm_forward(lit, v * scale, fs) for scale in scales]
    lit_d, v_d = lit.to(cuda_device), v.to(cuda_device)
    with _slab_spans() as once:
        got = once(term_infer.factorized_tm_forward, lit_d, v_d, fs)
        got_run = once(compiler.run_compiled, comp, x.to(cuda_device), engine="factorized")
        got_scaled = [once(term_infer.factorized_tm_forward, lit_d, v_d * scale, fs)
                      for scale in scales]
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(got_run.cpu().numpy(), want.numpy())
    for scale, w, g in zip(scales, wants, got_scaled):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=str(scale))


def _wide_bank(W, K, U, seed, long_every=0):
    """(include words (U, W) uint32, votes (U, K)): 1-8 include bits a
    clause over W words, every 13th clause empty (fires everywhere), and
    with `long_every` every such clause 150 bits long (many tiles)."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((U, W * 32), np.uint8)
    for c in range(U):
        bits[c, rng.choice(W * 32, rng.integers(1, 9), replace=False)] = 1
        if long_every and c % long_every == 5:
            bits[c, rng.choice(W * 32, 150, replace=False)] = 1
    bits[::13] = 0
    iw = packetizer.pack_bits_np(bits).view(np.uint32)
    return iw, rng.integers(-4, 5, (U, K)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("W,K,tiling", [(70, 2, dict()), (70, 10, dict(block_c=64, block_j=8)),
                                        (97, 32, dict()), (65, 10, dict(block_c=8, block_j=4))])
def test_cuda_slab_walk_equals_plain_on_wide_banks(cuda_device, W, K, tiling):
    """Banks past 64 literal words at K 2, 10 and 32, chains longer than one
    tile, every prefix of a budgeted schedule that leaves a clause block
    unclosed (it must add nothing) and tiles in reverse order: the slab
    design against the plain version, tolerance 0, one launch a call."""
    from repro_torch.kernels import anytime, term_infer
    iw, votes = _wide_bank(W, K, 700, W + K, long_every=37)
    B = 48000
    lit = _requests("random", B, W, W).to(cuda_device)
    v = torch.from_numpy(votes).to(cuda_device)
    fs = term_infer.build_factorized_schedule(iw, **tiling)
    assert int(fs.counts.max()) > 1                     # a chain past one tile
    schedules = [fs]
    for n in range(fs.n_term_tiles + 1, fs.n_tiles, max(1, fs.n_tiles // 6)):
        ps = anytime.factorized_prefix_schedule(fs, n)
        t1 = ps.n_term_tiles + ps.indptr[1:]
        if ((t1 > ps.n_term_tiles + ps.indptr[:-1]) & (ps.tile_last[t1 - 1] != 1)).any():
            schedules.append(ps)                          # a block left unclosed
    assert len(schedules) > 1
    wants = [term_infer.factorized_tm_forward(lit.cpu(), v.cpu(), s) for s in schedules]
    t = fs.tensors(cuda_device)
    tiles = t["tiles"].clone()
    for cb in range(fs.n_cblocks):
        lo = fs.n_term_tiles + int(fs.indptr[cb])
        hi = fs.n_term_tiles + int(fs.indptr[cb + 1])
        tiles[3, lo:hi] = tiles[3, lo:hi].flip(0)
    args = (lit, t["term_chain"], t["clause_chain"], v, tiles, t["indptr"])
    kw = dict(block_c=fs.block_c, block_j=fs.block_j, n_term_tiles=fs.n_term_tiles)
    want_rev = term_infer.factorized_tables_plain(*(a.cpu() for a in args), **kw)
    with _slab_spans() as once:
        gots = [once(term_infer.factorized_tm_forward, lit, v, s) for s in schedules]
        got_rev = once(term_infer.factorized_tables_cuda, *args, **kw)
    for s, want, got in zip(schedules, wants, gots):
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=f"{s.n_tiles}/{fs.n_tiles} tiles")
    np.testing.assert_array_equal(got_rev.cpu().numpy(), want_rev.numpy(),
                                  err_msg="tiles reversed")


@pytest.mark.cuda
def test_cuda_slab_walk_clause_sharded_equals_unsharded(card_mesh, cuda_device):
    """The stacked clause-sharded forward on the tm-mnist benchmark artifact
    at 65,536 samples: each shard's call is one slab launch, and the psum
    of the shards equals the unsharded sums."""
    from repro_torch.core import sharding
    from repro_torch.kernels import term_infer
    comp = compiler.CompiledTM.load(BENCH_ASSETS["mnist"])
    mesh = card_mesh("model=2")
    xw = _dataset_literals(comp, "mnist", 65536, 5)[1].to(cuda_device)
    v = torch.from_numpy(np.asarray(comp.votes, np.int32))
    want = term_infer.factorized_tm_forward(xw.cpu(), v, comp.factorized_schedule())
    fs, *stacks, _ = term_infer.stack_shard_factorized(comp.include_words, comp.votes, 2)
    fwd = sharding.sharded_factorized_forward_fn(mesh, block_t=fs[0].block_t,
                                                 block_c=fs[0].block_c, block_j=fs[0].block_j)
    tabs = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in stacks]
    with _slab_spans() as once:
        got = once(fwd, *tabs, xw, calls=mesh.size)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_cuda_slab_choice_and_ptxas_figures(cuda_device):
    """At the benchmark's shapes the card's limits pick 4 sample words a
    CTA (2 for votes of 22 bit planes), the serve bucket keeps the three
    launches, and no instance of the slab kernel spills (ptxas)."""
    import re

    from repro_torch.kernels import _build, term_infer
    sms, shared = term_infer._limits(cuda_device)
    assert sms >= 100 and shared >= 227 * 1024
    for name in ("mnist", "cifar2"):
        comp = compiler.CompiledTM.load(BENCH_ASSETS[name])
        fs = comp.factorized_schedule()
        (U, W), K = comp.include_words.shape, comp.votes.shape[1]
        Tp = fs.term_chain.shape[0]
        n_planes = term_infer.vote_planes(
            torch.from_numpy(np.asarray(comp.votes, np.int32)).to(cuda_device))[1]
        pick = dict(tile_margin=None, block_s=None, sm_count=sms, shared_bytes=shared)
        shape = (W, Tp, K, U, fs.n_cblocks)
        assert n_planes == 2
        assert term_infer.slab_words_for(65536, *shape, n_planes, **pick) == 4
        assert term_infer.slab_words_for(512, *shape, n_planes, **pick) == 0
        if name == "mnist":
            assert term_infer.slab_words_for(65536, *shape, 22, **pick) == 2
    _build.build()
    entries = [e for e in _build.build_log("term_infer").split("Compiling entry function")
               if "slab_term_eval_kernel" in e.split("\n")[0]]
    assert len(entries) == len(term_infer.SLAB_SIZES), entries
    for e in entries:
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        assert spills and spills.groups() == ("0", "0"), e


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_infer", "fused_train", "sparse_infer",
                                    "term_infer"])
def test_cuda_every_autotune_candidate_equals_plain(cuda_device, kernel, tmp_path,
                                                    monkeypatch):
    """Every candidate of each registry, at its default grid, launched by
    the tuner's own timed runs, against the plain version on the same
    inputs, tolerance 0; then a sweep on the card records torch-cuda
    observations and a winner that is one of the candidates."""
    from repro_torch.kernels import autotune, cost_model
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_DATA", str(tmp_path / "td.json"))
    cost_model._invalidate_model_cache()
    comp = compiler.CompiledTM.load(ASSET)
    shapes = dict(fused_infer=[dict(B=B, C=2000, W=49, K=10) for B in (1, 64, 512)],
                  fused_train=[dict(B=B, C=2000, W=49, L=1568, K=10) for B in (1, 64)],
                  sparse_infer=[dict(B=B, K=10, include_words=comp.include_words)
                                for B in (33, 512)],
                  term_infer=[dict(B=B, K=10, include_words=comp.include_words)
                              for B in (33, 512)])[kernel]
    tuner = autotune._REGISTRY[kernel]
    for shape in shapes:
        problem = tuner.prepare(**shape)
        clipped = tuner.clip(tuner.default_candidates, problem)
        assert len(clipped) >= 2
        runs = tuner.make_runs(problem, clipped, cuda_device)
        cpu_runs = tuner.make_runs(problem, clipped[:1], torch.device("cpu"))
        want = next(iter(cpu_runs.values()))().numpy()
        for cand, run in runs.items():
            np.testing.assert_array_equal(run().cpu().numpy(), want,
                                          err_msg=f"{kernel} {shape.get('B')} {cand}")
    before = autotune.TIMING_RUNS
    best = autotune.tune(kernel, device=cuda_device, policy="sweep", reps=1, **shapes[-1])
    assert autotune.TIMING_RUNS > before
    rows = cost_model.load_observations()
    assert rows and all(r["mode"] == "torch-cuda" for r in rows)
    assert best in [r["blocks"] for r in rows]


# -- the jax.random trainer's draws and the matmul step on the card ------------------

@pytest.mark.cuda
def test_cuda_prng_draws_equal_cpu(cuda_device):
    from repro_torch.core import prng

    key = prng.PRNGKey(7)
    keys = prng.split(key, 64)           # batched: 64 streams in one pass
    for k, fn in ((keys, lambda k: prng.split(k, 3)),
                  (keys, lambda k: prng.random_bits(k, 8, (5, 9))),
                  (keys, lambda k: prng.uniform(k, (200,))),
                  (keys, lambda k: prng.randint(k, (), 0, 9, torch.int32)),
                  (key, lambda k: prng.random_bits(k, 32, (200, 1568))),
                  (key, lambda k: prng.uniform(k, (200, 1568))),
                  (key, lambda k: prng.randint(k, (2000, 1568), -1, 1, torch.int8))):
        want = fn(k)
        got = fn(k.to(cuda_device))
        assert got.device.type == cuda_device.type
        assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    for n in (7, 70000):
        assert torch.equal(prng.permutation(key.to(cuda_device), n).cpu(),
                           prng.permutation(key, n))


@pytest.mark.cuda
@pytest.mark.parametrize("arch, B", [("tm-tiny", 40), ("tm-mnist", 64)])
def test_cuda_batch_feedback_delta_equals_cpu(cuda_device, arch, B):
    from repro_torch.configs.matador_tm import TM_CONFIGS
    from repro_torch.core import feedback, prng

    cfg = TM_CONFIGS[arch]
    rng = np.random.default_rng(B)
    ta = torch.from_numpy(rng.integers(-3, 3, (cfg.n_clauses_total, cfg.n_literals),
                                       dtype=np.int8))
    x = torch.from_numpy(rng.integers(0, 2, (B, cfg.n_features), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, B).astype(np.int32))
    for c in (cfg, cfg.replace(s=3.9, boost_true_positive=False)):
        want = feedback.batch_feedback_delta(c, ta, x, y, prng.PRNGKey(3))
        got = feedback.batch_feedback_delta(c, ta.to(cuda_device), x, y, prng.PRNGKey(3))
        assert got.device.type == cuda_device.type and int(want.abs().sum()) > 0
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, B", [("tm-tiny", 40), ("tm-mnist", 64)])
def test_cuda_tm_train_step_matmul_equals_cpu(cuda_device, arch, B):
    from repro_torch.configs.matador_tm import TM_CONFIGS
    from repro_torch.kernels import ops

    cfg = TM_CONFIGS[arch]
    rng = np.random.default_rng(B + 1)
    ta = torch.from_numpy(rng.integers(-3, 3, (cfg.n_clauses_total, cfg.n_literals),
                                       dtype=np.int8))
    x = torch.from_numpy(rng.integers(0, 2, (B, cfg.n_features), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, B).astype(np.int32))
    want_ta, want_d = ops.tm_train_step_matmul(cfg, ta, x, y, 5)
    got_ta, got_d = ops.tm_train_step_matmul(cfg, ta.to(cuda_device), x, y, 5)
    assert torch.equal(got_d.cpu(), want_d) and torch.equal(got_ta.cpu(), want_ta)


@pytest.mark.cuda
def test_cuda_serve_tm_trains_the_committed_asset(cuda_device, tmp_path):
    """``serve_tm`` with the README's flags trains tm-mnist on the card with
    the jax.random trainer and writes an artifact equal to the committed
    one, array for array and in its meta (but for the cost-model features
    and the checksum, which the port's artifacts hold without HLO terms)."""
    import json

    from repro_torch.kernels import term_infer
    from repro_torch.launch import serve

    path = str(tmp_path / "tm_mnist.npz")
    term_infer.launches = 0
    health, gw, *_ = serve.serve_tm(serve.build_parser().parse_args(
        ["--arch", "tm-mnist", "--device", "cuda", "--epochs", "1", "--n-train",
         "600", "--requests", "256", "--bucket", "256", "--artifact", path]))
    assert health["final_engine"] == "factorized" and gw["answered"] == 256
    assert term_infer.launches > 0
    got, want = np.load(path), np.load(ASSET)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k != "meta":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    metas = [json.loads(bytes(z["meta"]).decode()) for z in (got, want)]
    for m in metas:
        m.pop("features")
        m.pop("checksum")
    assert metas[0] == metas[1]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [5, 15, 50])
def test_cuda_feedback_probs_equal_cpu(cuda_device, T):
    """The hash-RNG step's selection probabilities (T -/+ sum) / 2T on the
    card equal the CPU's, bit for bit, over every clamped class sum."""
    from repro_torch.kernels import ops

    sums = torch.arange(-T, T + 1, dtype=torch.int32)[:, None].repeat(1, 3)
    y = (torch.arange(2 * T + 1) % 3).to(torch.int32)
    want = ops.feedback_probs(sums, y, 3, T, 11)
    got = ops.feedback_probs(sums.to(cuda_device), y.to(cuda_device), 3, T, 11)
    for a, b in zip(got, want):
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()


# -- the clause-sharded mesh (core/sharding.py) on one card ----------------------

@pytest.fixture
def card_mesh(cuda_device, monkeypatch):
    """Meshes of logical devices laid over the one card."""
    from repro_torch.launch import mesh

    monkeypatch.setenv(mesh.FORCE_ENV, "4")
    return lambda spec: mesh.parse_mesh_spec(spec, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["model=2", "model=4", "data=2,model=2"])
def test_cuda_sharded_forward_equals_unsharded(card_mesh, cuda_device, spec):
    """The three sharded forward builders launch their kernel once a shard
    (padded tile tables included: some shard walks fewer real tiles than the
    stack holds) and equal the unsharded kernels."""
    from repro_torch.core import sharding
    from repro_torch.kernels import fused_infer, sparse_infer, term_infer

    comp = _bank(48, 4, 40, 0.08, 3)
    mesh = card_mesh(spec)
    n = mesh.shape["model"]
    x = packetizer.pack_literals(torch.from_numpy(np.random.default_rng(4).integers(
        0, 2, (96, 48), dtype=np.uint8))).to(cuda_device)
    xw = x[:, comp.tensors(cuda_device)["word_ids"]]
    want = compiler.run_compiled(comp, x, engine="factorized")
    for eng in ("sparse", "dense"):
        np.testing.assert_array_equal(want.cpu().numpy(), compiler.run_compiled(
            comp, x, engine=eng).cpu().numpy())

    def t(stacks):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in stacks]

    fs, *fst, _ = term_infer.stack_shard_factorized(comp.include_words, comp.votes, n,
                                                    block_c=8, block_j=8)
    ss, *sst, _ = sparse_infer.stack_shard_schedules(comp.include_words, comp.votes, n,
                                                     block_c=8, block_j=8)
    real = sharding.real_tiles(sst[2], sst[0].shape[1], 8)
    assert min(real) < sst[2].shape[-1], real          # a shard carries padding
    dense = sharding.stack_shard_dense(comp.include_words, comp.votes, n)
    cases = [
        (term_infer, sharding.sharded_factorized_forward_fn(
            mesh, block_t=fs[0].block_t, block_c=fs[0].block_c, block_j=fs[0].block_j),
         t(fst)),
        (sparse_infer, sharding.sharded_schedule_forward_fn(
            mesh, block_c=ss[0].block_c, block_j=ss[0].block_j), t(sst)),
        (fused_infer, sharding.sharded_forward_fn(mesh), t(dense)),
    ]
    for mod, fwd, tabs in cases:
        n0 = mod.launches
        got = fwd(*tabs, xw)
        torch.cuda.synchronize()
        assert mod.launches - n0 == mesh.size, mod.__name__
        np.testing.assert_array_equal(want.cpu().numpy(), got.cpu().numpy(),
                                      err_msg=mod.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["model=2", "data=2,model=2"])
@pytest.mark.parametrize("fuse, chunk", [(True, None), (False, None), (True, 5)])
def test_cuda_sharded_train_step_equals_unsharded(card_mesh, cuda_device, spec, fuse,
                                                  chunk):
    """The clause-sharded step launches each kernel once a shard and chunk
    and ends on the single-device step's bank."""
    from repro_torch.core import prng, sharding
    from repro_torch.kernels import class_sum, clause_eval, fused_infer, fused_train, ops
    from repro_torch.kernels import ta_update

    cfg = tm.TMConfig(n_features=48, n_classes=4, clauses_per_class=16,
                      clause_pad_multiple=8, threshold=15, s=5.0)
    ta = tm.init(cfg, prng.PRNGKey(0), cuda_device).ta_state
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 2, (24, 48), dtype=np.uint8)).to(cuda_device)
    y = torch.from_numpy(rng.integers(0, 4, 24, dtype=np.int32)).to(cuda_device)
    want, _ = ops.tm_train_step_kernel(cfg, ta, x, y, 9, batch_chunk=chunk, fuse=fuse)
    mesh = card_mesh(spec)
    mods = ((fused_infer, fused_train) if fuse else (clause_eval, class_sum, ta_update))
    n0 = [m.launches for m in mods]
    got = sharding.sharded_train_step_fn(cfg, mesh, batch_chunk=chunk, engine="kernel",
                                         fuse=fuse)(ta, x, y, 9)
    torch.cuda.synchronize()
    n_data = mesh.shape.get("data", 1)
    chunks = -(-(24 // n_data) // chunk) if chunk else 1
    assert [m.launches - a for m, a in zip(mods, n0)] == [mesh.size * chunks] * len(mods)
    np.testing.assert_array_equal(want.cpu().numpy(), got.cpu().numpy())
