"""Which design a factorized call takes on the card, as a pure function of
what the call observes (``term_infer.slab_words_for``): the slab-resident
one launch at large batches in exact mode, the three launches everywhere
else.  No card needed: the rule and the shared-memory count are plain
Python, held here at the benchmark artifacts' own shapes and at the edges
of the rule.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import compiler
from repro_torch.kernels import term_infer

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "tmbench", "assets")
H100 = dict(sm_count=132, shared_bytes=232448)      # 227 KB a block, opted in


@pytest.fixture(scope="module")
def shapes():
    """(W, Tp, K, U, n_cblocks, n_planes) of the two benchmark artifacts'
    schedules and votes."""
    out = {}
    for name, f in (("mnist", "tm_mnist_10k_e1.npz"), ("cifar2", "tm_cifar2_e1.npz")):
        comp = compiler.CompiledTM.load(os.path.join(ASSETS, f))
        fs = comp.factorized_schedule()
        votes = torch.from_numpy(np.asarray(comp.votes, np.int32))
        out[name] = (comp.include_words.shape[1], fs.term_chain.shape[0],
                     comp.votes.shape[1], comp.votes.shape[0], fs.n_cblocks,
                     term_infer.vote_planes(votes)[1])
    return out


def test_artifact_shapes_and_their_tables(shapes):
    """The shapes the rule is sized on: 49 and 64 literal words, 9,584 and
    10,048 term rows, 2,000 vote rows of +-1 (two bit planes), a 6.3 / 8.2
    KB literal table and a 38.3 / 40.2 KB term table a sample word, with the
    sums, the fired table (128 rows of 65 words) and the planes (24 / 8
    rows of 64 words) 217 / 224 KB at 4 words a CTA."""
    assert shapes == {"mnist": (49, 9584, 10, 2000, 2, 2),
                      "cifar2": (64, 10048, 2, 2000, 2, 2)}
    for (W, Tp, K, U, ncb, npl), kb in zip(shapes.values(), (217, 224)):
        assert 32 * W * 4 in (6272, 8192) and Tp * 4 in (38336, 40192)
        assert kb * 1024 < 4 * term_infer.slab_shared_words(4, W, Tp, K, U, ncb, npl) <= 232448
        assert 4 * term_infer.slab_shared_words(8, W, Tp, K, U, ncb, npl) > 232448


CASES = {
    # name: (artifact or explicit shape, B, keyword overrides, sample words a CTA)
    "serve-bucket-512": ("mnist", 512, {}, 0),
    "cifar2-bucket-512": ("cifar2", 512, {}, 0),
    "mnist-64k": ("mnist", 65536, {}, 4),
    "cifar2-64k": ("cifar2", 65536, {}, 4),
    "mnist-ragged-64k": ("mnist", 65519, {}, 4),
    "term-table-too-large": ((49, 60000, 10, 2000, 2, 2), 65536, {}, 0),
    # votes of 22 bit planes: 57 KB of planes leave 4 words no room
    "wide-votes-take-2-words": ((49, 9584, 10, 2000, 2, 22), 65536, {}, 2),
    "early-exit": ("mnist", 65536, dict(tile_margin=object()), 0),
    "explicit-block_s": ("mnist", 65536, dict(block_s=4), 0),
    "small-tables-take-8-words": ((3, 200, 10, 100, 2, 2), 1 << 20, {}, 8),
    # the largest S whose slabs fill half the SMs (66 CTAs): 4 words from
    # 8,448 samples, 2 words from 4,224, 1 word from 2,112; below, three
    # launches
    "half-wave-of-4-words": ("mnist", 32 * 4 * 66, {}, 4),
    "under-half-wave-of-4-words": ("mnist", 32 * 4 * 66 - 32 * 4, {}, 2),
    "cifar2-half-wave-of-2-words": ("cifar2", 6144, {}, 2),
    "half-wave-of-1-word": ("mnist", 3072, {}, 1),
    "under-half-wave-of-1-word": ("mnist", 32 * 65, {}, 0),
    "cifar2-2048": ("cifar2", 2048, {}, 0),
    "small-card": ("mnist", 16384, dict(sm_count=32), 4),
    "little-shared-memory": ("mnist", 65536, dict(shared_bytes=120 * 1024), 2),
    "small-tables-small-batch": ((3, 200, 10, 100, 2, 2), 4096, {}, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_slab_rule_picks_the_design(shapes, case):
    shape, B, over, want = CASES[case]
    W, Tp, K, U, ncb, npl = shapes[shape] if isinstance(shape, str) else shape
    kw = dict(tile_margin=None, block_s=None, **H100)
    kw.update(over)
    assert term_infer.slab_words_for(B, W, Tp, K, U, ncb, npl, **kw) == want


@pytest.mark.parametrize("S", term_infer.SLAB_SIZES)
def test_slab_shared_words_align_and_grow(S):
    """Every region the kernel lays out starts on 16 bytes, the term rows
    hold at least the slab's raw literal words, and the count grows with
    every table."""
    base = term_infer.slab_shared_words(S, 49, 9584, 10, 2000, 2, 2)
    assert base % 4 == 0
    assert term_infer.slab_shared_words(S, 49, 10, 10, 2000, 2, 2) >= 32 * 49 * S + 32 * 49 * S
    for bigger in ((50, 9584, 10, 2000, 2, 2), (49, 9585 + 4, 10, 2000, 2, 2),
                   (49, 9584, 11, 2000, 2, 2), (49, 9584, 10, 2000 + 32 * 8, 2, 2),
                   (49, 9584, 10, 2000, 3, 2), (49, 9584, 10, 2000, 2, 3)):
        assert term_infer.slab_shared_words(S, *bigger) > base


VOTE_SETS = {
    "plus-minus-one": (np.array([[1, -1], [-1, 1], [1, 1]]), 2),
    "zeros": (np.zeros((5, 3), np.int64), 1),
    "minus-one-only": (np.full((40, 2), -1), 1),
    "range-4": (np.random.default_rng(0).integers(-4, 5, (70, 10)), 4),
    "scaled-2-20": (np.random.default_rng(1).integers(-4, 5, (700, 10)) << 20, 24),
    "int32-extremes": (np.array([[-(1 << 31)], [(1 << 31) - 1], [0]]), 32),
}


@pytest.mark.parametrize("case", list(VOTE_SETS))
def test_vote_planes_hold_the_votes(case):
    """The slab fold's bit planes give back every vote (the top plane
    negative), with the fewest planes that do (the planes above them
    repeat the sign), and are derived once per votes tensor and version."""
    votes, want_np = VOTE_SETS[case]
    v = torch.from_numpy(votes.astype(np.int32))
    planes, n_planes = term_infer.vote_planes(v)
    U, K = v.shape
    assert n_planes == want_np and planes.shape == (K, 32, -(-U // 32))
    bits = (planes.to(torch.int64) & 0xFFFFFFFF)[..., None] >> torch.arange(32)   # (K, p, n, c)
    bits = (bits & 1).permute(2, 3, 0, 1).reshape(-1, K, 32)[:U]                   # (U, K, p)
    weights = torch.tensor([1 << p for p in range(n_planes)], dtype=torch.int64)
    weights[-1] = -weights[-1]
    assert torch.equal(bits[..., n_planes - 1:], bits[..., 31:].expand(-1, -1, 33 - n_planes))
    assert torch.equal((bits[..., :n_planes] * weights).sum(-1), v.to(torch.int64))
    assert term_infer.vote_planes(v)[0] is planes
    v += 0
    assert term_infer.vote_planes(v)[0] is not planes
