"""The plain reference against brute-force loops on tiny banks, and against
the program's plain versions on the CPU."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import datagen  # noqa: E402
from tmbench.reference import tm_reference as R  # noqa: E402

TINY = dict(n_features=20, n_classes=3, clauses_per_class=6, threshold=4, s=3.0,
            n_states=8, boost_true_positive=True, clause_pad_multiple=8)


def brute_class_sums(inc, votes, lits):
    """inc (U, L) 0/1, votes (U, K), lits (B, L) 0/1 -> (B, K)."""
    B, (U, L) = lits.shape[0], inc.shape
    out = np.zeros((B, votes.shape[1]), np.int64)
    for b in range(B):
        for c in range(U):
            if inc[c].sum() == 0:
                continue
            if all(lits[b, l] == 1 for l in range(L) if inc[c, l]):
                out[b] += votes[c]
    return out


def pack_rows(bits):
    """(n, 32 W) 0/1 -> (n, W) uint32, bit i of word w is column 32 w + i."""
    W = bits.shape[1] // 32
    packed = np.zeros((bits.shape[0], W), np.uint32)
    for w in range(W):
        for i in range(32):
            packed[:, w] |= bits[:, 32 * w + i].astype(np.uint32) << np.uint32(i)
    return packed


def test_pack_literals_matches_the_port(rng=np.random.default_rng(3)):
    from repro_torch.core import packetizer

    x = torch.from_numpy(rng.integers(0, 2, (37, 50)).astype(np.uint8))
    assert torch.equal(datagen.pack_literals(x), packetizer.pack_literals(x))
    bits = R.unpack_words(datagen.pack_literals(x))[:, :100]
    assert torch.equal(bits, R.literals(x))


def test_prototypes_are_paper_datasets_first_draw():
    from repro_torch.data.synthetic import make_boolean_classification

    rng = np.random.default_rng(0)
    want = rng.random((10, 784)) < 0.15
    assert np.array_equal(datagen.prototypes("mnist", 0), want)
    X, y = make_boolean_classification(4000, 784, 10, seed=0)
    # the prototype pixels light 0.9 of the time, the rest 0.08
    on = want[y]
    assert abs(X[on].mean() - 0.9) < 0.01 and abs(X[~on].mean() - 0.08) < 0.01


def test_inference_reference_matches_brute_force(tmp_path):
    rng = np.random.default_rng(7)
    tmc = R.TM(dict(TINY, n_features=48))                 # 96 literals, 3 words
    B = 70
    bank = np.where(rng.random((tmc.C, tmc.L)) < 0.06, 3, -4).astype(np.int8)
    bank[4] = -1                                          # an empty clause votes nothing
    bank[tmc.C_raw:] = 0                                  # padded clauses vote nothing
    np.savez(tmp_path / "b.npz", ta_state=bank)
    ref = R.Bank(str(tmp_path / "b.npz"), tmc, "cpu")
    lits = rng.integers(0, 2, (B, tmc.L)).astype(np.uint8)
    lits[:10, :] = 1                                      # samples on which clauses fire
    words = torch.from_numpy(pack_rows(lits).view(np.int32))
    got = R.infer_class_sums(ref, words)
    inc = (bank[:tmc.C_raw] >= 0).astype(np.uint8)
    j = np.arange(tmc.C_raw)
    votes = np.zeros((tmc.C_raw, tmc.K), np.int64)
    votes[j, j // tmc.cpc] = np.where(j % 2 == 0, 1, -1)
    want = brute_class_sums(inc, votes, lits)
    assert np.array_equal(got.numpy(), want)
    assert (want != 0).any()
    # the control leaves every 5th clause out
    keep = ref.keep_all_but_every(5)
    assert int((~keep).sum()) == tmc.C_raw // 5
    pre = R.infer_class_sums(ref, words, keep=keep)
    k = keep.numpy()
    assert np.array_equal(pre.numpy(), brute_class_sums(inc[k], votes[k], lits))


def test_a_bank_of_the_wrong_shape_is_refused(tmp_path):
    tmc = R.TM(TINY)
    np.savez(tmp_path / "b.npz", ta_state=np.zeros((tmc.C, tmc.L - 2), np.int8))
    with pytest.raises(ValueError):
        R.Bank(str(tmp_path / "b.npz"), tmc, "cpu")


def brute_train_step(tmc, bank, x, y, seed):
    """The feedback rules one automaton at a time."""
    B = x.shape[0]
    C, L = bank.shape
    lits = np.concatenate([x, 1 - x], 1)
    inc = bank >= 0
    cls = np.minimum(np.arange(C) // tmc.cpc, tmc.K - 1)
    pol = np.where(np.arange(C) % 2 == 0, 1, -1) * (np.arange(C) < tmc.C_raw)
    h = lambda i, s: int(R.hash_u32(torch.tensor([i]), s)[0])  # noqa: E731
    delta = np.zeros((C, L), np.int64)
    t_act = R.prob_threshold(1.0)
    t_inact = R.prob_threshold(1.0 / tmc.s)
    for b in range(B):
        fire = [all(lits[b, l] for l in range(L) if inc[c, l]) for c in range(C)]
        sums = np.zeros(tmc.K, np.int64)
        for c in range(C):
            if fire[c] and pol[c]:
                sums[cls[c]] += pol[c]
        sums = np.clip(sums, -tmc.T, tmc.T)
        kn = h(b, (seed ^ 0x9E3779B9) & R.M32) % (tmc.K - 1)
        kn += kn >= y[b]
        p_t = np.float32(tmc.T - sums[y[b]]) / np.float32(2 * tmc.T)
        p_n = np.float32(tmc.T + sums[kn]) / np.float32(2 * tmc.T)
        for c in range(C):
            r = np.float32(h((b * 0x9E3779B1 + c) & R.M32, (seed ^ 0x85EBCA6B) & R.M32)) \
                / np.float32(2 ** 32)
            if cls[c] == y[b]:
                p, t1 = p_t, pol[c] > 0
            elif cls[c] == kn:
                p, t1 = p_n, pol[c] < 0
            else:
                continue
            if not pol[c] or not r < p:
                continue
            for l in range(L):
                if t1:
                    d = h((((b * C + c) & R.M32) * L + l) & R.M32, seed)
                    if fire[c] and lits[b, l]:
                        delta[c, l] += d < t_act
                    else:
                        delta[c, l] -= d < t_inact
                elif fire[c] and not lits[b, l] and not inc[c, l]:
                    delta[c, l] += 1
    return np.clip(bank + delta, -tmc.n_states, tmc.n_states - 1)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 32 + 7])
def test_training_reference_matches_brute_force(seed):
    tmc = R.TM(TINY)
    g = torch.Generator().manual_seed(seed % 1000)
    bank = torch.randint(-2, 2, (tmc.C, tmc.L), generator=g).to(torch.int8)
    bank[tmc.C_raw:] = -tmc.n_states
    x = (torch.rand((12, tmc.F), generator=g) < 0.5).to(torch.uint8)
    x[:3] = 1
    y = torch.randint(0, tmc.K, (12,), generator=g).to(torch.int32)
    got, fire, ftype = R.train_step(tmc, bank, x, y, seed)
    want = brute_train_step(tmc, bank.numpy().astype(np.int64), x.numpy(), y.numpy(), seed)
    assert np.array_equal(got.numpy(), want)
    assert (got != bank).any() and (ftype == 1).any()


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 99])
def test_training_reference_matches_the_programs_step(seed):
    from repro_torch.core.tm import TMConfig
    from repro_torch.kernels import ops

    model = dict(TINY, n_features=40, n_classes=4, clauses_per_class=10)
    tmc = R.TM(model)
    cfg = TMConfig(**model)
    g = torch.Generator().manual_seed(seed % 977)
    bank = torch.randint(-1, 1, (tmc.C, tmc.L), generator=g).to(torch.int8)
    bank[tmc.C_raw:] = -tmc.n_states
    for step in range(3):
        x = (torch.rand((33, tmc.F), generator=g) < 0.3).to(torch.uint8)
        y = torch.randint(0, tmc.K, (33,), generator=g).to(torch.int32)
        want, _ = ops.tm_train_step_kernel(cfg, bank, x, y, step)
        got, _, _ = R.train_step(tmc, bank, x, y, step)
        assert torch.equal(got, want)
        bank = want


@pytest.mark.parametrize("config", ["tm-mnist", "tm-cifar2"])
def test_the_programs_runner_serves_the_committed_bank(config):
    """The committed artifact, served by the program, gives the class sums
    that the reference derives from the committed bank."""
    import json

    from repro_torch.core.compiler import CompiledTM, run_compiled

    with open(os.path.join(ROOT, "tmbench", "configs", config + ".json")) as f:
        cfg = json.load(f)
    ref = R.Bank(os.path.join(ROOT, cfg["serve_bank"]), R.TM(cfg["model"]), "cpu")
    g = datagen.generator(5, "test", torch.device("cpu"))
    protos = datagen.prototypes(cfg["data"]["dataset"], cfg["data"]["data_seed"])
    x, _ = datagen.sample(protos, 600, g, torch.device("cpu"))
    words = datagen.pack_literals(x)
    want = run_compiled(CompiledTM.load(os.path.join(ROOT, cfg["serve_artifact"])), words,
                        engine="factorized")
    got = R.infer_class_sums(ref, words)
    assert torch.equal(got, want.to(torch.int64))
    assert (got != 0).any()
