"""Port parity: bit packing, synthetic requests and configs against the
JAX reference, exact (tolerance 0)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import matador_tm as ref_configs  # noqa: E402
from repro.core import packetizer as ref_pk  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro_torch.configs import matador_tm as port_configs  # noqa: E402
from repro_torch.core import packetizer as port_pk  # noqa: E402
from repro_torch.data import synthetic as port_synth  # noqa: E402


@pytest.mark.parametrize("shape", [(1, 1), (3, 31), (5, 32), (4, 33), (2, 3, 70), (7, 1568)])
def test_pack_bits_matches_reference(shape):
    bits = np.random.default_rng(sum(shape)).integers(0, 2, shape, dtype=np.uint8)
    want = np.asarray(ref_pk.pack_bits(jnp.asarray(bits)))
    got = port_pk.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = port_pk.unpack_bits(got, shape[-1])
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_pk.unpack_bits(jnp.asarray(want), shape[-1])))


def test_unpack_handles_sign_bit():
    # bit 31 set: an int32 right shift copies the sign, the mask must undo it
    words = np.array([[0x80000001, 0xFFFFFFFF, 0x7FFFFFFF, 0]], np.uint32)
    got = port_pk.unpack_bits(port_pk.words_to_tensor(words, "cpu"), 128)
    np.testing.assert_array_equal(got.numpy(), ref_pk.unpack_bits_np(words, 128))


@pytest.mark.parametrize("n_features", [1, 16, 17, 784])
def test_pack_literals_matches_reference(n_features):
    x = np.random.default_rng(n_features).integers(0, 2, (9, n_features), dtype=np.uint8)
    want = np.asarray(ref_pk.pack_literals(jnp.asarray(x)))
    got = port_pk.pack_literals(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_numpy_twins_identical():
    bits = np.random.default_rng(3).integers(0, 2, (6, 77), dtype=np.uint8)
    w = port_pk.pack_bits_np(bits)
    np.testing.assert_array_equal(w, ref_pk.pack_bits_np(bits))
    np.testing.assert_array_equal(port_pk.unpack_bits_np(w, 77),
                                  ref_pk.unpack_bits_np(w, 77))
    assert port_pk.n_words(77) == ref_pk.n_words(77) == 3


@pytest.mark.parametrize("kw", [dict(), dict(label_noise=0.2), dict(prototype_density=0.3)])
def test_make_boolean_classification_identical(kw):
    a = ref_synth.make_boolean_classification(300, 784, 10, seed=2, **kw)
    b = port_synth.make_boolean_classification(300, 784, 10, seed=2, **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_tm_configs_identical():
    assert ref_configs.TM_CONFIGS.keys() == port_configs.TM_CONFIGS.keys()
    for name, cfg in ref_configs.TM_CONFIGS.items():
        pc = port_configs.TM_CONFIGS[name]
        for field in ("n_features", "n_classes", "clauses_per_class", "n_states",
                      "threshold", "s", "boost_true_positive", "clause_pad_multiple",
                      "n_literals", "n_clauses_raw", "n_clauses_total"):
            assert getattr(cfg, field) == getattr(pc, field), (name, field)
