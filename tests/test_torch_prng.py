"""Port: ``core/prng.py`` against ``jax.random``, bit for bit.

Every draw the reference's trainer makes (keys, splits, bits, uniforms,
``randint`` and ``permutation``) must come out of the port equal, words
and float32 bit patterns alike: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def _j(key):
    """A port key -> a jax raw key."""
    return jnp.asarray(key.numpy().astype(np.uint32))


def _eq(port, reference):
    np.testing.assert_array_equal(port.numpy(), np.asarray(reference).astype(port.numpy().dtype))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1, -1, -2 ** 31, 2 ** 32 + 5])
def test_prng_key(seed):
    _eq(prng.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 16])
def test_split(num):
    for seed in (0, 3, 99):
        key = prng.PRNGKey(seed)
        got = prng.split(key, num)
        assert got.shape == (num, 2)
        _eq(got, jax.random.split(jax.random.PRNGKey(seed), num))
    # batched over leading key dimensions
    keys = prng.split(prng.PRNGKey(5), 6).reshape(2, 3, 2)
    want = jax.vmap(jax.vmap(lambda k: jax.random.split(k, num)))(_j(keys))
    _eq(prng.split(keys, num), want)


@pytest.mark.parametrize("bit_width, dtype", [(8, jnp.uint8), (32, jnp.uint32)])
def test_random_bits(bit_width, dtype):
    key = prng.PRNGKey(11)
    for shape in ((), (7,), (5, 9), (2, 3, 4)):
        _eq(prng.random_bits(key, bit_width, shape),
            jax.random.bits(jax.random.PRNGKey(11), shape, dtype))
    # bits_at reads single positions of a draw
    full = prng.random_bits(key, bit_width, (5, 9))
    idx = torch.tensor([[0, 44], [17, 3]])
    _eq(prng.bits_at(key, idx, bit_width), full.reshape(-1)[idx])


@pytest.mark.parametrize("shape", [(3, 1568), (2, 5, 7)])
def test_uniform_bit_patterns(shape):
    for seed in (0, 4):
        got = prng.uniform(prng.PRNGKey(seed), shape)
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert got.numpy().tobytes() == want.tobytes()
    keys = prng.split(prng.PRNGKey(8), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(_j(keys)))
    assert prng.uniform(keys, shape).numpy().tobytes() == want.tobytes()


def test_randint_int8_init_draw():
    for seed in range(5):
        got = prng.randint(prng.PRNGKey(seed), (30, 98), -1, 1, torch.int8)
        assert got.dtype == torch.int8
        _eq(got, jax.random.randint(jax.random.PRNGKey(seed), (30, 98), -1, 1,
                                    dtype=jnp.int8))


@pytest.mark.parametrize("K", [2, 3, 10])
def test_randint_negative_class_draw(K):
    keys = torch.stack([prng.PRNGKey(s) for s in range(50)])
    got = prng.randint(keys, (), 0, K - 1, torch.int32)
    want = [int(jax.random.randint(jax.random.PRNGKey(s), (), 0, K - 1)) for s in range(50)]
    assert got.tolist() == want


@pytest.mark.parametrize("lo, hi, jdt, tdt", [
    (0, 256, jnp.uint8, torch.uint8),          # maxval past the dtype's max
    (-128, 128, jnp.int8, torch.int8),
    (0, 200, jnp.int8, torch.int8),            # the offset wraps the signed dtype
    (-5, 100000, jnp.int32, torch.int32),      # the multiplier wraps 32 bits
    (3, 3, jnp.int32, torch.int32),            # empty span: minval
    (-2 ** 31, 2 ** 31 - 1, jnp.int32, torch.int32),
])
def test_randint_edges(lo, hi, jdt, tdt):
    got = prng.randint(prng.PRNGKey(2), (4, 9), lo, hi, tdt)
    _eq(got.to(torch.int64), np.asarray(
        jax.random.randint(jax.random.PRNGKey(2), (4, 9), lo, hi, dtype=jdt)).astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 1000, 70000])
def test_permutation(n):
    for seed in (0, 1):
        got = prng.permutation(prng.PRNGKey(seed), n)
        _eq(got, jax.random.permutation(jax.random.PRNGKey(seed), n))
    if n == 70000:     # two sort rounds: the stream past one split
        assert int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1))) == 2


def test_as_key_takes_checkpointed_words():
    key = prng.PRNGKey(3)
    words = key.numpy().astype(np.uint32)
    assert torch.equal(prng.as_key(words), key)
    assert torch.equal(prng.as_key([0, 3]), key)
    with pytest.raises(ValueError, match="last dimension"):
        prng.as_key(np.zeros(3, np.uint32))
