"""Port: the BNN baseline and its XNOR-popcount kernel against the reference.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs its jnp oracle and its Pallas kernel in interpret mode
(``use_kernel=True, interpret=True``, as ``tests/test_kernels.py`` runs
it).  Integer results (packed words, dots, argmax) are held at tolerance
0; float training at a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import bnn as r_bnn
from repro.core import packetizer as r_pk
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.baselines import bnn as t_bnn
from repro_torch.core import packetizer as t_pk
from repro_torch.data.synthetic import make_boolean_classification
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import xnor_popcount as t_xnor

KW = dict(use_kernel=True, interpret=True)


def _words(bits):
    """{0,1} (N, n_bits) -> (reference uint32 words, port int32 words)."""
    w = r_pk.pack_bits_np(bits)
    return jnp.asarray(w), torch.from_numpy(w.view(np.int32))


# the shapes of tests/test_kernels.py::test_xnor_popcount_sweep, plus the
# BNN's ragged 784-bit first layer (W = 25) and its 256-bit layers (W = 8)
@pytest.mark.parametrize("B,O,W,pad", [(4, 6, 2, 0), (33, 65, 4, 13), (128, 256, 8, 31),
                                       (50, 256, 25, 16), (7, 10, 8, 0)])
def test_xnor_popcount_plain_equals_reference(B, O, W, pad):
    rng = np.random.default_rng(B * O + pad)
    n_bits = W * 32 - pad
    a_bits = rng.integers(0, 2, (B, n_bits), dtype=np.uint8)
    w_bits = rng.integers(0, 2, (O, n_bits), dtype=np.uint8)
    (ra, ta), (rw, tw) = _words(a_bits), _words(w_bits)
    want = np.asarray(r_ref.xnor_popcount_ref(ra, rw, n_bits))
    np.testing.assert_array_equal(np.asarray(r_ops.xnor_dot(ra, rw, n_bits, **KW)), want)
    np.testing.assert_array_equal(t_xnor.xnor_popcount_plain(ta, tw, n_bits).numpy(), want)
    np.testing.assert_array_equal(t_ref.xnor_popcount_ref(ta, tw, n_bits).numpy(), want)
    np.testing.assert_array_equal(t_ops.xnor_dot(ta, tw, n_bits).numpy(), want)
    # oracle of the oracle: the +-1 dot product
    pm = (2.0 * a_bits - 1) @ (2.0 * w_bits - 1).T
    np.testing.assert_array_equal(want, pm.astype(np.int32))


@pytest.mark.parametrize("B,O,W,pad,ones", [(9, 6, 1, 31, False), (9, 6, 1, 31, True),
                                            (33, 65, 4, 13, True), (50, 256, 25, 16, False),
                                            (17, 10, 8, 0, False), (20, 12, 26, 7, True)])
def test_xnor_dot_equals_the_and_popcount_form(B, O, W, pad, ones):
    """The CUDA kernel's arithmetic, dot = n - 2 pa - 2 pw + 4 popcount(a & w)
    over the first n_bits bits (pads masked off), against the port's
    xnor_popcount_ref and the reference's Pallas kernel (interpret mode).
    ``ones`` sets the pad bits in both operands: they agree, so the XNOR
    forms count them as matches and the masked form never sees them."""
    rng = np.random.default_rng(7 * B + O + pad)
    n_bits = W * 32 - pad
    a_bits = rng.integers(0, 2, (B, n_bits), dtype=np.uint8)
    w_bits = rng.integers(0, 2, (O, n_bits), dtype=np.uint8)
    ra, rw = r_pk.pack_bits_np(a_bits), r_pk.pack_bits_np(w_bits)
    mask = np.full(W, 0xFFFFFFFF, np.uint32)
    if n_bits % 32:
        mask[-1] = (1 << (n_bits % 32)) - 1
    if ones:
        ra, rw = ra | ~mask, rw | ~mask
    ta, tw = (torch.from_numpy(x.view(np.int32).copy()) for x in (ra, rw))
    am, wm = (torch.from_numpy((x & mask).astype(np.int64)) for x in (ra, rw))
    pa, pw = t_ref.popcount32(am).sum(1), t_ref.popcount32(wm).sum(1)
    s = sum(t_ref.popcount32(am[:, i, None] & wm[None, :, i]) for i in range(W))
    dot = (n_bits - 2 * pa[:, None] - 2 * pw[None, :] + 4 * s).to(torch.int32)
    np.testing.assert_array_equal(dot.numpy(), t_ref.xnor_popcount_ref(ta, tw, n_bits).numpy())
    np.testing.assert_array_equal(
        dot.numpy(), np.asarray(r_ops.xnor_dot(jnp.asarray(ra), jnp.asarray(rw), n_bits, **KW)))
    pm = (2.0 * a_bits - 1) @ (2.0 * w_bits - 1).T
    np.testing.assert_array_equal(dot.numpy(), pm.astype(np.int32))


def test_popcount32_on_edge_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555,
                      0xDEADBEEF], np.uint32)
    want = [bin(int(x)).count("1") for x in words]
    assert t_ref.popcount32(torch.from_numpy(words.view(np.int32))).tolist() == want


def test_xnor_popcount_checks_and_cuda_only_wrapper():
    a = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_xnor.xnor_popcount_cuda(a, a, 64)
    with pytest.raises(ValueError, match="n_bits"):
        t_xnor.xnor_popcount_plain(a, a, 20)
    with pytest.raises(TypeError):
        t_xnor.xnor_popcount_plain(a.to(torch.int64), a, 64)
    with pytest.raises(ValueError, match="word count"):
        t_xnor.xnor_popcount_plain(a, torch.zeros((3, 3), dtype=torch.int32), 64)


def _ref_layer_dots(packed, x, **kw):
    """The reference's bnn_predict, keeping every layer's dots."""
    a = jnp.asarray(x).astype(jnp.uint8)
    dots = []
    for i, (w, n_bits) in enumerate(packed):
        dots.append(np.asarray(r_ops.xnor_dot(r_pk.pack_bits(a), w, n_bits, **kw)))
        if i < len(packed) - 1:
            a = (jnp.asarray(dots[-1]) >= 0).astype(jnp.uint8)
    return dots


@pytest.mark.parametrize("sizes", [(64, 128, 4), (784, 256, 256, 256, 10)])
def test_bnn_predict_from_reference_params(sizes):
    cfg = r_bnn.BNNConfig(layer_sizes=sizes)
    params = r_bnn.bnn_init(cfg, jax.random.PRNGKey(0))
    X, _ = make_boolean_classification(97, sizes[0], sizes[-1], seed=1)
    r_packed = r_bnn.bnn_pack(params)
    t_packed = t_bnn.bnn_pack(t_bnn.bnn_params_from_numpy(
        [np.asarray(p) for p in params], "cpu"))
    for (rw, rn), (tw, tn) in zip(r_packed, t_packed):
        assert rn == tn
        np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(rw))
    x = torch.from_numpy(X)
    want = _ref_layer_dots(r_packed, X)
    got = t_bnn.bnn_layer_dots(t_packed, x)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(_ref_layer_dots(r_packed, X, **KW)[-1], want[-1])
    np.testing.assert_array_equal(t_bnn.bnn_predict(t_packed, x).numpy(),
                                  np.asarray(r_bnn.bnn_predict(r_packed, jnp.asarray(X))))


def test_bnn_forward_and_ste_gradients_match_reference():
    """The training forward and the straight-through gradients, float32,
    atol 1e-5 (the same products and clips; XLA and torch round the
    softmax and sum the gradients in other orders).  Layer 1's
    pre-activations are sums of +-1 over 64 inputs, so |h| / 8 == 1 ties
    occur and check the half gradient at the clip boundary."""
    cfg = r_bnn.BNNConfig(layer_sizes=(64, 32, 4))
    params = r_bnn.bnn_init(cfg, jax.random.PRNGKey(2))
    X, y = make_boolean_classification(40, 64, 4, seed=3)
    tp = [p.requires_grad_(True) for p in t_bnn.bnn_params_from_numpy(
        [np.asarray(p) for p in params], "cpu")]
    want = r_bnn._forward_float(params, jnp.asarray(X))
    got = t_bnn._forward_float(tp, torch.from_numpy(X))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)

    def r_loss(p):
        return jnp.sum(r_bnn._forward_float(p, jnp.asarray(X))[jnp.arange(40), y])

    r_grads = jax.grad(r_loss)(params)
    t_grads = torch.autograd.grad(got[torch.arange(40), torch.from_numpy(y).long()].sum(), tp)
    for a, b in zip(t_grads, r_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    h = (2.0 * X - 1) @ np.sign(np.where(np.asarray(params[0]) == 0, 1, params[0]))
    assert (np.abs(h) == 8).any()      # ties at the clip boundary are exercised


def test_bnn_train_steps_match_reference():
    """Eight SGD steps (two epochs of four batches of 50, the reference's
    numpy permutation) from the same weights: float32, atol 1e-5."""
    cfg = r_bnn.BNNConfig(layer_sizes=(64, 128, 4), lr=5e-3)
    params = r_bnn.bnn_init(cfg, jax.random.PRNGKey(0))
    X, y = make_boolean_classification(200, 64, 4, seed=0)
    want = r_bnn.bnn_train(cfg, params, X, y, epochs=2, batch_size=50,
                           rng=jax.random.PRNGKey(1))
    tcfg = t_bnn.BNNConfig(layer_sizes=(64, 128, 4), lr=5e-3)
    got = t_bnn.bnn_train(tcfg, t_bnn.bnn_params_from_numpy(
        [np.asarray(p) for p in params], "cpu"), X, y, epochs=2, batch_size=50)
    moved = 0.0
    for a, b, p0 in zip(got, want, params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
        moved = max(moved, float(np.abs(np.asarray(b) - np.asarray(p0)).max()))
    assert moved > 1e-3


def test_bnn_init_and_device_default():
    cfg = t_bnn.BNNConfig()
    params = t_bnn.bnn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(p.shape) for p in params] == [(784, 256), (256, 256), (256, 256), (256, 10)]
    assert abs(float(params[0].std()) - 784 ** -0.5) < 0.002
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_bnn.bnn_init(cfg, torch.Generator().manual_seed(0))
