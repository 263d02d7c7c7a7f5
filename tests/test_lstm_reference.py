"""The XLA LSTM stack (models/lstm.py) against an independent numpy float64
LSTM in torch gate order (i, f, g, o): across layer counts, sequence
lengths and batch widths (rows that are not a multiple of 8 included), in
eval and train mode with the inter-layer dropout streams fold_in(rng, l),
and float64 finite-difference gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.models.lstm import (
    apply_lstm,
    apply_lstm_wavefront,
    init_lstm,
)

C_IN, HIDDEN = 5, 8


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def numpy_lstm(params, x, masks=None, keep=1.0):
    """x [B, T, C] -> last hidden [B, H] of the top layer, float64.

    masks[l] is the [T, B, H] keep-mask applied (inverted) to layer l's
    output sequence before layer l+1."""
    h_seq = np.swapaxes(np.asarray(x, np.float64), 0, 1)  # [T, B, C]
    layers = params["layers"]
    for l, p in enumerate(layers):
        wx, wh = np.asarray(p["wx"], np.float64), np.asarray(p["wh"], np.float64)
        b = np.asarray(p["b"], np.float64)
        t_len, batch, _ = h_seq.shape
        h = np.zeros((batch, wh.shape[0]))
        c = np.zeros_like(h)
        out = []
        for t in range(t_len):
            z = h_seq[t] @ wx + h @ wh + b
            i, f, g, o = np.split(z, 4, axis=-1)
            c = _sigmoid(f) * c + _sigmoid(i) * np.tanh(g)
            h = _sigmoid(o) * np.tanh(c)
            out.append(h)
        h_seq = np.stack(out)
        if masks is not None and l < len(layers) - 1:
            h_seq = np.where(masks[l], h_seq / keep, 0.0)
    return h_seq[-1]


def _inputs(layers, t, b, seed=0, dtype=jnp.float32):
    params = init_lstm(jax.random.key(seed), C_IN, HIDDEN, layers)
    x = np.random.default_rng(seed).normal(size=(b, t, C_IN))
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), params), jnp.asarray(x, dtype)


def _stream_masks(rng, layers, t, b, keep):
    """The masks apply_lstm draws: layer l from fold_in(rng, l), [T, B, H]."""
    return [
        np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, l), keep, (t, b, HIDDEN)))
        for l in range(layers - 1)
    ]


@pytest.mark.parametrize(
    "layers,t,b",
    [
        (1, 1, 1), (1, 7, 3), (1, 24, 13),
        (2, 1, 8), (2, 5, 3), (2, 24, 20),
        (3, 6, 13), (3, 12, 1),
        (4, 24, 3), (4, 24, 16), (4, 9, 21), (4, 2, 64),
    ],
)
def test_eval_matches_numpy(layers, t, b):
    params, x = _inputs(layers, t, b)
    got = jax.jit(lambda p, v: apply_lstm(p, v, unroll=0))(params, x)
    assert got.shape == (b, HIDDEN)
    np.testing.assert_allclose(
        np.asarray(got), numpy_lstm(params, x), rtol=2e-5, atol=2e-6
    )


@pytest.mark.parametrize("layers,rate", [(2, 0.2), (2, 0.5), (3, 0.2), (4, 0.3)])
def test_train_dropout_streams_match_numpy(layers, rate):
    t, b = 6, 11
    params, x = _inputs(layers, t, b, seed=1)
    rng = jax.random.key(5)
    got = apply_lstm(params, x, dropout_rate=rate, train=True, rng=rng)
    keep = 1.0 - rate
    want = numpy_lstm(params, x, _stream_masks(rng, layers, t, b, keep), keep)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-6)
    eval_out = apply_lstm(params, x, dropout_rate=rate, train=False, rng=rng)
    np.testing.assert_allclose(
        np.asarray(eval_out), numpy_lstm(params, x), rtol=2e-5, atol=2e-6
    )


@pytest.mark.parametrize("unroll", [0, 1, 4, 100])
def test_unroll_does_not_change_values(unroll):
    params, x = _inputs(2, 9, 5, seed=2)
    got = apply_lstm(params, x, unroll=unroll)
    np.testing.assert_allclose(
        np.asarray(got), numpy_lstm(params, x), rtol=2e-5, atol=2e-6
    )


@pytest.mark.parametrize("layers,train", [(1, False), (2, False), (2, True), (3, True)])
def test_gradients_match_finite_differences_f64(layers, train):
    """Every parameter leaf and the input: the analytic directional
    derivative along a random direction equals the central difference."""
    t, b, rate = 5, 3, 0.25
    with jax.enable_x64(True):
        params, x = _inputs(layers, t, b, seed=3, dtype=jnp.float64)
        rng = jax.random.key(9)

        def loss(p, v):
            out = apply_lstm(
                p, v, dropout_rate=rate, train=train, rng=rng,
                compute_dtype=jnp.float64,
            )
            return jnp.sum(out * jnp.arange(1.0, HIDDEN + 1.0))

        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
        dirs = np.random.default_rng(4)
        leaves, treedef = jax.tree.flatten(params)
        grads = jax.tree.leaves(gp)
        eps = 1e-6
        for i, (leaf, g) in enumerate(zip(leaves, grads)):
            v = dirs.normal(size=leaf.shape)
            bump = [jnp.zeros_like(a) for a in leaves]
            bump[i] = jnp.asarray(v)
            plus = jax.tree.map(lambda a, d: a + eps * d, params, treedef.unflatten(bump))
            minus = jax.tree.map(lambda a, d: a - eps * d, params, treedef.unflatten(bump))
            fd = (loss(plus, x) - loss(minus, x)) / (2 * eps)
            np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd), rtol=1e-6, atol=1e-9)
        v = dirs.normal(size=x.shape)
        fd = (loss(params, x + eps * v) - loss(params, x - eps * v)) / (2 * eps)
        np.testing.assert_allclose(float(jnp.vdot(gx, v)), float(fd), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("train", [False, True])
def test_wavefront_matches_numpy(train):
    layers, t, b, rate = 3, 7, 5, 0.3
    params, x = _inputs(layers, t, b, seed=6)
    rng = jax.random.key(2)
    got = apply_lstm_wavefront(params, x, dropout_rate=rate, train=train, rng=rng)
    keep = 1.0 - rate
    masks = _stream_masks(rng, layers, t, b, keep) if train else None
    want = numpy_lstm(params, x, masks, keep)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-6)


def test_bfloat16_compute_close_to_numpy():
    params, x = _inputs(2, 8, 6, seed=7)
    got = apply_lstm(params, x, compute_dtype=jnp.bfloat16)
    assert got.dtype == jnp.float32  # accumulation stays float32
    np.testing.assert_allclose(np.asarray(got), numpy_lstm(params, x), atol=3e-2)


def test_split_torch_biases_equal_fused_bias():
    """Torch-imported params carry b_ih + b_hh; the sum is the gate bias."""
    params, x = _inputs(2, 5, 4, seed=8)
    split = jax.tree.map(lambda a: a, params)
    for layer in split["layers"]:
        b = layer.pop("b")
        layer["b_ih"], layer["b_hh"] = 0.25 * b, 0.75 * b
    np.testing.assert_allclose(
        np.asarray(apply_lstm(split, x)), numpy_lstm(params, x), rtol=2e-5, atol=2e-6
    )
