"""The XLA GCN encoder (models/stgcn.apply_encoder) against an independent
numpy float64 encoder: ReLU after every layer, dropout after every layer but
the last (or every layer with final_dropout) drawn from fold_in(rng, l),
padded nodes isolated, and float64 finite-difference gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.models.stgcn import (
    apply_encoder,
    apply_stgcn,
    init_encoder,
    init_stgcn,
)

W = 4


def _cfg(layers=2, hidden=12, rate=0.0, dtype="float32"):
    return ModelConfig(
        hidden_channels=hidden, gcn_layers=layers, gcn_dropout=rate,
        koppen_dim=3, window=W, horizon=2, compute_dtype=dtype,
        num_weather_vars=4, num_time_vars=2,
    )


def _graph(side):
    return build_region_graph(np.arange(float(side)), np.arange(float(side)))


def numpy_encoder(params, a_hat, x, masks=None, keep=1.0, final_dropout=False):
    h = np.asarray(x, np.float64)
    a = np.asarray(a_hat, np.float64)
    layers = params["layers"]
    for l, p in enumerate(layers):
        hw = h @ np.asarray(p["w"], np.float64)
        h = np.einsum("nm,...mc->...nc", a, hw) + np.asarray(p["b"], np.float64)
        h = np.maximum(h, 0.0)
        if masks is not None and (l < len(layers) - 1 or final_dropout):
            h = np.where(masks[l], h / keep, 0.0)
    return h


def _inputs(cfg, side, lead=(W,), seed=0, dtype=jnp.float32):
    g = _graph(side)
    params = init_encoder(jax.random.key(seed), cfg)
    # Non-zero biases so their path is checked too.
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(seed).normal(size=a.shape), params
    )
    x = np.random.default_rng(seed + 1).normal(
        size=(*lead, g.padded_nodes, cfg.in_channels)
    )
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return jax.tree.map(cast, params), cast(g.a_hat), cast(x), g


def _stream_masks(rng, cfg, shape, final_dropout):
    n = cfg.gcn_layers if final_dropout else cfg.gcn_layers - 1
    keep = 1.0 - cfg.gcn_dropout
    return [
        np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, l), keep, shape))
        for l in range(n)
    ]


@pytest.mark.parametrize("layers", [1, 2, 4])
@pytest.mark.parametrize("side", [3, 7])
def test_eval_matches_numpy(layers, side):
    cfg = _cfg(layers)
    params, a_hat, x, g = _inputs(cfg, side)
    got = jax.jit(lambda p, a, v: apply_encoder(p, a, v, cfg))(params, a_hat, x)
    assert got.shape == (W, g.padded_nodes, cfg.hidden_channels)
    np.testing.assert_allclose(
        np.asarray(got), numpy_encoder(params, a_hat, x), rtol=2e-5, atol=2e-5
    )


def test_leading_batch_dims_match_numpy():
    cfg = _cfg(3)
    params, a_hat, x, _ = _inputs(cfg, 4, lead=(2, W))
    got = apply_encoder(params, a_hat, x, cfg)
    np.testing.assert_allclose(
        np.asarray(got), numpy_encoder(params, a_hat, x), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("final_dropout", [False, True])
@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_train_dropout_streams_match_numpy(final_dropout, rate):
    cfg = _cfg(3, rate=rate)
    params, a_hat, x, _ = _inputs(cfg, 5, seed=2)
    rng = jax.random.key(11)
    got = apply_encoder(
        params, a_hat, x, cfg, train=True, rng=rng, final_dropout=final_dropout
    )
    shape = (W, a_hat.shape[0], cfg.hidden_channels)
    want = numpy_encoder(
        params, a_hat, x, _stream_masks(rng, cfg, shape, final_dropout),
        1.0 - rate, final_dropout,
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-5)


def test_padded_nodes_do_not_reach_real_nodes():
    """Padding rows/cols of A_hat are zero: whatever sits in the padded
    node slots never changes a real node's output."""
    cfg = _cfg(3)
    params, a_hat, x, g = _inputs(cfg, 5, seed=3)
    n = g.num_nodes
    noisy = x.at[:, n:, :].set(1e3)
    a = apply_encoder(params, a_hat, x, cfg)[:, :n]
    b = apply_encoder(params, a_hat, noisy, cfg)[:, :n]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_gradients_match_finite_differences_f64(train):
    cfg = _cfg(2, hidden=6, rate=0.3, dtype="float64")
    with jax.enable_x64(True):
        params, a_hat, x, _ = _inputs(cfg, 3, seed=4, dtype=jnp.float64)
        rng = jax.random.key(7)

        def loss(p, v):
            out = apply_encoder(p, a_hat, v, cfg, train=train, rng=rng)
            return jnp.sum(jnp.sin(out))

        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
        leaves, treedef = jax.tree.flatten(params)
        dirs = np.random.default_rng(5)
        eps = 1e-6
        for i, (leaf, g) in enumerate(zip(leaves, jax.tree.leaves(gp))):
            v = dirs.normal(size=leaf.shape)
            bump = [jnp.zeros_like(a) for a in leaves]
            bump[i] = jnp.asarray(v)
            d = treedef.unflatten(bump)
            fd = (
                loss(jax.tree.map(lambda a, e: a + eps * e, params, d), x)
                - loss(jax.tree.map(lambda a, e: a - eps * e, params, d), x)
            ) / (2 * eps)
            np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd), rtol=1e-6, atol=1e-9)
        v = dirs.normal(size=x.shape)
        fd = (loss(params, x + eps * v) - loss(params, x - eps * v)) / (2 * eps)
        np.testing.assert_allclose(float(jnp.vdot(gx, v)), float(fd), rtol=1e-6, atol=1e-9)


def test_bfloat16_compute_close_to_numpy():
    cfg = _cfg(2, dtype="bfloat16")
    params, a_hat, x, _ = _inputs(cfg, 4, seed=6)
    got = apply_encoder(params, a_hat, x, cfg)
    assert got.dtype == jnp.float32
    want = numpy_encoder(params, a_hat, x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=5e-2, atol=5e-2)


def test_stgcn_head_reads_last_slice():
    """Standalone STGCN: encoder (final dropout) then a dense head on the
    last time slice, laid out [H, N, 12-vars]."""
    cfg = dataclasses.replace(_cfg(2), num_weather_vars=4)
    g = _graph(3)
    params = init_stgcn(jax.random.key(0), cfg)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(W, g.padded_nodes, cfg.in_channels)),
        jnp.float32,
    )
    got = apply_stgcn(params, jnp.asarray(g.a_hat), x, cfg)
    enc = numpy_encoder(params["encoder"], g.a_hat, x)[-1]
    head = enc @ np.asarray(params["head"]["w"]) + np.asarray(params["head"]["b"])
    want = np.swapaxes(head.reshape(-1, cfg.horizon, cfg.num_weather_vars), 0, 1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-5)
