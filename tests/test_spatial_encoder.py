"""The node-sharded XLA encoder (parallel/spatial.py: one all-gather per GCN
layer inside shard_map) against the unsharded encoder on 2/4/8 virtual
devices: forward and every gradient leaf. A 10x10 grid has 100 real nodes
padded to 128, so real nodes span shards at every sp degree (rows 64-99 sit
in shard 1 at sp=2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from weatherforecast_stgcn_maml_tpu.config import MeshConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.models.hybrid import apply_hybrid, init_hybrid
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu.models.stgcn import apply_encoder, init_encoder
from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh
from weatherforecast_stgcn_maml_tpu.parallel.spatial import (
    _spatial_encoder,
    hybrid_local_forward,
    psum_masked_mse,
)

AXIS = "sp"


def _cfg(layers=2, dtype="float32"):
    return ModelConfig(
        hidden_channels=8, gcn_layers=layers, lstm_hidden=6, lstm_layers=2,
        window=3, horizon=2, koppen_dim=3, gcn_dropout=0.0, lstm_dropout=0.0,
        compute_dtype=dtype,
    )


def _graph():
    g = build_region_graph(np.arange(10.0), np.arange(10.0))
    assert g.num_nodes == 100 and g.padded_nodes == 128
    return g


def _mesh(n):
    return make_mesh(MeshConfig(data_axis=AXIS, num_devices=n))


def _sharded_encoder(cfg, n):
    def local(params, a_rows, h):
        return _spatial_encoder(params, a_rows, h, cfg, AXIS)

    return jax.jit(
        jax.shard_map(
            local, mesh=_mesh(n),
            in_specs=(P(), P(AXIS, None), P(None, AXIS, None)),
            out_specs=P(None, AXIS, None),
        )
    )


def _encoder_inputs(cfg, seed=0, dtype=jnp.float32):
    g = _graph()
    params = init_encoder(jax.random.key(seed), cfg)
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(seed).normal(size=a.shape), params
    )
    x = np.random.default_rng(seed + 1).normal(
        size=(cfg.window, g.padded_nodes, cfg.in_channels)
    )
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return jax.tree.map(cast, params), cast(g.a_hat), cast(x), g


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("layers", [1, 3])
def test_encoder_forward_matches_unsharded(n, layers):
    cfg = _cfg(layers)
    params, a_hat, x, _ = _encoder_inputs(cfg)
    got = _sharded_encoder(cfg, n)(params, a_hat, x)
    want = apply_encoder(params, a_hat, x, cfg, final_dropout=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_encoder_every_gradient_leaf_matches_unsharded_f64(n):
    cfg = _cfg(3, dtype="float64")
    with jax.enable_x64(True):
        params, a_hat, x, g = _encoder_inputs(cfg, seed=2, dtype=jnp.float64)
        sharded = _sharded_encoder(cfg, n)
        weights = jnp.asarray(np.random.default_rng(3).normal(size=(cfg.hidden_channels,)))

        def loss_sharded(p, v):
            return jnp.sum(jnp.tanh(sharded(p, a_hat, v)) * weights)

        def loss_plain(p, v):
            out = apply_encoder(p, a_hat, v, cfg, final_dropout=True)
            return jnp.sum(jnp.tanh(out) * weights)

        gs = jax.grad(loss_sharded, argnums=(0, 1))(params, x)
        gp = jax.grad(loss_plain, argnums=(0, 1))(params, x)
        for a, b in zip(jax.tree.leaves(gs), jax.tree.leaves(gp)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-12)


def _hybrid_inputs(cfg, seed=0):
    g = _graph()
    params = init_hybrid(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(
        rng.normal(size=(cfg.window, g.padded_nodes, cfg.feature_channels)), jnp.float32
    )
    y = jnp.asarray(
        rng.normal(size=(cfg.horizon, g.padded_nodes, cfg.num_weather_vars)), jnp.float32
    )
    return params, jnp.asarray(g.a_hat), x, y, jnp.asarray(g.node_mask)


def _sharded_loss(cfg, n):
    def local(params, a_rows, x, y, mask):
        preds = hybrid_local_forward(params, a_rows, x, jnp.int32(3), cfg, AXIS)
        return psum_masked_mse(preds, y, mask, AXIS)

    return jax.jit(
        jax.shard_map(
            local, mesh=_mesh(n),
            in_specs=(
                P(), P(AXIS, None), P(None, AXIS, None), P(None, AXIS, None), P(AXIS),
            ),
            out_specs=P(),
        )
    )


@pytest.mark.parametrize("n", [2, 4, 8])
def test_hybrid_loss_and_gradients_match_unsharded(n):
    cfg = _cfg(2)
    params, a_hat, x, y, mask = _hybrid_inputs(cfg, seed=4)
    sharded = _sharded_loss(cfg, n)

    def plain(p):
        return masked_mse(apply_hybrid(p, a_hat, x, jnp.int32(3), cfg), y, mask)

    ls, gs = jax.value_and_grad(lambda p: sharded(p, a_hat, x, y, mask))(params)
    lp, gp = jax.value_and_grad(plain)(params)
    np.testing.assert_allclose(float(ls), float(lp), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(gs), jax.tree.leaves(gp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_psum_masked_mse_matches_masked_mse(n):
    g = _graph()
    rng = np.random.default_rng(n)
    preds = jnp.asarray(rng.normal(size=(2, g.padded_nodes, 5)), jnp.float32)
    targets = jnp.asarray(rng.normal(size=(2, g.padded_nodes, 5)), jnp.float32)
    mask = jnp.asarray(g.node_mask)
    fn = jax.jit(
        jax.shard_map(
            lambda p, t, m: psum_masked_mse(p, t, m, AXIS), mesh=_mesh(n),
            in_specs=(P(None, AXIS, None), P(None, AXIS, None), P(AXIS)),
            out_specs=P(),
        )
    )
    np.testing.assert_allclose(
        float(fn(preds, targets, mask)), float(masked_mse(preds, targets, mask)),
        rtol=1e-6,
    )


def test_sharded_dropout_trains_and_stays_finite():
    """With dropout on, each shard draws its own mask stream (fold_in by
    shard index): the loss stays finite and differs from eval mode."""
    cfg = ModelConfig(
        hidden_channels=8, gcn_layers=2, lstm_hidden=6, lstm_layers=2,
        window=3, horizon=2, koppen_dim=3, gcn_dropout=0.4, lstm_dropout=0.4,
    )
    params, a_hat, x, y, mask = _hybrid_inputs(cfg, seed=5)

    def local(params, a_rows, x, y, mask, key, train):
        preds = hybrid_local_forward(
            params, a_rows, x, jnp.int32(3), cfg, AXIS, train=train, rng=key
        )
        return psum_masked_mse(preds, y, mask, AXIS)

    def run(train):
        fn = jax.shard_map(
            lambda *a: local(*a, train=train), mesh=_mesh(4),
            in_specs=(
                P(), P(AXIS, None), P(None, AXIS, None), P(None, AXIS, None),
                P(AXIS), P(),
            ),
            out_specs=P(),
        )
        return float(jax.jit(fn)(params, a_hat, x, y, mask, jax.random.key(0)))

    train_loss, eval_loss = run(True), run(False)
    assert np.isfinite(train_loss) and np.isfinite(eval_loss)
    assert train_loss != eval_loss
