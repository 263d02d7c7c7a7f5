"""Node-sharded (spatial-parallel) forward vs the unsharded reference path."""

import jax
import jax.numpy as jnp
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import MeshConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.graph import (
    build_distance_weighted_graph,
    build_region_graph,
)
from weatherforecast_stgcn_maml_tpu.models.hybrid import apply_hybrid, init_hybrid
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh
from weatherforecast_stgcn_maml_tpu.parallel.spatial import (
    make_spatial_forward,
    spatial_mse,
)

CFG = ModelConfig(
    hidden_channels=16,
    gcn_layers=2,
    lstm_hidden=8,
    lstm_layers=2,
    window=6,
    horizon=3,
    koppen_dim=4,
    gcn_dropout=0.0,
    lstm_dropout=0.0,
)


def _mesh(axis="sp", n=8):
    return make_mesh(MeshConfig(data_axis=axis, num_devices=n))


def test_spatial_forward_matches_unsharded():
    mesh = _mesh()
    g = build_region_graph(np.arange(5.0), np.arange(6.0), pad_to=128)
    params = init_hybrid(jax.random.key(0), CFG)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(CFG.window, 128, CFG.feature_channels)),
        jnp.float32,
    )
    a = jnp.asarray(g.a_hat)
    kop = jnp.int32(3)

    ref = apply_hybrid(params, a, x, kop, CFG, train=False)
    fwd = make_spatial_forward(CFG, mesh)
    got = fwd(params, a, x, kop)
    assert got.shape == (CFG.horizon, 128, 12)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_spatial_mse_matches_masked_mse():
    mesh = _mesh()
    rng = np.random.default_rng(1)
    preds = jnp.asarray(rng.normal(size=(3, 128, 12)), jnp.float32)
    targets = jnp.asarray(rng.normal(size=(3, 128, 12)), jnp.float32)
    mask = np.zeros(128, np.float32)
    mask[:30] = 1.0
    ref = masked_mse(preds, targets, jnp.asarray(mask))
    got = spatial_mse(mesh)(preds, targets, jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_spatial_train_step_matches_unsharded_gradients():
    """Node-sharded training gradients (dropout off) must equal the
    unsharded value_and_grad of masked_mse(apply_hybrid)."""
    import optax

    from weatherforecast_stgcn_maml_tpu.parallel.spatial import (
        make_spatial_train_step,
    )

    mesh = _mesh()
    g = build_region_graph(np.arange(5.0), np.arange(6.0), pad_to=128)
    params = init_hybrid(jax.random.key(0), CFG)
    rng_np = np.random.default_rng(0)
    x = jnp.asarray(rng_np.normal(size=(CFG.window, 128, CFG.feature_channels)), jnp.float32)
    y = jnp.asarray(rng_np.normal(size=(CFG.horizon, 128, 12)), jnp.float32)
    a = jnp.asarray(g.a_hat)
    mask = jnp.asarray(g.node_mask)
    kop = jnp.int32(3)

    # The step convention applies `params -= lr * tx_output`, so tx must
    # yield an ascent direction (like scale_by_adam); identity == raw grads.
    tx = optax.identity()
    step = make_spatial_train_step(CFG, mesh, tx)
    p2, _, loss = step(
        params, tx.init(params), a, x, y, kop, mask, jnp.float32(0.1),
        jax.random.key(5),
    )

    def ref_loss(p):
        preds = apply_hybrid(p, a, x, kop, CFG, train=True, rng=jax.random.key(99))
        return masked_mse(preds, y, mask)

    # CFG has zero dropout -> train mode is deterministic; compare params
    # after one step against the reference update.
    ref_l, ref_g = jax.value_and_grad(ref_loss)(params)
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-5)
    for pa, pb, gg in zip(
        jax.tree.leaves(p2), jax.tree.leaves(params), jax.tree.leaves(ref_g)
    ):
        np.testing.assert_allclose(
            np.asarray(pa), np.asarray(pb) - 0.1 * np.asarray(gg),
            rtol=2e-4, atol=2e-6,
        )


def test_spatial_train_step_learns_with_dropout():
    """With real dropout rates the sharded step still runs and reduces loss."""
    import dataclasses

    import optax

    from weatherforecast_stgcn_maml_tpu.parallel.spatial import (
        make_spatial_train_step,
    )

    cfg = dataclasses.replace(CFG, gcn_dropout=0.1, lstm_dropout=0.1)
    mesh = _mesh()
    g = build_region_graph(np.arange(5.0), np.arange(6.0), pad_to=128)
    params = init_hybrid(jax.random.key(0), cfg)
    rng_np = np.random.default_rng(1)
    x = jnp.asarray(rng_np.normal(size=(cfg.window, 128, cfg.feature_channels)), jnp.float32)
    y = jnp.asarray(rng_np.normal(size=(cfg.horizon, 128, 12)) * 0.1, jnp.float32)
    a = jnp.asarray(g.a_hat)
    mask = jnp.asarray(g.node_mask)
    tx = optax.scale_by_adam()
    step = make_spatial_train_step(cfg, mesh, tx)
    opt = tx.init(params)
    losses = []
    for i in range(8):
        params, opt, loss = step(
            params, opt, a, x, y, jnp.int32(3), mask, jnp.float32(5e-3),
            jax.random.key(i),
        )
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_distance_weighted_graph():
    g = build_distance_weighted_graph(
        np.arange(4.0), np.arange(4.0), distance_threshold=1.5
    )
    assert g.num_nodes == 16
    assert g.padded_nodes == 128
    a = g.a_hat[:16, :16]
    # Symmetric, self-loops present, zero beyond the threshold.
    np.testing.assert_allclose(a, a.T, atol=1e-6)
    assert np.all(np.diag(a) > 0)
    # Nodes 0 (corner, (0,0)) and 15 ((3,3)) are far apart -> no edge.
    assert a[0, 15] == 0.0
    # Adjacent nodes (dist 1) and diagonal (sqrt2 < 1.5) connected.
    assert a[0, 1] > 0 and a[0, 5] > 0
    # Works in the model like any other adjacency.
    params = init_hybrid(jax.random.key(0), CFG)
    x = jnp.zeros((CFG.window, 128, CFG.feature_channels))
    out = apply_hybrid(params, jnp.asarray(g.a_hat), x, jnp.int32(1), CFG)
    assert np.isfinite(np.asarray(out)).all()
