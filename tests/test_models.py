"""Models: shapes, numerics vs hand-computed references, masking invariance."""

import jax
import jax.numpy as jnp
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.models.gcn import apply_gcn_layer, init_gcn_layer
from weatherforecast_stgcn_maml_tpu.models.hybrid import (
    apply_hybrid,
    hybrid_param_count,
    init_hybrid,
)
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mae, masked_mse
from weatherforecast_stgcn_maml_tpu.models.lstm import apply_lstm, init_lstm
from weatherforecast_stgcn_maml_tpu.models.stgcn import apply_stgcn, init_stgcn


def test_gcn_layer_matches_manual():
    key = jax.random.key(0)
    p = init_gcn_layer(key, 3, 5)
    a = jnp.asarray(np.random.default_rng(0).uniform(size=(4, 4)), jnp.float32)
    h = jnp.asarray(np.random.default_rng(1).normal(size=(2, 4, 3)), jnp.float32)
    out = apply_gcn_layer(p, a, h)
    manual = np.einsum("nm,tmc->tnc", np.asarray(a), np.asarray(h) @ np.asarray(p["w"]))
    manual = manual + np.asarray(p["b"])
    np.testing.assert_allclose(np.asarray(out), manual, rtol=1e-5, atol=1e-5)


def _manual_lstm(params, x):
    """Plain-numpy stacked LSTM for parity (gate order i,f,g,o)."""

    def sigmoid(z):
        return 1.0 / (1.0 + np.exp(-z))

    h_in = np.asarray(x)  # [B, T, C]
    for layer in params["layers"]:
        wx, wh, b = map(np.asarray, (layer["wx"], layer["wh"], layer["b"]))
        bsz, t, _ = h_in.shape
        hidden = wh.shape[0]
        h = np.zeros((bsz, hidden))
        c = np.zeros((bsz, hidden))
        outs = []
        for s in range(t):
            gates = h_in[:, s] @ wx + h @ wh + b
            i, f, g, o = np.split(gates, 4, axis=-1)
            c = sigmoid(f) * c + sigmoid(i) * np.tanh(g)
            h = sigmoid(o) * np.tanh(c)
            outs.append(h)
        h_in = np.stack(outs, axis=1)
    return h_in[:, -1]


def test_lstm_matches_manual():
    key = jax.random.key(1)
    params = init_lstm(key, in_dim=3, hidden=4, num_layers=2)
    x = jnp.asarray(np.random.default_rng(2).normal(size=(5, 7, 3)), jnp.float32)
    out = apply_lstm(params, x)  # eval mode: no dropout
    np.testing.assert_allclose(
        np.asarray(out), _manual_lstm(params, x), rtol=1e-4, atol=1e-5
    )


def test_stgcn_shapes(tiny_model_cfg):
    cfg = tiny_model_cfg
    g = build_region_graph(np.arange(3.0), np.arange(5.0), pad_to=128)
    key = jax.random.key(0)
    params = init_stgcn(key, cfg)
    x = jnp.zeros((cfg.window, 128, cfg.in_channels))
    out = apply_stgcn(params, jnp.asarray(g.a_hat), x, cfg)
    assert out.shape == (cfg.horizon, 128, 12)


def test_hybrid_shapes_and_param_count(tiny_model_cfg):
    cfg = tiny_model_cfg
    key = jax.random.key(0)
    params = init_hybrid(key, cfg)
    n = 128
    g = build_region_graph(np.arange(3.0), np.arange(5.0), pad_to=n)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(cfg.window, n, cfg.feature_channels)),
        jnp.float32,
    )
    out = apply_hybrid(params, jnp.asarray(g.a_hat), x, jnp.int32(8), cfg)
    assert out.shape == (cfg.horizon, n, 12)
    assert np.isfinite(np.asarray(out)).all()
    assert hybrid_param_count(params) > 0


def test_reference_scale_param_count():
    """The full-scale hybrid should be in the reference's ~835K ballpark
    (SURVEY.md section 0; computed from train_hybrid_maml_v5.py:31-38).

    Exact torch parity is impossible (we use one LSTM bias instead of two and
    train the Koppen table in-model), so assert the window [700K, 1.1M]."""
    cfg = ModelConfig()
    params = init_hybrid(jax.random.key(0), cfg)
    count = hybrid_param_count(params)
    assert 700_000 < count < 1_100_000, count


def test_padding_nodes_do_not_affect_real_nodes(tiny_model_cfg):
    """Growing the pad must not change real-node outputs (mask isolation)."""
    cfg = tiny_model_cfg
    key = jax.random.key(0)
    params = init_hybrid(key, cfg)
    lats, lons = np.arange(2.0), np.arange(3.0)
    x_real = np.random.default_rng(0).normal(size=(cfg.window, 6, cfg.feature_channels))

    outs = []
    for pad in (128, 256):
        g = build_region_graph(lats, lons, pad_to=pad)
        x = np.zeros((cfg.window, pad, cfg.feature_channels), np.float32)
        x[:, :6] = x_real
        out = apply_hybrid(
            params, jnp.asarray(g.a_hat), jnp.asarray(x), jnp.int32(1), cfg
        )
        outs.append(np.asarray(out)[:, :6])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_masked_losses():
    preds = jnp.ones((2, 4, 3))
    targets = jnp.zeros((2, 4, 3))
    mask = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    assert np.isclose(float(masked_mse(preds, targets, mask)), 1.0)
    assert np.isclose(float(masked_mae(preds, targets, mask)), 1.0)
    # Garbage in masked nodes must not change the loss.
    preds2 = preds.at[:, 2:].set(1e9)
    assert np.isclose(float(masked_mse(preds2, targets, mask)), 1.0)


def test_dropout_active_in_train_mode(tiny_model_cfg):
    cfg = tiny_model_cfg
    key = jax.random.key(0)
    params = init_hybrid(key, cfg)
    g = build_region_graph(np.arange(2.0), np.arange(3.0), pad_to=128)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(cfg.window, 128, cfg.feature_channels)),
        jnp.float32,
    )
    a = jnp.asarray(g.a_hat)
    o1 = apply_hybrid(params, a, x, jnp.int32(1), cfg, train=True, rng=jax.random.key(1))
    o2 = apply_hybrid(params, a, x, jnp.int32(1), cfg, train=True, rng=jax.random.key(2))
    o3 = apply_hybrid(params, a, x, jnp.int32(1), cfg, train=False)
    assert not np.allclose(np.asarray(o1), np.asarray(o2))
    # Eval mode is deterministic.
    o4 = apply_hybrid(params, a, x, jnp.int32(1), cfg, train=False)
    np.testing.assert_array_equal(np.asarray(o3), np.asarray(o4))


def test_stop_base_gradients_freezes_encoder(tiny_model_cfg):
    import dataclasses

    cfg = dataclasses.replace(tiny_model_cfg, stop_base_gradients=True)
    params = init_hybrid(jax.random.key(0), cfg)
    g = build_region_graph(np.arange(2.0), np.arange(3.0), pad_to=128)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(cfg.window, 128, cfg.feature_channels)),
        jnp.float32,
    )

    def loss(p):
        out = apply_hybrid(p, jnp.asarray(g.a_hat), x, jnp.int32(1), cfg)
        return jnp.sum(out**2)

    grads = jax.grad(loss)(params)
    enc_norm = sum(
        float(jnp.abs(l).sum()) for l in jax.tree.leaves(grads["encoder"])
    )
    lstm_norm = sum(float(jnp.abs(l).sum()) for l in jax.tree.leaves(grads["lstm"]))
    assert enc_norm == 0.0
    assert lstm_norm > 0.0


def test_wavefront_lstm_matches_layerwise():
    """apply_lstm_wavefront is mathematically identical to apply_lstm
    (antidiagonal scheduling, same cells) — exact in eval mode."""
    import jax
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu.models.lstm import (
        apply_lstm,
        apply_lstm_wavefront,
        init_lstm,
    )

    for n_layers, t in [(4, 24), (2, 5), (1, 6), (3, 1)]:
        p = init_lstm(jax.random.key(0), 9, 6, n_layers)
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal((5, t, 9)), jnp.float32
        )
        ref = apply_lstm(p, x)
        got = apply_lstm_wavefront(p, x)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    # Train mode: the wavefront draws the EXACT layerwise dropout streams
    # (fold_in(rng, l) over [T, B, H]) gathered to wavefront order, so
    # train-mode values AND gradients match apply_lstm to rounding — the
    # property that lets the wavefront serve as the twice-differentiable
    # Hessian-transpose route in second-order MAML (train/so_grad.py).
    p = init_lstm(jax.random.key(1), 9, 6, 3)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 7, 9)), jnp.float32)
    rng = jax.random.key(2)
    ref = apply_lstm(p, x, dropout_rate=0.3, train=True, rng=rng)
    got = apply_lstm_wavefront(p, x, dropout_rate=0.3, train=True, rng=rng)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    def loss_of(fn):
        def loss(p):
            out = fn(p, x, dropout_rate=0.3, train=True, rng=rng)
            return (out**2).mean()

        return loss

    g = jax.grad(loss_of(apply_lstm_wavefront))(p)
    g_ref = jax.grad(
        loss_of(apply_lstm)
    )(p)
    for u, v in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(u, v, rtol=2e-3, atol=1e-5)


def test_wavefront_single_layer_full_unroll_delegation():
    """Regression: the n_layers==1 delegation must translate unroll=0 (the
    '0 = full unroll' convention) before calling apply_lstm, whose own
    convention treats <=1 as rolled — the results must match apply_lstm
    with an explicit full unroll, and jit must produce straight-line code
    (no scan) like the non-wavefront path does for unroll=0."""
    import jax
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu.models.lstm import (
        apply_lstm,
        apply_lstm_wavefront,
        init_lstm,
    )

    p = init_lstm(jax.random.key(0), 5, 4, 1)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 6, 5)), jnp.float32)
    ref = apply_lstm(p, x, unroll=6)
    got = apply_lstm_wavefront(p, x, unroll=0)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # The delegation must request a FULL unroll from the scan (unroll=6 in
    # the jaxpr's scan params), not the rolled unroll=1 the raw 0 would give.
    jpr_full = str(jax.make_jaxpr(lambda p, x: apply_lstm_wavefront(p, x, unroll=0))(p, x))
    jpr_rolled = str(jax.make_jaxpr(lambda p, x: apply_lstm(p, x, unroll=1))(p, x))
    assert "unroll=6" in jpr_full
    assert "unroll=1" in jpr_rolled
