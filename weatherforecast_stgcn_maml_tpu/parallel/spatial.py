"""Spatial (node-axis) model parallelism via shard_map.

The per-region grids of the reference are tiny (~441 nodes), but the node
axis is this workload's big dimension: continental/global grids at 0.25
degrees reach 1M+ nodes, far beyond one device's memory at hidden width 256.
SURVEY.md §5 (long-context note) prescribes sharding the *node* dimension —
the spatial analog of sequence parallelism. This module implements it with
`jax.shard_map` and explicit collectives:

  * node features `[W, N, C]` are sharded along N; every dense layer,
    LSTM step, and head matmul is node-local (zero communication);
  * graph convolution needs neighbor features: each device holds its row
    block `[N/d, N]` of the normalized adjacency, `all_gather`s the
    feature-transformed activations `H @ W` (the only communication, one
    all-gather per GCN layer), then contracts locally;
  * the masked loss ends with one `psum`.

The all-gather moves `[W, N, hidden]` per layer; with the feature transform
applied *before* gathering, that is the minimal tensor that any node-sharded
GCN must exchange.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.models.common import accum_dtype, apply_dense, resolve_dtype
from weatherforecast_stgcn_maml_tpu.models.lstm import apply_lstm


def psum_masked_mse(preds_local, targets_local, mask_local, axis: str):
    """Node-sharded `models.losses.masked_mse`: local partial sums + psum.

    masked_mse([H, N, C]) = sum(se * mask) / (H * C * max(sum(mask), 1));
    both reductions distribute over node shards.
    """
    se = jnp.square(preds_local - targets_local) * mask_local[:, None]
    num = jax.lax.psum(se.sum(), axis)
    cnt = jax.lax.psum(mask_local.sum(), axis)
    scale = preds_local.shape[0] * preds_local.shape[-1]
    return num / (jnp.maximum(cnt, 1.0) * scale)


def _spatial_encoder(
    params,
    a_rows,
    h_local,
    cfg: ModelConfig,
    axis: str,
    *,
    train: bool = False,
    rng=None,
):
    """GCN stack with node-sharded activations.

    Args:
      a_rows: [N/d, N] this device's row block of the padded adjacency.
      h_local: [W, N/d, C_in] this device's node shard.
      rng: per-SHARD key (already folded with the shard index) for dropout.
    Returns [W, N/d, hidden].
    """
    from weatherforecast_stgcn_maml_tpu.models.common import dropout

    dtype = resolve_dtype(cfg.compute_dtype)
    acc = accum_dtype(dtype)
    h = h_local
    n_layers = len(params["layers"])
    for l, layer in enumerate(params["layers"]):
        w = layer["w"].astype(dtype)
        hw_local = jnp.dot(h.astype(dtype), w, preferred_element_type=acc)
        # One all-gather per layer: [W, N/d, C_out] -> [W, N, C_out].
        hw_full = jax.lax.all_gather(hw_local, axis, axis=1, tiled=True)
        h = (
            jnp.einsum(
                "nm,...mc->...nc",
                a_rows.astype(dtype),
                hw_full.astype(dtype),
                preferred_element_type=acc,
            )
            + layer["b"]
        )
        h = jax.nn.relu(h)
        if l < n_layers - 1:
            sub = jax.random.fold_in(rng, l) if rng is not None else None
            h = dropout(h, cfg.gcn_dropout, sub, train=train)
    return h


def make_spatial_forward(model_cfg: ModelConfig, mesh, axis: str = "sp"):
    """Build a node-sharded hybrid forward (inference path).

    Returns `fwd(params, a_hat, x, koppen) -> preds [H, N, 12]` where the
    node axis of `a_hat` (rows), `x`, and the output are sharded over
    `axis`. N must be divisible by the mesh size (graph padding guarantees
    a multiple of 128). Dropout is off — this is the large-grid serving
    path; training at this scale would add rng plumbing per shard.
    """

    def local_fwd(params, a_rows, x_local, koppen):
        w, n_local, _ = x_local.shape
        emb = params["koppen"][koppen]
        emb = jnp.broadcast_to(emb, (w, n_local, emb.shape[-1]))
        h = jnp.concatenate([x_local, emb.astype(x_local.dtype)], axis=-1)
        h = _spatial_encoder(params["encoder"], a_rows, h, model_cfg, axis)
        h = jnp.swapaxes(h, 0, 1)  # [N/d, W, hidden] — nodes stay local
        feat = apply_lstm(
            params["lstm"], h,
            compute_dtype=resolve_dtype(model_cfg.compute_dtype),
            unroll=model_cfg.lstm_unroll,  # 0 = full (normalized in apply_lstm)
        )
        out = apply_dense(
            params["head"], feat,
            compute_dtype=resolve_dtype(model_cfg.compute_dtype),
        )
        out = out.reshape(n_local, model_cfg.horizon, model_cfg.num_weather_vars)
        return jnp.swapaxes(out, 0, 1)  # [H, N/d, 12]

    sharded = jax.shard_map(
        local_fwd,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(None, axis, None), P()),
        out_specs=P(None, axis, None),
    )
    return jax.jit(sharded)


def hybrid_local_forward(
    params,
    a_rows,
    x_local,
    koppen,
    model_cfg: ModelConfig,
    axis: str,
    *,
    train: bool = False,
    rng=None,
):
    """Node-sharded hybrid forward for use INSIDE a shard_map body.

    Args:
      a_rows: [N/d, N] this device's adjacency row block.
      x_local: [W, N/d, C] this device's node shard of the window.
      rng: UNSHARDED key (identical across shards); dropout folds in the
        shard index so every shard draws an independent stream — same
        convention as `make_spatial_train_step`. None disables dropout.
    Returns [H, N/d, 12] local predictions.

    The node axis is the LSTM batch axis, so the LSTM runs on the local rows
    with no communication; the GCN stack does one all-gather per layer
    (`_spatial_encoder`).
    """
    w, n_local, _ = x_local.shape
    if rng is not None:
        shard_rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        enc_rng, lstm_rng, head_rng = jax.random.split(shard_rng, 3)
    else:
        enc_rng = lstm_rng = head_rng = None
    emb = params["koppen"][koppen]
    emb = jnp.broadcast_to(emb, (w, n_local, emb.shape[-1]))
    h = jnp.concatenate([x_local, emb.astype(x_local.dtype)], axis=-1)
    h = _spatial_encoder(
        params["encoder"], a_rows, h, model_cfg, axis, train=train, rng=enc_rng
    )
    if model_cfg.stop_base_gradients:
        # Same honest-freeze semantics as the single-device path
        # (models/hybrid.py); pair with an optax.masked optimizer to
        # also exclude the encoder from weight decay.
        h = jax.lax.stop_gradient(h)
    h = jnp.swapaxes(h, 0, 1)  # [N/d, W, hidden]
    dtype = resolve_dtype(model_cfg.compute_dtype)
    feat = apply_lstm(
        params["lstm"], h,
        dropout_rate=model_cfg.lstm_dropout, train=train, rng=lstm_rng,
        compute_dtype=dtype,
        unroll=model_cfg.lstm_unroll,  # 0 = full (normalized in apply_lstm)
    )
    from weatherforecast_stgcn_maml_tpu.models.common import dropout

    feat = dropout(feat, model_cfg.lstm_dropout, head_rng, train=train)
    out = apply_dense(params["head"], feat, compute_dtype=dtype)
    out = out.reshape(n_local, model_cfg.horizon, model_cfg.num_weather_vars)
    return jnp.swapaxes(out, 0, 1)  # [H, N/d, 12]


def make_spatial_train_step(model_cfg: ModelConfig, mesh, tx, axis: str = "sp"):
    """Node-sharded TRAINING step for grids beyond one device's activation
    memory: forward and backward both run with the node axis sharded
    (autodiff through shard_map inserts the psum for the replicated-param
    gradients), dropout uses a per-shard rng (fold_in by shard index), and
    `tx` updates replicated params.

    Returns `step(params, opt_state, a_hat, x, y, koppen, mask, lr, rng)
    -> (params, opt_state, loss)`; a_hat rows / x / y / mask are sharded
    along `axis` by the jit's sharding constraints.

    `tx` follows the same convention as train/supervised.py: a chain ending
    in `scale_by_adam` (or similar) emitting a preconditioned ASCENT
    direction; the step applies `params -= lr * u`. Do NOT pass a stock
    lr-scaled optimizer like `optax.adam(lr)` (its updates are already
    negated descent steps meant for `optax.apply_updates` — here they would
    invert into gradient ascent).
    """

    def local_fwd(params, a_rows, x_local, koppen, rng):
        return hybrid_local_forward(
            params, a_rows, x_local, koppen, model_cfg, axis,
            train=True, rng=rng,
        )

    def local_loss(params, a_rows, x_local, y_local, koppen, mask_local, rng):
        preds = local_fwd(params, a_rows, x_local, koppen, rng)
        se = jnp.square(preds - y_local) * mask_local[:, None]
        num = jax.lax.psum(se.sum(), axis)
        cnt = jax.lax.psum(mask_local.sum(), axis)
        scale = preds.shape[0] * preds.shape[-1]
        return num / (jnp.maximum(cnt, 1.0) * scale)

    sharded_loss = jax.shard_map(
        local_loss,
        mesh=mesh,
        in_specs=(
            P(),
            P(axis, None),
            P(None, axis, None),
            P(None, axis, None),
            P(),
            P(axis),
            P(),
        ),
        out_specs=P(),
    )

    @jax.jit
    def step(params, opt_state, a_hat, x, y, koppen, mask, lr, rng):
        loss, grads = jax.value_and_grad(sharded_loss)(
            params, a_hat, x, y, koppen, mask, rng
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p - lr * u, params, updates)
        return params, opt_state, loss

    return step


def spatial_mse(mesh, axis: str = "sp"):
    """Node-sharded masked MSE: local partial sums + one psum."""

    def local_mse(preds_local, targets_local, mask_local):
        se = jnp.square(preds_local - targets_local) * mask_local[:, None]
        num = jax.lax.psum(se.sum(), axis)
        cnt = jax.lax.psum(mask_local.sum(), axis)
        scale = preds_local.shape[0] * preds_local.shape[-1]
        return num / (jnp.maximum(cnt, 1.0) * scale)

    fn = jax.shard_map(
        local_mse,
        mesh=mesh,
        in_specs=(P(None, axis, None), P(None, axis, None), P(axis)),
        out_specs=P(),
    )
    return jax.jit(fn)
