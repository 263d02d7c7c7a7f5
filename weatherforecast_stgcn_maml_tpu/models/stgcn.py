"""STGCN backbone: stacked per-timestep graph convolutions + forecast head.

Capability match for the reference STGCN (model.py:7-52) with the *intended*
semantics: the same N-node normalized adjacency is applied to each of the W
time slices (the reference flattens [W*N] rows against an N-node edge list,
so message passing only ever touches the oldest slice — SURVEY.md 3.3).

The encoder (conv stack without the head) is shared with the hybrid model,
mirroring `extract_base_features` (hybrid_model.py:60-78): ReLU after every
conv, dropout after every conv *except the last*.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.models.common import (
    Params,
    apply_dense,
    dropout,
    init_dense,
    resolve_dtype,
)
from weatherforecast_stgcn_maml_tpu.models.gcn import apply_gcn_layer, init_gcn_layer


def init_encoder(key, cfg: ModelConfig) -> Params:
    keys = jax.random.split(key, cfg.gcn_layers)
    layers = []
    d_in = cfg.in_channels
    for l in range(cfg.gcn_layers):
        layers.append(init_gcn_layer(keys[l], d_in, cfg.hidden_channels))
        d_in = cfg.hidden_channels
    return {"layers": layers}


def apply_encoder(
    params: Params,
    a_hat: jnp.ndarray,
    x: jnp.ndarray,
    cfg: ModelConfig,
    *,
    train: bool = False,
    rng=None,
    final_dropout: bool = False,
) -> jnp.ndarray:
    """Spatial encoder over [..., W, N, C_in] -> [..., W, N, hidden].

    `final_dropout=False` reproduces the hybrid feature-extraction path
    (hybrid_model.py:76: "Don't apply final dropout"); the standalone STGCN
    forward uses `final_dropout=True` (model.py:40-42).
    """
    dtype = resolve_dtype(cfg.compute_dtype)
    h = x
    n_layers = len(params["layers"])
    with jax.named_scope("gcn_encoder"):
        for l, layer in enumerate(params["layers"]):
            h = apply_gcn_layer(layer, a_hat, h, compute_dtype=dtype)
            h = jax.nn.relu(h)
            if l < n_layers - 1 or final_dropout:
                sub = jax.random.fold_in(rng, l) if rng is not None else None
                h = dropout(h, cfg.gcn_dropout, sub, train=train)
    return h


def init_stgcn(key, cfg: ModelConfig) -> Params:
    ek, hk = jax.random.split(key)
    return {
        "encoder": init_encoder(ek, cfg),
        "head": init_dense(
            hk, cfg.hidden_channels, cfg.num_weather_vars * cfg.horizon
        ),
    }


def init_stgcn_forecaster(key, cfg: ModelConfig) -> Params:
    """Standalone-STGCN model with an in-model Koppen embedding, so it is a
    drop-in `family="stgcn"` alternative to the hybrid across all engines."""
    sk, kk = jax.random.split(key)
    params = init_stgcn(sk, cfg)
    params["koppen"] = jax.random.normal(kk, (cfg.koppen_classes, cfg.koppen_dim))
    return params


def apply_stgcn_forecaster(
    params: Params,
    a_hat: jnp.ndarray,
    x: jnp.ndarray,
    koppen_code: jnp.ndarray,
    cfg: ModelConfig,
    *,
    train: bool = False,
    rng=None,
) -> jnp.ndarray:
    """[W, N, 16] features + Koppen code -> [H, N, 12] forecasts (same
    signature as models.hybrid.apply_hybrid)."""
    w, n, _ = x.shape
    emb = params["koppen"][koppen_code]
    emb = jnp.broadcast_to(emb, (w, n, emb.shape[-1]))
    h = jnp.concatenate([x, emb.astype(x.dtype)], axis=-1)
    return apply_stgcn(
        {"encoder": params["encoder"], "head": params["head"]},
        a_hat, h, cfg, train=train, rng=rng,
    )


def apply_stgcn(
    params: Params,
    a_hat: jnp.ndarray,
    x: jnp.ndarray,
    cfg: ModelConfig,
    *,
    train: bool = False,
    rng=None,
) -> jnp.ndarray:
    """Standalone STGCN forward: [W, N, C_in] -> predictions [H, N, 12].

    Reads out the **last** time slice and projects it to the full horizon
    (model.py:44-52), with output laid out [H, N, 12] so prediction rows
    align with target rows (the reference flattens them inconsistently —
    SURVEY.md quirks).
    """
    dtype = resolve_dtype(cfg.compute_dtype)
    h = apply_encoder(
        params["encoder"], a_hat, x, cfg, train=train, rng=rng,
        final_dropout=True,
    )
    last = h[..., -1, :, :]  # [..., N, hidden]
    out = apply_dense(params["head"], last, compute_dtype=dtype)
    out = out.reshape(*out.shape[:-1], cfg.horizon, cfg.num_weather_vars)
    return jnp.swapaxes(out, -3, -2)  # [..., H, N, 12]
