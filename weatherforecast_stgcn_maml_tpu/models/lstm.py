"""Multi-layer LSTM as `lax.scan` over time, batched over nodes.

The reference runs one cuDNN LSTM launch *per node* in a Python loop
(hybrid_model.py:94-102) — N sequential kernel launches per forward. Here the
node axis is simply the batch axis of a scanned LSTM: one compiled scan of W
steps processes all nodes at once, each step being two matmuls
([N, C] @ [C, 4H] and [N, H] @ [H, 4H]). The input projection for *all*
timesteps is hoisted out of the scan into a single [W*N, C] @ [C, 4H] matmul
(the recurrent matmul is the only sequential dependency).

Gate order is (i, f, g, o); a single bias per layer (the sum of torch's
b_ih + b_hh is mathematically identical).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.common import (
    Params,
    accum_dtype,
    dropout,
    lstm_bias,
    scaled_uniform,
)


def init_lstm(key, in_dim: int, hidden: int, num_layers: int) -> Params:
    """Uniform(-1/sqrt(hidden)) init, the torch.nn.LSTM scheme, so parameter
    scales match the reference (hybrid_model.py:42-49)."""
    layers = []
    bound = 1.0 / float(hidden) ** 0.5
    for l in range(num_layers):
        key, kx, kh, kb = jax.random.split(key, 4)
        d_in = in_dim if l == 0 else hidden
        layers.append(
            {
                "wx": scaled_uniform(kx, (d_in, 4 * hidden), bound),
                "wh": scaled_uniform(kh, (hidden, 4 * hidden), bound),
                "b": scaled_uniform(kb, (4 * hidden,), bound),
            }
        )
    return {"layers": layers}


def _lstm_recurrence(xp, wh, *, compute_dtype=jnp.float32, unroll: int = 1):
    """Recurrent part of one LSTM layer via lax.scan.

    Args:
      xp: [T, B, 4H] pre-computed input projection + bias (accum dtype).
      wh: [H, 4H] recurrent weights (cast to compute_dtype).
    Returns:
      h_all: [T, B, H] hidden states for every step.
    """
    t = xp.shape[0]
    hidden = wh.shape[0]
    acc = accum_dtype(compute_dtype)
    whc = wh.astype(compute_dtype)

    def step(carry, x_t):
        h, c = carry
        gates = x_t + jnp.dot(
            h.astype(compute_dtype), whc, preferred_element_type=acc
        )
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        c = f * c + i * jnp.tanh(g)
        h = o * jnp.tanh(c)
        return (h, c), h

    # Zero carry derived from a traced input: dtype AND device-varying type
    # must match under shard_map.
    zero = xp[0, :, :hidden] * 0.0
    _, h_all = jax.lax.scan(
        step, (zero, zero), xp, unroll=max(1, min(unroll, t))
    )
    return h_all


def _lstm_layer(
    p: Params,
    x_tbc: jnp.ndarray,
    *,
    compute_dtype=jnp.float32,
    unroll: int = 1,
) -> jnp.ndarray:
    """One LSTM layer over time-major input [T, B, C] -> outputs [T, B, H]."""
    acc = accum_dtype(compute_dtype)
    wx = p["wx"].astype(compute_dtype)
    bias = lstm_bias(p)

    # Hoist the input projection out of the scan: [T, B, C] @ [C, 4H].
    x_proj = (
        jnp.dot(x_tbc.astype(compute_dtype), wx, preferred_element_type=acc)
        + bias
    )
    return _lstm_recurrence(
        x_proj, p["wh"], compute_dtype=compute_dtype, unroll=unroll
    )


def apply_lstm_wavefront(
    params: Params,
    x: jnp.ndarray,
    *,
    dropout_rate: float = 0.0,
    train: bool = False,
    rng=None,
    compute_dtype=jnp.float32,
    unroll: int = 0,
) -> jnp.ndarray:
    """Stacked LSTM advanced on the (layer, time) antidiagonal wavefront.

    The layer-by-layer formulation (`apply_lstm`) executes L*T sequential
    recurrent matmuls; but cell (l, t) only depends on (l, t-1) and
    (l-1, t), so every cell on the antidiagonal k = l + t is independent.
    Advancing the whole wavefront at once needs only T+L-1 sequential steps,
    each ONE lane-batched matmul [L, B, 2H] @ [L, 2H, 4H] (inter-layer input
    and recurrent contributions concatenated) — a ~3.5x cut in sequential
    depth for the 4x24 reference shape.

    Mathematically identical to `apply_lstm` INCLUDING the train-mode
    dropout realization: the inter-layer masks are drawn from the exact
    layerwise streams (`fold_in(rng, l)` over [T, B, H], like `apply_lstm`)
    and gathered per wavefront step — lane l's input at step k is layer
    l-1's output at time k-l, so it takes mask element [l-1, k-l]. This
    makes the wavefront a legal twice-differentiable stand-in for the
    layerwise route inside second-order MAML's Hessian transpose
    (train/so_grad.py), where the HVP must be of the SAME stochastic loss
    the inner gradient used (values agree to accumulation-order rounding;
    masks agree exactly). Lane l is reset at its first active step, so
    pre-start garbage never reaches an active cell.

    Args/returns match `apply_lstm`: x [B, T, C] -> last hidden [B, H].
    """
    layers = params["layers"]
    n_layers = len(layers)
    if n_layers == 1:
        return apply_lstm(
            params, x, dropout_rate=dropout_rate, train=train, rng=rng,
            compute_dtype=compute_dtype, unroll=unroll,
        )
    x_tbc = jnp.swapaxes(x, 0, 1)  # [T, B, C]
    t_len, b, _ = x_tbc.shape
    hidden = layers[0]["wh"].shape[0]
    acc = accum_dtype(compute_dtype)

    # Layer 0's input projection has its own width (C != H) — hoist it out
    # as one big [T*B, C] @ [C, 4H] matmul, like the layerwise formulation.
    xproj0 = (
        jnp.dot(
            x_tbc.astype(compute_dtype),
            layers[0]["wx"].astype(compute_dtype),
            preferred_element_type=acc,
        )
        + lstm_bias(layers[0])
    )  # [T, B, 4H]

    # Lane-stacked weights: lane l computes [inter-layer input, recurrent]
    # @ [[wx_l], [wh_l]]. Lane 0 has no in-wavefront input (xproj0 is added
    # explicitly), so its wx slot is zero.
    w_cat = jnp.stack(
        [
            jnp.concatenate(
                [
                    jnp.zeros((hidden, 4 * hidden), compute_dtype)
                    if l == 0
                    else layers[l]["wx"].astype(compute_dtype),
                    layers[l]["wh"].astype(compute_dtype),
                ],
                axis=0,
            )
            for l in range(n_layers)
        ]
    )  # [L, 2H, 4H]
    bias = jnp.stack(
        [jnp.zeros_like(lstm_bias(layers[0]))]
        + [lstm_bias(layers[l]) for l in range(1, n_layers)]
    )  # [L, 4H] (lane 0's bias lives in xproj0)

    # Zero carries derived from a traced input (dtype AND device-varying
    # type must match under shard_map — see _lstm_layer).
    zero_lane = xproj0[0, :, :hidden] * 0.0  # [B, H]
    zeros = zero_lane[None] + jnp.zeros((n_layers, 1, 1), zero_lane.dtype)
    lane_idx = jnp.arange(n_layers)
    n_steps = t_len + n_layers - 1

    # Exact layerwise dropout masks, gathered to wavefront order: lane l's
    # inter-layer input at step k is layer l-1's output at time k-l, so the
    # mask it needs is element [t=k-l] of the layerwise stream
    # fold_in(rng, l-1) (apply_lstm). Indices are clamped where a lane is
    # pre-start / past-end — those inputs never reach the final output (the
    # lane-reset argument above), so the reused mask values are inert.
    use_dropout = train and dropout_rate > 0.0 and rng is not None
    if use_dropout:
        keep = 1.0 - dropout_rate
        masks = jnp.stack(
            [
                jax.random.bernoulli(
                    jax.random.fold_in(rng, l), keep, (t_len, b, hidden)
                )
                for l in range(n_layers - 1)
            ]
        )  # [L-1, T, B, H] — bit-identical to apply_lstm's draws
        t_idx = jnp.clip(
            jnp.arange(n_steps)[:, None] - jnp.arange(1, n_layers)[None, :],
            0,
            t_len - 1,
        )  # [n_steps, L-1]
        wf_masks = masks[
            jnp.arange(n_layers - 1)[None, :], t_idx
        ]  # [n_steps, L-1, B, H]
    else:
        keep = 1.0
        wf_masks = jnp.zeros((n_steps, 0, b, hidden), jnp.bool_)

    def step(carry, k_and_mask):
        k, mask_k = k_and_mask
        h_prev, c_prev = carry  # [L, B, H] — all lanes' state after step k-1
        # Lane l's inter-layer input at step k is lane l-1's output from
        # step k-1 (time k-l), i.e. h_prev shifted down one lane.
        shifted = jnp.concatenate([zeros[:1], h_prev[:-1]], axis=0)
        if use_dropout:
            # Inverted dropout exactly as models/common.dropout applies it
            # layerwise: where(mask, x / keep, 0). Lane 0 has no
            # inter-layer input (xproj0 is added explicitly) — no mask.
            dropped = jnp.where(mask_k, shifted[1:] / keep, 0.0)
            shifted = jnp.concatenate([shifted[:1], dropped], axis=0)
        # Reset a lane's own recurrence at its first active step (t == 0).
        starting = (k - lane_idx == 0)[:, None, None]
        h_own = jnp.where(starting, 0.0, h_prev)
        c_own = jnp.where(starting, 0.0, c_prev)

        in_cat = jnp.concatenate(
            [shifted.astype(compute_dtype), h_own.astype(compute_dtype)], axis=-1
        )  # [L, B, 2H]
        gates = (
            jnp.einsum("lbh,lhg->lbg", in_cat, w_cat, preferred_element_type=acc)
            + bias[:, None, :]
        )
        t0 = jnp.clip(k, 0, t_len - 1)
        g0 = jax.lax.dynamic_index_in_dim(xproj0, t0, 0, keepdims=False)
        gates = gates.at[0].add(g0)

        i, f, g, o = jnp.split(gates, 4, axis=-1)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        c_new = f * c_own + i * jnp.tanh(g)
        h_new = o * jnp.tanh(c_new)
        return (h_new, c_new), None

    (h_final, _), _ = jax.lax.scan(
        step, (zeros, zeros), (jnp.arange(n_steps), wf_masks),
        unroll=n_steps if unroll == 0 else max(1, min(unroll, n_steps)),
    )
    # The last wavefront step computes the top lane at time T-1.
    return h_final[-1]


def apply_lstm(
    params: Params,
    x: jnp.ndarray,
    *,
    dropout_rate: float = 0.0,
    train: bool = False,
    rng=None,
    compute_dtype=jnp.float32,
    unroll: int = 1,
) -> jnp.ndarray:
    """Run the stacked LSTM.

    Args:
      x: [B, T, C] batch-major sequences (B = nodes).
      unroll: scan unroll factor; 0 = unroll fully (trip count T).
    Returns:
      [B, H] last-timestep hidden state of the top layer — the feature the
      hybrid head consumes (hybrid_model.py:101).

    Inter-layer dropout is applied to every layer's output except the last
    (torch.nn.LSTM semantics when num_layers > 1), layer l's mask drawn from
    the fold_in(rng, l) stream.
    """
    if unroll <= 0:
        # "0 = full unroll" convention (cfg.lstm_unroll) normalized HERE so
        # call sites can pass the config value straight through; x is
        # [B, T, C], so full unroll = T.
        unroll = x.shape[1]
    n_layers = len(params["layers"])
    h = jnp.swapaxes(x, 0, 1)  # [T, B, C] time-major for scan
    for l, layer in enumerate(params["layers"]):
        h = _lstm_layer(layer, h, compute_dtype=compute_dtype, unroll=unroll)
        if l < n_layers - 1 and n_layers > 1:
            sub = jax.random.fold_in(rng, l) if rng is not None else None
            h = dropout(h, dropout_rate, sub, train=train)
    return h[-1]  # [B, H]
