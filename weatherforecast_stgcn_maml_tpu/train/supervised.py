"""Supervised single-region training — the regional-adaptation engine core.

JAX counterpart of the fine-tuning loop in adapt_hybrid_v5.py:182-231:
one jitted train step consumes a *batch* of windows gathered device-side
(data/windows.py) instead of the reference's host-marshalled batch-size-1
DataLoader; the climate-aware learning rate enters as a traced scalar so the
host-side ClimateAwareLRScheduler (train/optimizers.py) never forces a
recompile.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp  # noqa: F401  (jnp types in signatures)

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, slice_window
from weatherforecast_stgcn_maml_tpu.models.registry import apply_model
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse


class SupervisedState(NamedTuple):
    params: Any
    opt_state: Any


def batched_forward(
    params, a_hat, x, koppen, model_cfg: ModelConfig, *, train: bool, rng
):
    """vmap the model over a [B, W, N, C] window batch with per-sample rngs."""
    b = x.shape[0]
    if rng is not None:
        rngs = jax.random.split(rng, b)
        return jax.vmap(
            lambda xi, ri: apply_model(
                params, a_hat, xi, koppen, model_cfg, train=train, rng=ri
            )
        )(x, rngs)
    return jax.vmap(
        lambda xi: apply_model(params, a_hat, xi, koppen, model_cfg, train=train)
    )(x)


def make_train_step(model_cfg: ModelConfig, tx):
    """Build `step(state, batch, a_hat, node_mask, koppen, lr, rng)`.

    `tx` must be a chain ending in `scale_by_adam` (or similar) producing a
    preconditioned ascent direction; the step applies `params -= lr * u`.
    """

    def loss_fn(params, a_hat, x, y, koppen, node_mask, rng):
        preds = batched_forward(
            params, a_hat, x, koppen, model_cfg, train=True, rng=rng
        )
        return masked_mse(preds, y, node_mask)

    @jax.jit
    def step(state: SupervisedState, x, y, a_hat, node_mask, koppen, lr, rng):
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, a_hat, x, y, koppen, node_mask, rng
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = jax.tree.map(lambda p, u: p - lr * u, state.params, updates)
        return SupervisedState(params, opt_state), loss

    return step


def make_eval_step(model_cfg: ModelConfig):
    """Build `eval_step(params, x, y, a_hat, node_mask, koppen) -> mse`."""

    @jax.jit
    def eval_step(params, x, y, a_hat, node_mask, koppen):
        preds = batched_forward(
            params, a_hat, x, koppen, model_cfg, train=False, rng=None
        )
        return masked_mse(preds, y, node_mask)

    return eval_step


def make_epoch_fn(model_cfg: ModelConfig, tx, spec: WindowSpec):
    """The pure (unjitted) compiled-epoch function.

    `epoch_fn(state, features, anchor_batches, a_hat, node_mask, koppen,
    lr, rng) -> (state, batch_losses)` scans over `[nb, B]` anchor batches,
    gathering each window batch from the HBM-resident `[T, N, C]` feature
    tensor inside the scan. Shared by the single-region runner below and
    the mesh-sharded region fleet (parallel/fleet_mesh.py), which vmaps it
    over a leading region axis.
    """

    def loss_fn(params, features, anchors, a_hat, node_mask, koppen, rng):
        x, y = jax.vmap(lambda a: slice_window(features, a, spec))(anchors)
        preds = batched_forward(
            params, a_hat, x, koppen, model_cfg, train=True, rng=rng
        )
        return masked_mse(preds, y, node_mask)

    def epoch_fn(state, features, anchor_batches, a_hat, node_mask, koppen, lr, rng):
        def body(carry, inp):
            st = carry
            anchors, step_rng = inp
            loss, grads = jax.value_and_grad(loss_fn)(
                st.params, features, anchors, a_hat, node_mask, koppen, step_rng
            )
            updates, opt_state = tx.update(grads, st.opt_state, st.params)
            params = jax.tree.map(lambda p, u: p - lr * u, st.params, updates)
            return SupervisedState(params, opt_state), loss

        nb = anchor_batches.shape[0]
        rngs = jax.random.split(rng, nb)
        return jax.lax.scan(body, state, (anchor_batches, rngs))

    return epoch_fn


def make_epoch_runner(model_cfg: ModelConfig, tx, spec: WindowSpec):
    """Jitted single-region training epoch — one device program per epoch,
    zero host round-trips (the reference dispatches ~960 host-built batches
    per epoch, adapt_hybrid_v5.py:189-203). Donates the state."""
    return partial(jax.jit, donate_argnums=(0,))(make_epoch_fn(model_cfg, tx, spec))


def make_batched_eval(model_cfg: ModelConfig, spec: WindowSpec):
    """Compiled evaluation over `[nb, B]` anchor batches.

    Returns per-WINDOW MSEs `[nb, B]` (not per-batch means) so callers can
    drop padding windows and aggregate with exact per-window weighting.
    """

    @jax.jit
    def run_eval(params, features, anchor_batches, a_hat, node_mask, koppen):
        def body(_, anchors):
            x, y = jax.vmap(lambda a: slice_window(features, a, spec))(anchors)
            preds = batched_forward(
                params, a_hat, x, koppen, model_cfg, train=False, rng=None
            )
            per_window = jax.vmap(
                lambda p, t: masked_mse(p, t, node_mask)
            )(preds, y)
            return None, per_window

        _, losses = jax.lax.scan(body, None, anchor_batches)
        return losses

    return run_eval


def make_predict(model_cfg: ModelConfig):
    """Build `predict(params, x, a_hat, koppen) -> [B, H, N, 12]` (eval mode).

    Cached per ModelConfig so validate/forecast across an 18-region
    pipeline reuse ONE compiled program instead of recompiling per region.
    """
    return _make_predict_cached(model_cfg)


@lru_cache(maxsize=8)
def _make_predict_cached(model_cfg: ModelConfig):
    @jax.jit
    def predict(params, x, a_hat, koppen):
        return batched_forward(
            params, a_hat, x, koppen, model_cfg, train=False, rng=None
        )

    return predict
