"""Functional MAML: grad-through-inner-SGD, vmapped over region tasks.

The reference's meta-training loop (train_hybrid_maml_v5.py:110-184) deep-
copies the model per task, runs 90 SGD steps on the copy, backprops the query
loss into the *copy*, and steps AdamW on the originals — so no meta-gradient
ever reaches the meta-parameters (SURVEY.md quirk 1). This module implements
what that code intends, as a pure function transform:

  inner loop   : `lax.scan` of SGD steps (grad + global-norm clip + update)
                 over the support set — one compiled region of W*N-sized
                 batched matmuls, no per-step dispatch;
  meta-gradient: `jax.grad` THROUGH the scan. `second_order=False` gives
                 FOMAML (inner grads stop_gradient'ed, so the adapted params
                 depend on the meta-params only through the identity chain);
                 `second_order=True` differentiates the full unroll with
                 per-step rematerialization to bound memory;
  task batch   : `jax.vmap` over stacked tasks (regions are padded to a
                 common node count, graph.py), replacing the serial
                 `for task in tasks` loop;
  accumulation : the meta batch is split into `grad_accum` micro-updates
                 scanned sequentially, matching the reference's "AdamW step
                 every 2 tasks" semantics (train_hybrid_maml_v5.py:173-179);
  outer loop   : optax AdamW + cosine warm restarts + clip (optimizers.py).

Everything here is shape-polymorphic over the task structure and jit/pjit
friendly: `parallel/meta_dp.py` shards the task micro-batch over the device
mesh and XLA inserts the psum for the gradient mean.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from weatherforecast_stgcn_maml_tpu.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu.train.optimizers import (
    clip_global_norm_tree,
    meta_optimizer,
)


class Task(NamedTuple):
    """One meta-learning task (a climate region), fully device-resident.

    Only the support samples the inner loop actually touches are shipped:
    the reference iterates the first `min(15, S)` support windows per inner
    epoch without shuffling (train_hybrid_maml_v5.py:121-127), so task
    builders materialize exactly those. All tasks share padded node count N.
    """

    support_x: jnp.ndarray  # [S, W, N, C]
    support_y: jnp.ndarray  # [S, H, N, 12]
    query_x: jnp.ndarray  # [Q, W, N, C]
    query_y: jnp.ndarray  # [Q, H, N, 12]
    koppen: jnp.ndarray  # [] int32 climate class code
    a_hat: jnp.ndarray  # [N, N]
    node_mask: jnp.ndarray  # [N]


class MamlState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray  # optimizer update counter


def init_meta_state(key, model_cfg: ModelConfig, meta_cfg: MetaConfig) -> MamlState:
    params = init_model(key, model_cfg)
    tx, _ = meta_optimizer(meta_cfg)
    return MamlState(
        params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)
    )


def run_inner_scan(inner_step, params, total_steps: int, cfg: MetaConfig):
    """`lax.scan` of `inner_step` under cfg's second-order remat policy.

    Shared by the single-device path below and the shard_map dp x sp path
    (parallel/meta_sp.py) so both build identical inner-SGD jaxpr shapes.
    """
    if cfg.second_order and (
        cfg.so_remat == "sqrt" or cfg.so_remat.startswith("chunk")
    ):
        # Two-level (sqrt) rematerialization: checkpoint only CHUNK
        # boundaries; within a chunk the scan saves full residuals. The
        # backward recomputes each chunk's forward ONCE (vs "step", which
        # recomputes the whole fwd+bwd of EVERY inner step inside its
        # transpose), for sqrt(total)-scaled memory instead of "none"'s
        # full-unroll residency. Classic Griewank checkpoint schedule.
        if cfg.so_remat == "sqrt":
            chunk = max(1, int(total_steps**0.5))
        else:
            chunk = int(cfg.so_remat.split(":", 1)[1])
        if total_steps % chunk:
            # Fall back to the nearest divisor so the scan stays static.
            divs = [d for d in range(1, total_steps + 1) if total_steps % d == 0]
            chunk = min(divs, key=lambda d: abs(d - chunk))
        n_chunks = total_steps // chunk

        def chunk_fn(p, ss):
            p2, _ = jax.lax.scan(inner_step, p, ss)
            return p2, None

        adapted, _ = jax.lax.scan(
            jax.checkpoint(chunk_fn),
            params,
            jnp.arange(total_steps).reshape(n_chunks, chunk),
        )
        return adapted
    if cfg.second_order:
        if cfg.so_remat == "none":
            step_fn = inner_step  # scan saves full residuals (needs HBM)
        elif cfg.so_remat == "dots":
            step_fn = jax.checkpoint(
                inner_step,
                policy=(
                    jax.checkpoint_policies.dots_with_no_batch_dims_saveable
                ),
            )
        elif cfg.so_remat == "step":  # recompute everything per inner step
            step_fn = jax.checkpoint(inner_step)
        else:
            raise ValueError(
                f"meta.so_remat={cfg.so_remat!r}: expected 'step', "
                "'dots', 'none', 'sqrt', or 'chunk:<k>'"
            )
    else:
        step_fn = inner_step
    adapted, _ = jax.lax.scan(
        step_fn, params, jnp.arange(total_steps),
        unroll=max(1, min(cfg.inner_unroll, total_steps)),
    )
    return adapted


def inner_sgd_update(params, grads, lr: float, clip_norm: float):
    """One inner SGD step on the globally clipped gradient: torch's
    clip_grad_norm_ (train/optimizers.clip_global_norm_tree), then
    p - lr * g on every leaf."""
    with jax.named_scope("inner_update"):
        grads, _ = clip_global_norm_tree(grads, clip_norm)
        return jax.tree.map(lambda a, b: a - lr * b, params, grads)


def adapt_and_query_loss(
    params,
    task: Task,
    rng,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
) -> jnp.ndarray:
    """Inner-adapt on the task's support set, return the query loss.

    This is the per-task function whose gradient w.r.t. `params` is the MAML
    meta-gradient (exact for second_order=True, first-order otherwise).
    """
    # so_wavefront runs the Hessian transpose's twice-differentiated loss
    # on the wavefront LSTM formulation (same cells and dropout streams).
    model_cfg_x = model_cfg
    if cfg.second_order and cfg.so_impl != "xla" and cfg.so_wavefront:
        model_cfg_x = dataclasses.replace(model_cfg, lstm_wavefront=True)
    n_support = task.support_x.shape[0]
    total_steps = cfg.inner_epochs * n_support

    # Task data reaches the loss as an explicit argument pytree: the SO
    # route wraps the inner gradient in a custom_vjp (so_grad.py), and a
    # custom_vjp must not close over task tensors — under the meta step's
    # task-vmap they are batch tracers, and closed-over tracers escaping
    # into the bwd rule is an UnexpectedTracerError.
    def _support_loss_on(mc):
        def loss(p, aux, step_rng):
            xb, yb, a_hat, koppen, node_mask = aux
            preds = apply_model(
                p, a_hat, xb, koppen, mc, train=True, rng=step_rng
            )
            return masked_mse(preds, yb, node_mask)

        return loss

    support_loss = _support_loss_on(model_cfg)

    def _support_aux(idx):
        return (
            task.support_x[idx],
            task.support_y[idx],
            task.a_hat,
            task.koppen,
            task.node_mask,
        )

    if cfg.second_order:
        from weatherforecast_stgcn_maml_tpu.train.so_grad import make_so_grad

        so_inner_grad = make_so_grad(
            support_loss, _support_loss_on(model_cfg_x), cfg.so_impl
        )

    def inner_step(p, s):
        # Epoch-major pass over the same support windows, like the
        # reference's unshuffled DataLoader (train_hybrid_maml_v5.py:121).
        idx = jnp.mod(s, n_support)
        if cfg.second_order:
            p_in = p
        else:
            # FOMAML detaches the inner gradient anyway — detach the
            # PARAMS it is evaluated at (same value) so the outer
            # linearization never propagates tangents into the inner
            # fwd/bwd graph.
            p_in = jax.lax.stop_gradient(p)
        step_rng = jax.random.fold_in(rng, s)
        aux = _support_aux(idx)
        if cfg.second_order:
            g = so_inner_grad(p_in, aux, step_rng)
        else:
            g = jax.grad(support_loss)(p_in, aux, step_rng)
        if not cfg.second_order:
            g = jax.lax.stop_gradient(g)
        return inner_sgd_update(p, g, cfg.inner_lr, cfg.clip_norm), None

    adapted = run_inner_scan(inner_step, params, total_steps, cfg)

    # Query evaluation — the reference keeps dropout active here
    # (adapted_model.train(), train_hybrid_maml_v5.py:159).
    # Floor at 1: the task builder always ships >= 1 query batch
    # (tasks.py max(1, query_batches)); query_batches=0 would otherwise
    # crash at trace time in an empty jnp.stack.
    q = max(1, min(cfg.query_batches, task.query_x.shape[0]))

    def query_loss(i):
        q_rng = (
            jax.random.fold_in(rng, 100_000 + i) if cfg.query_train_mode else None
        )
        preds = apply_model(
            adapted, task.a_hat, task.query_x[i], task.koppen, model_cfg,
            train=cfg.query_train_mode, rng=q_rng,
        )
        return masked_mse(preds, task.query_y[i], task.node_mask)

    return jnp.stack([query_loss(i) for i in range(q)]).mean()


def task_partition_specs(dp_axis: str, sp_axis=None, leading: int = 0) -> "Task":
    """PartitionSpecs for a stacked Task pytree.

    `leading` extra unsharded axes are prepended (0 for a [B, ...] task
    batch, 1 for the [n_updates, per, ...] micro-batch layout). The task
    axis is sharded along `dp_axis`; with `sp_axis`, the padded-node axis
    of every field is sharded too (node counts are multiples of 128 —
    graph.py — so they divide any power-of-two sp degree).
    """
    from jax.sharding import PartitionSpec as P

    pre = (None,) * leading
    xy = P(*pre, dp_axis, None, None, sp_axis, None)
    return Task(
        support_x=xy,
        support_y=xy,
        query_x=xy,
        query_y=xy,
        koppen=P(*pre, dp_axis),
        a_hat=P(*pre, dp_axis, sp_axis, None),
        node_mask=P(*pre, dp_axis, sp_axis),
    )


def make_meta_step(
    model_cfg: ModelConfig, cfg: MetaConfig, mesh=None, axis="dp", sp_axis=None
):
    """Build the jittable meta-training step.

    Returns `meta_step(state, tasks, rng) -> (state, metrics)` where `tasks`
    is a Task pytree with a leading meta-batch axis of size B (divisible by
    `grad_accum`). The step performs `grad_accum` sequential optimizer
    updates, each on the mean gradient of B/grad_accum vmapped tasks.
    Metrics: per-task query losses [B] (in input order) and the epoch-style
    scalar `meta_loss` (mean of per-task losses).

    With a `mesh`, each micro-batch of tasks is sharding-constrained along
    `axis` (data parallelism over tasks): the vmapped inner loops run fully
    local per device and XLA inserts one psum for the gradient mean — the
    data-parallel realization of the reference's serial task loop +
    gradient accumulation (SURVEY.md section 2, parallelism table).

    With `sp_axis` as well (a 2-D mesh), every task operand's padded-node
    axis is additionally sharding-constrained along `sp_axis` and GSPMD
    partitions the inner-loop compute over nodes (all-gather per GCN layer,
    psum'd loss/grads — the same collectives parallel/spatial.py writes by
    hand, here inserted by the partitioner). Use via
    `parallel.meta_dp.make_parallel_meta_step_2d` (or MeshConfig.
    spatial_devices > 1 through the engine).
    """
    tx, schedule = meta_optimizer(cfg)

    def _shard_micro(micro_tasks):
        if mesh is None:
            return micro_tasks
        from jax.sharding import NamedSharding, PartitionSpec as P

        if sp_axis is None:
            spec = NamedSharding(mesh, P(None, axis))
            return jax.tree.map(
                lambda x: jax.lax.with_sharding_constraint(x, spec),
                micro_tasks,
            )
        specs = task_partition_specs(axis, sp_axis, leading=1)
        return Task(
            *(
                jax.lax.with_sharding_constraint(
                    getattr(micro_tasks, f), NamedSharding(mesh, getattr(specs, f))
                )
                for f in Task._fields
            )
        )

    def micro_update(state: MamlState, micro):
        tasks, rngs = micro

        def mean_loss(p):
            losses = jax.vmap(
                lambda t, r: adapt_and_query_loss(p, t, r, model_cfg, cfg)
            )(tasks, rngs)
            return losses.mean(), losses

        (_, per_task), grads = jax.value_and_grad(mean_loss, has_aux=True)(
            state.params
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return MamlState(params, opt_state, state.step + 1), per_task

    def meta_step(state: MamlState, tasks: Task, rng):
        batch = tasks.support_x.shape[0]
        n_updates = max(1, min(cfg.grad_accum, batch))
        if batch % n_updates:
            raise ValueError(
                f"meta batch {batch} not divisible by grad_accum {n_updates}"
            )
        per = batch // n_updates
        micro_tasks = jax.tree.map(
            lambda x: x.reshape(n_updates, per, *x.shape[1:]), tasks
        )
        micro_tasks = _shard_micro(micro_tasks)
        split = jax.random.split(rng, batch)
        # Legacy PRNGKeys split to [batch, 2] uint32; typed keys to [batch].
        # Keep any trailing key dims so both public idioms work.
        rngs = split.reshape(n_updates, per, *split.shape[1:])
        state, losses = jax.lax.scan(micro_update, state, (micro_tasks, rngs))
        per_task = losses.reshape(batch)
        metrics = {
            "meta_loss": per_task.mean(),
            "per_task_loss": per_task,
            "learning_rate": schedule(state.step - 1),
        }
        return state, metrics

    return meta_step


def make_jit_meta_step(model_cfg: ModelConfig, cfg: MetaConfig):
    return jax.jit(make_meta_step(model_cfg, cfg), donate_argnums=(0,))


def make_chained_meta_step(
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    mesh=None,
    axis: str = "dp",
    sp_axis=None,
    step=None,
):
    """Chain k meta steps into ONE compiled dispatch.

    Every epoch dispatched on its own pays a host round-trip plus a metrics
    fetch; chaining k epochs pays it once. The returned callable

        chained(state, pool, idx_k, base_key, epochs_k) -> (state, metrics_k)

    runs `k = idx_k.shape[0]` full meta epochs inside one `lax.scan`:
    each scanned step gathers its task batch from the HBM-staged `pool`
    (device-side `jnp.take`, exactly `train.tasks.select_tasks`) and
    applies the ordinary meta step with `fold_in(base_key, epoch)` — the
    same per-epoch key derivation the engine's sequential loop uses — so a
    chained run is bit-identical to k single-dispatch epochs fed the same
    indices (tests/test_maml.py::test_chained_meta_step_matches_sequential).

    The only semantic difference lives OUTSIDE this function: the host
    difficulty sampler sees per-task losses once per chunk instead of once
    per epoch, so within a chunk it samples from difficulties up to k-1
    epochs stale (engines/meta_train.py documents the checkpoint-cadence
    consequence). Metrics come back stacked with a leading [k] axis.

    `step` optionally supplies a prebuilt (unjitted) meta step with the
    standard `(state, tasks, rng) -> (state, metrics)` signature — the
    shard_map 2-D implementation (parallel/meta_sp.py) chains through
    this hook.
    """
    if step is None:
        step = make_meta_step(
            model_cfg, cfg, mesh=mesh, axis=axis, sp_axis=sp_axis
        )

    def chained(state: MamlState, pool: Task, idx_k, base_key, epochs_k):
        def body(st, inp):
            idx, epoch = inp
            tasks = jax.tree.map(lambda x: jnp.take(x, idx, axis=0), pool)
            return step(st, tasks, jax.random.fold_in(base_key, epoch))

        return jax.lax.scan(body, state, (idx_k, epochs_k))

    return chained


def make_jit_chained_meta_step(
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    mesh=None,
    axis: str = "dp",
    sp_axis=None,
    sp_impl: str = "gspmd",
):
    """Jit `make_chained_meta_step`, donating the state.

    With a `mesh`, state/metrics are replicated and the per-epoch
    micro-batches are dp-sharded inside the step via its sharding
    constraints (same construction as `parallel.meta_dp`); the staged pool
    is gathered device-side so the scan never leaves the device. With
    `sp_axis` too (2-D mesh) the gathered batches are node-sharded as in
    `parallel.meta_dp.make_parallel_meta_step_2d`, and the POOL itself is
    stored node-sharded over sp (a replicated pool would reinstate the
    per-device memory ceiling the sp axis exists to remove).
    """
    if mesh is None:
        return jax.jit(
            make_chained_meta_step(model_cfg, cfg), donate_argnums=(0,)
        )
    inner_step = None
    if sp_axis is not None and sp_impl == "shardmap":
        # Chain the manual-collective 2-D step instead of the GSPMD one;
        # pool sharding below is identical.
        from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
            make_shardmap_meta_step_2d,
        )

        inner_step = make_shardmap_meta_step_2d(
            model_cfg, cfg, mesh, dp_axis=axis, sp_axis=sp_axis, jit=False
        )
    per_update = cfg.meta_batch // max(1, cfg.grad_accum)
    n_dev = mesh.shape[axis] if sp_axis is not None else mesh.devices.size
    if per_update % n_dev:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by the dp "
            f"extent ({n_dev}) for even sharding"
        )
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import replicated

    rep = replicated(mesh)
    if sp_axis is None:
        pool_sharding = rep
    else:
        # On a 2-D dp x sp mesh — built precisely for regions whose node
        # axis exceeds one device's memory — a replicated pool would put the
        # ENTIRE task pool on every device, reinstating the per-device
        # memory ceiling the sp axis removes. Shard the pool's node axis
        # over sp (its task axis stays unsharded: any epoch's batch gathers
        # arbitrary pool rows device-side).
        from jax.sharding import NamedSharding

        specs = task_partition_specs(None, sp_axis, leading=0)
        pool_sharding = Task(
            *(NamedSharding(mesh, getattr(specs, f)) for f in Task._fields)
        )
    return jax.jit(
        make_chained_meta_step(
            model_cfg, cfg, mesh=mesh, axis=axis, sp_axis=sp_axis,
            step=inner_step,
        ),
        in_shardings=(rep, pool_sharding, rep, rep, rep),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )
