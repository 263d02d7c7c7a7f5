"""shard_map 2-D (dp x sp) MAML meta step — manual collectives.

The GSPMD 2-D meta step (`parallel.meta_dp.make_parallel_meta_step_2d`)
leaves the partitioning of the inner loop to XLA's SPMD partitioner. This
module writes it by hand instead: one `jax.shard_map` wraps the whole
micro-update loss, tasks sharded over `dp` and the padded-node axis over
`sp`, and the body

  * runs the inner-SGD scan with a node-LOCAL hybrid forward
    (`parallel.spatial.hybrid_local_forward`): GCN dots with one all-gather
    per layer, the LSTM on the local node rows (the node axis is the LSTM
    batch axis, so it needs no communication);
  * differentiates the psummed support loss per inner step and psums the
    per-shard PARTIAL gradients over `sp` into the total before the SGD
    update (the SPMD invariant: grads of replicated-in-value params arrive
    as per-shard partial sums), so params stay replicated-consistent;
  * pmeans per-task query losses over `dp`.

The OUTER meta-gradient is `jax.grad` through the shard_map: the replicated
param in-spec transposes to a psum over both mesh axes, so XLA still inserts
the meta-grad collective — sharding annotations in, collectives out, just at
the shard_map boundary instead of GSPMD's.

Semantics vs the GSPMD path: identical with dropout off (regression-tested on
a CPU mesh, tests/test_parallel.py); with dropout ON, masks are drawn
per-shard (fold_in by sp shard index — `make_spatial_train_step`'s
convention), a different-but-valid stream from the unsharded step, because
drawing full-N masks per shard would reinstate the per-device memory ceiling
the sp axis removes. Second-order MAML is supported: each inner gradient is
wrapped in train/so_grad.py's custom_vjp with the node-local losses, so the
Hessian transpose is a per-shard HVP psum-composed at the carry boundary.

Reference workload: the serial task loop + per-region adaptation of the
reference's train_hybrid_maml_v5.py:110-184 at fleet scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from weatherforecast_stgcn_maml_tpu.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.parallel.mesh import replicated
from weatherforecast_stgcn_maml_tpu.parallel.spatial import hybrid_local_forward
from weatherforecast_stgcn_maml_tpu.train.maml import (
    MamlState,
    Task,
    run_inner_scan,
    task_partition_specs,
)
from weatherforecast_stgcn_maml_tpu.train.optimizers import (
    clip_global_norm_tree,
    meta_optimizer,
)


# Node-sharded masked MSE now lives next to the other node-local model
# pieces; kept under the old private name for in-module use.
from weatherforecast_stgcn_maml_tpu.parallel.spatial import (  # noqa: E402
    psum_masked_mse as _psum_masked_mse,
)


def _local_adapt_and_query_loss(
    params,
    task: Task,
    rng,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    dp_axis: str,
    sp_axis: str,
):
    """Per-task inner adaptation + query loss with node-LOCAL operands.

    Mirrors `train.maml.adapt_and_query_loss` step for step; every loss is
    psummed over `sp_axis` (replicated scalar), and each inner gradient is
    the psum of the per-shard partials (see inner_step). Second-order MAML
    routes the Hessian transpose through `train.so_grad` exactly like the
    single-device path, with the node-local losses: the custom_vjp's bwd
    jvp's the LOCAL gradient with each shard's incoming cotangent, which by
    symmetry of the joint Hessian over the per-shard param copies composes
    with the psum's transpose into the exact meta-gradient (f64 parity
    tests in tests/test_parallel.py).
    """
    # Promote params to device-varying over BOTH mesh axes before any use:
    # the task operands vary (dp: different tasks; sp: node shards), so all
    # downstream values — including the weight cotangents, which are
    # per-shard PARTIAL sums — are varying. The pvary keeps the inner scan's carry type
    # stable, and its transpose is a psum over (dp, sp): exactly the
    # meta-gradient reduction, inserted at this boundary by VMA tracking.
    params = jax.tree.map(
        lambda a: jax.lax.pcast(a, (dp_axis, sp_axis), to="varying"), params
    )
    n_support = task.support_x.shape[0]
    total_steps = cfg.inner_epochs * n_support

    def _support_loss_on(mc):
        # Task data arrives as an explicit aux pytree: the SO route wraps
        # the inner gradient in a custom_vjp (so_grad.py), which must not
        # close over the task-vmap's batch tracers.
        def loss(p, aux, step_rng):
            xb, yb, a_rows, koppen, node_mask = aux
            preds = hybrid_local_forward(
                p, a_rows, xb, koppen, mc, sp_axis, train=True, rng=step_rng
            )
            return _psum_masked_mse(preds, yb, node_mask, sp_axis)

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

        so_inner_grad = make_so_grad(support_loss, support_loss, cfg.so_impl)

    def inner_step(p, s):
        idx = jnp.mod(s, n_support)
        step_rng = jax.random.fold_in(rng, s)
        aux = _support_aux(idx)
        if cfg.second_order:
            # Exact MAML: tangents flow into the inner grad; so_grad's
            # custom_vjp supplies the per-shard HVP transpose.
            g = so_inner_grad(p, aux, step_rng)
        else:
            # FOMAML: detach the evaluation point so the outer
            # linearization never propagates tangents into the inner
            # fwd/bwd graph, same as train/maml.py inner_step.
            p_in = jax.lax.stop_gradient(p)
            g = jax.grad(support_loss)(p_in, aux, step_rng)
        # The carry was pvary'd to device-varying, so the gradient above is
        # each shard's PARTIAL gradient of the psummed loss — per-shard
        # node-row contributions, plus whatever crossed collectives inside
        # the forward (the encoder all-gather transposes). The standard
        # SPMD invariant applies: the TOTAL gradient is the psum of the
        # per-shard partials (auto-inserted only when differentiating
        # UNVARYING inputs, which the pvary deliberately opted out of).
        # Without this psum every shard inner-SGD-steps on its own partial
        # and the adapted params silently diverge across sp shards — wrong
        # whenever real nodes span shards (any region with more real rows
        # than one shard holds). Caught by the f64 100-node parity test in
        # tests/test_parallel.py; the psum also makes the clip norm the
        # GLOBAL norm, matching the unsharded step.
        g = jax.lax.psum(g, sp_axis)
        g, _ = clip_global_norm_tree(g, cfg.clip_norm)
        if not cfg.second_order:
            g = jax.lax.stop_gradient(g)
        # pvary back for the carry's VMA type; its transpose (a psum over
        # sp) correctly accumulates the SO cotangents.
        g = jax.tree.map(
            lambda a: jax.lax.pcast(a, sp_axis, to="varying"), g
        )
        p = jax.tree.map(lambda a, b: a - cfg.inner_lr * b, p, g)
        return p, None

    adapted = run_inner_scan(inner_step, params, total_steps, cfg)

    q = max(1, min(cfg.query_batches, task.query_x.shape[0]))

    def query_loss(i):
        q_rng = (
            jax.random.fold_in(rng, 100_000 + i) if cfg.query_train_mode else None
        )
        preds = hybrid_local_forward(
            adapted, task.a_hat, task.query_x[i], task.koppen, model_cfg,
            sp_axis, train=cfg.query_train_mode, rng=q_rng,
        )
        return _psum_masked_mse(
            preds, task.query_y[i], task.node_mask, sp_axis
        )

    return jnp.stack([query_loss(i) for i in range(q)]).mean()


def make_shardmap_meta_step_2d(
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    mesh,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    donate_state: bool = True,
    jit: bool = True,
):
    """Build the shard_map dp x sp meta step.

    Same signature and task layout as `make_parallel_meta_step_2d`:
    `(state, tasks, rng) -> (state, metrics)`, tasks placed with
    `parallel.mesh.shard_task_batch_2d`. Requires `model.family == "hybrid"`
    (the flagship; other families meta-train on the GSPMD path). Supports
    first-order AND second-order MAML: the SO Hessian transpose runs
    through train/so_grad.py on the node-local losses.

    `jit=False` returns the unjitted step (for embedding in a chained
    scan).
    """
    if getattr(model_cfg, "family", "hybrid") != "hybrid":
        raise ValueError(
            "shard_map 2-D meta step supports family='hybrid' only; use the "
            "GSPMD path (make_parallel_meta_step_2d) for other families"
        )
    per_update = meta_cfg.meta_batch // max(1, meta_cfg.grad_accum)
    n_dp = mesh.shape[dp_axis]
    if per_update % n_dp:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by the dp "
            f"mesh axis ({n_dp}) for even sharding"
        )
    tx, schedule = meta_optimizer(meta_cfg)

    task_specs = task_partition_specs(dp_axis, sp_axis, leading=0)

    def local_mean_loss(params, local_tasks: Task, local_rngs):
        losses = jax.vmap(
            lambda t, r: _local_adapt_and_query_loss(
                params, t, r, model_cfg, meta_cfg, dp_axis, sp_axis
            )
        )(local_tasks, local_rngs)  # [per/n_dp] replicated over sp
        return jax.lax.pmean(losses.mean(), dp_axis), losses

    sharded_loss = jax.shard_map(
        local_mean_loss,
        mesh=mesh,
        in_specs=(P(), task_specs, P(dp_axis)),
        out_specs=(P(), P(dp_axis)),
    )

    def micro_update(state: MamlState, micro):
        tasks, rngs = micro
        (_, per_task), grads = jax.value_and_grad(
            sharded_loss, has_aux=True
        )(state.params, tasks, rngs)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return MamlState(params, opt_state, state.step + 1), per_task

    def meta_step(state: MamlState, tasks: Task, rng):
        batch = tasks.support_x.shape[0]
        n_updates = max(1, min(meta_cfg.grad_accum, batch))
        if batch % n_updates:
            raise ValueError(
                f"meta batch {batch} not divisible by grad_accum {n_updates}"
            )
        per = batch // n_updates
        micro_tasks = jax.tree.map(
            lambda x: x.reshape(n_updates, per, *x.shape[1:]), tasks
        )
        split = jax.random.split(rng, batch)
        rngs = split.reshape(n_updates, per, *split.shape[1:])
        state, losses = jax.lax.scan(micro_update, state, (micro_tasks, rngs))
        per_task = losses.reshape(batch)
        metrics = {
            "meta_loss": per_task.mean(),
            "per_task_loss": per_task,
            "learning_rate": schedule(state.step - 1),
        }
        return state, metrics

    if not jit:
        return meta_step
    rep = replicated(mesh)
    task_sh = Task(
        *(NamedSharding(mesh, getattr(task_specs, f)) for f in Task._fields)
    )
    return jax.jit(
        meta_step,
        in_shardings=(rep, task_sh, rep),
        out_shardings=(rep, rep),
        donate_argnums=(0,) if donate_state else (),
    )
