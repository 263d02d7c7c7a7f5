"""Data-parallel MAML meta step over a device mesh.

Tasks are sharded along the mesh's data axis; parameters and optimizer state
are replicated. Each device runs the full inner-adaptation scan for its local
tasks (zero communication — the inner loop is task-local by construction) and
XLA inserts a single psum for the meta-gradient mean. This is the
sharded-jit ("pjit") formulation: sharding annotations in, collectives out.
"""

from __future__ import annotations

import jax

from weatherforecast_stgcn_maml_tpu.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
    replicated,
    task_batch_sharding,
)
from weatherforecast_stgcn_maml_tpu.train.maml import make_meta_step


def make_parallel_meta_step(
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    mesh,
    axis: str = "dp",
    donate_state: bool = True,
):
    """Jit the meta step with dp sharding over the task batch.

    The returned callable has the same signature as the single-device step:
    `(state, tasks, rng) -> (state, metrics)`. `tasks` should be placed with
    `parallel.mesh.shard_task_batch` (or any layout — jit will reshard).

    Requires meta_batch/grad_accum (the per-update micro-batch) to be
    divisible by the mesh size so every device holds equal task shards.
    """
    per_update = meta_cfg.meta_batch // max(1, meta_cfg.grad_accum)
    n_dev = mesh.devices.size
    if per_update % n_dev:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by mesh size "
            f"({n_dev}) for even dp sharding"
        )

    step = make_meta_step(model_cfg, meta_cfg, mesh=mesh, axis=axis)
    rep = replicated(mesh)
    task_sh = task_batch_sharding(mesh, axis)
    return jax.jit(
        step,
        in_shardings=(rep, task_sh, rep),
        out_shardings=(rep, rep),
        donate_argnums=(0,) if donate_state else (),
    )


def make_parallel_meta_step_2d(
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    mesh,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    donate_state: bool = True,
):
    """dp x sp meta step on a 2-D mesh: tasks sharded over `dp_axis` AND the
    padded-node axis of every task operand sharded over `sp_axis`.

    This is the scaling path for meta-training on regions too large for one
    device's activation memory (continental 0.25-degree grids; SURVEY.md §5
    long-context note): each dp group adapts its tasks with the node axis
    split across its sp column, GSPMD inserting the per-GCN-layer
    all-gather and the loss/grad psums — the collectives
    `parallel/spatial.py` writes by hand for the supervised step, here
    derived by the partitioner through the whole inner-SGD scan. Per-
    device activation memory genuinely scales down with the sp degree
    (temp memory 147.9 -> 36.7 MB going dp2 -> dp2 x sp4 at 1024 nodes;
    regression-tested in tests/test_parallel.py).

    Signature matches `make_parallel_meta_step`; place `tasks` with
    `parallel.mesh.shard_task_batch_2d` (or any layout — jit reshards).
    """
    per_update = meta_cfg.meta_batch // max(1, meta_cfg.grad_accum)
    n_dp = mesh.shape[dp_axis]
    if per_update % n_dp:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by the dp "
            f"mesh axis ({n_dp}) for even sharding"
        )

    from jax.sharding import NamedSharding
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        Task,
        task_partition_specs,
    )

    step = make_meta_step(
        model_cfg, meta_cfg, mesh=mesh, axis=dp_axis, sp_axis=sp_axis
    )
    rep = replicated(mesh)
    specs = task_partition_specs(dp_axis, sp_axis, leading=0)
    task_sh = Task(
        *(NamedSharding(mesh, getattr(specs, f)) for f in Task._fields)
    )
    return jax.jit(
        step,
        in_shardings=(rep, task_sh, rep),
        out_shardings=(rep, rep),
        donate_argnums=(0,) if donate_state else (),
    )
