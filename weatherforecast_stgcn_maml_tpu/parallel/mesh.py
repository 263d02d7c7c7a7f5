"""Device mesh construction and sharding specs."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from weatherforecast_stgcn_maml_tpu.config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """Data-parallel mesh over the task axis (1-D by default).

    MAML's meta batch is the natural parallel dimension of this workload
    (SURVEY.md section 2): tasks are independent until the outer gradient
    mean, so a 1-D mesh has one collective (the grad psum). With
    `cfg.spatial_devices > 1` the mesh is 2-D dp x sp (see make_mesh_2d)
    for node-sharded meta-training.
    """
    if devices is None:
        devices = jax.devices()
    n = cfg.num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    sp = max(1, cfg.spatial_devices)
    if sp > 1:
        if n % sp:
            raise ValueError(
                f"num_devices ({n}) must be divisible by spatial_devices "
                f"({sp}) for a dp x sp mesh"
            )
        return make_mesh_2d(
            n // sp, sp, devices=devices,
            dp_axis=cfg.data_axis, sp_axis=cfg.spatial_axis,
        )
    return Mesh(np.array(devices[:n]), axis_names=(cfg.data_axis,))


def resolve_sp_impl(sp_impl: str, model_cfg) -> str:
    """Resolve MeshConfig.sp_impl="auto" to a concrete 2-D step impl.

    "auto" picks "shardmap" for the hybrid family: its collectives are
    written by hand (one all-gather per GCN layer, one psum of the inner
    gradient per step, parallel/meta_sp.py), so what crosses the mesh does
    not depend on the partitioner's choices. Which of the two is faster on
    a real mesh is not settled; both are tested against the one-device
    step. Other families take "gspmd", the only impl that supports every
    registry model (through sharding constraints).
    """
    if sp_impl != "auto":
        return sp_impl
    family = getattr(model_cfg, "family", "hybrid")
    return "shardmap" if family == "hybrid" else "gspmd"


def make_mesh_2d(
    dp: int,
    sp: int,
    devices=None,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
) -> Mesh:
    """2-D mesh: task data-parallelism x node (spatial) model-parallelism.

    Devices are laid out row-major, `sp` varying fastest.
    """
    if devices is None:
        devices = jax.devices()
    if dp * sp > len(devices):
        raise ValueError(
            f"requested {dp}x{sp} devices, have {len(devices)}"
        )
    grid = np.array(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(grid, axis_names=(dp_axis, sp_axis))


def task_batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding for a Task pytree batched on its leading axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_task_batch(tasks, mesh: Mesh, axis: str = "dp"):
    """Place a stacked Task pytree with its leading axis sharded over `axis`."""
    sharding = task_batch_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tasks)


def shard_task_batch_2d(
    tasks, mesh: Mesh, dp_axis: str = "dp", sp_axis: str = "sp"
):
    """Place a stacked Task pytree on a 2-D mesh: task axis over `dp_axis`,
    padded-node axis over `sp_axis` (specs from train.maml.task_partition_specs)."""
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        Task,
        task_partition_specs,
    )

    specs = task_partition_specs(dp_axis, sp_axis, leading=0)
    return Task(
        *(
            jax.device_put(
                getattr(tasks, f), NamedSharding(mesh, getattr(specs, f))
            )
            for f in Task._fields
        )
    )
