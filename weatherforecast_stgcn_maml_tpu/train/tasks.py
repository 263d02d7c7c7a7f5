"""Task construction: RegionData -> device-ready MAML Task.

Counterpart of `create_v4_task` (train_hybrid_maml_v5.py:73-107): build the
graph, preprocess features, window, and split support/query contiguously.
Differences by design:

  * node counts are padded to a fleet-wide lane-aligned size so all tasks
    share one compiled shape under vmap (SURVEY.md section 7 hard part (b));
  * only the support windows the inner loop will touch are materialized
    (the reference builds a 450-sample Subset but reads 15, SURVEY 3.2);
  * the Koppen code rides along as an integer; the embedding lookup happens
    inside the model (see models/hybrid.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import DataConfig, MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.data.preprocess import (
    NormStats,
    pad_nodes,
    prepare_features,
)
from weatherforecast_stgcn_maml_tpu.data.region import RegionData
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, contiguous_split
from weatherforecast_stgcn_maml_tpu.graph import RegionGraph, build_region_graph, round_up
from weatherforecast_stgcn_maml_tpu.train.maml import Task


@dataclass
class BuiltTask:
    task: Task  # numpy-leaved Task (stack then ship to device)
    stats: NormStats
    graph: RegionGraph
    region_name: str


def _materialize(features: np.ndarray, anchors: np.ndarray, spec: WindowSpec):
    """Host-side window materialization for a small set of anchors."""
    from weatherforecast_stgcn_maml_tpu import native
    from weatherforecast_stgcn_maml_tpu.config import NUM_WEATHER_VARS

    out = native.gather_windows_native(
        features, anchors, spec.window, spec.horizon, y_channels=NUM_WEATHER_VARS
    )
    if out is not None:
        return out
    xs = np.stack([features[a - spec.window : a] for a in anchors])
    ys = np.stack(
        [
            features[a + 1 : a + 1 + spec.horizon, :, :NUM_WEATHER_VARS]
            for a in anchors
        ]
    )
    return xs.astype(np.float32), ys.astype(np.float32)


def build_task(
    region: RegionData,
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    data_cfg: DataConfig,
    *,
    pad_to: int | None = None,
    stats: NormStats | None = None,
) -> BuiltTask:
    graph = build_region_graph(
        region.lats, region.lons, k_neighbors=data_cfg.k_neighbors, pad_to=pad_to
    )
    features, stats = prepare_features(
        region, stats=stats, rel_coords=model_cfg.relative_coords
    )
    features = pad_nodes(features, graph.padded_nodes)

    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    n_samples = spec.num_samples(region.num_timesteps)
    if n_samples < 2:
        raise ValueError(
            f"region {region.name!r}: {region.num_timesteps} timesteps give "
            f"{n_samples} windows; need >= 2"
        )
    support_idx, query_idx = contiguous_split(
        n_samples, meta_cfg.support_fraction, meta_cfg.max_samples_per_task
    )
    if len(query_idx) == 0:  # degenerate tiny regions: reuse the tail
        query_idx = support_idx[-1:]
        support_idx = support_idx[:-1]
    if len(support_idx) == 0 or len(query_idx) == 0:
        raise ValueError(
            f"region {region.name!r}: cannot form non-empty support and "
            f"query sets from {n_samples} windows"
        )

    # Anchor t for sample i is window + i (data/windows.py). Counts are
    # padded by cycling (np.resize wraps) so every task ships exactly
    # inner_batches support and query_batches query windows — vmap/stacking
    # requires uniform shapes, and short regions simply revisit windows
    # (the reference's unshuffled loader revisits them across inner epochs
    # anyway, train_hybrid_maml_v5.py:121-127).
    support_used = np.resize(support_idx, meta_cfg.inner_batches)
    query_used = np.resize(query_idx, max(1, meta_cfg.query_batches))
    sx, sy = _materialize(features, spec.window + support_used, spec)
    qx, qy = _materialize(features, spec.window + query_used, spec)

    task = Task(
        support_x=sx,
        support_y=sy,
        query_x=qx,
        query_y=qy,
        koppen=np.int32(max(region.koppen_code, 0)),
        a_hat=graph.a_hat,
        node_mask=graph.node_mask,
    )
    return BuiltTask(task=task, stats=stats, graph=graph, region_name=region.name)


def common_padded_nodes(regions: list[RegionData]) -> int:
    """Fleet-wide padded node count (max region size rounded to the lane)."""
    return round_up(max(r.num_nodes for r in regions))


def stack_tasks(tasks: list[Task]) -> Task:
    """Stack per-region Tasks into one batched Task pytree [B, ...]."""
    return jax.tree.map(lambda *xs: np.stack(xs), *tasks)


def build_meta_tasks(
    regions: list[RegionData],
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    data_cfg: DataConfig,
) -> list[BuiltTask]:
    pad = common_padded_nodes(regions)
    return [
        build_task(r, model_cfg, meta_cfg, data_cfg, pad_to=pad) for r in regions
    ]


def stage_tasks(tasks: list[Task], sharding=None) -> Task:
    """Upload the full task pool to device HBM once.

    Returns a stacked Task pytree [num_tasks, ...] resident on device (or
    placed with `sharding`). Per-epoch batches are then cut with
    `select_tasks` — a jitted device-side gather — so the epoch loop never
    re-transfers task data from the host (the reference re-marshals every
    batch through a DataLoader, SURVEY 3.2). The 15-region pool at reference
    scale is ~250 MB, far under HBM.
    """
    import jax

    stacked = stack_tasks(tasks)
    if sharding is not None:
        return jax.tree.map(lambda x: jax.device_put(x, sharding), stacked)
    return jax.tree.map(jax.device_put, stacked)


_SELECT_JIT = None


def select_tasks(staged: Task, indices) -> Task:
    """Device-side gather of a task batch from the staged pool — ONE jitted
    dispatch (eager tree.map would issue one op per leaf per epoch)."""
    import jax
    import jax.numpy as jnp

    global _SELECT_JIT
    if _SELECT_JIT is None:
        _SELECT_JIT = jax.jit(
            lambda s, i: jax.tree.map(lambda x: jnp.take(x, i, axis=0), s)
        )
    return _SELECT_JIT(staged, jnp.asarray(indices))
