"""Mesh-parallel region fleet: adapt many regions at once, sharded over a mesh.

The reference adapts its 18 regions strictly serially (main.py:30-69); the
host-level counterpart here (`parallel/fleet.py`) still runs one region per
process. This module parallelizes the *device* work instead: regional
adaptations are completely independent (own params, own data, own climate
optimizer — no cross-region reduction of any kind), so a stacked fleet of R
regions shards its leading axis over the mesh and every device fine-tunes
its own regions locally. Zero collectives are inserted — the sharding IS
the parallelism: on 8 devices the 18 regions take ceil(18/8) = 3 rounds.

Shapes: all regions are padded to one node count (graph.py) and must share
the feature length T (true for the synthetic backend and for ERA5 regions
loaded over the same years). A fleet whose R is not divisible by the mesh
size is padded with copies of region 0; `pad_fleet` handles this (it
returns the real count so callers drop the padding slots' results).

The per-region learning rate is a traced `[R]` vector: each region keeps
its own host-side ClimateLRSchedule (adaptive_scheduler.py semantics)
feeding its lane, exactly like the serial engine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from weatherforecast_stgcn_maml_tpu.config import ModelConfig
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, slice_window
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu.train.supervised import (
    batched_forward,
    make_epoch_fn,
)


def fleet_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Leading-axis (region) sharding for every fleet-stacked array."""
    return NamedSharding(mesh, P(axis))


def pad_fleet(r: int, mesh: Mesh) -> int:
    """Fleet size after padding to a multiple of the mesh size."""
    d = mesh.devices.size
    return -(-r // d) * d


def stack_fleet(trees, mesh: Mesh, axis: str = "dp"):
    """Stack per-region pytrees on a new leading axis, pad to the mesh size
    with copies of the first entry, and shard. Returns (stacked, real_r)."""
    r = len(trees)
    total = pad_fleet(r, mesh)
    trees = list(trees) + [trees[0]] * (total - r)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    sh = fleet_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sh), stacked), r


def make_fleet_epoch_runner(
    model_cfg: ModelConfig, tx, spec: WindowSpec, mesh: Mesh, axis: str = "dp"
):
    """Compiled FLEET training epoch: `make_epoch_fn` vmapped over a leading
    region axis with every operand sharded over `axis`.

    `run_epoch(states, features, anchor_batches, a_hat, node_mask, koppen,
    lr, rng) -> (states, losses [R, nb])` where every argument carries a
    leading [R] axis (lr is a per-region vector, rng a [R] key array).
    XLA partitions the vmapped program along the region axis with no
    communication — each device runs its shard of regions' epochs locally.
    """
    epoch = make_epoch_fn(model_cfg, tx, spec)
    sh = fleet_sharding(mesh, axis)

    @jax.jit
    def run_epoch(states, features, anchor_batches, a_hat, node_mask, koppen, lr, rng):
        args = (states, features, anchor_batches, a_hat, node_mask, koppen, lr, rng)
        args = jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, sh), args)
        return jax.vmap(epoch)(*args)

    return run_epoch


def make_fleet_eval(
    model_cfg: ModelConfig, spec: WindowSpec, mesh: Mesh, axis: str = "dp"
):
    """Compiled fleet evaluation: per-window MSEs `[R, nb, B]`."""
    sh = fleet_sharding(mesh, axis)

    def one_region(params, features, anchor_batches, a_hat, node_mask, koppen):
        def body(_, anchors):
            x, y = jax.vmap(lambda a: slice_window(features, a, spec))(anchors)
            preds = batched_forward(
                params, a_hat, x, koppen, model_cfg, train=False, rng=None
            )
            return None, jax.vmap(lambda p, t: masked_mse(p, t, node_mask))(preds, y)

        _, losses = jax.lax.scan(body, None, anchor_batches)
        return losses

    @jax.jit
    def run_eval(params, features, anchor_batches, a_hat, node_mask, koppen):
        args = (params, features, anchor_batches, a_hat, node_mask, koppen)
        args = jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, sh), args)
        return jax.vmap(one_region)(*args)

    return run_eval
