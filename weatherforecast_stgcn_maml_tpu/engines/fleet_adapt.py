"""Mesh-parallel regional adaptation — N regions fine-tuned at once.

Device-level parallelization of the reference's serial 18-region loop
(main.py:30-69): regions are stacked on a leading axis and sharded over the
device mesh (parallel/fleet_mesh.py), so an 8-device mesh adapts 8 regions
at once. Semantics match `engines/adapt.py` exactly — same
climate optimizer/schedule, same contiguous split, same compat flags, same
checkpoint schema — verified by a numerical-equivalence test against the
serial engine (tests/test_fleet_mesh.py).

Regions are grouped by climate zone first: the zone-specific weight decay
is baked into the optax chain (train/optimizers.py), so each zone's group
shares one `tx` while the per-region learning rate (which diverges across
regions after epoch 3 via the loss-based nudges) rides a traced [R] vector.

On ONE device the stacked lanes only widen the batch; the fleet is meant
for a mesh, where each lane is device-local.

Limitations vs the serial engine: all regions in a group must share the
feature length T and padded node count (true for the synthetic backend and
same-year ERA5 loads), and HBM streaming (`adapt.max_device_timesteps`) is
not supported — fleet mode keeps every region's features device-resident.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import ExperimentConfig, to_dict
from weatherforecast_stgcn_maml_tpu.data.preprocess import pad_nodes, prepare_features
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, contiguous_split
from weatherforecast_stgcn_maml_tpu.engines.adapt import (
    AdaptResult,
    _batch_anchors,
    adapt_epoch_rng,
    adapted_ckpt_path,
    pad_eval_batches,
)
from weatherforecast_stgcn_maml_tpu.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.parallel.fleet_mesh import (
    make_fleet_epoch_runner,
    make_fleet_eval,
    pad_fleet,
    stack_fleet,
)
from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh
from weatherforecast_stgcn_maml_tpu.train.optimizers import (
    ClimateLRSchedule,
    adaptation_optimizer,
    climate_zone,
)
from weatherforecast_stgcn_maml_tpu.train.supervised import SupervisedState
from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
    check_family,
    load_checkpoint,
    load_meta,
    save_checkpoint,
)


def run_fleet_adaptation(
    cfg: ExperimentConfig,
    regions: list[tuple[tuple, str]],
    *,
    meta_ckpt: str | None = None,
    mesh=None,
    log_cb=print,
) -> list[AdaptResult]:
    """Adapt `[(box, name), ...]` with regions sharded over the mesh.

    Returns AdaptResults in input order (same artifacts as the serial
    engine: adapted checkpoint + stats per region).
    """
    model_cfg, ad = cfg.model, cfg.adapt
    if ad.max_device_timesteps:
        raise ValueError(
            "fleet adaptation keeps whole regions in HBM; "
            "adapt.max_device_timesteps (streaming) requires the serial engine"
        )
    if meta_ckpt is None:
        meta_ckpt = os.path.join(cfg.out_dir, "meta", "ckpt_best")
    if mesh is None:
        mesh = make_mesh(cfg.mesh)

    from weatherforecast_stgcn_maml_tpu.models.registry import init_model

    check_family(load_meta(meta_ckpt), model_cfg.family, meta_ckpt)
    template = init_model(jax.random.key(0), model_cfg)
    arrays, _ = load_checkpoint(meta_ckpt, like={"params": template})
    meta_params = arrays["params"]

    # Zone groups share an optax chain (zone weight decay is static in it).
    by_zone: dict[str, list[int]] = {}
    for i, (_, name) in enumerate(regions):
        by_zone.setdefault(climate_zone(name), []).append(i)

    results: list[AdaptResult | None] = [None] * len(regions)
    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    for zone, idxs in by_zone.items():
        group = [regions[i] for i in idxs]
        log_cb(
            f"[fleet-adapt] zone {zone}: {len(group)} regions over "
            f"{mesh.devices.size} devices"
        )
        for i, res in zip(idxs, _run_zone_group(
            cfg, group, zone, meta_params, spec, mesh, meta_ckpt, log_cb
        )):
            results[i] = res
    return results  # type: ignore[return-value]


def _run_zone_group(cfg, group, zone, meta_params, spec, mesh, meta_ckpt, log_cb):
    model_cfg, ad = cfg.model, cfg.adapt
    tx, lr0 = adaptation_optimizer(group[0][1], ad.base_lr, ad.clip_norm)
    if model_cfg.stop_base_gradients:
        from weatherforecast_stgcn_maml_tpu.train.optimizers import (
            freeze_base_mask, masked_freeze,
        )

        # masked_freeze: frozen leaves must get ZERO updates — bare
        # optax.masked passes the raw gradient through (see optimizers.py).
        tx = masked_freeze(tx, freeze_base_mask(meta_params))

    feats, a_hats, masks, kops, stats_list, graphs, datas = [], [], [], [], [], [], []
    for box, name in group:
        region = get_region_data(
            box, cfg.data.adapt_years, cfg.data, tag="adapt", name=name
        )
        graph = build_region_graph(
            region.lats, region.lons, k_neighbors=cfg.data.k_neighbors
        )
        f_np, stats = prepare_features(region, rel_coords=model_cfg.relative_coords)
        feats.append(pad_nodes(f_np, graph.padded_nodes))
        a_hats.append(np.asarray(graph.a_hat))
        masks.append(np.asarray(graph.node_mask))
        kops.append(
            np.int32(0 if cfg.compat.koppen_zero_in_adapt
                     else max(region.koppen_code, 0))
        )
        stats_list.append(stats)
        graphs.append(graph)
        datas.append(region)
    t_set = {f.shape[0] for f in feats}
    n_set = {f.shape[1] for f in feats}
    if len(t_set) > 1 or len(n_set) > 1:
        raise ValueError(
            f"fleet regions must share (T, padded N); got T={sorted(t_set)} "
            f"N={sorted(n_set)} — pad/trim histories or use the serial engine"
        )

    n_samples = spec.num_samples(feats[0].shape[0])
    train_idx, val_idx = contiguous_split(n_samples, ad.train_fraction, ad.max_samples)
    if len(train_idx) == 0 or len(val_idx) == 0:
        raise ValueError(f"{n_samples} windows cannot be split {ad.train_fraction:.0%}")

    run_epoch = make_fleet_epoch_runner(model_cfg, tx, spec, mesh, cfg.mesh.data_axis)
    run_eval = make_fleet_eval(model_cfg, spec, mesh, cfg.mesh.data_axis)

    r = len(group)
    states = [
        SupervisedState(
            params=jax.tree.map(jnp.array, meta_params),
            opt_state=tx.init(meta_params),
        )
        for _ in range(r)
    ]
    states, _ = stack_fleet(states, mesh, cfg.mesh.data_axis)
    # Pad the region axis to the mesh size with lane-0 copies.
    total = pad_fleet(r, mesh)

    def pad_r(x):
        reps = np.concatenate([x, np.repeat(x[:1], total - r, axis=0)]) \
            if total > r else x
        return jnp.asarray(reps)

    features_s = pad_r(np.stack(feats))
    a_hat_s = pad_r(np.stack(a_hats))
    mask_s = pad_r(np.stack(masks))
    kop_s = pad_r(np.stack(kops))

    # Per-region (identical-seed) batch shuffles — matches the serial
    # engine's np_rng stream so fleet == serial numerically.
    np_rngs = [np.random.default_rng(ad.seed) for _ in range(total)]
    # Raw base lr: ClimateLRSchedule.step applies the climate multiplier
    # itself — passing lr0 (= base*mult) would double-apply it (same fix
    # as the serial engine, engines/adapt.py).
    schedules = [ClimateLRSchedule(name, base_lr=ad.base_lr) for _, name in group] + [
        # One instance per padding lane — sharing one (list multiplication)
        # would advance its epoch counter once per lane per epoch.
        ClimateLRSchedule(group[0][1], base_lr=ad.base_lr)
        for _ in range(total - r)
    ]
    lrs = np.full(total, lr0, np.float32)
    anchors = spec.window + train_idx

    # Same per-region adapt JSONL artifact as the serial engine — fleet runs
    # must not leave an observability gap (ADVICE r2).
    from weatherforecast_stgcn_maml_tpu.utils.metrics import JsonlLogger

    jsonls = [
        JsonlLogger(os.path.join(cfg.out_dir, "adapt", f"{name}.jsonl"))
        for _, name in group
    ]

    epoch_losses = [[] for _ in range(r)]
    for epoch in range(ad.epochs):
        batches = np.stack([
            _batch_anchors(anchors, ad.batch_size, shuffle=ad.shuffle, rng=g)
            for g in np_rngs
        ])
        # Region-folded dropout rngs (padding lanes mirror lane 0): every
        # lane draws its own masks, matching the serial engine per region.
        rngs = jnp.stack(
            [adapt_epoch_rng(ad.seed, name, epoch, impl=ad.rng_impl)
             for _, name in group]
            + [adapt_epoch_rng(ad.seed, group[0][1], epoch, impl=ad.rng_impl)]
            * (total - r)
        )
        states, losses = run_epoch(
            states, features_s, jnp.asarray(batches), a_hat_s, mask_s,
            kop_s, jnp.asarray(lrs), rngs,
        )
        losses = np.asarray(losses)  # [total, nb]
        for i in range(r):
            avg = float(losses[i].mean())
            epoch_losses[i].append(avg)
            jsonls[i].log({"epoch": epoch + 1, "loss": avg, "lr": float(lrs[i])})
            lrs[i] = schedules[i].step(avg)
        for i in range(r, total):
            lrs[i] = schedules[i].step(float(losses[i].mean()))
        log_cb(
            f"[fleet-adapt] zone {zone} epoch {epoch + 1}/{ad.epochs} "
            f"losses {[round(e[-1], 4) for e in epoch_losses]}"
        )

    # Exact per-window validation (pad final batch, drop pad windows).
    val_anchors = spec.window + val_idx
    padded = pad_eval_batches(val_anchors, ad.batch_size)
    per_window = np.asarray(run_eval(
        states.params, features_s,
        jnp.asarray(np.broadcast_to(padded, (total,) + padded.shape)),
        a_hat_s, mask_s, kop_s,
    )).reshape(total, -1)[:, : len(val_anchors)]

    results = []
    for i, (box, name) in enumerate(group):
        val_mse = float(per_window[i].mean())
        params_i = jax.tree.map(lambda x: np.asarray(x[i]), states.params)
        path = adapted_ckpt_path(cfg.out_dir, name, box)
        save_checkpoint(
            path,
            {"params": params_i},
            {
                "schema": "wfstgcn-adapted-v1",
                "model_version": "jax-1.0",
                "region": list(box),
                "region_name": name,
                "climate_zone": zone,
                "koppen_code": int(datas[i].koppen_code),
                "stats": stats_list[i].to_dict(),
                "val_mse": val_mse,
                "epoch_losses": epoch_losses[i],
                "base_checkpoint": os.path.abspath(meta_ckpt),
                "config": to_dict(cfg),
                "fleet_mesh": True,
            },
        )
        log_cb(f"[fleet-adapt] {name}: val MSE {val_mse:.6f} -> {path}")
        results.append(AdaptResult(
            ckpt_path=path, val_mse=val_mse,
            epoch_losses=epoch_losses[i], region_name=name,
        ))
    return results
