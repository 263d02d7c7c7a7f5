"""Meta-training engine — the JAX counterpart of train_hybrid_maml_v5.py.

Workflow parity with the reference driver (train_hybrid_maml_v5.py:187-383):
build region tasks, run `num_epochs` meta-epochs of difficulty-sampled task
batches, step the warm-restart schedule, append the CSV log, keep best/final
checkpoints. Differences by design:

  * the meta step is ONE compiled program per epoch (inner scans + task vmap
    + grad-accum scan), optionally dp-sharded over a device mesh;
  * per-task query losses feed the difficulty sampler (fixing SURVEY quirk 3);
  * a `last` checkpoint with optimizer + sampler state enables true mid-run
    resume (the reference saves optimizer state but never reloads it).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import jax
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import (
    ExperimentConfig,
    META_TRAIN_REGIONS,
    to_dict,
)
from weatherforecast_stgcn_maml_tpu.data.region import RegionData
from weatherforecast_stgcn_maml_tpu.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu.models.hybrid import hybrid_param_count
from weatherforecast_stgcn_maml_tpu.train.maml import (
    MamlState,
    init_meta_state,
    make_jit_meta_step,
)
from weatherforecast_stgcn_maml_tpu.train.sampling import DifficultySampler
from weatherforecast_stgcn_maml_tpu.train.tasks import select_tasks, stage_tasks
from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu.utils.prng import make_key
from weatherforecast_stgcn_maml_tpu.utils.metrics import CsvLogger, JsonlLogger
from weatherforecast_stgcn_maml_tpu.utils.profiling import Timer


@dataclass
class MetaTrainResult:
    best_loss: float
    final_loss: float
    best_path: str
    final_path: str
    epochs_run: int
    param_count: int


def _load_regions(cfg: ExperimentConfig, max_workers: int = 4) -> list[RegionData]:
    """Load all meta-training regions with a threaded prefetcher.

    ERA5 ingestion is disk/IO-bound (40 NetCDF opens per region on a cold
    cache, SURVEY 3.5); loading regions concurrently overlaps that I/O and
    keeps it off the device critical path. Per-region failures are isolated
    (train_hybrid_maml_v5.py:225-231 semantics).
    """
    from concurrent.futures import ThreadPoolExecutor

    def load(i_box):
        i, box = i_box
        # strict=True: a missing quarter must RAISE (dropping this region via
        # the isolation below) rather than silently stitch a multi-month time
        # gap into a nominally hourly-contiguous training tensor — matches
        # the reference, where a missing file throws out of create_v4_task
        # and the region is skipped (train_hybrid_maml_v5.py:225-231).
        return get_region_data(
            box, cfg.data.train_years, cfg.data, strict=True,
            tag="train", name=f"region{i}",
        )

    # Deterministic ordering: collect by META_TRAIN_REGIONS index, not by
    # thread completion. Task order feeds the difficulty sampler's indices,
    # so a failed region must drop out without reshuffling the rest.
    regions = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [
            (pool.submit(load, (i, box)), box)
            for i, box in enumerate(META_TRAIN_REGIONS)
        ]
        for fut, box in futures:
            try:
                regions.append(fut.result())
            except Exception as e:
                print(f"[meta-train] skipping region {box}: {e}")
    return regions


def run_meta_training(
    cfg: ExperimentConfig,
    regions: list[RegionData] | None = None,
    *,
    mesh=None,
    resume: bool = False,
    log_cb=print,
) -> MetaTrainResult:
    out_dir = os.path.join(cfg.out_dir, "meta")
    os.makedirs(out_dir, exist_ok=True)
    model_cfg, meta_cfg = cfg.model, cfg.meta

    if regions is None:
        regions = _load_regions(cfg)
    if not regions:
        raise RuntimeError("no meta-training regions could be loaded")

    timer = Timer()
    with timer.span("task_build"):
        # Per-region isolation extends to task CONSTRUCTION (degenerate
        # regions — e.g. truncated histories — must not kill the run,
        # train_hybrid_maml_v5.py:225-231 semantics).
        from weatherforecast_stgcn_maml_tpu.train.tasks import (
            build_task,
            common_padded_nodes,
        )

        pad = common_padded_nodes(regions)
        built = []
        for r in regions:
            try:
                built.append(
                    build_task(r, model_cfg, meta_cfg, cfg.data, pad_to=pad)
                )
            except Exception as e:
                log_cb(f"[meta-train] skipping region {r.name!r}: {e}")
    if not built:
        raise RuntimeError("no meta-training tasks could be built")
    log_cb(
        f"[meta-train] {len(built)} tasks, padded nodes="
        f"{built[0].graph.padded_nodes}"
    )

    # When region failures shrink the task pool below meta_batch (or the
    # configured batch/accum pair doesn't divide), adjust to the nearest
    # valid decomposition instead of crashing at the first meta step.
    import dataclasses as _dc

    batch = min(meta_cfg.meta_batch, len(built))
    accum = max(1, min(meta_cfg.grad_accum, batch))
    while batch % accum:
        accum -= 1
    if (batch, accum) != (meta_cfg.meta_batch, meta_cfg.grad_accum):
        log_cb(
            f"[meta-train] adjusting meta_batch {meta_cfg.meta_batch}->"
            f"{batch}, grad_accum {meta_cfg.grad_accum}->{accum} "
            f"({len(built)} tasks available)"
        )
        meta_cfg = _dc.replace(meta_cfg, meta_batch=batch, grad_accum=accum)

    state = init_meta_state(jax.random.key(meta_cfg.seed), model_cfg, meta_cfg)
    params_n = hybrid_param_count(state.params)
    log_cb(f"[meta-train] hybrid model: {params_n:,} parameters")

    # A 2-D mesh (MeshConfig.spatial_devices > 1) additionally shards the
    # padded-node axis over the spatial axis — meta-training for regions
    # beyond one device's memory (parallel/meta_dp.make_parallel_meta_step_2d).
    sp_axis = (
        cfg.mesh.spatial_axis
        if mesh is not None
        and len(mesh.axis_names) > 1
        and cfg.mesh.spatial_axis in mesh.axis_names
        else None
    )
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import resolve_sp_impl

    sp_impl = resolve_sp_impl(cfg.mesh.sp_impl, model_cfg)
    if mesh is not None and sp_axis is not None:
        if sp_impl == "shardmap":
            # Manual-collective 2-D step (parallel/meta_sp.py), first- and
            # second-order. Hybrid family only; misconfiguration raises
            # loudly there.
            from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
                make_shardmap_meta_step_2d,
            )

            meta_step = make_shardmap_meta_step_2d(
                model_cfg, meta_cfg, mesh,
                dp_axis=cfg.mesh.data_axis, sp_axis=sp_axis,
            )
        elif sp_impl == "gspmd":
            from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (
                make_parallel_meta_step_2d,
            )

            meta_step = make_parallel_meta_step_2d(
                model_cfg, meta_cfg, mesh,
                dp_axis=cfg.mesh.data_axis, sp_axis=sp_axis,
            )
        else:
            raise ValueError(
                f"mesh.sp_impl={cfg.mesh.sp_impl!r}: expected 'auto', "
                "'gspmd' or 'shardmap'"
            )
    elif mesh is not None:
        from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (
            make_parallel_meta_step,
        )

        meta_step = make_parallel_meta_step(
            model_cfg, meta_cfg, mesh, axis=cfg.mesh.data_axis
        )
    else:
        meta_step = make_jit_meta_step(model_cfg, meta_cfg)

    sampler = DifficultySampler(
        len(built), meta_cfg.meta_batch, ema=meta_cfg.difficulty_ema,
        seed=meta_cfg.seed,
    )
    csv = CsvLogger(
        os.path.join(out_dir, "meta_log.csv"),
        ["epoch", "meta_loss", "learning_rate"],
    )
    jsonl = JsonlLogger(os.path.join(out_dir, "meta_log.jsonl"))

    best_path = os.path.join(out_dir, "ckpt_best")
    final_path = os.path.join(out_dir, "ckpt_final")
    last_path = os.path.join(out_dir, "ckpt_last")

    task_names = [b.region_name or f"task{i}" for i, b in enumerate(built)]

    start_epoch, best_loss = 0, float("inf")
    resumed_meta: dict = {}
    if resume and checkpoint_exists(last_path):
        arrays, meta = load_checkpoint(
            last_path, like={"params": state.params, "opt_state": state.opt_state}
        )
        state = MamlState(
            params=arrays["params"],
            opt_state=arrays["opt_state"],
            step=np.int32(meta["step"]),
        )
        # Sampler state is only meaningful if the task pool is identical
        # (same regions, same order); otherwise indices would attribute
        # difficulties to the wrong regions — reset in that case.
        if meta.get("task_names") == task_names:
            sampler.difficulty = np.asarray(meta["sampler_difficulty"], np.float64)
            sampler.seen = np.asarray(meta["sampler_seen"], bool)
            rng_state = meta.get("sampler_rng_state")
            if rng_state is not None:
                sampler._rng.bit_generator.state = rng_state
        else:
            log_cb(
                "[meta-train] task pool changed since the checkpoint — "
                "resetting the difficulty sampler"
            )
        start_epoch = int(meta["epoch"]) + 1
        best_loss = float(meta["best_loss"])
        resumed_meta = meta
        log_cb(f"[meta-train] resumed at epoch {start_epoch} (best {best_loss:.4f})")

    def _rng_state_jsonable():
        import json as _json

        # bit_generator.state nests numpy scalars/arrays; round-trip through
        # the checkpoint's JSON encoder (which handles numpy types).
        return _json.loads(_json.dumps(
            sampler._rng.bit_generator.state,
            default=lambda o: o.item() if hasattr(o, "item") else list(o),
        ))

    def ckpt_meta(epoch, loss):
        return {
            "schema": "wfstgcn-meta-v1",
            "model_version": "jax-1.0",
            "epoch": epoch,
            "step": int(state.step),
            "meta_loss": loss,
            "best_loss": best_loss,
            "total_params": params_n,
            "config": to_dict(cfg),
            "task_names": task_names,
            "sampler_difficulty": sampler.difficulty.tolist(),
            "sampler_seen": sampler.seen.tolist(),
            "sampler_rng_state": _rng_state_jsonable(),
        }

    if start_epoch >= meta_cfg.num_epochs:
        # Nothing left to train — do NOT overwrite final with a NaN loss.
        log_cb(
            f"[meta-train] checkpoint already at epoch {start_epoch} >= "
            f"num_epochs {meta_cfg.num_epochs}; nothing to do"
        )
        return MetaTrainResult(
            best_loss=best_loss,
            final_loss=float(resumed_meta.get("meta_loss", best_loss)),
            best_path=best_path,
            final_path=final_path,
            epochs_run=0,
            param_count=params_n,
        )

    # Upload the whole task pool to HBM once; per-epoch batches are cut with
    # a device-side gather (no host transfer inside the training loop).
    staged = stage_tasks([b.task for b in built])

    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
        AsyncCheckpointer,
    )

    # Epochs fused per dispatch: k>1 runs whole chunks of meta epochs as
    # ONE compiled program (train/maml.py make_chained_meta_step),
    # paying the dispatch + metrics fetch once per chunk. Within a chunk the difficulty
    # sampler draws from difficulties up to k-1 epochs stale, and best/last
    # checkpoints are decided at chunk boundaries from the chunk-end state
    # (intermediate params are never on host). k=1 preserves the exact
    # per-epoch reference cadence.
    k_cfg = max(1, int(meta_cfg.epochs_per_dispatch))
    chained_step = None
    if k_cfg > 1:
        from weatherforecast_stgcn_maml_tpu.train.maml import (
            make_jit_chained_meta_step,
        )

        chained_step = make_jit_chained_meta_step(
            model_cfg, meta_cfg, mesh=mesh,
            axis=cfg.mesh.data_axis if mesh is not None else "dp",
            sp_axis=sp_axis, sp_impl=sp_impl,
        )
    base_key = make_key(meta_cfg.seed + 1, meta_cfg.rng_impl)

    async_ckpt = AsyncCheckpointer()
    loss = float("nan")
    epoch = start_epoch
    while epoch < meta_cfg.num_epochs:
        remaining = meta_cfg.num_epochs - epoch
        # A tail chunk with 2 <= kk < k_cfg would re-trace the chained step
        # at a one-off scan length — one extra full meta-step compile.
        # Decompose the remainder into
        # k=1 steps instead: `meta_step` is either already compiled or far
        # cheaper to compile than a fresh chained scan.
        kk = k_cfg if remaining >= k_cfg else 1
        t0 = time.perf_counter()
        idx_k = np.stack([sampler.sample() for _ in range(kk)])
        if kk == 1:
            tasks = select_tasks(staged, idx_k[0])
            state, metrics = meta_step(
                state, tasks, jax.random.fold_in(base_key, epoch)
            )
        else:
            state, metrics = chained_step(
                state, staged, idx_k.astype(np.int32),
                base_key, np.arange(epoch, epoch + kk, dtype=np.int32),
            )
        # ONE batched device->host fetch instead of three sequential ones.
        loss_arr, per_task, lr_arr = jax.device_get(
            (metrics["meta_loss"], metrics["per_task_loss"],
             metrics["learning_rate"])
        )
        dt = time.perf_counter() - t0
        # Normalize to stacked [kk, ...] metrics so both paths log the same.
        loss_k = np.reshape(np.asarray(loss_arr), (kk,))
        per_task_k = np.reshape(np.asarray(per_task), (kk, -1))
        lr_k = np.reshape(np.asarray(lr_arr), (kk,))

        for j in range(kk):
            e = epoch + j
            sampler.update(idx_k[j], per_task_k[j])
            csv.log(
                epoch=e + 1, meta_loss=float(loss_k[j]),
                learning_rate=float(lr_k[j]),
            )
            rec = {
                "epoch": e + 1,
                "meta_loss": float(loss_k[j]),
                "learning_rate": float(lr_k[j]),
                "per_task_loss": per_task_k[j].tolist(),
                "task_indices": np.asarray(idx_k[j]).tolist(),
                "epoch_seconds": dt / kk,
            }
            if kk > 1:
                rec["dispatch_epochs"] = kk
            jsonl.log(rec)
        loss = float(loss_k[-1])
        lr = float(lr_k[-1])
        last_epoch = epoch + kk - 1
        log_cb(
            f"[meta-train] epoch {last_epoch + 1}/{meta_cfg.num_epochs} "
            f"loss {loss:.4f} lr {lr:.6f} ({dt:.2f}s"
            + (f", {kk} epochs/dispatch)" if kk > 1 else ")")
        )

        # Checkpoint decisions use the CHUNK-END loss/state: with kk>1 the
        # params that achieved an intermediate epoch's loss no longer exist
        # by fetch time, and saving chunk-end params under a better
        # intermediate loss would mislabel the checkpoint.
        if loss < best_loss:
            best_loss = loss
            # Async: the device-side snapshot is taken now, but the fetch
            # + write ride under the next epochs' compute.
            async_ckpt.save(
                best_path,
                {"params": state.params, "opt_state": state.opt_state},
                ckpt_meta(last_epoch, loss),
            )
        if (
            (last_epoch + 1) % max(1, meta_cfg.checkpoint_every) < kk
            or last_epoch == meta_cfg.num_epochs - 1
        ):
            async_ckpt.save(
                last_path,
                {"params": state.params, "opt_state": state.opt_state},
                ckpt_meta(last_epoch, loss),
            )
        epoch += kk

    async_ckpt.wait()  # everything durable before the final (sync) save
    save_checkpoint(
        final_path,
        {"params": state.params, "opt_state": state.opt_state},
        ckpt_meta(meta_cfg.num_epochs - 1, loss),
    )
    log_cb(
        f"[meta-train] done: best {best_loss:.4f}; "
        f"spans {timer.summary()}"
    )
    return MetaTrainResult(
        best_loss=best_loss,
        final_loss=loss,
        best_path=best_path,
        final_path=final_path,
        epochs_run=meta_cfg.num_epochs - start_epoch,
        param_count=params_n,
    )
