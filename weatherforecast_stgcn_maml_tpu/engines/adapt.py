"""Regional adaptation engine — the JAX counterpart of adapt_hybrid_v5.py.

Workflow parity (adapt_hybrid_v5.py:65-271): load the meta-trained
checkpoint, load the region's adaptation-year data, fine-tune ALL parameters
with the climate-aware optimizer + per-epoch LR schedule, validate on the
held-out contiguous tail, save the adapted checkpoint including the region's
normalization stats (which validation must reuse).

Redesign: the feature tensor stays device-resident; every epoch is one
compiled scan over window batches (train/supervised.py) instead of ~960
host-marshalled single-sample batches. The base is honestly trainable —
the reference's `torch.no_grad()` base freeze (SURVEY quirk 2) is the
`model.stop_base_gradients` flag.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import ExperimentConfig, to_dict
from weatherforecast_stgcn_maml_tpu.data.preprocess import pad_nodes, prepare_features
from weatherforecast_stgcn_maml_tpu.data.region import RegionData
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, contiguous_split
from weatherforecast_stgcn_maml_tpu.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.models.hybrid import hybrid_param_count
from weatherforecast_stgcn_maml_tpu.models.registry import init_model
from weatherforecast_stgcn_maml_tpu.train.optimizers import (
    ClimateLRSchedule,
    adaptation_optimizer,
    climate_zone,
)
from weatherforecast_stgcn_maml_tpu.train.supervised import (
    SupervisedState,
    make_batched_eval,
    make_epoch_runner,
)
from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu.utils.metrics import JsonlLogger


@dataclass
class AdaptResult:
    ckpt_path: str
    val_mse: float
    epoch_losses: list
    region_name: str


def adapted_ckpt_path(out_dir: str, region_name: str, box) -> str:
    safe = region_name.replace("/", "_")
    # Canonicalize coordinates: config region boxes are ints while CLI
    # --box parses floats — repr(tuple(box)) would give the SAME region two
    # different paths ("(40, 45, ...)" vs "(40.0, 45.0, ...)") and a later
    # lookup would silently fall back to the base checkpoint.
    coords = "_".join(f"{float(v):g}" for v in box)
    path = os.path.join(out_dir, "adapted", f"{safe}_{coords}")
    if not os.path.exists(path):
        # Pre-canonicalization revisions wrote f"{safe}_{tuple(box)}" — probe
        # both spellings (int and float coords) so checkpoints adapted by an
        # older revision are still discovered instead of silently falling
        # back to the base checkpoint (ADVICE r2). Re-adaptation then also
        # overwrites the legacy directory rather than duplicating it.
        for legacy_box in (tuple(box), tuple(float(v) for v in box)):
            legacy = os.path.join(out_dir, "adapted", f"{safe}_{legacy_box}")
            if os.path.exists(legacy):
                return legacy
    return path


# Jitted-runner cache: all regions share (padded N, T, model config), and
# the optimizer chain only differs across the 3 climate zones — rebuilding
# the runners per region would recompile the identical fully-unrolled
# epoch/eval programs up to 18x per pipeline. Keyed on everything that
# changes the compiled program.
# Bounded FIFO (insertion-ordered dict): a pipeline needs at most the 3
# climate-zone variants, but long-lived processes sweeping configs (probes,
# notebooks) would otherwise accumulate jitted programs without end.
_RUNNER_CACHE: dict = {}
_RUNNER_CACHE_MAX = 8


def _cached_runners(model_cfg, spec, region_name, base_lr, clip_norm, params):
    from weatherforecast_stgcn_maml_tpu.train.optimizers import (
        masked_freeze, trainable_mask,
    )

    zone = climate_zone(region_name)
    key = (model_cfg, spec, zone, base_lr, clip_norm)
    if key not in _RUNNER_CACHE:
        tx, lr0 = adaptation_optimizer(region_name, base_lr, clip_norm)
        if model_cfg.stop_base_gradients or not model_cfg.train_koppen_embedding:
            # Frozen subtrees (encoder and/or Koppen table): excluded from
            # updates AND weight decay (torch requires_grad=False / not-in-
            # optimizer semantics); the global-norm clip then covers only
            # the trainable leaves, like torch's clip over
            # hybrid_model.parameters() (adapt_hybrid_v5.py:200).
            # masked_freeze (not bare optax.masked) so frozen leaves get
            # ZERO updates, not the raw gradient passed through.
            tx = masked_freeze(tx, trainable_mask(params, model_cfg))
        while len(_RUNNER_CACHE) >= _RUNNER_CACHE_MAX:
            _RUNNER_CACHE.pop(next(iter(_RUNNER_CACHE)))
        _RUNNER_CACHE[key] = (
            tx,
            lr0,
            make_epoch_runner(model_cfg, tx, spec),
            make_batched_eval(model_cfg, spec),
        )
    return _RUNNER_CACHE[key]


def adapt_epoch_rng(seed: int, region_name: str, epoch: int, chunk: int = 0,
                    impl: str | None = None):
    """Dropout rng for one adaptation epoch, folded over the REGION identity
    (stable name hash) as well as (epoch, chunk). Without the region fold,
    every region — and every fleet lane in a zone group — would draw
    identical dropout masks each epoch (VERDICT r2 weak #5): a statistical
    correlation the reference's per-region global-RNG runs don't have.
    Shared by the serial and fleet engines so fleet lane i == serial region
    i numerically (tests/test_fleet_mesh.py)."""
    import zlib

    from weatherforecast_stgcn_maml_tpu.utils.prng import make_key

    rid = zlib.crc32(region_name.encode()) % (2**31)
    return jax.random.fold_in(
        jax.random.fold_in(make_key(seed + 7, impl), rid), epoch * 1000 + chunk
    )


def _batch_anchors(anchors: np.ndarray, batch_size: int, *, shuffle, rng):
    """[S] anchors -> [nb, B], shuffled, remainder wrapped to keep coverage."""
    a = np.asarray(anchors)
    if shuffle:
        a = rng.permutation(a)
    b = max(1, min(batch_size, len(a)))
    nb = -(-len(a) // b)
    padded = np.resize(a, nb * b)  # wraps around, every anchor appears >= once
    return padded.reshape(nb, b)


def pad_eval_batches(anchors: np.ndarray, batch_size: int) -> np.ndarray:
    """[S] anchors -> [nb, B] for EXACT per-window eval: the final batch is
    padded by repeating the LAST anchor (the training loop's wrap-padding
    would double-count early windows); callers slice the flat losses back
    to len(anchors) to drop the padding. Shared by the serial and fleet
    adaptation engines."""
    a = np.asarray(anchors)
    b = max(1, min(batch_size, len(a)))
    nb = -(-len(a) // b)
    padded = np.concatenate([a, np.full(nb * b - len(a), a[-1])])
    return padded.reshape(nb, b)


def run_adaptation(
    cfg: ExperimentConfig,
    box,
    region_name: str,
    *,
    meta_ckpt: str | None = None,
    region: RegionData | None = None,
    log_cb=print,
) -> AdaptResult:
    model_cfg, ad = cfg.model, cfg.adapt
    out_dir = cfg.out_dir
    if meta_ckpt is None:
        meta_ckpt = os.path.join(out_dir, "meta", "ckpt_best")

    # Rebuild params from the checkpoint (template-shaped restore).
    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
        check_family,
        load_meta,
    )

    check_family(load_meta(meta_ckpt), model_cfg.family, meta_ckpt)
    template = init_model(jax.random.key(0), model_cfg)
    arrays, meta = load_checkpoint(meta_ckpt, like={"params": template})
    params = arrays["params"]
    log_cb(
        f"[adapt:{region_name}] loaded {meta_ckpt} "
        f"(epoch {meta.get('epoch')}, {hybrid_param_count(params):,} params)"
    )

    if region is None:
        region = get_region_data(
            box, cfg.data.adapt_years, cfg.data, tag="adapt", name=region_name
        )

    graph = build_region_graph(
        region.lats, region.lons, k_neighbors=cfg.data.k_neighbors
    )
    features_np, stats = prepare_features(
        region, rel_coords=model_cfg.relative_coords
    )
    features_np = pad_nodes(features_np, graph.padded_nodes)

    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    from weatherforecast_stgcn_maml_tpu.data.streaming import (
        assign_anchors,
        plan_chunks,
    )

    chunks = plan_chunks(
        region.num_timesteps, spec, ad.max_device_timesteps
    )
    if len(chunks) == 1:
        chunk_feats = [jnp.asarray(features_np)]  # fully device-resident
    else:
        log_cb(
            f"[adapt:{region_name}] streaming {region.num_timesteps} "
            f"timesteps through HBM in {len(chunks)} chunks of "
            f"{chunks[0].stop - chunks[0].start}"
        )
        chunk_feats = None  # shipped per epoch below

    n_samples = spec.num_samples(region.num_timesteps)
    train_idx, val_idx = contiguous_split(
        n_samples, ad.train_fraction, ad.max_samples
    )
    if len(train_idx) == 0 or len(val_idx) == 0:
        raise ValueError(
            f"region {region_name}: {n_samples} windows cannot be split "
            f"{ad.train_fraction:.0%}/{1 - ad.train_fraction:.0%}"
        )
    log_cb(
        f"[adapt:{region_name}] {len(train_idx)} train / {len(val_idx)} val "
        f"windows, {graph.num_nodes} nodes (padded {graph.padded_nodes}), "
        f"climate zone {climate_zone(region_name)}"
    )

    # Quirk 6 compat: reference adapts with koppen_code=0 (padding index).
    koppen = jnp.int32(
        0 if cfg.compat.koppen_zero_in_adapt else max(region.koppen_code, 0)
    )
    a_hat = jnp.asarray(graph.a_hat)
    node_mask = jnp.asarray(graph.node_mask)

    tx, lr0, run_epoch, run_eval = _cached_runners(
        model_cfg, spec, region_name, ad.base_lr, ad.clip_norm, params
    )
    # The schedule takes the RAW base lr: its step() applies the climate
    # multiplier itself (train/optimizers.py:132), exactly like the
    # reference passes the same raw base_lr to both create_climate_optimizer
    # and ClimateAwareLRScheduler (adaptive_scheduler.py:68-95, :7-66).
    # Passing lr0 (= base*mult) here would double-apply the multiplier from
    # epoch 2 on (round-3 review finding).
    schedule = ClimateLRSchedule(region_name, base_lr=ad.base_lr)

    state = SupervisedState(params=params, opt_state=tx.init(params))
    np_rng = np.random.default_rng(ad.seed)
    jsonl = JsonlLogger(os.path.join(out_dir, "adapt", f"{region_name}.jsonl"))

    train_anchor_sets = assign_anchors(chunks, spec.window + train_idx, spec)
    val_anchor_sets = assign_anchors(chunks, spec.window + val_idx, spec)

    def chunk_features(i):
        if chunk_feats is not None:
            return chunk_feats[i]
        ch = chunks[i]
        return jnp.asarray(features_np[ch.start : ch.stop])

    active_chunks = [
        ci for ci in range(len(chunks)) if len(train_anchor_sets[ci]) > 0
    ]

    epoch_losses: list[float] = []
    # Reference phase: epoch 1 trains at the optimizer's initial lr
    # (base*mult); the scheduler steps AFTER each epoch to set the next
    # one's lr (adapt_hybrid_v5.py:171-208). Stepping before epoch 1 would
    # shift the cosine phase and double-apply the climate multiplier there.
    lr = lr0
    for epoch in range(ad.epochs):
        t0 = time.perf_counter()
        losses_all = []
        feats = chunk_features(active_chunks[0]) if active_chunks else None
        for pos, ci in enumerate(active_chunks):
            batches = _batch_anchors(
                train_anchor_sets[ci], ad.batch_size, shuffle=ad.shuffle,
                rng=np_rng,
            )
            state, losses = run_epoch(
                state,
                feats,
                jnp.asarray(batches),
                a_hat,
                node_mask,
                koppen,
                jnp.float32(lr),
                adapt_epoch_rng(ad.seed, region_name, epoch, ci, impl=ad.rng_impl),
            )
            # Start the NEXT chunk's host->HBM transfer before blocking on
            # this chunk's losses — device_put and the dispatched epoch are
            # both async, so the transfer rides under the compute.
            if pos + 1 < len(active_chunks):
                feats = chunk_features(active_chunks[pos + 1])
            losses_all.append(np.asarray(losses))
        avg = float(np.concatenate(losses_all).mean())
        epoch_losses.append(avg)
        jsonl.log({
            "epoch": epoch + 1, "loss": avg, "lr": lr,
            "epoch_seconds": time.perf_counter() - t0,
            "windows": len(train_idx),
        })
        log_cb(
            f"[adapt:{region_name}] epoch {epoch + 1}/{ad.epochs} "
            f"loss {avg:.6f} lr {lr:.6f}"
        )
        lr = schedule.step(avg)

    # Exact per-window validation MSE: pad the final batch by repeating the
    # last anchor, then drop the padding losses before aggregating (the
    # training loop's wrap-padding would double-count early windows here).
    total_se, total_n = 0.0, 0
    for ci in range(len(chunks)):
        anchors = np.asarray(val_anchor_sets[ci])
        if len(anchors) == 0:
            continue
        per_window = np.asarray(
            run_eval(
                state.params, chunk_features(ci),
                jnp.asarray(pad_eval_batches(anchors, ad.batch_size)),
                a_hat, node_mask, koppen,
            )
        ).reshape(-1)[: len(anchors)]
        total_se += float(per_window.sum())
        total_n += len(anchors)
    val_mse = total_se / max(1, total_n)
    log_cb(f"[adapt:{region_name}] validation MSE {val_mse:.6f}")

    path = adapted_ckpt_path(out_dir, region_name, box)
    save_checkpoint(
        path,
        {"params": state.params},
        {
            "schema": "wfstgcn-adapted-v1",
            "model_version": "jax-1.0",
            "region": list(box),
            "region_name": region_name,
            "climate_zone": climate_zone(region_name),
            "koppen_code": int(region.koppen_code),
            "stats": stats.to_dict(),
            "val_mse": val_mse,
            "epoch_losses": epoch_losses,
            "base_checkpoint": os.path.abspath(meta_ckpt),
            "config": to_dict(cfg),
        },
    )
    log_cb(f"[adapt:{region_name}] saved {path}")
    return AdaptResult(
        ckpt_path=path,
        val_mse=val_mse,
        epoch_losses=epoch_losses,
        region_name=region_name,
    )
