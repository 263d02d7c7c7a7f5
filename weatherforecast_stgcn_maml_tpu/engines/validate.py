"""Validation engine — the JAX counterpart of validate_hybrid_v5.py.

Workflow parity (validate_hybrid_v5.py:113-371): load the adapted checkpoint
(falling back to the meta-trained base), load held-out validation-year data,
slice the middle <= `validate_max_timesteps` window, normalize with the
STATS SAVED AT ADAPTATION TIME, run a few forward passes, denormalize, print
the per-step t2m table, emit the temperature + all-variable PNGs, and return
per-variable MSE/MAE with `sp` excluded from the average.

Quirk 5 compat: the reference averages predictions AND targets across 3
*different* windows before scoring (a smoothing choice). That protocol is
the `compat.average_validation_targets` flag (default True for comparable
numbers); False scores each window against its own target and averages the
per-window metrics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import ExperimentConfig, T2M_INDEX
from weatherforecast_stgcn_maml_tpu.data.preprocess import (
    NormStats,
    pad_nodes,
    prepare_features,
)
from weatherforecast_stgcn_maml_tpu.data.region import RegionData
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu.engines.adapt import adapted_ckpt_path
from weatherforecast_stgcn_maml_tpu.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu.eval.metrics import forecast_table, variable_metrics
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu.models.registry import init_model
from weatherforecast_stgcn_maml_tpu.train.supervised import make_predict
from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
)


@dataclass
class ValidationResult:
    results: dict  # {var: {mse, mae}, "average_mse": float}
    table: str
    plots: list
    region_name: str
    model_kind: str  # "adapted" | "base"


def _mean_metric_dicts(dicts: list[dict]) -> dict:
    """Average identically-shaped metric dicts leaf-wise."""
    out = {}
    for key, value in dicts[0].items():
        if isinstance(value, dict):
            out[key] = _mean_metric_dicts([d[key] for d in dicts])
        else:
            out[key] = float(np.mean([d[key] for d in dicts]))
    return out


def _load_params_and_stats(cfg: ExperimentConfig, box, region_name, log_cb):
    """Adapted checkpoint first, base fallback (validate_hybrid_v5.py:35-110)."""
    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
        check_family,
        load_meta,
    )

    template = init_model(jax.random.key(0), cfg.model)
    adapted = adapted_ckpt_path(cfg.out_dir, region_name, box)
    base = os.path.join(cfg.out_dir, "meta", "ckpt_best")
    if checkpoint_exists(adapted):
        check_family(load_meta(adapted), cfg.model.family, adapted)
        arrays, meta = load_checkpoint(adapted, like={"params": template})
        stats = NormStats.from_dict(meta["stats"]) if meta.get("stats") else None
        return arrays["params"], stats, "adapted"
    if checkpoint_exists(base):
        log_cb(f"[validate:{region_name}] no adapted model, using base checkpoint")
        check_family(load_meta(base), cfg.model.family, base)
        arrays, _ = load_checkpoint(base, like={"params": template})
        return arrays["params"], None, "base"
    raise FileNotFoundError(
        f"no checkpoint found for {region_name}: tried {adapted} and {base}"
    )


def run_validation(
    cfg: ExperimentConfig,
    box,
    region_name: str,
    *,
    region: RegionData | None = None,
    make_plots: bool = True,
    log_cb=print,
) -> ValidationResult:
    model_cfg, data_cfg = cfg.model, cfg.data
    params, saved_stats, kind = _load_params_and_stats(cfg, box, region_name, log_cb)

    if region is None:
        region = get_region_data(
            box,
            (data_cfg.validate_year,),
            data_cfg,
            tag="validate",
            name=region_name,
            num_timesteps=max(
                data_cfg.validate_max_timesteps + model_cfg.window + model_cfg.horizon,
                96,
            ),
        )

    # At least one full (window, horizon) pair with its anchor step between
    # them (data/windows.py: anchors live in [W, T - H), so T >= W + H + 1).
    needed = model_cfg.window + model_cfg.horizon + 1
    total = region.num_timesteps
    if total < needed:
        log_cb(
            f"[validate:{region_name}] only {total} timesteps "
            f"(need {needed}) — returning inf MSE"
        )
        return ValidationResult(
            results={"average_mse": float("inf")},
            table="",
            plots=[],
            region_name=region_name,
            model_kind=kind,
        )

    # Middle slice of up to validate_max_timesteps (validate_hybrid_v5.py:156-159).
    start = max(0, total // 4)
    end = min(total, start + data_cfg.validate_max_timesteps)
    if end - start < needed:
        start, end = 0, min(total, max(needed, data_cfg.validate_max_timesteps))
    sub = RegionData(
        weather=region.weather[start:end],
        times=region.times[start:end],
        lats=region.lats,
        lons=region.lons,
        koppen_code=region.koppen_code,
        name=region.name,
    )

    graph = build_region_graph(sub.lats, sub.lons, k_neighbors=data_cfg.k_neighbors)
    features_np, stats = prepare_features(
        sub, stats=saved_stats, rel_coords=model_cfg.relative_coords
    )
    features = jnp.asarray(pad_nodes(features_np, graph.padded_nodes))

    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    n_samples = spec.num_samples(sub.num_timesteps)
    num = min(data_cfg.validate_num_samples, n_samples)
    anchors = jnp.asarray(spec.window + np.arange(num))
    x, y = gather_batch(features, anchors, spec)

    koppen = jnp.int32(
        0 if cfg.compat.koppen_zero_in_adapt else max(region.koppen_code, 0)
    )
    predict = make_predict(model_cfg)
    preds = np.asarray(predict(params, x, jnp.asarray(graph.a_hat), koppen))
    targets = np.asarray(y)

    n = graph.num_nodes
    # Node-average the real nodes: [B, H, N, 12] -> [B, H, 12].
    pred_avg_b = preds[:, :, :n, :].mean(axis=2)
    true_avg_b = targets[:, :, :n, :].mean(axis=2)

    if cfg.compat.average_validation_targets:
        pred_avg = pred_avg_b.mean(axis=0)
        true_avg = true_avg_b.mean(axis=0)
        results = variable_metrics(pred_avg, true_avg, stats)
    else:
        # Score each window separately, then average the metric dicts
        # leaf-wise (per-variable {"mse","mae"} plus scalar summaries).
        per_window = [
            variable_metrics(pred_avg_b[i], true_avg_b[i], stats)
            for i in range(num)
        ]
        results = _mean_metric_dicts(per_window)
        pred_avg, true_avg = pred_avg_b.mean(axis=0), true_avg_b.mean(axis=0)

    # t2m table on the first window's timeline.
    input_times = sub.times[: model_cfg.window]
    forecast_times = sub.times[
        model_cfg.window : model_cfg.window + model_cfg.horizon
    ]
    t_true = stats.denormalize(true_avg[:, T2M_INDEX], T2M_INDEX)
    t_pred = stats.denormalize(pred_avg[:, T2M_INDEX], T2M_INDEX)
    table = forecast_table(forecast_times, t_true, t_pred)
    log_cb(f"[validate:{region_name}] t2m forecast ({kind} model):\n{table}")

    plots = []
    if make_plots:
        from weatherforecast_stgcn_maml_tpu.eval.plots import (
            temperature_figure,
            variables_figure,
        )

        plot_dir = os.path.join(cfg.out_dir, "validation")
        x0 = np.asarray(x[0])[:, :n, :]  # [W, N, C]
        input_temp = stats.denormalize(
            x0[..., T2M_INDEX].mean(axis=1), T2M_INDEX
        )
        plots.append(
            temperature_figure(
                os.path.join(plot_dir, f"{region_name}_temperature.png"),
                input_times,
                forecast_times,
                input_temp,
                t_true,
                t_pred,
                region_name,
            )
        )
        plots.append(
            variables_figure(
                os.path.join(plot_dir, f"{region_name}_all_variables.png"),
                true_avg,
                pred_avg,
                stats,
                region_name,
            )
        )

    summary = ", ".join(
        f"{k}: mse={v['mse']:.3f}" for k, v in results.items() if isinstance(v, dict)
    )
    log_cb(
        f"[validate:{region_name}] {summary}; "
        f"average_mse={results['average_mse']:.3f}"
    )
    return ValidationResult(
        results=results,
        table=table,
        plots=plots,
        region_name=region_name,
        model_kind=kind,
    )
