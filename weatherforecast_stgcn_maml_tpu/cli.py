"""Command-line interface for the framework.

The reference has no CLI — every workflow is a module-level script with
hardcoded constants (SURVEY.md section 5, config). Here one entry point
drives all workflows with dotted-path config overrides:

  python -m weatherforecast_stgcn_maml_tpu.cli meta-train -o meta.num_epochs=5
  python -m weatherforecast_stgcn_maml_tpu.cli adapt --region Moscow
  python -m weatherforecast_stgcn_maml_tpu.cli validate --region Moscow
  python -m weatherforecast_stgcn_maml_tpu.cli pipeline --shard 0 --num-shards 4
  python -m weatherforecast_stgcn_maml_tpu.cli info
"""

from __future__ import annotations

import argparse
import json
import sys

from weatherforecast_stgcn_maml_tpu.config import (
    ADAPTATION_REGIONS,
    ExperimentConfig,
    apply_overrides,
    to_dict,
)


def _region_by_name(name: str):
    for box, rname in ADAPTATION_REGIONS:
        if rname == name:
            return box, rname
    names = "; ".join(n for _, n in ADAPTATION_REGIONS)
    raise SystemExit(f"unknown region {name!r}; known: {names}")


def _parse_region_list(spec: str):
    """Parse --regions. Six region names contain commas ('Lytton, Canada'),
    so ';' is the safe separator; comma-separated input is still accepted
    by greedily re-joining fragments until they match a known name."""
    if ";" in spec:
        return [_region_by_name(n.strip()) for n in spec.split(";") if n.strip()]
    known = {n for _, n in ADAPTATION_REGIONS}
    out, pending = [], ""
    for frag in spec.split(","):
        pending = f"{pending}, {frag.strip()}" if pending else frag.strip()
        if pending in known:
            out.append(_region_by_name(pending))
            pending = ""
    if pending:
        _region_by_name(pending)  # raises with the known-names list
    return out


def _parse_box(values):
    lat_min, lat_max, lon_min, lon_max = map(float, values)
    return (lat_min, lat_max, lon_min, lon_max)


def _add_common(p):
    p.add_argument(
        "-o",
        "--override",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override, e.g. -o meta.num_epochs=5 -o out_dir=out2",
    )


def _log_stderr(*args):
    """Engine progress goes to stderr so stdout stays machine-readable
    (the validate subcommand prints a JSON document)."""
    print(*args, file=sys.stderr)


def _json_safe(obj):
    """Replace non-finite floats (json.dumps would emit invalid `Infinity`).
    Delegates to utils.metrics._finite, which also handles numpy scalars;
    pair with json.dumps(..., default=float) for remaining numpy leaves."""
    from weatherforecast_stgcn_maml_tpu.utils.metrics import _finite

    return _finite(obj)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wfstgcn", description="MAML-STGCN-LSTM weather forecasting in JAX"
    )
    sub = p.add_subparsers(dest="command", required=True)

    mt = sub.add_parser("meta-train", help="MAML meta-training over global regions")
    mt.add_argument("--resume", action="store_true", help="resume from ckpt_last")
    mt.add_argument(
        "--mesh", action="store_true",
        help="shard the meta batch over all available devices",
    )
    _add_common(mt)

    ad = sub.add_parser("adapt", help="fine-tune the meta-init to one region")
    ad.add_argument("--region", help="named region (see `info`)")
    ad.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    ad.add_argument("--name", help="region name when using --box")
    ad.add_argument("--meta-ckpt", help="path to the meta checkpoint")
    _add_common(ad)

    va = sub.add_parser("validate", help="validate an adapted model")
    va.add_argument("--region", help="named region (see `info`)")
    va.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    va.add_argument("--name")
    va.add_argument("--no-plots", action="store_true")
    _add_common(va)

    pl = sub.add_parser("pipeline", help="adapt+validate all regions")
    pl.add_argument(
        "--regions",
        help="subset of region names, ';'-separated (names may contain commas)",
    )
    pl.add_argument(
        "--shard", type=int, default=None,
        help="this process's shard id. Run one process per GPU: several "
        "shards on one machine each need CUDA_VISIBLE_DEVICES=<shard>, "
        "because a JAX process reserves most of every GPU it sees",
    )
    pl.add_argument("--num-shards", type=int, default=None)
    pl.add_argument("--no-plots", action="store_true")
    pl.add_argument(
        "--mesh-fleet", action="store_true",
        help="adapt pending regions in one mesh-sharded fleet pass "
        "(N regions per step on an N-device slice; engines/fleet_adapt.py)",
    )
    _add_common(pl)

    fc = sub.add_parser("forecast", help="emit denormalized forecasts for a region")
    fc.add_argument("--region", help="named region (see `info`)")
    fc.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    fc.add_argument("--name")
    fc.add_argument("--plots", action="store_true")
    _add_common(fc)

    imp = sub.add_parser(
        "import-checkpoint",
        help="convert a reference PyTorch .pt checkpoint into this framework",
    )
    imp.add_argument("path", help="reference .pt checkpoint")
    imp.add_argument(
        "--allow-unsafe-pickle", action="store_true",
        help="load with full pickle (executes arbitrary bytecode) — only "
        "for TRUSTED files that torch's safe weights_only load rejects",
    )
    imp.add_argument(
        "--out",
        help="output checkpoint dir (default: out/meta/ckpt_best, or the "
        "region's adapted-checkpoint path with --region/--box)",
    )
    imp.add_argument(
        "--region",
        help="import as an ADAPTED checkpoint for this named region "
        "(reference adapt_hybrid_v5.py outputs carry region stats)",
    )
    imp.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    imp.add_argument("--name", help="region name when using --box")
    _add_common(imp)

    exp = sub.add_parser(
        "export-checkpoint",
        help="convert one of this framework's checkpoints to a reference "
        "PyTorch .pt (inverse of import-checkpoint)",
    )
    exp.add_argument(
        "path",
        nargs="?",
        help="framework checkpoint dir (default: out/meta/ckpt_best, or the "
        "region's adapted checkpoint with --region/--box)",
    )
    exp.add_argument("--out", required=True, help="output .pt path")
    exp.add_argument(
        "--region", help="export this named region's adapted checkpoint"
    )
    exp.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    exp.add_argument("--name", help="region name when using --box")
    _add_common(exp)

    dr = sub.add_parser(
        "data-report",
        help="NaN percentages, normalization stats, and graph info for a region",
    )
    dr.add_argument("--region", help="named region (see `info`)")
    dr.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    dr.add_argument("--name")
    dr.add_argument(
        "--years", default="train", choices=["train", "adapt", "validate"]
    )
    _add_common(dr)

    info = sub.add_parser("info", help="print config, regions, and devices")
    _add_common(info)

    return p


def _resolve_region(args):
    if args.region:
        return _region_by_name(args.region)
    if args.box:
        box = _parse_box(args.box)
        return box, (args.name or f"box{box}")
    raise SystemExit("pass --region NAME or --box LAT_MIN LAT_MAX LON_MIN LON_MAX")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = apply_overrides(ExperimentConfig(), args.override)
    except (ValueError, AttributeError, TypeError) as e:
        raise SystemExit(f"bad -o override: {e}") from e

    from weatherforecast_stgcn_maml_tpu.eval.plots import require_matplotlib
    from weatherforecast_stgcn_maml_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    if args.command in ("validate", "pipeline") and not args.no_plots:
        require_matplotlib("--no-plots")
    if args.command == "forecast" and args.plots:
        require_matplotlib("no --plots")
    enable_compile_cache()

    if args.command == "info":
        import jax

        print(json.dumps(to_dict(cfg), indent=2))
        print("devices:", jax.devices())
        print("regions:", ", ".join(n for _, n in ADAPTATION_REGIONS))
        return 0

    if args.command == "meta-train":
        from weatherforecast_stgcn_maml_tpu.engines.meta_train import run_meta_training

        mesh = None
        if args.mesh:
            from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(cfg.mesh)
        res = run_meta_training(cfg, mesh=mesh, resume=args.resume)
        print(f"best_loss={res.best_loss:.6f} best={res.best_path}")
        return 0

    if args.command == "adapt":
        from weatherforecast_stgcn_maml_tpu.engines.adapt import run_adaptation

        box, name = _resolve_region(args)
        res = run_adaptation(cfg, box, name, meta_ckpt=args.meta_ckpt)
        print(f"val_mse={res.val_mse:.6f} ckpt={res.ckpt_path}")
        return 0

    if args.command == "validate":
        from weatherforecast_stgcn_maml_tpu.engines.validate import run_validation

        box, name = _resolve_region(args)
        res = run_validation(
            cfg, box, name, make_plots=not args.no_plots, log_cb=_log_stderr
        )
        print(json.dumps(_json_safe(res.results), indent=2, default=float))
        return 0

    if args.command == "forecast":
        from weatherforecast_stgcn_maml_tpu.engines.forecast import run_forecast

        box, name = _resolve_region(args)
        res = run_forecast(cfg, box, name, make_plots=args.plots)
        print(f"forecast={res.artifact_path} ({res.model_kind} model)")
        return 0

    if args.command == "import-checkpoint":
        from weatherforecast_stgcn_maml_tpu.utils.checkpoint import save_checkpoint
        from weatherforecast_stgcn_maml_tpu.utils.torch_import import (
            import_torch_checkpoint,
        )

        params, model_cfg, stats, meta = import_torch_checkpoint(
            args.path, allow_unsafe_pickle=args.allow_unsafe_pickle
        )
        common = {
            "model_version": str(meta.get("model_version", "imported")),
            "imported_from": args.path,
            "epoch": int(meta.get("epoch", -1)),
            "stats": stats.to_dict() if stats is not None else None,
            "config": {**to_dict(cfg), "model": to_dict(model_cfg)},
        }
        if args.region or args.box:
            from weatherforecast_stgcn_maml_tpu.engines.adapt import (
                adapted_ckpt_path,
            )

            box, name = _resolve_region(args)
            out = args.out or adapted_ckpt_path(cfg.out_dir, name, box)
            save_checkpoint(
                out,
                {"params": params},
                {
                    "schema": "wfstgcn-adapted-v1",
                    "region": list(box),
                    "region_name": name,
                    **common,
                },
            )
        else:
            out = args.out or f"{cfg.out_dir}/meta/ckpt_best"
            save_checkpoint(
                out, {"params": params}, {"schema": "wfstgcn-meta-v1", **common}
            )
        print(f"imported {args.path} -> {out}")
        print(f"model config: {model_cfg}")
        return 0

    if args.command == "export-checkpoint":
        import jax

        from weatherforecast_stgcn_maml_tpu.config import experiment_from_dict
        from weatherforecast_stgcn_maml_tpu.data.preprocess import NormStats
        from weatherforecast_stgcn_maml_tpu.models.registry import init_model
        from weatherforecast_stgcn_maml_tpu.utils.checkpoint import (
            load_checkpoint,
            load_meta,
        )
        from weatherforecast_stgcn_maml_tpu.utils.torch_export import (
            export_torch_checkpoint,
        )

        box = name = None
        if args.region or args.box:
            from weatherforecast_stgcn_maml_tpu.engines.adapt import (
                adapted_ckpt_path,
            )

            box, name = _resolve_region(args)
            src = args.path or adapted_ckpt_path(cfg.out_dir, name, box)
        else:
            src = args.path or f"{cfg.out_dir}/meta/ckpt_best"
        meta = load_meta(src)
        model_cfg = cfg.model
        if isinstance(meta.get("config"), dict) and "model" in meta["config"]:
            model_cfg = experiment_from_dict(meta["config"]).model
        if model_cfg.family != "hybrid":
            raise SystemExit(
                f"export-checkpoint: reference schema is hybrid-only, "
                f"checkpoint family is {model_cfg.family!r}"
            )
        template = init_model(jax.random.key(0), model_cfg)
        arrays, _ = load_checkpoint(src, like={"params": template})
        stats = (
            NormStats.from_dict(meta["stats"]) if meta.get("stats") else None
        )
        extra = {
            k: meta[k]
            for k in ("epoch", "val_mse", "koppen_code")
            if k in meta and meta[k] is not None
        }
        export_torch_checkpoint(
            args.out,
            arrays["params"],
            model_cfg,
            stats=stats,
            region=tuple(box) if box else meta.get("region"),
            region_name=name or meta.get("region_name"),
            extra_meta=extra,
        )
        print(f"exported {src} -> {args.out}")
        return 0

    if args.command == "data-report":
        import numpy as np

        from weatherforecast_stgcn_maml_tpu.data.koppen import class_name
        from weatherforecast_stgcn_maml_tpu.data.preprocess import (
            compute_stats,
            fill_nans_with_mean,
            nan_percentages,
        )
        from weatherforecast_stgcn_maml_tpu.engines.data_source import get_region_data
        from weatherforecast_stgcn_maml_tpu.config import WEATHER_VARS
        from weatherforecast_stgcn_maml_tpu.graph import build_region_graph

        box, name = _resolve_region(args)
        years = {
            "train": cfg.data.train_years,
            "adapt": cfg.data.adapt_years,
            "validate": (cfg.data.validate_year,),
        }[args.years]
        region = get_region_data(box, years, cfg.data, tag=args.years, name=name)
        pct = nan_percentages(region.weather)
        t, la, lo, _ = region.weather.shape
        # Same NaN policy as the real pipeline (prepare_features): fill with
        # the per-variable nanmean, THEN compute stats — zero-filling would
        # report stats the model never sees.
        filled = fill_nans_with_mean(
            region.weather.reshape(t, la * lo, -1).astype(np.float32)
        )
        stats = compute_stats(filled)
        g = build_region_graph(region.lats, region.lons, k_neighbors=cfg.data.k_neighbors)
        print(f"region {name} {tuple(box)} — {args.years} years {years}")
        print(
            f"  {t} timesteps x {la}x{lo} grid = {g.num_nodes} nodes "
            f"(padded {g.padded_nodes}); koppen {region.koppen_code} "
            f"({class_name(region.koppen_code)})"
        )
        print(f"  {'var':>6} {'nan%':>6} {'mean':>12} {'std':>12}")
        for i, var in enumerate(WEATHER_VARS):
            flag = "!!" if pct[i] >= 0.15 else (" !" if pct[i] >= 0.05 else "  ")
            print(
                f"  {var:>6} {100 * pct[i]:5.1f}{flag} {stats.mean[i]:12.4g} "
                f"{stats.std[i]:12.4g}"
            )
        return 0

    if args.command == "pipeline":
        from weatherforecast_stgcn_maml_tpu.engines.pipeline import run_pipeline
        from weatherforecast_stgcn_maml_tpu.parallel.fleet import auto_shard

        regions = None
        if args.regions:
            regions = _parse_region_list(args.regions)
        if args.shard is not None and args.num_shards is not None:
            shard, num = args.shard, args.num_shards
        elif args.shard is None and args.num_shards is None:
            # jax.distributed-aware: (process_index, process_count); plain
            # single-process hosts get (0, 1).
            shard, num = auto_shard()
        else:
            raise SystemExit(
                "pass BOTH --shard and --num-shards (explicit partitioning) "
                "or neither (auto from the jax process topology)"
            )
        res = run_pipeline(
            cfg,
            regions,
            shard_id=shard,
            num_shards=num,
            make_plots=not args.no_plots,
            mesh_fleet=args.mesh_fleet,
        )
        return 1 if res.errors else 0

    raise SystemExit(f"unhandled command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
