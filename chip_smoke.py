"""Smoke run of the whole system on one NVIDIA GPU (four with --four).

Drives the main path through the CLI entry points a user calls, at the full
width of the reference model (ModelConfig()/MetaConfig() defaults: GCN
256x4, LSTM 128x4, window 24 -> horizon 8, 808,280 parameters, 441-node
synthetic regions padded to 512, 4 tasks x 6x15 inner steps, grad-accum 2).
Weights are random from fixed seeds; data comes from the in-repo generator.

  0 device      refuse to run without a GPU; print devices, card, native lib
  1 meta-train  2 meta-epochs, float32
  2 bf16        2 meta-epochs, -o model.compute_dtype=bfloat16
  3 so          2 meta-epochs, -o meta.second_order=true (so_impl="hvp")
  4 adapt       2 epochs on one region from phase 1's checkpoint
  5 validate    validate --no-plots, then forecast
  6 parity      GPU against the same function on the host CPU
  7 trace       with --trace DIR: profiler trace of one FO meta step

--four runs only the multi-GPU paths (dp meta step, dp x sp meta step under
shard_map and GSPMD, fleet adaptation), each against its one-GPU reference.
A failed phase raises, so the script exits non-zero before the last line,
which is one JSON object naming the device.

  python chip_smoke.py [--trace DIR] [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ONE_GPU_PHASES = ("meta_train", "bf16", "second_order", "adapt", "validate", "parity")
FOUR_GPU_PHASES = ("dp", "dp_sp", "fleet")
ADAPT_REGION = "Moscow"  # a 5-degree box: 441 nodes, padded to 512

# Parity tolerances, relative L2 over all outputs. Both sides run the same
# float32 program at "highest" matmul precision with threefry keys, so only
# the summation order of the GPU's and the CPU's kernels differs. (a) is one
# forward pass; (b) differentiates through 3 clipped SGD steps and a query
# loss, which amplifies rounding, hence the looser bound.
FORWARD_RTOL = 1e-4
META_GRAD_RTOL = 1e-3
# --four: the sharded and the one-GPU programs differ in how XLA splits and
# orders sums (psum of per-device partial gradients, per-device batch
# shapes); a full inner loop of 90 SGD steps runs on each side.
MULTI_GPU_RTOL = 1e-3
# --four runs the LSTM as a rolled scan: the same math at the same width,
# and each of the seven programs compiles several times faster than with
# the scan fully unrolled (the one-GPU phases keep the default).
FOUR_GPU_OVERRIDES = ("model.lstm_unroll=1",)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def report(phase: str, **numbers) -> None:
    body = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {body}", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--trace", metavar="DIR",
        help="also write a jax.profiler trace of one full-width FO meta step",
    )
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU phases (needs 4 GPUs)",
    )
    return ap.parse_args(argv)


def select_phases(args) -> tuple[str, ...]:
    if args.four:
        return FOUR_GPU_PHASES
    return ONE_GPU_PHASES + (("trace",) if args.trace else ())


def rel_l2(a_leaves, b_leaves) -> tuple[float, float]:
    """(relative L2 error of a against b, max abs difference) over leaves."""
    import numpy as np

    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a_leaves])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b_leaves])
    diff = a - b
    return (
        float(np.linalg.norm(diff) / max(np.linalg.norm(b), 1e-30)),
        float(np.abs(diff).max()),
    )


def _cli(argv, capture: bool = False) -> str:
    """Run one CLI command in-process; engine logs go to stderr."""
    from weatherforecast_stgcn_maml_tpu.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out if capture else sys.stderr):
        rc = main(argv)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return out.getvalue()


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Ctx:
    """What the phases share: the scratch dir and the CLI overrides that set
    its paths (full width is the configs' defaults; tests pass smaller
    model overrides here to run the same phases on the CPU)."""

    def __init__(self, root: str, overrides=()):
        self.root = root
        self.overrides = list(overrides)

    def out(self, name: str) -> str:
        return os.path.join(self.root, name)

    def flags(self, out_dir: str, *extra: str) -> list[str]:
        opts = [
            f"out_dir={out_dir}",
            f"data.cache_dir={os.path.join(self.root, 'cache')}",
            *self.overrides,
            *extra,
        ]
        return [x for o in opts for x in ("-o", o)]


def _meta_train(ctx: Ctx, phase: str, out_dir: str, *extra: str) -> None:
    t0 = time.perf_counter()
    _cli(["meta-train", *ctx.flags(out_dir, "meta.num_epochs=2", *extra)])
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "meta", "meta_log.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    losses = [r["meta_loss"] for r in recs]
    secs = [r["epoch_seconds"] for r in recs]
    check(len(recs) == 2, f"{phase}: {len(recs)} epochs logged, expected 2")
    check(all(math.isfinite(v) for v in losses), f"{phase}: losses {losses}")
    check(
        os.path.exists(os.path.join(out_dir, "meta", "ckpt_best", "meta.json")),
        f"{phase}: ckpt_best was not written",
    )
    report(
        phase,
        first_epoch_s=f"{secs[0]:.3f}",
        steady_epoch_s=f"{secs[1]:.3f}",
        compile_s_est=f"{secs[0] - secs[1]:.3f}",
        wall_s=f"{wall:.1f}",
        losses=[round(v, 6) for v in losses],
        peak_bytes=_peak_bytes(),
    )


def phase_meta_train(ctx: Ctx) -> None:
    _meta_train(ctx, "meta_train", ctx.out("f32"))


def phase_bf16(ctx: Ctx) -> None:
    _meta_train(ctx, "bf16", ctx.out("bf16"), "model.compute_dtype=bfloat16")


def phase_second_order(ctx: Ctx) -> None:
    _meta_train(ctx, "second_order", ctx.out("so"), "meta.second_order=true")


def phase_adapt(ctx: Ctx) -> None:
    from weatherforecast_stgcn_maml_tpu.cli import _region_by_name
    from weatherforecast_stgcn_maml_tpu.engines.adapt import adapted_ckpt_path
    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import load_meta

    out_dir = ctx.out("f32")
    _cli([
        "adapt", "--region", ADAPT_REGION,
        *ctx.flags(out_dir, "adapt.epochs=2"),
    ])
    with open(os.path.join(out_dir, "adapt", f"{ADAPT_REGION}.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    box, _ = _region_by_name(ADAPT_REGION)
    val_mse = load_meta(adapted_ckpt_path(out_dir, ADAPT_REGION, box))["val_mse"]
    check(math.isfinite(val_mse), f"adapt: val_mse {val_mse}")
    check(all(math.isfinite(r["loss"]) for r in recs), f"adapt: {recs}")
    steady = recs[-1]
    report(
        "adapt",
        region=ADAPT_REGION,
        windows_per_epoch=steady["windows"],
        first_epoch_s=f"{recs[0]['epoch_seconds']:.3f}",
        steady_epoch_s=f"{steady['epoch_seconds']:.3f}",
        windows_per_s=f"{steady['windows'] / steady['epoch_seconds']:.1f}",
        val_mse=f"{val_mse:.6f}",
    )


def phase_validate(ctx: Ctx) -> None:
    import numpy as np

    out_dir = ctx.out("f32")
    text = _cli(
        ["validate", "--region", ADAPT_REGION, "--no-plots", *ctx.flags(out_dir)],
        capture=True,
    )
    results = json.loads(text)
    per_var = {k: v for k, v in results.items() if isinstance(v, dict)}
    check(len(per_var) > 0, "validate: no variable scored")
    values = [x for v in per_var.values() for x in (v["mse"], v["mae"])]
    check(all(math.isfinite(x) for x in values), f"validate: {results}")
    _cli(["forecast", "--region", ADAPT_REGION, *ctx.flags(out_dir)])
    with open(os.path.join(out_dir, "forecasts", f"{ADAPT_REGION}.json")) as f:
        forecast = np.asarray(json.load(f)["mean_forecast"])
    check(np.isfinite(forecast).all(), "forecast: non-finite values")
    report(
        "validate",
        variables=len(per_var),
        average_mse=f"{results['average_mse']:.6f}",
        t2m_mse=f"{per_var['t2m']['mse']:.6f}",
        t2m_mae=f"{per_var['t2m']['mae']:.6f}",
        forecast_shape=list(forecast.shape),
    )


def _parity_inputs(model_cfg, meta_cfg):
    """Full-width model, one 441-node task and one eval window, all made
    from fixed seeds on the host."""
    import jax
    import numpy as np

    from weatherforecast_stgcn_maml_tpu.config import DataConfig
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks

    region = synthetic_region_for_box((10.0, 15.0, 20.0, 25.0), num_timesteps=96, seed=0)
    built = build_meta_tasks([region], model_cfg, meta_cfg, DataConfig())[0]
    task = jax.tree.map(np.asarray, built.task)
    with jax.default_device(jax.devices("cpu")[0]):
        params = jax.tree.map(np.asarray, init_model(jax.random.key(0), model_cfg))
    return params, task


def phase_parity(ctx: Ctx) -> None:
    import dataclasses

    import jax

    from weatherforecast_stgcn_maml_tpu.config import (
        ExperimentConfig,
        MetaConfig,
        apply_overrides,
    )
    from weatherforecast_stgcn_maml_tpu.models.registry import apply_model
    from weatherforecast_stgcn_maml_tpu.train.maml import adapt_and_query_loss

    model_cfg = apply_overrides(ExperimentConfig(), ctx.overrides).model
    model_cfg = dataclasses.replace(model_cfg, compute_dtype="float32")
    meta_cfg = MetaConfig(inner_epochs=1, inner_batches=3, rng_impl="threefry2x32")
    params, task = _parity_inputs(model_cfg, meta_cfg)
    devices = {"gpu": jax.devices()[0], "cpu": jax.devices("cpu")[0]}

    def forward(p, t):
        return apply_model(p, t.a_hat, t.query_x[0], t.koppen, model_cfg)

    def meta_grad(p, t, key):
        return jax.value_and_grad(
            lambda q: adapt_and_query_loss(q, t, key, model_cfg, meta_cfg)
        )(p)

    def on(dev, fn, *args):
        with jax.default_device(dev):
            args = jax.device_put(args, dev)
            return jax.device_get(jax.jit(fn)(*args))

    key = jax.random.key(7, impl="threefry2x32")
    with jax.default_matmul_precision("highest"):
        fwd = {k: on(d, forward, params, task) for k, d in devices.items()}
        grads = {k: on(d, meta_grad, params, task, key) for k, d in devices.items()}
    fwd_default = on(devices["gpu"], forward, params, task)

    fwd_err, fwd_max = rel_l2([fwd["gpu"]], [fwd["cpu"]])
    grad_err, grad_max = rel_l2(
        jax.tree.leaves(grads["gpu"]), jax.tree.leaves(grads["cpu"])
    )
    tf32_err, tf32_max = rel_l2([fwd_default], [fwd["cpu"]])
    report(
        "parity",
        forward_rel_l2=f"{fwd_err:.3e}", forward_max_abs=f"{fwd_max:.3e}",
        forward_tol=FORWARD_RTOL,
        meta_grad_rel_l2=f"{grad_err:.3e}", meta_grad_max_abs=f"{grad_max:.3e}",
        meta_grad_tol=META_GRAD_RTOL,
        query_loss_gpu=f"{float(grads['gpu'][0]):.6f}",
        query_loss_cpu=f"{float(grads['cpu'][0]):.6f}",
    )
    report(
        "parity_default_precision",
        forward_rel_l2=f"{tf32_err:.3e}", forward_max_abs=f"{tf32_max:.3e}",
        gates="nothing",
    )
    check(fwd_err <= FORWARD_RTOL, f"parity: forward rel L2 {fwd_err:.3e}")
    check(grad_err <= META_GRAD_RTOL, f"parity: meta-grad rel L2 {grad_err:.3e}")


def phase_trace(ctx: Ctx, trace_dir: str) -> None:
    """Two traces of one full-width FO meta step: the program as it runs
    (window, busy and idle share), then the same program compiled without
    command buffers, whose kernels name their HLO ops (device time per
    named scope: GCN encoder, LSTM, inner clip+SGD)."""
    import jax

    from bench import build_bench_inputs
    from weatherforecast_stgcn_maml_tpu.utils.profiling import (
        hlo_op_names,
        load_trace,
        summarize_trace,
    )

    state, step, tasks, _, _, _ = build_bench_inputs(quick=False, dtype="float32")
    key = jax.random.key(1)
    plain = step.lower(state, tasks, key).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""}
    )
    summaries = {}
    for name, fn in (("default", step), ("no_command_buffer", plain)):
        for _ in range(2):  # compile, then one warm step outside the window
            state, metrics = fn(state, tasks, key)
            jax.block_until_ready(metrics)
        t0 = time.perf_counter()
        with jax.profiler.trace(os.path.join(trace_dir, name)):
            state, metrics = fn(state, tasks, key)
            jax.block_until_ready(metrics)
        traced_s = time.perf_counter() - t0
        names = hlo_op_names(plain.as_text()) if fn is plain else None
        summaries[name] = summarize_trace(
            load_trace(os.path.join(trace_dir, name)), names
        )
        summaries[name]["traced_step_s"] = traced_s
        sm = summaries[name]
        report(
            f"trace_{name}",
            traced_step_s=f"{traced_s:.3f}",
            window_ms=f"{sm['window_ns'] / 1e6:.3f}",
            busy_ms=f"{sm['busy_ns'] / 1e6:.3f}",
            idle_share=f"{1 - sm['busy_ns'] / max(sm['window_ns'], 1):.4f}",
            kernels=sm["kernels"],
            scopes_ms={k: round(v / 1e6, 3) for k, v in sm["scopes_ns"].items()},
        )
        top = sm["top_op_names_ns"] or sm["top_kernels_ns"]
        report(
            f"trace_{name}_top",
            ms={k[-90:]: round(v / 1e6, 3) for k, v in list(top.items())[:10]},
        )
    with open(os.path.join(trace_dir, "summary.json"), "w") as f:
        json.dump(summaries, f, indent=2)


def _configs(ctx: Ctx, **meta):
    """Model and meta configs: the defaults (full width) plus ctx's
    overrides, with the multi-GPU phase's own meta settings on top."""
    import dataclasses

    from weatherforecast_stgcn_maml_tpu.config import ExperimentConfig, apply_overrides

    cfg = apply_overrides(ExperimentConfig(), ctx.overrides)
    return cfg.model, dataclasses.replace(cfg.meta, rng_impl="threefry2x32", **meta)


def _multi_gpu_inputs(model_cfg, meta_cfg, n_tasks: int):
    import jax

    from weatherforecast_stgcn_maml_tpu.config import DataConfig
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.train.maml import init_meta_state
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

    regions = [
        synthetic_region_for_box(
            (10.0 + 6 * i, 15.0 + 6 * i, 20.0, 25.0), num_timesteps=160, seed=i
        )
        for i in range(n_tasks)
    ]
    built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
    tasks = stack_tasks([b.task for b in built])
    state = jax.device_get(init_meta_state(jax.random.key(0), model_cfg, meta_cfg))
    return state, tasks


def _timed(fn, *args):
    """Run twice: the first call compiles; return the second's result and
    seconds."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _one_gpu_step(model_cfg, meta_cfg, state, tasks, key):
    import jax

    from weatherforecast_stgcn_maml_tpu.train.maml import make_meta_step

    dev = jax.devices()[0]
    step = jax.jit(make_meta_step(model_cfg, meta_cfg))
    return _timed(step, *jax.device_put((state, tasks, key), dev))


def _compare(phase, name, ref, got, seconds_ref, seconds_got) -> None:
    import jax

    (s1, m1), (s2, m2) = ref, got
    loss_err, _ = rel_l2([m2["per_task_loss"]], [m1["per_task_loss"]])
    param_err, param_max = rel_l2(
        jax.tree.leaves(s2.params), jax.tree.leaves(s1.params)
    )
    report(
        phase,
        impl=name,
        loss_rel_l2=f"{loss_err:.3e}",
        params_rel_l2=f"{param_err:.3e}", params_max_abs=f"{param_max:.3e}",
        tol=MULTI_GPU_RTOL,
        step_s_one_gpu=f"{seconds_ref:.3f}", step_s=f"{seconds_got:.3f}",
    )
    check(loss_err <= MULTI_GPU_RTOL, f"{phase}/{name}: losses {loss_err:.3e}")
    check(param_err <= MULTI_GPU_RTOL, f"{phase}/{name}: params {param_err:.3e}")


def phase_dp(ctx: Ctx) -> None:
    import jax

    from weatherforecast_stgcn_maml_tpu.config import MeshConfig
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh, shard_task_batch
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import make_parallel_meta_step

    model_cfg, meta_cfg = _configs(ctx, meta_batch=8, grad_accum=2)
    state, tasks = _multi_gpu_inputs(model_cfg, meta_cfg, 8)
    key = jax.random.key(3, impl="threefry2x32")
    with jax.default_matmul_precision("highest"):
        ref, t_ref = _one_gpu_step(model_cfg, meta_cfg, state, tasks, key)
        mesh = make_mesh(MeshConfig(num_devices=4))
        step = make_parallel_meta_step(model_cfg, meta_cfg, mesh, donate_state=False)
        got, t_got = _timed(step, state, shard_task_batch(tasks, mesh), key)
    _compare("dp", "dp4", ref, got, t_ref, t_got)


def phase_dp_sp(ctx: Ctx) -> None:
    import dataclasses

    import jax

    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import make_parallel_meta_step_2d
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import make_shardmap_meta_step_2d

    # Dropout off: the shard_map step draws its masks per node shard, a
    # different (valid) stream from the unsharded step's.
    model_cfg, meta_cfg = _configs(
        ctx, meta_batch=4, grad_accum=2, query_train_mode=False
    )
    model_cfg = dataclasses.replace(model_cfg, gcn_dropout=0.0, lstm_dropout=0.0)
    state, tasks = _multi_gpu_inputs(model_cfg, meta_cfg, 4)
    key = jax.random.key(5, impl="threefry2x32")
    mesh = make_mesh_2d(2, 2)
    with jax.default_matmul_precision("highest"):
        ref, t_ref = _one_gpu_step(model_cfg, meta_cfg, state, tasks, key)
        sharded = shard_task_batch_2d(tasks, mesh)
        for name, make in (
            ("shardmap", make_shardmap_meta_step_2d),
            ("gspmd", make_parallel_meta_step_2d),
        ):
            step = make(model_cfg, meta_cfg, mesh, donate_state=False)
            got, t_got = _timed(step, state, sharded, key)
            _compare("dp_sp", name, ref, got, t_ref, t_got)


def phase_fleet(ctx: Ctx) -> None:
    import jax

    import dataclasses

    from weatherforecast_stgcn_maml_tpu.config import (
        ADAPTATION_REGIONS,
        ExperimentConfig,
        MeshConfig,
        apply_overrides,
    )
    from weatherforecast_stgcn_maml_tpu.engines.adapt import run_adaptation
    from weatherforecast_stgcn_maml_tpu.engines.fleet_adapt import run_fleet_adaptation
    from weatherforecast_stgcn_maml_tpu.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu.utils.checkpoint import save_checkpoint

    # One climate zone, so the fleet adapts all four in one 4-lane pass.
    names = ("NewYork", "Argentina", "Sudan", "India")
    regions = [(box, name) for box, name in ADAPTATION_REGIONS if name in names]

    def cfg_for(name):
        cfg = apply_overrides(ExperimentConfig(), ctx.overrides)
        cfg = dataclasses.replace(
            cfg,
            adapt=dataclasses.replace(cfg.adapt, epochs=1, rng_impl="threefry2x32"),
            mesh=MeshConfig(num_devices=4),
            out_dir=ctx.out(name),
        )
        save_checkpoint(
            os.path.join(cfg.out_dir, "meta", "ckpt_best"),
            {"params": init_model(jax.random.key(0), cfg.model)},
            {"schema": "wfstgcn-meta-v1", "epoch": 0},
        )
        return cfg

    def quiet(*_):
        pass

    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        fleet = run_fleet_adaptation(cfg_for("fleet"), regions, log_cb=quiet)
        t_fleet = time.perf_counter() - t0
        serial_cfg = cfg_for("serial")
        t0 = time.perf_counter()
        serial = [run_adaptation(serial_cfg, b, n, log_cb=quiet) for b, n in regions]
        t_serial = time.perf_counter() - t0
    loss_err, _ = rel_l2(
        [r.epoch_losses for r in fleet], [r.epoch_losses for r in serial]
    )
    mse_err, _ = rel_l2([r.val_mse for r in fleet], [r.val_mse for r in serial])
    report(
        "fleet",
        regions=len(regions),
        epoch_loss_rel_l2=f"{loss_err:.3e}", val_mse_rel_l2=f"{mse_err:.3e}",
        tol=MULTI_GPU_RTOL,
        wall_s_fleet=f"{t_fleet:.1f}", wall_s_serial=f"{t_serial:.1f}",
    )
    check(loss_err <= MULTI_GPU_RTOL, f"fleet: epoch losses {loss_err:.3e}")
    check(mse_err <= MULTI_GPU_RTOL, f"fleet: val MSE {mse_err:.3e}")


PHASES = {
    "meta_train": phase_meta_train,
    "bf16": phase_bf16,
    "second_order": phase_second_order,
    "adapt": phase_adapt,
    "validate": phase_validate,
    "parity": phase_parity,
    "dp": phase_dp,
    "dp_sp": phase_dp_sp,
    "fleet": phase_fleet,
}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import weatherforecast_stgcn_maml_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is not importable here ({e})", file=sys.stderr)
        return 2
    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX's backend is {jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 2
    from weatherforecast_stgcn_maml_tpu import native
    from weatherforecast_stgcn_maml_tpu.utils.compile_cache import enable_compile_cache

    need = 4 if args.four else 1
    devices = jax.devices()
    check(len(devices) >= need, f"needs {need} GPUs, JAX sees {len(devices)}")
    print(f"[device] devices={devices}", flush=True)
    print(f"[device] nvidia-smi: {_card_line()}", flush=True)
    report(
        "device",
        native_host_lib=native.build() and native.available(),
        compile_cache=enable_compile_cache(),
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        ctx = Ctx(root, FOUR_GPU_OVERRIDES if args.four else ())
        for name in select_phases(args):
            if name == "trace":
                phase_trace(ctx, os.path.abspath(args.trace))
            else:
                PHASES[name](ctx)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
