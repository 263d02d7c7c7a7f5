"""Benchmark harness — MAML meta-training throughput at reference scale.

Headline metric: MAML meta-steps/sec on one GPU, where one meta step is one
full reference meta-epoch workload — 4 tasks x (6 inner epochs x 15 support
batches + 1 query batch) with grad-accum-2 AdamW outer updates — on the
reference architecture (441-node region padded to 512, window 24 ->
horizon 8, GCN hidden 256, LSTM 128x4, 808K params).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

`vs_baseline` compares against the measured PyTorch reference-equivalent
workload on a host CPU (benchmarks/baseline_torch.json; re-measure with
--baseline). MFU divides the cost-analyzed FLOPs of a step by the device's
published peak for the run's dtype (PEAKS below).

Runs only where JAX's backend is a GPU; anywhere else `main` exits
non-zero. `build_bench_inputs` and `flops_per_meta_step` work on any
backend.

  --quick         tiny shapes (smoke test)
  --dtype         bfloat16 (default) or float32
  --second-order  second-order MAML instead of FOMAML
  --all-configs   also time the other workload configs
  --baseline      re-measure the torch baseline and rewrite its JSON
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


BASELINE_PATH = os.path.join(os.path.dirname(__file__), "benchmarks", "baseline_torch.json")


def build_bench_inputs(quick: bool, dtype: str, second_order: bool = False):
    import jax

    from weatherforecast_stgcn_maml_tpu.config import (
        DataConfig,
        MetaConfig,
        ModelConfig,
    )
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        init_meta_state,
        make_jit_meta_step,
    )
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

    if quick:
        model_cfg = ModelConfig(
            hidden_channels=32, gcn_layers=2, lstm_hidden=16, lstm_layers=2,
            window=8, horizon=4, compute_dtype=dtype,
        )
        meta_cfg = MetaConfig(
            meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=3,
            second_order=second_order,
        )
        boxes = [(10.0 + i, 10.75 + i, 20.0, 20.75) for i in range(2)]
        t = 64
    else:
        model_cfg = ModelConfig(compute_dtype=dtype)  # reference scale
        meta_cfg = MetaConfig(second_order=second_order)  # 4 tasks, 6x15 inner, grad-accum 2
        # 5-degree boxes at 0.25 deg -> 21x21 = 441 nodes, like the
        # reference's meta-training regions (BASELINE.md data scale).
        boxes = [(10.0 + 6 * i, 15.0 + 6 * i, 20.0, 25.0) for i in range(4)]
        t = 160  # enough for 15 support + query windows

    regions = [
        synthetic_region_for_box(b, num_timesteps=t, seed=i)
        for i, b in enumerate(boxes)
    ]
    built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
    # Stage the task batch ON DEVICE once, like engines/meta_train.py's
    # device-staged task pool: host (numpy) tasks would re-ship ~140 MB of
    # support/query tensors every timed step.
    import jax.numpy as jnp

    tasks = jax.tree.map(jnp.asarray, stack_tasks([b.task for b in built]))
    jax.block_until_ready(tasks)
    state = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
    step = make_jit_meta_step(model_cfg, meta_cfg)
    return state, step, tasks, built[0].graph, model_cfg, meta_cfg


# Published peaks per device, keyed by `device_kind` (NVIDIA H100 SXM data
# sheet: dense tensor-core rates, no sparsity; device-memory bandwidth).
# A float32 run's matmuls go to the tensor cores as TF32 at JAX's default
# precision, so its MFU is taken against the TF32 peak. A device missing
# here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,
        "float32": 495e12,
        "bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add it to "
            "bench.PEAKS with its source"
        ) from None


def flops_per_meta_step(state, tasks, model_cfg, meta_cfg) -> float:
    """Physically-derived FLOPs of ONE meta step (FO or second-order).

    XLA's `cost_analysis` counts a `lax.scan` body ONCE regardless of trip
    count, so cost analysis of the full meta step undercounts ~100x (the
    round-1 roofline made exactly that mistake). Instead: cost-analyze a
    single inner SGD gradient step, then multiply by the real trip counts —
    meta_batch tasks x (inner_epochs x S support steps + Q query fwd/bwd,
    where a query grad costs about one inner grad).

    Second-order (VERDICT r3 item 2a): the SO meta-gradient additionally
    differentiates THROUGH every inner update. The inner scan's forward
    pass costs one inner update `A` per step; its backward pass costs one
    VJP-of-the-inner-update `B` per step — cost-analyzed directly from
    `jax.vjp(inner_update)`, whose lowering includes the per-step remat
    recompute (so_remat="step" recomputes the update's fwd+bwd inside the
    transpose, exactly what the lowered vjp contains). Total:
    batch x (steps x (A + B) + query grad-of-adapted ~ A).
    """
    import jax

    from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu.models.registry import apply_model
    from weatherforecast_stgcn_maml_tpu.train.optimizers import (
        clip_global_norm_tree,
    )

    task0 = jax.tree.map(lambda x: x[0], tasks)

    def support_loss(p, x, y, rng):
        preds = apply_model(
            p, task0.a_hat, x, task0.koppen, model_cfg, train=True, rng=rng
        )
        return masked_mse(preds, y, task0.node_mask)

    def one_inner_grad(p, rng):
        return jax.grad(support_loss)(
            p, task0.support_x[0], task0.support_y[0], rng
        )

    def _cost(fn, *args) -> float:
        lowered = jax.jit(fn).lower(*args)
        analysis = lowered.cost_analysis() or {}
        return float(analysis.get("flops", 0.0))

    inner_flops = _cost(one_inner_grad, state.params, jax.random.key(0))
    if inner_flops <= 0.0:  # backend without client-side cost analysis
        inner_flops = _analytic_inner_flops(model_cfg, int(task0.a_hat.shape[0]))

    batch = int(tasks.support_x.shape[0])
    s = int(tasks.support_x.shape[1])
    steps = meta_cfg.inner_epochs * s
    q = min(meta_cfg.query_batches, int(tasks.query_x.shape[1]))
    if not meta_cfg.second_order:
        return batch * (steps + q) * inner_flops

    # SO: B = FLOPs of one VJP through the full inner update (grad + clip
    # + SGD step), evaluated the way the scan transpose evaluates it.
    def inner_update(p, rng):
        g = one_inner_grad(p, rng)
        g, _ = clip_global_norm_tree(g, meta_cfg.clip_norm)
        return jax.tree.map(lambda a, b: a - meta_cfg.inner_lr * b, p, g)

    def step_vjp(p, ct, rng):
        _, vjp = jax.vjp(lambda q: inner_update(q, rng), p)
        return vjp(ct)

    ct = jax.tree.map(jax.numpy.zeros_like, state.params)
    vjp_flops = _cost(step_vjp, state.params, ct, jax.random.key(0))
    if vjp_flops <= 0.0:
        # Fallback: an HVP-like transpose costs ~3x the first-order step
        # (recompute fwd+bwd, then transpose both) — standard grad-of-grad
        # cost ratio; used only when cost_analysis is unavailable.
        vjp_flops = 3.0 * inner_flops
    return batch * (steps * (inner_flops + vjp_flops) + q * inner_flops)


def _analytic_inner_flops(cfg, n: int) -> float:
    """Fallback matmul-FLOP estimate of one fwd+bwd inner step (bwd ~ 2x fwd)."""
    w, ch, lh = cfg.window, cfg.hidden_channels, cfg.lstm_hidden
    gcn = 0.0
    c_in = cfg.in_channels
    for _ in range(cfg.gcn_layers):
        gcn += w * (2.0 * n * c_in * ch + 2.0 * n * n * ch)
        c_in = ch
    lstm, inp = 0.0, ch
    for _ in range(cfg.lstm_layers):
        lstm += 2.0 * n * w * 4.0 * lh * (inp + lh)
        inp = lh
    head = 2.0 * n * lh * cfg.num_weather_vars * cfg.horizon
    return 3.0 * (gcn + lstm + head)


def bench_meta(quick: bool, dtype: str, reps: int, second_order: bool = False) -> dict:
    """Warm up, then time `reps` dispatches, each ending in
    block_until_ready. A dispatch runs `chain_k` meta steps in one jitted
    scan, so host dispatch is paid once per chain."""
    import jax

    reps = max(1, reps)

    from weatherforecast_stgcn_maml_tpu.utils.prng import make_key

    state, step, tasks, graph, model_cfg, meta_cfg = build_bench_inputs(
        quick, dtype, second_order
    )
    dev = jax.devices()[0]
    _log(
        f"[bench] devices={jax.devices()} nodes={graph.num_nodes} "
        f"(padded {graph.padded_nodes}) dtype={dtype}"
    )
    step_flops = flops_per_meta_step(state, tasks, model_cfg, meta_cfg)
    peak = device_peaks(dev.device_kind)[dtype]
    floor_s = step_flops / peak
    _log(
        f"[bench] {step_flops:.3e} FLOPs/meta-step -> {floor_s * 1e3:.1f} "
        f"ms/step at the {dtype} peak of {dev.device_kind}"
    )
    bench_key = make_key(1, meta_cfg.rng_impl)

    chain_k = 1 if (quick or second_order) else 8
    if chain_k > 1:
        import jax.numpy as jnp

        @jax.jit
        def chain(state, tasks, key):
            def body(s, k):
                s, m = step(s, tasks, k)
                return s, m["meta_loss"]

            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
                jnp.arange(chain_k)
            )
            state, losses = jax.lax.scan(body, state, keys)
            return state, {"meta_loss": losses[-1]}
    else:
        chain = step

    t0 = time.perf_counter()
    state, metrics = chain(state, tasks, bench_key)
    jax.block_until_ready(metrics)
    compile_s = time.perf_counter() - t0
    _log(f"[bench] first dispatch (compile + run, chain of {chain_k}): {compile_s:.2f}s")
    state, metrics = chain(state, tasks, bench_key)
    jax.block_until_ready(metrics)

    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        state, metrics = chain(state, tasks, jax.random.fold_in(bench_key, 2 + r))
        jax.block_until_ready(metrics)
        times.append((time.perf_counter() - t0) / chain_k)
    times.sort()
    median = times[len(times) // 2]
    _log(
        f"[bench] step: median {median * 1e3:.2f} ms, best {times[0] * 1e3:.2f} "
        f"ms over {reps} reps; MFU {floor_s / median * 100:.1f}%"
    )
    return {
        "meta_steps_per_sec": 1.0 / median,
        "step_seconds_median": median,
        "step_seconds_best": times[0],
        "step_seconds_all": times,
        "compile_seconds": compile_s,
        "meta_loss": float(metrics["meta_loss"]),
        "dtype": dtype,
        "flops_per_step": step_flops,
        "peak_flops": peak,
        "floor_seconds": floor_s,
        "mfu": floor_s / median,
        "chain_length": chain_k,
        "device": _device_info(),
    }


def _device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def bench_workload_configs(dtype: str) -> dict:
    """Measure the remaining BASELINE.json workload configs (1, 2, 3, 5).

    1: single-region forward + MSE eval latency;
    2: single-region supervised fine-tune epoch throughput (adapt path);
    3: single-task MAML inner loop + one meta-update;
    5: dp-sharded meta step over a device mesh (skipped on 1 device).
    Details only — the headline JSON line stays config 4 (full meta step).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from weatherforecast_stgcn_maml_tpu.config import (
        DataConfig,
        MeshConfig,
        MetaConfig,
        ModelConfig,
    )
    from weatherforecast_stgcn_maml_tpu.data.preprocess import pad_nodes, prepare_features
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec
    from weatherforecast_stgcn_maml_tpu.graph import build_region_graph
    from weatherforecast_stgcn_maml_tpu.models.hybrid import init_hybrid
    from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        adapt_and_query_loss,
        init_meta_state,
        make_jit_meta_step,
    )
    from weatherforecast_stgcn_maml_tpu.train.optimizers import adaptation_optimizer
    from weatherforecast_stgcn_maml_tpu.train.supervised import (
        SupervisedState,
        make_epoch_runner,
    )
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks
    from weatherforecast_stgcn_maml_tpu.utils.profiling import block_until_ready

    model_cfg = ModelConfig(compute_dtype=dtype)
    meta_cfg = MetaConfig()
    box = (18.0, 23.0, 75.0, 80.0)  # the India box (config 1's region)
    region = synthetic_region_for_box(box, num_timesteps=160, seed=0)
    graph = build_region_graph(region.lats, region.lons)
    feats_np, _ = prepare_features(region)
    features = jnp.asarray(pad_nodes(feats_np, graph.padded_nodes))
    a_hat = jnp.asarray(graph.a_hat)
    mask = jnp.asarray(graph.node_mask)
    kop = jnp.int32(8)
    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    params = init_hybrid(jax.random.key(0), model_cfg)
    out = {}

    def timeit(fn, reps=10):
        fn()  # warmup/compile
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    # Config 1: forward + MSE eval on one window.
    from weatherforecast_stgcn_maml_tpu.data.windows import gather_batch

    x1, y1 = gather_batch(features, jnp.asarray([spec.window]), spec)

    @jax.jit
    def fwd_eval(params, x, y):
        from weatherforecast_stgcn_maml_tpu.train.supervised import batched_forward

        preds = batched_forward(params, a_hat, x, kop, model_cfg, train=False, rng=None)
        return masked_mse(preds, y, mask)

    # Single-dispatch latency, host dispatch included.
    out["forward_eval_us"] = timeit(
        lambda: block_until_ready(fwd_eval(params, x1, y1))
    ) * 1e6

    # Config 2: one supervised fine-tune epoch (adapt path) at the default
    # batch width (AdaptConfig.batch_size).
    from weatherforecast_stgcn_maml_tpu.config import AdaptConfig

    bsz = AdaptConfig().batch_size
    tx, _ = adaptation_optimizer("Bench")
    run_epoch = make_epoch_runner(model_cfg, tx, spec)
    anchors = spec.window + np.arange(spec.num_samples(region.num_timesteps))
    nb = len(anchors) // bsz
    batches = jnp.asarray(anchors[: nb * bsz].reshape(nb, bsz))
    # run_epoch donates its state: thread one state through the reps (fresh
    # copies of params so the shared `params` tree is never donated away).
    sstate = SupervisedState(
        params=jax.tree.map(jnp.array, params), opt_state=tx.init(params)
    )

    def one_epoch():
        nonlocal sstate
        sstate, losses = run_epoch(
            sstate, features, batches, a_hat,
            mask, kop, jnp.float32(5e-4), jax.random.key(1),
        )
        block_until_ready(losses)

    epoch_s = timeit(one_epoch, reps=5)
    out["adapt_epoch_seconds"] = epoch_s
    out["adapt_samples_per_sec"] = nb * bsz / epoch_s

    # Config 3: single-task inner loop + meta-update.
    built = build_meta_tasks([region], model_cfg, meta_cfg, DataConfig())
    task = jax.tree.map(jnp.asarray, built[0].task)

    inner = jax.jit(
        lambda p, t, r: adapt_and_query_loss(p, t, r, model_cfg, meta_cfg)
    )
    out["single_task_inner_ms"] = timeit(
        lambda: block_until_ready(inner(params, task, jax.random.key(2)))
    ) * 1e3

    # Config 5: dp-sharded meta step (needs >1 device).
    n_dev = len(jax.devices())
    if n_dev > 1:
        from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh
        from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (
            make_parallel_meta_step,
        )

        per = meta_cfg.meta_batch // meta_cfg.grad_accum
        use = min(n_dev, per)
        mesh = make_mesh(MeshConfig(num_devices=use))
        regions = [
            synthetic_region_for_box(
                (10.0 + 6 * i, 15.0 + 6 * i, 20.0, 25.0), num_timesteps=160, seed=i
            )
            for i in range(meta_cfg.meta_batch)
        ]
        built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
        tasks = jax.tree.map(jnp.asarray, stack_tasks([b.task for b in built]))
        state = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
        pstep = make_parallel_meta_step(model_cfg, meta_cfg, mesh, donate_state=False)

        def dp_step():
            _, m = pstep(state, tasks, jax.random.key(3))
            block_until_ready(m)

        out["dp_meta_step_ms"] = timeit(dp_step, reps=5) * 1e3
        out["dp_devices"] = use
    else:
        out["dp_meta_step_ms"] = None
        out["dp_devices"] = 1

    _log(f"[bench] workload configs: {out}")
    return out


def load_or_measure_baseline(remeasure: bool) -> dict:
    if not remeasure and os.path.exists(BASELINE_PATH):
        with open(BASELINE_PATH) as f:
            return json.load(f)
    _log("[bench] measuring torch reference-equivalent baseline on CPU ...")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    from torch_reference_workload import measure

    result = measure()
    with open(BASELINE_PATH, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--baseline", action="store_true", help="re-measure torch baseline")
    ap.add_argument(
        "--all-configs", action="store_true",
        help="also measure the other BASELINE.json workload configs",
    )
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument(
        "--second-order", action="store_true",
        help="benchmark full second-order MAML (grad-of-grad through the "
        "rematerialized inner scan) instead of FOMAML",
    )
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        _log(f"[bench] needs a GPU; JAX's backend is {jax.default_backend()!r}")
        return 2
    from weatherforecast_stgcn_maml_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    baseline = load_or_measure_baseline(args.baseline)
    result = bench_meta(args.quick, args.dtype, args.reps, args.second_order)
    details = {"bench": result, "baseline": baseline}
    if args.all_configs:
        details["workload_configs"] = bench_workload_configs(args.dtype)

    # Quick and second-order runs get their own artifact so a smoke test
    # never overwrites the full-scale record.
    if args.quick:
        artifact = "last_quick_run.json"
    elif args.second_order:
        artifact = "last_so_run.json"
    else:
        artifact = "last_run.json"
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "out")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, artifact)
    with open(out_path, "w") as f:
        json.dump(details, f, indent=2)
    _log(f"[bench] details -> {out_path}")

    value = result["meta_steps_per_sec"]
    if args.quick:
        line = {
            "metric": "maml_meta_steps_per_sec_quick_smoke",
            "value": round(value, 4),
            "unit": "meta-steps/s on tiny smoke-test shapes (NOT comparable to baseline)",
            "vs_baseline": None,
        }
    else:
        unit = (
            f"meta-epochs/s, {result['dtype']} (4 tasks x 90 inner steps, "
            "441-node regions, 808K-param hybrid), median of "
            f"{args.reps} timed dispatches; MFU {result['mfu'] * 100:.1f}% of "
            f"the {result['dtype']} peak; vs_baseline is vs the torch reference "
            "workload measured on a host CPU (benchmarks/baseline_torch.json)"
        )
        if args.second_order:
            unit = "SECOND-ORDER " + unit
        line = {
            "metric": "maml_so_meta_steps_per_sec"
            if args.second_order else "maml_meta_steps_per_sec",
            "value": round(value, 4),
            "unit": unit,
            "vs_baseline": round(value / baseline["meta_steps_per_sec"], 1),
        }
    line["device"] = result["device"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
