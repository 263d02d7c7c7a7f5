"""Time-to-val-MSE study — the second north-star metric (BASELINE.json:2).

BASELINE.json names two benchmark metrics: MAML meta-steps/sec (bench.py's
headline) and "time-to-val-MSE for regional adaptation". This study measures
the latter: starting from random init, how much *training* wall-clock does
each framework need to reach a given validation MSE on the SAME adaptation
workload (same synthetic region, same contiguous 80/20 split, same
z-score-normalized targets, same MSE reduction)?

Per-framework recipe (each system runs its own production path):
  * JAX: the adapt engine's compiled-epoch path (train/supervised.py,
    batch 8, shuffled, climate Adam + ClimateLRSchedule) — this system's
    redesign of adapt_hybrid_v5.py:171-210.
  * torch/CPU: the reference's executed behavior — per-node LSTM loop
    forward (hybrid_model.py:94-102), batch_size=1 (adapt_hybrid_v5.py:182),
    conv base frozen in effect (the no_grad quirk, hybrid_model.py:63;
    SURVEY quirk 2), climate Adam + grad clip 1.0. Budget-limited: the CPU
    step is ~seconds, so the run records how far it gets within
    --torch-budget seconds and the crossing table only compares thresholds
    torch actually reached.

Timing discipline: validation evals are clocked OUT of both sides' training
wall-clock (the metric is time spent training, evaluation cadence is a
measurement artifact). JAX compile time is reported separately and also
rolled into an "incl. compile" variant. Both sides evaluate on the same
fixed subset of validation windows (--val-windows) with dropout off; the
torch eval uses a node-BATCHED forward verified equal to the per-node loop.

Outputs: benchmarks/adapt_ttv.json (+ stderr log). Run on the GPU from the
repo root: python benchmarks/adapt_ttv_study.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SELF_DIR = os.path.dirname(os.path.abspath(__file__))
# Make the package importable when run as `python benchmarks/adapt_ttv_study.py`.
sys.path.insert(0, os.path.dirname(SELF_DIR))

THRESHOLDS = [
    1.0, 0.99, 0.98, 0.97, 0.96, 0.95, 0.93, 0.9, 0.85, 0.8, 0.7, 0.6,
    0.5, 0.45, 0.4, 0.35, 0.3, 0.25, 0.2, 0.15, 0.1, 0.07, 0.05,
]


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_shared_workload(quick: bool):
    """One synthetic region + split shared by both frameworks."""
    from weatherforecast_stgcn_maml_tpu.config import DataConfig, ModelConfig
    from weatherforecast_stgcn_maml_tpu.data.preprocess import prepare_features
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec, contiguous_split
    from weatherforecast_stgcn_maml_tpu.graph import build_region_graph

    if quick:
        model_cfg = ModelConfig(
            hidden_channels=32, gcn_layers=2, lstm_hidden=16, lstm_layers=2,
            window=8, horizon=4, compute_dtype="bfloat16",
        )
        box, t = (10.0, 11.0, 20.0, 21.0), 96
    else:
        model_cfg = ModelConfig(compute_dtype="bfloat16")
        box, t = (18.0, 23.0, 75.0, 80.0), 650  # the India box (config 2)
    region = synthetic_region_for_box(box, num_timesteps=t, seed=0)
    graph = build_region_graph(region.lats, region.lons, k_neighbors=DataConfig().k_neighbors)
    features, stats = prepare_features(region)  # [T, N, 24] z-scored, unpadded
    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    train_idx, val_idx = contiguous_split(spec.num_samples(t), 0.8, 1200)
    return {
        "model_cfg": model_cfg,
        "region": region,
        "graph": graph,
        "features": np.asarray(features, np.float32),
        "spec": spec,
        "train_anchors": spec.window + train_idx,
        "val_anchors": spec.window + val_idx,
    }


def crossings(curve):
    """curve: [(train_seconds, mse)] -> {threshold: first-crossing seconds}."""
    out = {}
    for thr in THRESHOLDS:
        for t, m in curve:
            if m <= thr:
                out[str(thr)] = round(t, 3)
                break
    return out


# ---------------------------------------------------------------- JAX side


def run_jax(shared, max_epochs: int, val_subset: int, seed: int = 42):
    import jax
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu.data.preprocess import pad_nodes
    from weatherforecast_stgcn_maml_tpu.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu.train.optimizers import (
        ClimateLRSchedule,
        adaptation_optimizer,
    )
    from weatherforecast_stgcn_maml_tpu.train.supervised import (
        SupervisedState,
        make_batched_eval,
        make_epoch_runner,
    )

    model_cfg, spec, graph = shared["model_cfg"], shared["spec"], shared["graph"]
    features = jnp.asarray(pad_nodes(shared["features"], graph.padded_nodes))
    a_hat = jnp.asarray(graph.a_hat)
    mask = jnp.asarray(graph.node_mask)
    from weatherforecast_stgcn_maml_tpu.config import AdaptConfig

    koppen = jnp.int32(0)  # quirk 6 compat: reference adapts with code 0
    batch = AdaptConfig().batch_size

    tx, lr0 = adaptation_optimizer("India")
    schedule = ClimateLRSchedule("India", base_lr=lr0)
    run_epoch = make_epoch_runner(model_cfg, tx, spec)
    run_eval = make_batched_eval(model_cfg, spec)

    params = init_model(jax.random.key(seed), model_cfg)
    state = SupervisedState(params=params, opt_state=tx.init(params))
    np_rng = np.random.default_rng(seed)
    val = shared["val_anchors"][:val_subset]
    val_batches = jnp.asarray(
        np.resize(val, (-(-len(val) // batch)) * batch).reshape(-1, batch)
    )
    n_val_pad = val_batches.size - len(val)

    def eval_mse(params):
        per = np.asarray(
            run_eval(params, features, val_batches, a_hat, mask, koppen)
        ).reshape(-1)
        return float(per[: len(per) - n_val_pad].mean()) if n_val_pad else float(per.mean())

    anchors = shared["train_anchors"]
    nb = len(anchors) // batch
    mses = []
    dts = []
    lr = lr0
    for epoch in range(max_epochs):
        batches = jnp.asarray(
            np_rng.permutation(anchors)[: nb * batch].reshape(nb, batch)
        )
        t0 = time.perf_counter()
        state, losses = run_epoch(
            state, features, batches, a_hat, mask, koppen,
            jnp.float32(lr), jax.random.fold_in(jax.random.key(seed + 7), epoch),
        )
        np.asarray(losses)  # forced fetch: contended block_until_ready lies
        dts.append(time.perf_counter() - t0)
        mses.append(eval_mse(state.params))  # eval off the training clock
        _log(f"[jax] epoch {epoch + 1}: dt {dts[-1]:.2f}s mse {mses[-1]:.4f}")
        lr = schedule.step(float(np.asarray(losses).mean()))
    # Epoch 1's wall time is dominated by trace+compile; charge it the
    # median steady epoch time instead and report compile separately.
    steady = float(np.median(dts[1:])) if len(dts) > 1 else dts[0]
    compile_s = max(0.0, dts[0] - steady)
    wall = np.concatenate([[steady], steady + np.cumsum(dts[1:])])
    curve = list(zip(wall.tolist(), mses))
    return {
        "framework": "jax",
        "backend": __import__("jax").default_backend(),
        "batch_size": batch,
        "compile_seconds_estimate": compile_s,
        "steady_epoch_seconds": steady,
        "curve": [(round(t, 3), round(m, 5)) for t, m in curve],
        "crossings_train_seconds": crossings(curve),
        "final_mse": curve[-1][1],
    }


# -------------------------------------------------------------- torch side


def build_torch_model(model_cfg, num_nodes: int):
    import torch
    import torch.nn as nn

    w, hid = model_cfg.window, model_cfg.hidden_channels
    lh, ll = model_cfg.lstm_hidden, model_cfg.lstm_layers
    cout, hor = model_cfg.num_weather_vars, model_cfg.horizon
    # Input = raw features + the 8-dim Köppen embedding of code 0 (quirk 6),
    # a trainable vector exactly like the reference's koppen_embed(0) row.
    kop_dim = model_cfg.koppen_dim
    cin = model_cfg.in_channels

    class RefHybrid(nn.Module):
        """Reference-equivalent hybrid (intended per-timestep graph conv).

        Mirrors benchmarks/torch_reference_workload.py; conv base frozen to
        match the reference's executed no_grad behavior (SURVEY quirk 2).
        """

        def __init__(self):
            super().__init__()
            self.convs = nn.ModuleList(
                [
                    nn.Linear(cin if i == 0 else hid, hid)
                    for i in range(model_cfg.gcn_layers)
                ]
            )
            self.lstm = nn.LSTM(
                hid, lh, num_layers=ll, batch_first=True, dropout=0.2
            )
            self.head = nn.Linear(lh, cout * hor)
            self.drop = nn.Dropout(0.2)
            self.koppen_vec = nn.Parameter(torch.randn(kop_dim) * 0.02)
            for p in self.convs.parameters():
                p.requires_grad_(False)

        def encode(self, x, a_hat):  # x [W, N, C_feat] -> [N, W, hid]
            h = torch.cat(
                [x, self.koppen_vec.expand(x.shape[0], x.shape[1], kop_dim)],
                dim=-1,
            )
            for i, conv in enumerate(self.convs):
                h = conv(h)
                h = torch.einsum("nm,tmc->tnc", a_hat, h)
                h = torch.relu(h)
                if i < len(self.convs) - 1:
                    h = self.drop(h)
            return h.permute(1, 0, 2)

        def forward(self, x, a_hat):  # the reference's per-node loop
            h = self.encode(x, a_hat)
            outs = []
            for node in range(num_nodes):
                seq = h[node : node + 1]
                lstm_out, _ = self.lstm(seq)
                outs.append(lstm_out[0, -1])
            feats = torch.stack(outs)
            pred = self.head(self.drop(feats)).view(num_nodes, hor, cout)
            return pred.permute(1, 0, 2)  # [H, N, 12]

        def forward_batched_eval(self, x, a_hat):
            """Node-batched forward — same function with dropout off."""
            h = self.encode(x, a_hat)
            lstm_out, _ = self.lstm(h)
            pred = self.head(lstm_out[:, -1]).view(num_nodes, hor, cout)
            return pred.permute(1, 0, 2)

    return RefHybrid()


def run_torch(shared, budget_s: float, eval_every: int, val_subset: int, seed: int = 42):
    import torch
    import torch.nn as nn

    from weatherforecast_stgcn_maml_tpu.train.optimizers import (
        CLIMATE_LR_MULT,
        CLIMATE_WEIGHT_DECAY,
        climate_zone,
    )

    torch.manual_seed(seed)
    model_cfg, spec = shared["model_cfg"], shared["spec"]
    n = shared["graph"].num_nodes
    feats = torch.from_numpy(shared["features"])  # [T, N, 24] unpadded
    # Padding rows/cols of the padded a_hat are all-zero, so the unpadded
    # normalized adjacency is exactly the leading [N, N] block.
    a_hat = torch.from_numpy(np.asarray(shared["graph"].a_hat[:n, :n], np.float32))
    model = build_torch_model(model_cfg, n)
    zone = climate_zone("India")
    opt = torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad],
        lr=6e-4 * CLIMATE_LR_MULT[zone],
        weight_decay=CLIMATE_WEIGHT_DECAY[zone],
    )
    criterion = nn.MSELoss()

    def sample(anchor):
        x = feats[anchor - spec.window : anchor].reshape(-1, feats.shape[-1])
        y = feats[anchor + 1 : anchor + 1 + spec.horizon, :, : model_cfg.num_weather_vars]
        return x.view(spec.window, n, -1), y

    # Verify the batched eval forward against the reference per-node loop.
    model.eval()
    with torch.no_grad():
        x0, _ = sample(int(shared["val_anchors"][0]))
        diff = float((model(x0, a_hat) - model.forward_batched_eval(x0, a_hat)).abs().max())
    assert diff < 1e-4, f"batched eval diverges from per-node loop: {diff}"

    val = shared["val_anchors"][:val_subset]

    def eval_mse():
        model.eval()
        with torch.no_grad():
            tot = 0.0
            for a in val:
                x, y = sample(int(a))
                tot += float(criterion(model.forward_batched_eval(x, a_hat), y))
        model.train()
        return tot / len(val)

    np_rng = np.random.default_rng(seed)
    order = np_rng.permutation(shared["train_anchors"])
    curve = [(0.0, eval_mse())]
    _log(f"[torch] init mse {curve[0][1]:.4f}")
    train_wall, steps = 0.0, 0
    model.train()
    while train_wall < budget_s:
        a = int(order[steps % len(order)])
        x, y = sample(a)
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = criterion(model(x, a_hat), y)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(
            [p for p in model.parameters() if p.requires_grad], 1.0
        )
        opt.step()
        train_wall += time.perf_counter() - t0
        steps += 1
        if steps % eval_every == 0:
            mse = eval_mse()  # clocked out of train_wall
            curve.append((train_wall, mse))
            _log(
                f"[torch] step {steps}: train_wall {train_wall:.1f}s mse {mse:.4f}"
            )
    if steps % eval_every:
        curve.append((train_wall, eval_mse()))
    return {
        "framework": "torch-cpu",
        "batch_size": 1,
        "steps": steps,
        "seconds_per_step": train_wall / max(1, steps),
        "budget_seconds": budget_s,
        "curve": [(round(t, 3), round(m, 5)) for t, m in curve],
        "crossings_train_seconds": crossings(curve),
        "final_mse": curve[-1][1],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--torch-budget", type=float, default=1200.0)
    ap.add_argument("--eval-every", type=int, default=40)
    ap.add_argument("--val-windows", type=int, default=24)
    ap.add_argument("--max-epochs", type=int, default=40)
    ap.add_argument("--skip-torch", action="store_true")
    ap.add_argument("--skip-jax", action="store_true")
    ap.add_argument("--out", default=os.path.join(SELF_DIR, "adapt_ttv.json"))
    args = ap.parse_args(argv)
    if args.quick:
        args.torch_budget = min(args.torch_budget, 30.0)
        args.eval_every, args.max_epochs = 5, 5

    shared = build_shared_workload(args.quick)
    _log(
        f"[ttv] region nodes={shared['graph'].num_nodes} "
        f"train={len(shared['train_anchors'])} val={len(shared['val_anchors'])} "
        f"(scoring first {args.val_windows})"
    )
    result = {
        "workload": {
            "nodes": int(shared["graph"].num_nodes),
            "train_windows": int(len(shared["train_anchors"])),
            "val_windows_scored": int(args.val_windows),
            "window": shared["spec"].window,
            "horizon": shared["spec"].horizon,
        },
        "thresholds": THRESHOLDS,
    }
    # A skipped arm reuses the previous run's result (lets a polluted arm be
    # re-measured alone in a quiet window and merged).
    if os.path.exists(args.out) and (args.skip_torch or args.skip_jax):
        with open(args.out) as f:
            prior = json.load(f)
        for arm in ("torch", "jax"):
            if arm in prior:
                result[arm] = prior[arm]
    if not args.skip_torch:
        result["torch"] = run_torch(
            shared, args.torch_budget, args.eval_every, args.val_windows
        )
    if not args.skip_jax:
        result["jax"] = run_jax(shared, args.max_epochs, args.val_windows)
    if "torch" in result and "jax" in result:
        # Exact speedups where both crossed; budget-limited LOWER BOUNDS for
        # thresholds the torch run never reached within its budget.
        speedups, bounds = {}, {}
        t_budget = result["torch"]["curve"][-1][0]
        for thr in map(str, THRESHOLDS):
            t_jax = result["jax"]["crossings_train_seconds"].get(thr)
            if t_jax is None or t_jax <= 0:
                continue
            t_torch = result["torch"]["crossings_train_seconds"].get(thr)
            if t_torch == 0.0:
                continue  # init already below threshold — no race to time
            if t_torch is not None:
                speedups[thr] = round(t_torch / t_jax, 1)
            else:
                bounds[thr] = round(t_budget / t_jax, 1)
        result["speedup_at_threshold"] = speedups
        result["speedup_lower_bound_at_threshold"] = bounds
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    _log(f"[ttv] wrote {args.out}")
    print(json.dumps({k: result[k] for k in result if k != "thresholds"})[:2000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
