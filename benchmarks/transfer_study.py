"""Cross-region (held-out-box) MAML transfer study — ROADMAP #2.

Round-1 result (benchmarks/maml_efficacy.md): on the shared-physics
synthetic field, the meta-init transfers NEGATIVELY to held-out boxes
(post-adaptation 1.9-2.0 vs 0.9 from a random init) — the 835K-param model
memorizes its 15 training boxes' phase textures instead of learning the
box-invariant advection operator that the task family admits.

This study tests the two box-invariance hypotheses from the roadmap, at
full reference scale, each arm meta-trained identically and evaluated
few-shot (90 inner SGD steps on 15 support windows) on held-out boxes
against a random init:

  base      — round-1 setup (absolute features), re-measured as control
  relcoord  — +2 within-box relative-coordinate channels
              (`model.relative_coords`): position-in-box awareness with no
              absolute-location shortcut
  timediv   — temporal task diversity: each meta-train task's history
              starts at a different (deterministic) hour offset inside the
              shared field, so tasks stop sharing one global phase-time
              alignment the init could co-memorize
  both      — relcoord + timediv

Writes benchmarks/transfer_study.json; the md summary is written by hand
from it.

Usage: python benchmarks/transfer_study.py [--epochs 40] [--arms base,...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

SHARED_SEED = 777  # one coherent global wave field for every box
HELD_OUT_BOXES = [
    # Disjoint from config.META_TRAIN_REGIONS.
    (-40.0, -35.0, 20.0, 25.0),
    (5.0, 10.0, -30.0, -25.0),
    (57.0, 62.0, 80.0, 85.0),
]
NUM_TIMESTEPS = 160


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_regions(boxes, *, offsets=None):
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box

    offsets = offsets or [0] * len(boxes)
    return [
        synthetic_region_for_box(
            tuple(b), num_timesteps=NUM_TIMESTEPS, seed=SHARED_SEED, hour_offset=off
        )
        for b, off in zip(boxes, offsets)
    ]


def meta_train(model_cfg, meta_cfg, regions, epochs):
    from weatherforecast_stgcn_maml_tpu.config import DataConfig
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        init_meta_state,
        make_jit_meta_step,
    )
    from weatherforecast_stgcn_maml_tpu.train.sampling import DifficultySampler
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

    built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
    all_tasks = [jax.tree.map(jnp.asarray, b.task) for b in built]
    state = init_meta_state(jax.random.key(meta_cfg.seed), model_cfg, meta_cfg)
    step = make_jit_meta_step(model_cfg, meta_cfg)
    sampler = DifficultySampler(len(all_tasks), meta_cfg.meta_batch, seed=0)
    best = float("inf")
    t0 = time.time()
    for epoch in range(epochs):
        idx = sampler.sample()
        tasks = stack_tasks([all_tasks[i] for i in idx])
        state, metrics = step(state, tasks, jax.random.key(1000 + epoch))
        loss = float(np.asarray(metrics["meta_loss"]))
        sampler.update(idx, np.asarray(metrics["per_task_loss"]))
        best = min(best, loss)
        if epoch % 10 == 0 or epoch == epochs - 1:
            _log(f"  epoch {epoch}: meta_loss {loss:.4f} ({time.time() - t0:.0f}s)")
    return state.params, best


def few_shot_eval(params_list, model_cfg, meta_cfg, eval_regions):
    """Post- and pre-adaptation query loss per init, averaged over regions.

    Dropout off for evaluation (query_train_mode=False) so comparisons are
    deterministic given the rng.
    """
    from weatherforecast_stgcn_maml_tpu.config import DataConfig
    from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu.models.registry import apply_model
    from weatherforecast_stgcn_maml_tpu.train.maml import adapt_and_query_loss
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks

    eval_cfg = dataclasses.replace(meta_cfg, query_train_mode=False)
    built = build_meta_tasks(eval_regions, model_cfg, eval_cfg, DataConfig())
    adapt = jax.jit(
        lambda p, t, r: adapt_and_query_loss(p, t, r, model_cfg, eval_cfg)
    )

    @jax.jit
    def pre_loss(p, t):
        preds = apply_model(
            p, t.a_hat, t.query_x[0], t.koppen, model_cfg, train=False
        )
        return masked_mse(preds, t.query_y[0], t.node_mask)

    out = {}
    for name, params in params_list.items():
        posts, pres = [], []
        for i, b in enumerate(built):
            task = jax.tree.map(jnp.asarray, b.task)
            posts.append(float(np.asarray(adapt(params, task, jax.random.key(i)))))
            pres.append(float(np.asarray(pre_loss(params, task))))
        out[name] = {
            "post_adapt_query_loss": float(np.mean(posts)),
            "pre_adapt_query_loss": float(np.mean(pres)),
            "per_region_post": posts,
        }
        _log(
            f"  {name}: post {np.mean(posts):.4f} pre {np.mean(pres):.4f} "
            f"(per-region {['%.3f' % p for p in posts]})"
        )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--arms", default="base,relcoord,timediv,both")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--small", action="store_true", help="CPU smoke-test scale")
    args = ap.parse_args(argv)

    from weatherforecast_stgcn_maml_tpu.config import (
        META_TRAIN_REGIONS,
        MetaConfig,
        ModelConfig,
    )
    from weatherforecast_stgcn_maml_tpu.models.registry import init_model

    meta_cfg = MetaConfig()
    model_kw = {}
    if args.small:
        global NUM_TIMESTEPS
        NUM_TIMESTEPS = 48
        model_kw = dict(
            hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2,
            window=6, horizon=3,
        )
        meta_cfg = MetaConfig(
            meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=3
        )
    # Deterministic spread of history start times over one year (hours).
    offset_rng = np.random.default_rng(5)
    offsets = offset_rng.integers(0, 24 * 365, size=len(META_TRAIN_REGIONS)).tolist()

    results = {
        "epochs": args.epochs,
        "shared_seed": SHARED_SEED,
        "held_out_boxes": HELD_OUT_BOXES,
        "timediv_offsets": offsets,
        "arms": {},
    }
    for arm in args.arms.split(","):
        rel = arm in ("relcoord", "both")
        tdiv = arm in ("timediv", "both")
        model_cfg = ModelConfig(
            compute_dtype=args.dtype, relative_coords=rel, **model_kw
        )
        _log(f"[arm {arm}] relative_coords={rel} time_diversity={tdiv}")

        train_regions = build_regions(
            META_TRAIN_REGIONS, offsets=offsets if tdiv else None
        )
        meta_params, best = meta_train(model_cfg, meta_cfg, train_regions, args.epochs)
        rand_params = init_model(jax.random.key(123), model_cfg)

        # Held-out boxes, plus a second temporal segment of each for robustness.
        eval_regions = build_regions(HELD_OUT_BOXES) + build_regions(
            HELD_OUT_BOXES, offsets=[4000, 5000, 6000]
        )
        evals = few_shot_eval(
            {"meta": meta_params, "random": rand_params},
            model_cfg, meta_cfg, eval_regions,
        )
        # In-distribution sanity: future windows of two TRAINING boxes.
        indist = build_regions(
            META_TRAIN_REGIONS[:2],
            offsets=[
                (offsets[i] if tdiv else 0) + NUM_TIMESTEPS for i in range(2)
            ],
        )
        evals_in = few_shot_eval(
            {"meta": meta_params, "random": rand_params},
            model_cfg, meta_cfg, indist,
        )
        results["arms"][arm] = {
            "meta_best_loss": best,
            "held_out": evals,
            "in_distribution": evals_in,
        }
        path = os.path.join(os.path.dirname(__file__), "transfer_study.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=2)
        _log(f"[arm {arm}] done, results written")
    print(json.dumps(results["arms"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
