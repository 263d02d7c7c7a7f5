"""MAML engine: meta step mechanics, gradient correctness, learning signal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.config import DataConfig, MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu.train.maml import (
    adapt_and_query_loss,
    init_meta_state,
    make_jit_meta_step,
)
from weatherforecast_stgcn_maml_tpu.train.optimizers import cosine_warm_restarts
from weatherforecast_stgcn_maml_tpu.train.sampling import DifficultySampler
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

MODEL_CFG = ModelConfig(
    hidden_channels=8,
    gcn_layers=2,
    lstm_hidden=8,
    lstm_layers=1,
    window=6,
    horizon=2,
    koppen_dim=4,
    gcn_dropout=0.0,
    lstm_dropout=0.0,
)
META_CFG = MetaConfig(
    meta_batch=2,
    grad_accum=1,
    inner_epochs=1,
    inner_batches=3,
    query_batches=1,
    query_train_mode=False,
)
DATA_CFG = DataConfig()


def _tasks(n=2, t=40):
    regions = [
        synthetic_region_for_box(
            (10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=t, seed=i
        )
        for i in range(n)
    ]
    return build_meta_tasks(regions, MODEL_CFG, META_CFG, DATA_CFG)


def test_task_shapes():
    built = _tasks()
    task = built[0].task
    s, w, n, c = task.support_x.shape
    assert (s, w, c) == (META_CFG.inner_batches, 6, 16)
    assert n % 8 == 0 and n >= built[0].graph.num_nodes
    assert task.support_y.shape == (s, 2, n, 12)
    assert task.a_hat.shape == (n, n)


def test_meta_step_runs_and_learns():
    built = _tasks()
    tasks = stack_tasks([b.task for b in built])
    state = init_meta_state(jax.random.key(0), MODEL_CFG, META_CFG)
    step = make_jit_meta_step(MODEL_CFG, META_CFG)
    losses = []
    for e in range(6):
        state, metrics = step(state, tasks, jax.random.key(e))
        losses.append(float(metrics["meta_loss"]))
        assert metrics["per_task_loss"].shape == (2,)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 6 * META_CFG.grad_accum


def test_params_change_after_meta_step():
    built = _tasks()
    tasks = stack_tasks([b.task for b in built])
    state = init_meta_state(jax.random.key(0), MODEL_CFG, META_CFG)
    step = make_jit_meta_step(MODEL_CFG, META_CFG)
    before = jax.tree.map(np.asarray, state.params)
    state, _ = step(state, tasks, jax.random.key(0))
    changed = jax.tree.map(
        lambda a, b: not np.allclose(a, np.asarray(b)), before, state.params
    )
    # Every major component receives meta-gradient (including the Koppen
    # embedding, which the reference never trains — SURVEY quirk).
    assert changed["koppen"]
    assert any(jax.tree.leaves(changed["encoder"]))
    assert any(jax.tree.leaves(changed["lstm"]))
    assert any(jax.tree.leaves(changed["head"]))


def test_second_order_meta_gradient_matches_finite_difference():
    """FD check of d(query_loss)/d(theta) through the unrolled inner SGD
    (SURVEY.md section 4 test plan item (c)). Runs in float64 so central
    differences are trustworthy."""
    cfg = dataclasses.replace(META_CFG, second_order=True, inner_epochs=1)
    model_cfg = dataclasses.replace(MODEL_CFG, compute_dtype="float64")
    with jax.enable_x64(True):
        built = _tasks(n=1)
        task = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64)
            if np.asarray(x).dtype == np.float32
            else jnp.asarray(x),
            built[0].task,
        )
        params = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64)
            if np.asarray(x).dtype == np.float32
            else x,
            init_meta_state(jax.random.key(1), model_cfg, cfg).params,
        )
        rng = jax.random.key(2)

        def loss_fn(p):
            return adapt_and_query_loss(p, task, rng, model_cfg, cfg)

        grads = jax.grad(loss_fn)(params)
        flat_p, treedef = jax.tree.flatten(params)
        flat_g = jax.tree.leaves(grads)
        rng_np = np.random.default_rng(0)
        # Probe one random coordinate in several leaves spread over the tree.
        for leaf_i in [0, len(flat_p) // 2, len(flat_p) - 1]:
            leaf = flat_p[leaf_i]
            idx = np.unravel_index(rng_np.integers(leaf.size), leaf.shape)
            eps = 1e-5

            def perturbed(delta):
                flat2 = list(flat_p)
                flat2[leaf_i] = leaf.at[idx].add(delta)
                return jax.tree.unflatten(treedef, flat2)

            fd = (
                float(loss_fn(perturbed(+eps))) - float(loss_fn(perturbed(-eps)))
            ) / (2 * eps)
            an = float(flat_g[leaf_i][idx])
            assert np.isclose(fd, an, rtol=2e-2, atol=1e-7), (leaf_i, fd, an)


def test_so_impl_routes_agree():
    """so_impl="hvp"/"rof" (explicit symmetric-Hessian transposes,
    train/so_grad.py) must match the default linearize-and-transpose
    meta-gradient exactly. float64 so every route traces identical math
    (fused kernels are off for f64/CPU regardless of impl)."""
    model_cfg = dataclasses.replace(MODEL_CFG, compute_dtype="float64")
    with jax.enable_x64(True):
        built = _tasks(n=1)

        def f64(x):
            a = np.asarray(x)
            return jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)

        task = jax.tree.map(f64, built[0].task)
        cfg0 = dataclasses.replace(META_CFG, second_order=True, inner_epochs=2)
        params = jax.tree.map(
            f64, init_meta_state(jax.random.key(1), model_cfg, cfg0).params
        )
        rng = jax.random.key(2)
        grads = {}
        for impl in ("xla", "hvp", "rof"):
            cfg = dataclasses.replace(cfg0, so_impl=impl)
            grads[impl] = jax.grad(
                lambda p: adapt_and_query_loss(p, task, rng, model_cfg, cfg)
            )(params)
        for impl in ("hvp", "rof"):
            jax.tree.map(
                lambda a, b: np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-14
                ),
                grads["xla"],
                grads[impl],
            )


def test_so_impl_vmapped_meta_step_agrees():
    """The custom_vjp SO routes must survive the meta step's task-vmap
    (task data flows through the op as explicit args — closed-over batch
    tracers broke exactly here) and produce the same meta update."""
    built = _tasks(n=2)
    from weatherforecast_stgcn_maml_tpu.train.tasks import stack_tasks

    tasks = jax.tree.map(jnp.asarray, stack_tasks([b.task for b in built]))
    out = {}
    for impl in ("xla", "hvp"):
        cfg = dataclasses.replace(
            META_CFG, second_order=True, so_impl=impl, grad_accum=1
        )
        state = init_meta_state(jax.random.key(1), MODEL_CFG, cfg)
        step = make_jit_meta_step(MODEL_CFG, cfg)
        state, m = step(state, tasks, jax.random.key(4))
        out[impl] = (state.params, float(m["meta_loss"]))
    assert np.isclose(out["xla"][1], out["hvp"][1], rtol=1e-6)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-5, atol=1e-7
        ),
        out["xla"][0],
        out["hvp"][0],
    )


def test_so_impl_unknown_raises():
    from weatherforecast_stgcn_maml_tpu.train.so_grad import make_so_grad

    with pytest.raises(ValueError, match="so_impl"):
        make_so_grad(lambda p, i, r: 0.0, lambda p, i, r: 0.0, "hpv")


def test_first_order_vs_second_order_differ_but_correlate():
    built = _tasks(n=1)
    task = jax.tree.map(jnp.asarray, built[0].task)
    rng = jax.random.key(0)
    params = init_meta_state(jax.random.key(1), MODEL_CFG, META_CFG).params

    def grad_for(second_order):
        cfg = dataclasses.replace(META_CFG, second_order=second_order)
        return jax.grad(
            lambda p: adapt_and_query_loss(p, task, rng, MODEL_CFG, cfg)
        )(params)

    g_fo = grad_for(False)
    g_so = grad_for(True)
    v_fo = jnp.concatenate([l.ravel() for l in jax.tree.leaves(g_fo)])
    v_so = jnp.concatenate([l.ravel() for l in jax.tree.leaves(g_so)])
    assert float(jnp.linalg.norm(v_fo)) > 0
    assert float(jnp.linalg.norm(v_so)) > 0
    cos = float(
        jnp.dot(v_fo, v_so) / (jnp.linalg.norm(v_fo) * jnp.linalg.norm(v_so))
    )
    # Same task, short horizon: directions should correlate but not be equal.
    assert cos > 0.5, cos
    assert not np.allclose(np.asarray(v_fo), np.asarray(v_so))


def test_cosine_warm_restarts_schedule():
    sched = cosine_warm_restarts(1.0, t0=10, t_mult=2, eta_min=0.0)
    # Epoch 0: full lr. Epoch 10: restart -> full lr again. Epoch 5: min-ish.
    assert np.isclose(float(sched(0)), 1.0)
    assert np.isclose(float(sched(10)), 1.0)
    assert float(sched(5)) == pytest.approx(0.5, abs=1e-6)
    # Second cycle spans epochs 10..30: epoch 20 is its midpoint.
    assert float(sched(20)) == pytest.approx(0.5, abs=1e-6)
    # Monotone decrease within a cycle.
    vals = [float(sched(e)) for e in range(10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_difficulty_sampler_prefers_harder_tasks():
    s = DifficultySampler(num_tasks=4, batch_size=2, ema=0.5, seed=0)
    # Uniform before any updates.
    first = s.sample()
    assert len(set(first.tolist())) == 2
    s.update([0, 1, 2, 3], [10.0, 0.1, 0.1, 0.1])
    counts = np.zeros(4)
    for _ in range(300):
        for i in s.sample():
            counts[i] += 1
    assert counts[0] == max(counts)
    # EMA update moves difficulty toward new loss.
    s.update([0], [0.0])
    assert s.difficulty[0] == pytest.approx(5.0)


def test_grad_accum_equals_two_updates():
    """grad_accum=2 on 4 tasks must perform two sequential optimizer updates
    (reference semantics: AdamW step every 2 tasks)."""
    built = _tasks(n=4, t=40)
    tasks = stack_tasks([b.task for b in built])
    cfg = dataclasses.replace(META_CFG, meta_batch=4, grad_accum=2)
    state = init_meta_state(jax.random.key(0), MODEL_CFG, cfg)
    step = make_jit_meta_step(MODEL_CFG, cfg)
    state, metrics = step(state, tasks, jax.random.key(0))
    assert int(state.step) == 2
    assert metrics["per_task_loss"].shape == (4,)


def test_so_remat_unknown_policy_raises():
    """meta.so_remat typos must fail at trace time, not silently fall back
    to the default policy (config.py documents step|dots|none)."""
    import pytest

    cfg = MetaConfig(
        meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=3,
        query_batches=1, second_order=True, so_remat="dot",  # typo
    )
    built = _tasks()
    tasks = jax.tree.map(np.asarray, stack_tasks([b.task for b in built]))
    step = make_jit_meta_step(MODEL_CFG, cfg)
    with pytest.raises(ValueError, match="so_remat"):
        step(
            init_meta_state(jax.random.key(0), MODEL_CFG, cfg),
            tasks, jax.random.key(1),
        )

    # The valid policies all trace and agree on the meta loss AND the
    # post-update params (i.e. the SO meta-GRADIENT) — remat must be a
    # pure recompute schedule, never a numerics change. "sqrt"/"chunk:<k>"
    # are the two-level Griewank schedules (chunk:2 exercises the
    # nearest-divisor fallback at total_steps=3).
    losses, first_leaves = [], []
    for pol in ("step", "dots", "none", "sqrt", "chunk:2", "chunk:3"):
        c = MetaConfig(
            meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=3,
            query_batches=1, query_train_mode=False,
            second_order=True, so_remat=pol,
        )
        s2 = make_jit_meta_step(MODEL_CFG, c)
        st, m = s2(init_meta_state(jax.random.key(0), MODEL_CFG, c), tasks, jax.random.key(1))
        losses.append(float(m["meta_loss"]))
        first_leaves.append(np.asarray(jax.tree.leaves(st.params)[0]))
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)
    for leaf in first_leaves[1:]:
        np.testing.assert_allclose(leaf, first_leaves[0], rtol=1e-4, atol=1e-6)


def test_meta_step_accepts_legacy_prngkey():
    """The public step API must work with legacy uint32 PRNGKeys too (the
    most common external idiom), not only typed keys."""
    built = _tasks()
    tasks = jax.tree.map(np.asarray, stack_tasks([b.task for b in built]))
    step = make_jit_meta_step(MODEL_CFG, META_CFG)
    state = init_meta_state(jax.random.key(0), MODEL_CFG, META_CFG)
    _, metrics = step(state, tasks, jax.random.PRNGKey(7))
    assert np.isfinite(float(metrics["meta_loss"]))


def test_query_batches_zero_does_not_crash():
    """meta.query_batches=0 must not crash at trace time: the task builder
    always ships >= 1 query batch (tasks.py max(1, .)), and the query-loss
    evaluation floors its batch count to match (round-3 review finding)."""
    cfg0 = dataclasses.replace(META_CFG, query_batches=0)
    regions = [
        synthetic_region_for_box(
            (10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=40, seed=i
        )
        for i in range(2)
    ]
    built = build_meta_tasks(regions, MODEL_CFG, cfg0, DATA_CFG)
    tasks = stack_tasks([b.task for b in built])
    state = init_meta_state(jax.random.key(0), MODEL_CFG, cfg0)
    step = make_jit_meta_step(MODEL_CFG, cfg0)
    state, metrics = step(state, tasks, jax.random.key(0))
    assert np.isfinite(float(metrics["meta_loss"]))


def test_sampler_survives_zero_difficulties():
    """Zero query losses on most tasks must not crash Generator.choice
    (replace=False needs >= batch_size positive-probability entries;
    round-3 review finding)."""
    from weatherforecast_stgcn_maml_tpu.train.sampling import DifficultySampler

    s = DifficultySampler(5, 4, seed=0)
    s.update(np.arange(5), np.array([1.0, 0.0, 0.0, 0.0, 0.0]))
    for _ in range(3):
        idx = s.sample()
        assert len(idx) == 4 and len(set(idx.tolist())) == 4


def test_chained_meta_step_matches_sequential():
    """k fused epochs in one dispatch must be BIT-identical to k sequential
    single-dispatch epochs fed the same task indices (the chained path
    derives each epoch's key with the same fold_in(base_key, epoch))."""
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        make_jit_chained_meta_step,
    )
    from weatherforecast_stgcn_maml_tpu.train.tasks import select_tasks

    built = _tasks(n=3)
    pool = stack_tasks([b.task for b in built])
    base_key = jax.random.key(7)
    idx_k = np.array([[0, 2], [2, 1], [1, 0]], np.int32)

    seq = init_meta_state(jax.random.key(0), MODEL_CFG, META_CFG)
    step = make_jit_meta_step(MODEL_CFG, META_CFG)
    seq_losses = []
    for e in range(3):
        seq, m = step(
            seq, select_tasks(pool, idx_k[e]), jax.random.fold_in(base_key, e)
        )
        seq_losses.append(np.asarray(m["per_task_loss"]))

    ch = init_meta_state(jax.random.key(0), MODEL_CFG, META_CFG)
    chained = make_jit_chained_meta_step(MODEL_CFG, META_CFG)
    ch, mk = chained(ch, pool, idx_k, base_key, np.arange(3, dtype=np.int32))

    assert mk["per_task_loss"].shape == (3, 2)
    np.testing.assert_array_equal(
        np.stack(seq_losses), np.asarray(mk["per_task_loss"])
    )
    for a, b in zip(jax.tree.leaves(seq.params), jax.tree.leaves(ch.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(ch.step) == int(seq.step)
