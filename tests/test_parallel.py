"""Parallel layer: mesh construction, dp-sharded meta step on 8 fake devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.config import (
    DataConfig,
    MeshConfig,
    MetaConfig,
    ModelConfig,
)
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
    make_mesh,
    shard_task_batch,
    task_batch_sharding,
)
from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import make_parallel_meta_step
from weatherforecast_stgcn_maml_tpu.train.maml import (
    init_meta_state,
    make_jit_meta_step,
)
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


def _build(meta_cfg):
    regions = [
        synthetic_region_for_box(
            (10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=32, seed=i
        )
        for i in range(meta_cfg.meta_batch)
    ]
    built = build_meta_tasks(regions, MODEL_CFG, meta_cfg, DataConfig())
    return stack_tasks([b.task for b in built])


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8


def test_make_mesh():
    mesh = make_mesh(MeshConfig())
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("dp",)
    small = make_mesh(MeshConfig(num_devices=4))
    assert small.devices.size == 4
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(num_devices=64))


def test_resolve_sp_impl():
    """MeshConfig.sp_impl="auto" routes hybrid to the kernel-preserving
    shardmap 2-D step and every other family to GSPMD; explicit choices
    pass through untouched (parallel/mesh.resolve_sp_impl)."""
    import dataclasses

    from weatherforecast_stgcn_maml_tpu.parallel.mesh import resolve_sp_impl

    assert MeshConfig().sp_impl == "auto"
    hybrid = MODEL_CFG
    assert getattr(hybrid, "family", "hybrid") == "hybrid"
    assert resolve_sp_impl("auto", hybrid) == "shardmap"
    stgcn = dataclasses.replace(hybrid, family="stgcn")
    assert resolve_sp_impl("auto", stgcn) == "gspmd"
    for explicit in ("gspmd", "shardmap"):
        assert resolve_sp_impl(explicit, hybrid) == explicit
        assert resolve_sp_impl(explicit, stgcn) == explicit


def test_parallel_meta_step_matches_single_device():
    """dp-sharded meta step must be numerically equivalent to the
    single-device step (same tasks, same rng)."""
    meta_cfg = MetaConfig(
        meta_batch=8,
        grad_accum=2,
        inner_epochs=1,
        inner_batches=2,
        query_train_mode=False,
    )
    tasks = _build(meta_cfg)
    mesh = make_mesh(MeshConfig(num_devices=4))

    state0 = init_meta_state(jax.random.key(0), MODEL_CFG, meta_cfg)
    single = make_jit_meta_step(MODEL_CFG, meta_cfg)
    s1, m1 = single(state0, jax.tree.map(jnp.asarray, tasks), jax.random.key(7))

    state0b = init_meta_state(jax.random.key(0), MODEL_CFG, meta_cfg)
    par = make_parallel_meta_step(
        MODEL_CFG, meta_cfg, mesh, donate_state=False
    )
    sharded = shard_task_batch(jax.tree.map(jnp.asarray, tasks), mesh)
    s2, m2 = par(state0b, sharded, jax.random.key(7))

    np.testing.assert_allclose(
        np.asarray(m1["per_task_loss"]),
        np.asarray(m2["per_task_loss"]),
        rtol=1e-4,
        atol=1e-5,
    )
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_parallel_meta_step_rejects_uneven_shard():
    meta_cfg = MetaConfig(meta_batch=6, grad_accum=2, inner_epochs=1, inner_batches=2)
    mesh = make_mesh(MeshConfig(num_devices=4))
    with pytest.raises(ValueError):
        make_parallel_meta_step(MODEL_CFG, meta_cfg, mesh)


def test_task_batch_actually_sharded():
    meta_cfg = MetaConfig(meta_batch=8, grad_accum=1, inner_epochs=1, inner_batches=2)
    tasks = _build(meta_cfg)
    mesh = make_mesh(MeshConfig())
    sharded = shard_task_batch(jax.tree.map(jnp.asarray, tasks), mesh)
    sh = sharded.support_x.sharding
    assert sh == task_batch_sharding(mesh)
    # Each device holds 1/8 of the task axis.
    shard_shapes = {s.data.shape for s in sharded.support_x.addressable_shards}
    assert shard_shapes == {(1, *tasks.support_x.shape[1:])}


def test_graft_entry_dryrun():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (8, 512, 12)
    ge.dryrun_multichip(8)


def test_meta_2d_matches_single_device():
    """dp x sp (2x2) meta step — node axis sharded through the whole inner
    loop by GSPMD — must match the single-device step numerically."""
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (
        make_parallel_meta_step_2d,
    )

    meta_cfg = MetaConfig(
        meta_batch=4,
        grad_accum=2,
        inner_epochs=1,
        inner_batches=2,
        query_train_mode=False,
    )
    tasks = _build(meta_cfg)
    assert tasks.a_hat.shape[-1] % 2 == 0  # node padding divides sp=2

    state0 = init_meta_state(jax.random.key(0), MODEL_CFG, meta_cfg)
    single = make_jit_meta_step(MODEL_CFG, meta_cfg)
    s1, m1 = single(state0, jax.tree.map(jnp.asarray, tasks), jax.random.key(7))

    mesh = make_mesh_2d(2, 2)
    state0b = init_meta_state(jax.random.key(0), MODEL_CFG, meta_cfg)
    par = make_parallel_meta_step_2d(
        MODEL_CFG, meta_cfg, mesh, donate_state=False
    )
    sharded = shard_task_batch_2d(jax.tree.map(jnp.asarray, tasks), mesh)
    # The input layout really is 2-D sharded: each device holds a
    # [B/2, ..., N/2, ...] block of the support set.
    shard_shapes = {s.data.shape for s in sharded.support_x.addressable_shards}
    b, s_, w, n, c = tasks.support_x.shape
    assert shard_shapes == {(b // 2, s_, w, n // 2, c)}
    s2, m2 = par(state0b, sharded, jax.random.key(7))

    np.testing.assert_allclose(
        np.asarray(m1["per_task_loss"]),
        np.asarray(m2["per_task_loss"]),
        rtol=1e-4,
        atol=1e-5,
    )
    for a, b_ in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b_), rtol=1e-4, atol=1e-6
        )


def test_meta_training_engine_2d_mesh_matches_serial(tmp_path):
    """The full engine on a dp x sp mesh (MeshConfig.spatial_devices=2,
    chained dispatch) must reproduce the serial (no-mesh) run's per-epoch
    losses: 2-D sharding and epoch fusion change the schedule, not the
    math. Exercises make_mesh's 2-D branch, the engine's sp detection, and
    the chained 2-D step in one pass."""
    import os

    from weatherforecast_stgcn_maml_tpu.config import ExperimentConfig
    from weatherforecast_stgcn_maml_tpu.engines.meta_train import (
        run_meta_training,
    )

    def cfg_for(sub, **meta_kw):
        return ExperimentConfig(
            model=MODEL_CFG,
            meta=MetaConfig(
                num_epochs=3,
                meta_batch=2,
                grad_accum=1,
                inner_epochs=1,
                inner_batches=2,
                query_train_mode=False,
                **meta_kw,
            ),
            data=DataConfig(synthetic_timesteps=32),
            mesh=MeshConfig(num_devices=4, spatial_devices=2),
            out_dir=str(tmp_path / sub),
        )

    regions = [
        synthetic_region_for_box(
            (10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=32, seed=i
        )
        for i in range(2)
    ]

    cfg = cfg_for("serial")
    run_meta_training(cfg, list(regions), log_cb=lambda *_: None)

    cfg2d = cfg_for("mesh2d", epochs_per_dispatch=2)
    mesh = make_mesh(cfg2d.mesh)
    assert mesh.axis_names == ("dp", "sp") and mesh.devices.shape == (2, 2)
    run_meta_training(cfg2d, list(regions), mesh=mesh, log_cb=lambda *_: None)

    def losses(sub):
        path = os.path.join(str(tmp_path / sub), "meta", "meta_log.csv")
        lines = open(path).read().strip().split("\n")[1:]
        return [float(l.split(",")[1]) for l in lines]

    np.testing.assert_allclose(
        losses("serial"), losses("mesh2d"), rtol=2e-4, atol=1e-5
    )


def test_meta_2d_actually_shards_activation_memory():
    """The sp axis must reduce PER-DEVICE memory, not just input layout:
    if GSPMD decided to all-gather the node axis at entry and compute
    replicated, temp memory would match the 1-D dp step. Measured on this
    config: dp2 147.9 MB -> dp2 x sp4 36.7 MB (~1/4). Guard at < 0.5x."""
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (
        make_parallel_meta_step_2d,
    )

    model_cfg = ModelConfig(
        hidden_channels=64, gcn_layers=4, lstm_hidden=64, lstm_layers=2,
        window=12, horizon=4,
    )
    meta_cfg = MetaConfig(
        meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=4,
        query_train_mode=False,
    )
    # A 31x31 box -> 961 nodes -> padded 1024: big enough that node-sharded
    # activations dominate replicated params in the memory analysis.
    regions = [
        synthetic_region_for_box(
            (10.0 + i, 17.5 + i, 20.0, 27.5), num_timesteps=48, seed=i
        )
        for i in range(2)
    ]
    built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
    tasks = stack_tasks([b.task for b in built])
    assert tasks.a_hat.shape[-1] == 1024
    state = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)

    mesh1 = make_mesh(MeshConfig(num_devices=2))
    c1 = (
        make_parallel_meta_step(model_cfg, meta_cfg, mesh1, donate_state=False)
        .lower(state, shard_task_batch(tasks, mesh1), jax.random.key(1))
        .compile()
    )
    mesh2 = make_mesh_2d(2, 4)
    c2 = (
        make_parallel_meta_step_2d(model_cfg, meta_cfg, mesh2, donate_state=False)
        .lower(state, shard_task_batch_2d(tasks, mesh2), jax.random.key(1))
        .compile()
    )
    m1, m2 = c1.memory_analysis(), c2.memory_analysis()
    if m1 is None or m2 is None:
        pytest.skip("backend exposes no memory analysis")
    assert m2.temp_size_in_bytes < 0.5 * m1.temp_size_in_bytes, (
        f"sp sharding did not reduce per-device temp memory: "
        f"{m2.temp_size_in_bytes} vs {m1.temp_size_in_bytes}"
    )


def test_meta_2d_rejects_uneven_dp_shard():
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh_2d
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import (
        make_parallel_meta_step_2d,
    )

    meta_cfg = MetaConfig(meta_batch=6, grad_accum=2, inner_epochs=1, inner_batches=2)
    mesh = make_mesh_2d(4, 2)
    with pytest.raises(ValueError):
        make_parallel_meta_step_2d(MODEL_CFG, meta_cfg, mesh)


def test_chained_meta_step_dp_matches_single_device():
    """The k-epochs-per-dispatch chained step under a dp mesh must match
    the single-device chained step (same pool, indices, base key)."""
    from weatherforecast_stgcn_maml_tpu.train.maml import (
        make_jit_chained_meta_step,
    )

    meta_cfg = MetaConfig(
        meta_batch=4,
        grad_accum=1,
        inner_epochs=1,
        inner_batches=2,
        query_train_mode=False,
        epochs_per_dispatch=2,
    )
    pool = _build(meta_cfg)  # 4 tasks staged
    pool = jax.tree.map(jnp.asarray, pool)
    idx_k = np.array([[0, 1, 2, 3], [3, 1, 0, 2]], np.int32)
    epochs = np.arange(2, dtype=np.int32)
    base_key = jax.random.key(11)

    s0 = init_meta_state(jax.random.key(0), MODEL_CFG, meta_cfg)
    single = make_jit_chained_meta_step(MODEL_CFG, meta_cfg)
    s1, m1 = single(s0, pool, idx_k, base_key, epochs)

    mesh = make_mesh(MeshConfig(num_devices=4))
    s0b = init_meta_state(jax.random.key(0), MODEL_CFG, meta_cfg)
    par = make_jit_chained_meta_step(MODEL_CFG, meta_cfg, mesh=mesh)
    s2, m2 = par(s0b, pool, idx_k, base_key, epochs)

    assert m2["per_task_loss"].shape == (2, 4)
    np.testing.assert_allclose(
        np.asarray(m1["per_task_loss"]),
        np.asarray(m2["per_task_loss"]),
        rtol=1e-4,
        atol=1e-5,
    )
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        )


def test_meta_shardmap_2d_matches_single_device():
    """The shard_map dp x sp meta step (parallel/meta_sp.py) must match the
    single-device step exactly (dropout off: per-shard rng streams are the
    one permitted divergence)."""
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )

    model_cfg = MODEL_CFG
    meta_cfg = MetaConfig(
        meta_batch=4,
        grad_accum=2,
        inner_epochs=1,
        inner_batches=2,
        query_train_mode=False,
    )
    tasks = _build(meta_cfg)
    tasks = jax.tree.map(jnp.asarray, tasks)

    state0 = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
    single = make_jit_meta_step(model_cfg, meta_cfg)
    s1, m1 = single(state0, tasks, jax.random.key(7))

    mesh = make_mesh_2d(2, 2)
    state0b = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
    par = make_shardmap_meta_step_2d(
        model_cfg, meta_cfg, mesh, donate_state=False
    )
    sharded = shard_task_batch_2d(tasks, mesh)
    s2, m2 = par(state0b, sharded, jax.random.key(7))

    np.testing.assert_allclose(
        np.asarray(m1["per_task_loss"]),
        np.asarray(m2["per_task_loss"]),
        rtol=1e-5,
        atol=1e-6,
    )
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        )


def test_meta_shardmap_2d_dropout_trains():
    """With dropout ON the shard_map step draws per-shard mask streams (a
    different-but-valid stream vs unsharded) — it must stay finite and
    actually move the parameters."""
    import dataclasses

    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )

    model_cfg = dataclasses.replace(
        MODEL_CFG, lstm_layers=2,
        gcn_dropout=0.3, lstm_dropout=0.3,
    )
    meta_cfg = MetaConfig(
        meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=2,
    )
    tasks = _build(meta_cfg)
    mesh = make_mesh_2d(2, 2)
    state0 = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
    par = make_shardmap_meta_step_2d(
        model_cfg, meta_cfg, mesh, donate_state=False
    )
    s1, m1 = par(
        state0, shard_task_batch_2d(jax.tree.map(jnp.asarray, tasks), mesh),
        jax.random.key(3),
    )
    assert np.isfinite(float(m1["meta_loss"]))
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(
            jax.tree.leaves(state0.params), jax.tree.leaves(s1.params)
        )
    )
    assert moved


def test_meta_shardmap_rejections():
    from weatherforecast_stgcn_maml_tpu.parallel.mesh import make_mesh_2d
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )
    import dataclasses

    mesh = make_mesh_2d(4, 2)
    with pytest.raises(ValueError):  # uneven dp shard
        make_shardmap_meta_step_2d(
            MODEL_CFG,
            MetaConfig(meta_batch=6, grad_accum=2, inner_epochs=1, inner_batches=2),
            mesh,
        )
    with pytest.raises(ValueError):  # non-hybrid family
        make_shardmap_meta_step_2d(
            dataclasses.replace(MODEL_CFG, family="stgcn"),
            MetaConfig(meta_batch=8, grad_accum=2, inner_epochs=1, inner_batches=2),
            mesh,
        )


def test_meta_shardmap_2d_nodes_span_shards_f64():
    """Regression: the shard_map step's inner gradients must be the TOTAL
    gradient, not each shard's partial. With 10x10 = 100 real nodes padded
    to 128 on a sp=2 mesh, rows 64-99 land in shard 1, so a partial-gradient
    inner SGD (the pre-fix behavior: grads w.r.t. the pvary'd carry come
    back per-shard) diverges measurably (loss off by ~7e-5, params by ~5e-4
    in f64). The fixed step psums the inner grads over sp and matches the
    single-device step to machine precision. The older parity test above
    cannot see this: its 3x3 regions sit entirely in shard 0."""
    import dataclasses

    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )
    from weatherforecast_stgcn_maml_tpu.train.maml import MamlState
    from weatherforecast_stgcn_maml_tpu.train.optimizers import meta_optimizer

    model_cfg = dataclasses.replace(
        MODEL_CFG, compute_dtype="float64",
        gcn_dropout=0.0, lstm_dropout=0.0,
    )
    meta_cfg = MetaConfig(
        meta_batch=4, grad_accum=2, inner_epochs=1, inner_batches=2,
        query_train_mode=False,
    )
    with jax.enable_x64(True):
        regions = [
            synthetic_region_for_box(
                (10.0 + i, 12.25 + i, 20.0, 22.25), num_timesteps=32, seed=i
            )
            for i in range(meta_cfg.meta_batch)
        ]
        built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
        tasks = stack_tasks([b.task for b in built])
        tasks = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64)
            if np.asarray(x).dtype == np.float32
            else jnp.asarray(x),
            tasks,
        )
        assert int(tasks.node_mask.shape[1]) == 128
        assert int(tasks.node_mask[0].sum()) == 100  # spans both sp shards

        def f64_state():
            st = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
            p = jax.tree.map(
                lambda a: a.astype(jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                st.params,
            )
            tx, _ = meta_optimizer(meta_cfg)
            return MamlState(p, tx.init(p), jnp.zeros((), jnp.int32))

        s1, m1 = make_jit_meta_step(model_cfg, meta_cfg)(
            f64_state(), tasks, jax.random.key(7)
        )
        mesh = make_mesh_2d(2, 2)
        par = make_shardmap_meta_step_2d(
            model_cfg, meta_cfg, mesh, donate_state=False
        )
        s2, m2 = par(
            f64_state(), shard_task_batch_2d(tasks, mesh), jax.random.key(7)
        )
        np.testing.assert_allclose(
            np.asarray(m1["per_task_loss"]),
            np.asarray(m2["per_task_loss"]),
            rtol=1e-12, atol=1e-12,
        )
        for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12
            )


@pytest.mark.parametrize("so_impl", ["xla", "hvp"])
def test_meta_shardmap_2d_second_order_f64(so_impl):
    """Second-order MAML on the shard_map dp x sp path must match the
    single-device SO meta step with real nodes spanning both sp shards.

    The Hessian transpose runs per shard through so_grad's custom_vjp on
    the node-local losses (jvp of the LOCAL partial gradient, psum-composed
    at the carry boundary — exact by joint-Hessian symmetry). "hvp" runs
    the custom_vjp wiring and the collective transposes; "xla" the plain
    linearize-and-transpose."""
    import dataclasses

    from weatherforecast_stgcn_maml_tpu.parallel.mesh import (
        make_mesh_2d,
        shard_task_batch_2d,
    )
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )
    from weatherforecast_stgcn_maml_tpu.train.maml import MamlState
    from weatherforecast_stgcn_maml_tpu.train.optimizers import meta_optimizer

    model_cfg = dataclasses.replace(
        MODEL_CFG, compute_dtype="float64",
        gcn_dropout=0.0, lstm_dropout=0.0,
    )
    meta_cfg = MetaConfig(
        meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=2,
        query_train_mode=False, second_order=True, so_impl=so_impl,
    )
    with jax.enable_x64(True):
        regions = [
            synthetic_region_for_box(
                (10.0 + i, 12.25 + i, 20.0, 22.25), num_timesteps=32, seed=i
            )
            for i in range(meta_cfg.meta_batch)
        ]
        built = build_meta_tasks(regions, model_cfg, meta_cfg, DataConfig())
        tasks = stack_tasks([b.task for b in built])
        tasks = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64)
            if np.asarray(x).dtype == np.float32
            else jnp.asarray(x),
            tasks,
        )
        assert int(tasks.node_mask[0].sum()) == 100  # spans both sp shards

        def f64_state():
            st = init_meta_state(jax.random.key(0), model_cfg, meta_cfg)
            p = jax.tree.map(
                lambda a: a.astype(jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                st.params,
            )
            tx, _ = meta_optimizer(meta_cfg)
            return MamlState(p, tx.init(p), jnp.zeros((), jnp.int32))

        s1, m1 = make_jit_meta_step(model_cfg, meta_cfg)(
            f64_state(), tasks, jax.random.key(7)
        )
        mesh = make_mesh_2d(2, 2)
        par = make_shardmap_meta_step_2d(
            model_cfg, meta_cfg, mesh, donate_state=False
        )
        s2, m2 = par(
            f64_state(), shard_task_batch_2d(tasks, mesh), jax.random.key(7)
        )
        np.testing.assert_allclose(
            np.asarray(m1["per_task_loss"]),
            np.asarray(m2["per_task_loss"]),
            rtol=1e-12, atol=1e-12,
        )
        for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-11
            )
