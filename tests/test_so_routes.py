"""Second-order MAML: the three Hessian-transpose routes of meta.so_impl
("xla" linearize-and-transpose, "hvp" forward-over-reverse, "rof"
reverse-over-forward; train/so_grad.py) give the same meta-gradient, with
the wavefront LSTM in the transpose (meta.so_wavefront) on and off, and
match float64 finite differences. Dropout is on and the LSTM has two
layers, so the wavefront's gathered mask streams are exercised."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weatherforecast_stgcn_maml_tpu.config import DataConfig, MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu.train.maml import adapt_and_query_loss, init_meta_state
from weatherforecast_stgcn_maml_tpu.train.so_grad import make_so_grad
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

MODEL = ModelConfig(
    hidden_channels=6, gcn_layers=2, lstm_hidden=5, lstm_layers=2,
    window=4, horizon=2, koppen_dim=3, gcn_dropout=0.2, lstm_dropout=0.2,
    compute_dtype="float64",
)
META = MetaConfig(
    meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=2,
    query_batches=1, second_order=True, rng_impl="threefry2x32",
)
IMPLS = ("xla", "hvp", "rof")


def _f64(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x), jnp.float64)
        if np.asarray(x).dtype == np.float32 else jnp.asarray(x),
        tree,
    )


def _setup(n_tasks=1):
    regions = [
        synthetic_region_for_box((10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=24, seed=i)
        for i in range(n_tasks)
    ]
    built = build_meta_tasks(regions, MODEL, META, DataConfig())
    params = _f64(init_meta_state(jax.random.key(1), MODEL, META).params)
    return params, [_f64(b.task) for b in built]


def _meta_grad(params, task, impl, wavefront):
    cfg = dataclasses.replace(META, so_impl=impl, so_wavefront=wavefront)
    rng = jax.random.key(2, impl="threefry2x32")
    return jax.jit(jax.value_and_grad(
        lambda p: adapt_and_query_loss(p, task, rng, MODEL, cfg)
    ))(params)


@pytest.mark.parametrize("a,b", list(itertools.combinations(IMPLS, 2)))
@pytest.mark.parametrize("wavefront", [False, True])
def test_meta_gradients_agree_pairwise(a, b, wavefront):
    with jax.enable_x64(True):
        params, (task,) = _setup()
        la, ga = _meta_grad(params, task, a, wavefront)
        lb, gb = _meta_grad(params, task, b, wavefront)
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-12)
        for x, y in zip(jax.tree.leaves(ga), jax.tree.leaves(gb)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_meta_gradient_matches_finite_differences(impl):
    """Directional derivative along a random direction in every leaf."""
    with jax.enable_x64(True):
        params, (task,) = _setup()
        cfg = dataclasses.replace(META, so_impl=impl)
        rng = jax.random.key(2, impl="threefry2x32")

        @jax.jit
        def loss(p):
            return adapt_and_query_loss(p, task, rng, MODEL, cfg)

        grads = jax.jit(jax.grad(loss))(params)
        leaves, treedef = jax.tree.flatten(params)
        dirs = np.random.default_rng(0)
        eps = 1e-6
        for i, (leaf, g) in enumerate(zip(leaves, jax.tree.leaves(grads))):
            v = dirs.normal(size=leaf.shape)
            bump = [jnp.zeros_like(a) for a in leaves]
            bump[i] = jnp.asarray(v)
            d = treedef.unflatten(bump)
            fd = (
                loss(jax.tree.map(lambda a, e: a + eps * e, params, d))
                - loss(jax.tree.map(lambda a, e: a - eps * e, params, d))
            ) / (2 * eps)
            np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("impl", ["hvp", "rof"])
def test_routes_survive_task_vmap(impl):
    """Task data reaches the custom_vjp as explicit arguments, so the routes
    work under the meta step's vmap and give the per-task gradients."""
    with jax.enable_x64(True):
        params, tasks = _setup(n_tasks=2)
        stacked = stack_tasks(tasks)
        cfg = dataclasses.replace(META, so_impl=impl)
        rngs = jax.random.split(jax.random.key(2, impl="threefry2x32"), 2)

        def mean_loss(p):
            return jax.vmap(
                lambda t, r: adapt_and_query_loss(p, t, r, MODEL, cfg)
            )(stacked, rngs).mean()

        got = jax.jit(jax.grad(mean_loss))(params)
        one = jax.jit(jax.grad(
            lambda p, t, r: adapt_and_query_loss(p, t, r, MODEL, cfg)
        ))
        want = [one(params, t, r) for t, r in zip(tasks, rngs)]
        for g, w0, w1 in zip(
            jax.tree.leaves(got), jax.tree.leaves(want[0]), jax.tree.leaves(want[1])
        ):
            np.testing.assert_allclose(
                np.asarray(g), (np.asarray(w0) + np.asarray(w1)) / 2, rtol=1e-9, atol=1e-12
            )


def test_removed_route_is_rejected():
    with pytest.raises(ValueError, match="so_impl"):
        make_so_grad(lambda p, a, r: 0.0, lambda p, a, r: 0.0, "fhvp")
