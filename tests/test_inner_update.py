"""The MAML inner update (train/maml.inner_sgd_update: global-norm clip,
then SGD) against optax.clip_by_global_norm + optax.sgd, alone and under
vmap with a different gradient norm per instance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from weatherforecast_stgcn_maml_tpu.train.maml import inner_sgd_update


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(scale * rng.normal(size=(7, 5)), jnp.float32),
        "layers": [
            {"b": jnp.asarray(scale * rng.normal(size=(5,)), jnp.float32)},
            {"b": jnp.asarray(scale * rng.normal(size=(3, 2)), jnp.float32)},
        ],
    }


def optax_update(params, grads, lr, clip_norm):
    tx = optax.chain(optax.clip_by_global_norm(clip_norm), optax.sgd(lr))
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


# optax scales by clip/norm, torch's clip (used here) by clip/(norm + 1e-6):
# the two differ by ~1e-6 relative when the clip is active.
RTOL = 1e-5


@pytest.mark.parametrize("clip_norm", [1e-3, 1.0, 100.0])
@pytest.mark.parametrize("lr", [0.01, 0.5])
def test_matches_optax(clip_norm, lr):
    params, grads = _tree(0), _tree(1, scale=3.0)
    got = jax.jit(inner_sgd_update, static_argnums=(2, 3))(params, grads, lr, clip_norm)
    want = optax_update(params, grads, lr, clip_norm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=1e-7)


def test_vmapped_instances_clip_by_their_own_norm():
    """Under the task vmap each instance clips by its own global norm."""
    params = jax.tree.map(lambda *a: jnp.stack(a), _tree(0), _tree(2), _tree(3))
    grads = jax.tree.map(
        lambda *a: jnp.stack(a), _tree(4, 0.01), _tree(5, 1.0), _tree(6, 50.0)
    )
    got = jax.vmap(lambda p, g: inner_sgd_update(p, g, 0.1, 1.0))(params, grads)
    for i in range(3):
        pick = lambda t: jax.tree.map(lambda a: a[i], t)  # noqa: E731
        want = optax_update(pick(params), pick(grads), 0.1, 1.0)
        for a, b in zip(jax.tree.leaves(pick(got)), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=1e-7)


def test_first_order_jacobian_is_identity():
    """With the gradient detached (FOMAML), d(update)/d(params) = I."""
    params, grads = _tree(7), _tree(8, scale=5.0)
    ct = _tree(9)

    def f(p):
        return inner_sgd_update(p, jax.lax.stop_gradient(grads), 0.1, 1.0)

    _, vjp = jax.vjp(f, params)
    (back,) = vjp(ct)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ct)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-7)


def test_clip_is_differentiable_for_second_order_f64():
    """Second-order MAML differentiates through the clip: its VJP with
    respect to the gradient matches central differences."""
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: a.astype(jnp.float64), _tree(10))
        grads = jax.tree.map(lambda a: a.astype(jnp.float64), _tree(11, scale=4.0))
        v = jax.tree.map(lambda a: a.astype(jnp.float64), _tree(12))

        def loss(g):
            out = inner_sgd_update(params, g, 0.1, 1.0)
            return sum(jnp.sum(jnp.sin(x)) for x in jax.tree.leaves(out))

        an = sum(
            float(jnp.vdot(a, b))
            for a, b in zip(jax.tree.leaves(jax.grad(loss)(grads)), jax.tree.leaves(v))
        )
        eps = 1e-6
        fd = (
            loss(jax.tree.map(lambda a, b: a + eps * b, grads, v))
            - loss(jax.tree.map(lambda a, b: a - eps * b, grads, v))
        ) / (2 * eps)
        np.testing.assert_allclose(an, float(fd), rtol=1e-6)
