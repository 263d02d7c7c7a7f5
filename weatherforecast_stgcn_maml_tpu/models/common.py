"""Shared functional building blocks: dense layers, dropout, dtype policy.

Models in this framework are plain pytrees of arrays with explicit
`init(key, ...) -> params` / `apply(params, ...) -> out` functions. This keeps
MAML trivial (params are just leaves to differentiate/update under lax.scan)
and keeps every transform (grad, vmap, jit, shard_map) first-class.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Params = dict


def glorot_uniform(key, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def scaled_uniform(key, shape, scale, dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype, -scale, scale)


def init_dense(key, in_dim: int, out_dim: int) -> Params:
    """Dense layer params with fan-in uniform init (torch.nn.Linear scheme,
    so parameter scales match the reference head layers)."""
    wk, bk = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(jnp.asarray(in_dim, jnp.float32))
    return {
        "w": scaled_uniform(wk, (in_dim, out_dim), bound),
        "b": scaled_uniform(bk, (out_dim,), bound),
    }


def accum_dtype(compute_dtype):
    """Matmul accumulation dtype: float32 for f32/bf16 compute, float64 when the
    whole computation is in f64 (gradient finite-difference tests)."""
    return jnp.float64 if compute_dtype == jnp.float64 else jnp.float32


def lstm_bias(layer: Params) -> jnp.ndarray:
    """Effective gate bias of one LSTM layer.

    Native params carry one fused bias `b` (torch's b_ih + b_hh is
    mathematically identical in the forward). Torch-imported params keep
    the two SEPARATE leaves `b_ih`/`b_hh` instead: under Adam the split is
    semantically meaningful — both copies receive the same gradient, each
    gets a full preconditioned step, so the effective bias sum moves at 2x
    the fused rate, and the global clip norm counts the bias twice. Summing
    here (not at import) keeps training-recipe parity with the reference
    (tests/test_recipe_parity.py) while every compute path stays fused."""
    if "b" in layer:
        return layer["b"]
    return layer["b_ih"] + layer["b_hh"]


def apply_dense(p: Params, x: jnp.ndarray, *, compute_dtype=jnp.float32) -> jnp.ndarray:
    w = p["w"].astype(compute_dtype)
    return (
        jnp.dot(
            x.astype(compute_dtype), w,
            preferred_element_type=accum_dtype(compute_dtype),
        )
        + p["b"]
    )


def dropout(x: jnp.ndarray, rate: float, rng, *, train: bool) -> jnp.ndarray:
    """Inverted dropout. No-op when not training / rate==0 / rng is None."""
    if not train or rate <= 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def resolve_dtype(name: str):
    # float64 exists for gradient finite-difference tests only (CPU + x64).
    return {
        "float32": jnp.float32,
        "bfloat16": jnp.bfloat16,
        "float64": jnp.float64,
    }[name]
