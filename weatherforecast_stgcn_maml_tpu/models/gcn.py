"""Dense-adjacency graph convolution.

The sparse scatter/gather GCNConv of the reference (model.py:23-26, via
torch_geometric) becomes two dense matmuls:

    out = A_hat @ (H @ W) + b

with `A_hat` the precomputed GCN-normalized adjacency (graph.py). For the
~441-node region graphs both matmuls are dense library calls and XLA fuses
the bias/activation. The feature transform is applied *before* aggregation
(H @ W first) because hidden width (256) >= input width, minimizing the
[N, N] matmul operand size.

Applied per-timestep with weights shared across time — the *intended*
semantics of the reference, whose flattened [W*N] graph actually only wires
the oldest time slice (SURVEY.md section 3.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.common import Params, glorot_uniform


def init_gcn_layer(key, in_dim: int, out_dim: int) -> Params:
    wk, _ = jax.random.split(key)
    return {
        "w": glorot_uniform(wk, (in_dim, out_dim)),
        "b": jnp.zeros((out_dim,), jnp.float32),
    }


def apply_gcn_layer(
    p: Params,
    a_hat: jnp.ndarray,
    h: jnp.ndarray,
    *,
    compute_dtype=jnp.float32,
) -> jnp.ndarray:
    """One graph convolution over arbitrary leading dims.

    Args:
      a_hat: [N, N] normalized adjacency.
      h: [..., N, C_in] node features (leading dims: time, batch, ...).
    Returns:
      [..., N, C_out] float32 (accumulation forced to f32).
    """
    from weatherforecast_stgcn_maml_tpu.models.common import accum_dtype

    acc = accum_dtype(compute_dtype)
    w = p["w"].astype(compute_dtype)
    a = a_hat.astype(compute_dtype)
    hw = jnp.dot(h.astype(compute_dtype), w, preferred_element_type=acc)
    out = jnp.einsum(
        "nm,...mc->...nc", a, hw.astype(compute_dtype),
        preferred_element_type=acc,
    )
    return out + p["b"]
