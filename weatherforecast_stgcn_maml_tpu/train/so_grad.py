"""Second-order inner-gradient operator with a pluggable Hessian transpose.

The SO meta-gradient through K inner SGD steps needs, at every inner step,
the transpose of d(inner grad)/d(params) applied to the incoming cotangent
— a Hessian-vector product. The default JAX route (``so_impl="xla"``)
linearizes-and-transposes the whole inner gradient computation, i.e. the
transpose of a reverse scan.

Because the Hessian of a scalar loss is symmetric, ``(dg/dp)^T ct == H ct``
(equality of mixed partials), the transpose can instead be an *explicit*
HVP on a separate, twice-differentiable loss (which may use another but
mathematically identical formulation, e.g. the wavefront LSTM):

  so_impl="hvp"   H·ct by forward-over-reverse:  jvp(grad(L))(p; ct)
  so_impl="rof"   H·ct by reverse-over-forward:  grad(p ↦ jvp(L)(p; ct))

"rof" builds the directional derivative s(p) = <∇L(p), ct> as ONE
hand-rolled forward-tangent pass and reverses through it once — a single
standard reverse scan over a doubled forward, instead of tangents threaded
through both the forward and the reverse scans.

All three routes compute the same meta-gradient (float64 equivalence
asserted in tests/test_maml.py). Reference intent: full MAML
(the reference's README.md:116-124, `higher` in requirements.txt:11).
"""

from __future__ import annotations

import numpy as np

import jax

SO_IMPLS = ("xla", "hvp", "rof")


def _zero_ct(x):
    """Zero cotangent for a non-differentiated primal input.

    custom_vjp's bwd must return a cotangent for every primal argument.
    Inexact (float) task tensors get symbolic-zero-equivalent arrays;
    integer / PRNG-key primals take JAX's float0 tangent type. The task
    data and step keys are never targets of the meta-gradient, so zeros
    are exact, not an approximation.
    """
    import jax.numpy as jnp

    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.inexact):
        return jnp.zeros_like(x)
    return np.zeros(np.shape(x), jax.dtypes.float0)


def make_so_grad(loss_fast, loss_diff2, impl: str):
    """Build the inner-gradient operator g(p, aux, step_rng) = ∇_p loss.

    loss_fast:  loss(p, aux, step_rng) on the model's own route —
                differentiated ONCE to produce g. `aux` is a
                pytree of task data passed EXPLICITLY (a custom_vjp must
                not close over task tensors: under the meta step's task
                vmap they are batch tracers, and closed-over tracers
                escaping into the bwd rule is an UnexpectedTracerError).
    loss_diff2: the same loss, possibly on another formulation — used only
                inside the Hessian transpose. Unused for impl="xla".
    """
    if impl == "xla":
        return jax.grad(loss_fast)
    if impl not in SO_IMPLS:
        raise ValueError(
            f"meta.so_impl={impl!r}: expected one of {SO_IMPLS}"
        )

    @jax.custom_vjp
    def g_op(p, aux, step_rng):
        return jax.grad(loss_fast)(p, aux, step_rng)

    def g_fwd(p, aux, step_rng):
        return jax.grad(loss_fast)(p, aux, step_rng), (p, aux, step_rng)

    def g_bwd(res, ct):
        p, aux, step_rng = res
        if impl == "hvp":
            _, hv = jax.jvp(
                lambda q: jax.grad(loss_diff2)(q, aux, step_rng), (p,), (ct,)
            )
        else:  # "rof"

            def directional(q):
                _, t = jax.jvp(
                    lambda qq: loss_diff2(qq, aux, step_rng), (q,), (ct,)
                )
                return t

            hv = jax.grad(directional)(p)
        return hv, jax.tree.map(_zero_ct, aux), _zero_ct(step_rng)

    g_op.defvjp(g_fwd, g_bwd)
    return g_op
