"""Training-path PRNG key construction.

The training engines only consume randomness for dropout masks and sampling,
but one inner SGD step draws ~50M bernoulli bits across the encoder/LSTM
dropout sites. The TRAINING key can use JAX's "rbg" implementation (backed
by XLA's RngBitGenerator) instead of the default threefry2x32 counter hash.

rbg keys are NOT stable across backends/shardings the way threefry is
(jax.random docs) — fine for dropout, wrong for anything that must
reproduce bit-exactly across machines. Engines expose `rng_impl` config
knobs (meta.rng_impl / adapt.rng_impl, default "rbg"); parameter
INITIALIZATION everywhere stays on the default threefry keys so saved
models remain reproducible.
"""

from __future__ import annotations

import jax


def make_key(seed: int, impl: str | None = None):
    """A typed PRNG key with the configured implementation.

    impl: "rbg" (XLA RngBitGenerator, default in engine configs), "threefry2x32"
    (JAX's portable default), or None/"default" for the library default.
    """
    if impl in (None, "", "default"):
        return jax.random.key(seed)
    return jax.random.key(seed, impl=impl)
