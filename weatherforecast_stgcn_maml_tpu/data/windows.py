"""Windowed sample extraction — device-side, zero host involvement.

The reference materializes every (window, horizon) sample on the host through
a torch Dataset + PyG DataLoader (dataset.py:30-54), shipping each sample to
the device one batch (of one!) at a time. Here we instead keep the whole
region feature tensor [T, N, C] resident in device memory and gather windows *inside*
jit with `lax.dynamic_slice`, so training loops never touch the host.

Sample semantics (matching dataset.py):
  anchor t valid in [window, T - horizon)
  x = features[t-window : t]                      -> [W, N, C]
  y = features[t+1 : t+horizon+1, :, :12]         -> [H, N, 12]

Our y keeps its natural [H, N, 12] layout. The reference flattens targets
H-outer but predictions N-outer (dataset.py:46 vs hybrid_model.py:114-115),
silently comparing misaligned rows in the MSE — documented as a quirk in
SURVEY.md; we align them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from weatherforecast_stgcn_maml_tpu.config import NUM_WEATHER_VARS


@dataclass(frozen=True)
class WindowSpec:
    window: int
    horizon: int

    def valid_anchors(self, num_timesteps: int) -> np.ndarray:
        """All valid anchor indices (dataset.py:25 equivalent)."""
        lo, hi = self.window, num_timesteps - self.horizon
        return np.arange(lo, max(lo, hi))

    def num_samples(self, num_timesteps: int) -> int:
        return max(0, num_timesteps - self.horizon - self.window)


def slice_window(
    features: jnp.ndarray, anchor: jnp.ndarray, spec: WindowSpec
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Extract one (x, y) sample from [T, N, C] at a traced anchor index.

    Returns x [W, N, C] and y [H, N, 12].
    """
    t, n, c = features.shape
    x = jax.lax.dynamic_slice(
        features, (anchor - spec.window, 0, 0), (spec.window, n, c)
    )
    y = jax.lax.dynamic_slice(features, (anchor + 1, 0, 0), (spec.horizon, n, c))
    return x, y[..., :NUM_WEATHER_VARS]


@partial(jax.jit, static_argnames=("spec",))
def gather_batch(
    features: jnp.ndarray, anchors: jnp.ndarray, spec: WindowSpec
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batch-gather windows: [B] anchors -> (x [B, W, N, C], y [B, H, N, 12])."""
    return jax.vmap(lambda a: slice_window(features, a, spec))(anchors)


def contiguous_split(
    num_samples: int, first_fraction: float, max_samples: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Contiguous (temporal, leakage-free) index split.

    Mirrors the reference's non-shuffled support/query and train/val splits
    (train_hybrid_maml_v5.py:100-104, adapt_hybrid_v5.py:152-159): take the
    first `max_samples`, split the leading `first_fraction` from the rest.
    """
    total = num_samples if max_samples is None else min(max_samples, num_samples)
    cut = int(first_fraction * total)
    return np.arange(0, cut), np.arange(cut, total)
