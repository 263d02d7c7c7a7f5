"""Feature assembly: RegionData -> model-ready [T, N, C] tensor + stats.

JAX-side counterpart of `prepare_model_input` (featurePreprocessor.py:67-184)
with two deliberate design changes documented in SURVEY.md:

  * The Koppen embedding is NOT baked into the features. The reference
    computes the embedding once at task-build time and stores it in the
    (detached) feature tensor, so the "learnable" embedding never receives a
    gradient. Here features carry only weather (12, z-scored) + time (4)
    channels; the model looks the embedding up from the integer code so it
    trains for real (models/hybrid.py).
  * Everything is pure numpy in -> numpy out; no prints, no device transfer.
    NaN diagnostics are returned as data, not printed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from weatherforecast_stgcn_maml_tpu.config import NUM_WEATHER_VARS
from weatherforecast_stgcn_maml_tpu.data.region import RegionData
from weatherforecast_stgcn_maml_tpu.data.timefeat import time_features


@dataclass(frozen=True)
class NormStats:
    """Per-variable z-score statistics over (time, nodes)."""

    mean: np.ndarray  # [12]
    std: np.ndarray  # [12]

    def to_dict(self) -> dict:
        return {"mean": self.mean.tolist(), "std": self.std.tolist()}

    @staticmethod
    def from_dict(d: dict) -> "NormStats":
        return NormStats(
            mean=np.asarray(d["mean"], dtype=np.float32),
            std=np.asarray(d["std"], dtype=np.float32),
        )

    def denormalize(self, x: np.ndarray, var_idx: int | None = None) -> np.ndarray:
        """Invert the z-score (featurePreprocessor.py:187-239 equivalent).

        `var_idx=None` denormalizes all 12 variables along the last axis;
        an integer denormalizes a single-variable array.
        """
        if var_idx is not None:
            return x * self.std[var_idx] + self.mean[var_idx]
        return x * self.std + self.mean


def nan_percentages(weather: np.ndarray) -> np.ndarray:
    """Fraction of NaNs per variable (diagnose_nan_percentage analogue)."""
    flat = weather.reshape(-1, weather.shape[-1])
    return np.isnan(flat).mean(axis=0)


def fill_nans_with_mean(weather: np.ndarray) -> np.ndarray:
    """Replace NaNs by the per-variable nanmean (0 if a variable is all-NaN),
    the same policy as featurePreprocessor.py:97-111."""
    if not np.isnan(weather).any():
        return weather
    out = weather.copy()
    for v in range(out.shape[-1]):
        col = out[..., v]
        hole = np.isnan(col)
        valid = col[~hole]
        col[hole] = valid.mean() if valid.size else 0.0
    return out


def compute_stats(weather_nodes: np.ndarray) -> NormStats:
    """Z-score stats over (T, N) per variable with the reference's 1e-8
    epsilon guard (featurePreprocessor.py:133-144)."""
    mean = weather_nodes.mean(axis=(0, 1))
    std = weather_nodes.std(axis=(0, 1)) + 1e-8
    mean = np.nan_to_num(mean, nan=0.0)
    std = np.nan_to_num(std, nan=1.0)
    return NormStats(mean=mean.astype(np.float32), std=std.astype(np.float32))


def relative_coord_channels(region: RegionData) -> np.ndarray:
    """[N, 2] within-box coordinates, each axis scaled to [-1, 1].

    Box-invariant by construction: two boxes of different absolute location
    produce identical channels, so the model can learn position-in-box
    structure without an absolute-location shortcut (ROADMAP #2)."""

    def scaled(v):
        v = np.asarray(v, np.float32)
        span = v.max() - v.min()
        if span <= 0:
            return np.zeros_like(v)
        return 2.0 * (v - v.min()) / span - 1.0

    lat_g, lon_g = np.meshgrid(
        scaled(region.lats), scaled(region.lons), indexing="ij"
    )
    return np.stack([lat_g.ravel(), lon_g.ravel()], axis=-1).astype(np.float32)


def prepare_features(
    region: RegionData,
    *,
    normalize: bool = True,
    stats: NormStats | None = None,
    rel_coords: bool = False,
) -> tuple[np.ndarray, NormStats]:
    """Build the [T, N, 16(+2)] feature tensor (12 weather z-scored + 4 time
    + optional relative coordinates, model.relative_coords).

    Returns (features, stats). When `stats` is given it is reused (the
    validation path must normalize with the stats saved at adaptation time,
    validate_hybrid_v5.py:167-171); otherwise new stats are computed.
    """
    from weatherforecast_stgcn_maml_tpu import native

    t, la, lo, c = region.weather.shape
    assert c == NUM_WEATHER_VARS
    # Fresh C-contiguous copy: the native path fills/normalizes in place and
    # must never mutate the caller's RegionData.
    nodes = np.array(
        region.weather.reshape(t, la * lo, c), dtype=np.float32, order="C"
    )

    fused = native.nan_fill_stats_native(nodes)  # in-place NaN fill
    if fused is None:
        nodes = fill_nans_with_mean(nodes)

    if normalize:
        if stats is None:
            if fused is not None:
                stats = NormStats(mean=fused[0], std=fused[1])
            else:
                stats = compute_stats(nodes)
        if not native.normalize_native(nodes, stats.mean, stats.std):
            nodes = (nodes - stats.mean) / stats.std
    elif stats is None:
        stats = NormStats(
            mean=np.zeros(c, dtype=np.float32), std=np.ones(c, dtype=np.float32)
        )

    tf = time_features(region.times)  # [T, 4]
    tf_tiled = np.broadcast_to(tf[:, None, :], (t, la * lo, tf.shape[-1]))
    parts = [nodes, tf_tiled]
    if rel_coords:
        rc = relative_coord_channels(region)  # [N, 2]
        parts.append(np.broadcast_to(rc[None], (t, la * lo, 2)))
    features = np.concatenate(parts, axis=-1).astype(np.float32)
    # Final guard mirroring featurePreprocessor.py:180-182.
    if np.isnan(features).any():
        features = np.nan_to_num(features, nan=0.0)
    return features, stats


def pad_nodes(features: np.ndarray, padded_nodes: int) -> np.ndarray:
    """Zero-pad the node axis of [T, N, C] features to `padded_nodes`."""
    t, n, c = features.shape
    if padded_nodes < n:
        raise ValueError(f"padded_nodes={padded_nodes} < N={n}")
    if padded_nodes == n:
        return features
    out = np.zeros((t, padded_nodes, c), dtype=features.dtype)
    out[:, :n] = features
    return out
