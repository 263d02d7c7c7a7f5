"""Region data resolution: ERA5 when configured, synthetic otherwise.

The reference hardwires a local ERA5 mirror (dataLoader.py:7). Here the data
backend is chosen by configuration: a real ERA5 root (NetCDF via the gated
xarray loader, NPZ-cached) or the deterministic synthetic generator — so
every engine runs end-to-end on any machine, including netCDF-less machines
and CI.
"""

from __future__ import annotations

from weatherforecast_stgcn_maml_tpu.config import DataConfig
from weatherforecast_stgcn_maml_tpu.data.region import RegionData
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box


def get_region_data(
    box: tuple[float, float, float, float],
    years,
    cfg: DataConfig,
    *,
    strict: bool = False,
    tag: str = "",
    name: str = "",
    num_timesteps: int | None = None,
) -> RegionData:
    """Load one region for the given years from the configured backend."""
    if cfg.root:
        from weatherforecast_stgcn_maml_tpu.data.era5 import load_region_cached

        return load_region_cached(
            box, years, cfg, strict=strict, tag=tag or "-".join(years), name=name
        )
    t = num_timesteps or cfg.synthetic_timesteps
    if cfg.synthetic_shared_seed >= 0:
        # One coherent global field; each workflow stage reads a different
        # temporal window of it (mimicking the reference's distinct ERA5
        # year ranges: train 2020-24, adapt 2023-24, validate 2025).
        offsets = {
            "train": 0,
            "adapt": 3 * 8766,
            "validate": 5 * 8766,
            # Serving reads the most recent period, like validation — NOT
            # the meta-train window (which would leak training data into
            # forecast-skill measurements).
            "forecast": 5 * 8766,
        }
        offset = offsets.get(tag, 0)
        if tag == "train" and cfg.synthetic_train_time_spread_hours > 0:
            # Per-region temporal diversity: tasks that all read the same
            # window co-memorize its phases and the meta-init does not
            # transfer (benchmarks/transfer_study.md — spreading the task
            # histories over the field flips transfer +40% positive).
            import zlib

            # Hash canonical float coords so the same region given as int vs
            # float box gets the same temporal offset (matches the coord
            # canonicalization in adapted_ckpt_path; ADVICE r2).
            canon = repr(tuple(float(v) for v in box))
            offset += zlib.crc32(canon.encode()) % (
                cfg.synthetic_train_time_spread_hours
            )
        return synthetic_region_for_box(
            box,
            num_timesteps=t,
            seed=cfg.synthetic_shared_seed,
            hour_offset=offset,
            name=name or f"synthetic{box}",
        )
    # Seed differs by (box, tag) so train/adapt/validate years yield
    # different-but-deterministic data, like distinct ERA5 year ranges.
    # crc32, not hash(): str hashing is salted per process and would give
    # every invocation different "deterministic" data.
    import zlib

    seed = zlib.crc32(repr((box, tag)).encode()) % (2**31)
    return synthetic_region_for_box(
        box, num_timesteps=t, seed=seed, name=name or f"synthetic{box}"
    )
