"""ERA5 NetCDF ingestion (import-gated on xarray) with NPZ region caching.

Capability match for the reference loaders (dataLoader.py:19-52 for
meta-training years, adapt_hybrid_v5.py:30-62 for adaptation years,
validate_hybrid_v5.py:137-159 for the 2025 validation quarter), redesigned:

  * dataset root and file layout are configuration, not hardcoded paths;
  * the output is a plain numpy `RegionData` (stream merge, descending-coord
    and 0-360 longitude handling preserved);
  * each region is cached once as a compressed NPZ so repeat runs (and the
    device input pipeline) never reopen the 40 source NetCDF files;
  * missing files are skipped (adaptation semantics) or raised (training
    semantics) per the `strict` flag.

The ERA5 directory layout mirrors the reference:
  {root}/{year}/{quarter}/data_stream-oper_stepType-{accum,instant}.nc
"""

from __future__ import annotations

import os

import numpy as np

from weatherforecast_stgcn_maml_tpu.config import DataConfig, WEATHER_VARS
from weatherforecast_stgcn_maml_tpu.data.koppen import koppen_code_for_box
from weatherforecast_stgcn_maml_tpu.data.region import (
    RegionData,
    region_cache_name,
    slice_coord_dim,
    to_0360,
)

NC_FILENAMES = (
    "data_stream-oper_stepType-accum.nc",
    "data_stream-oper_stepType-instant.nc",
)


def _require_xarray():
    try:
        import xarray as xr

        return xr
    except ImportError as e:  # pragma: no cover - only without extras
        raise ImportError(
            "ERA5 NetCDF loading requires xarray/netCDF4 (`pip install .[era5]`). "
            "Use data.synthetic or NPZ caches on images without them."
        ) from e


def load_region(
    box: tuple[float, float, float, float],
    years,
    cfg: DataConfig,
    *,
    strict: bool = True,
    name: str = "",
) -> RegionData:
    """Load + merge + sort all (year, quarter) NetCDF pairs for a region box.

    Longitudes are normalized to [0, 360); accum/instant streams are merged
    with first-file precedence (the reference's `compat="override"`,
    dataLoader.py:44); quarters are concatenated along time and sorted.
    """
    xr = _require_xarray()
    lat_min, lat_max, lon_min, lon_max = box
    lon_min, lon_max = to_0360(lon_min), to_0360(lon_max)
    if lon_max <= lon_min and lon_max == 0.0:
        # A box given as e.g. (-5, 0): to_0360 maps the upper edge 0 -> 0,
        # which would slice an empty range. The reference sidesteps this by
        # spelling such regions (355, 360) directly (main.py "Sahara");
        # accept the natural negative spelling too by restoring the edge.
        lon_max = 360.0
    if lon_max < lon_min:
        # e.g. (-10, 10) -> (350, 10): a box genuinely wrapping the 0/360
        # meridian. slice_coord_dim would silently select ZERO columns, and
        # the kNN graph's planar lon distances would be wrong at the seam
        # anyway — refuse loudly instead. (The reference cannot express such
        # boxes either; all its regions avoid the seam, main.py:7-26.)
        raise ValueError(
            f"region '{name or box}': longitude span ({lon_min:g}, "
            f"{lon_max:g}) wraps the 0/360 meridian; wrap-around boxes are "
            "not supported — split the region at the meridian into two "
            "boxes (0-360 spelling)"
        )

    quarter_sets = []
    for year in years:
        for quarter in cfg.quarters:
            streams = []
            for fname in NC_FILENAMES:
                fpath = os.path.join(cfg.root, year, quarter, fname)
                if not os.path.exists(fpath):
                    if strict:
                        raise FileNotFoundError(fpath)
                    continue
                handle = xr.open_dataset(fpath)
                try:
                    ds = slice_coord_dim(handle, "latitude", lat_min, lat_max)
                    ds = slice_coord_dim(ds, "longitude", lon_min, lon_max)
                    ds = ds.drop_vars("expver", errors="ignore")
                    # Materialize the (small) slice so the source file handle
                    # can close now — 40 opens per region would otherwise
                    # stay live until GC (fd exhaustion on fleet runs).
                    streams.append(ds.load() if hasattr(ds, "load") else ds)
                finally:
                    if hasattr(handle, "close"):
                        handle.close()
            if streams:
                quarter_sets.append(xr.merge(streams, compat="override"))
    if not quarter_sets:
        raise FileNotFoundError(f"no ERA5 files found under {cfg.root} for {box}")

    combined = xr.concat(quarter_sets, dim="valid_time").sortby("valid_time")
    return dataset_to_region(combined, box=box, cfg=cfg, name=name)


def dataset_to_region(
    ds,
    *,
    box: tuple[float, float, float, float] | None = None,
    cfg: DataConfig | None = None,
    koppen_code: int | None = None,
    name: str = "",
) -> RegionData:
    """Convert an xarray Dataset (any source) into a RegionData container."""
    time_dim = "time" if "time" in ds.dims else "valid_time"
    weather = np.stack(
        [ds[v].values.astype(np.float32) for v in WEATHER_VARS], axis=-1
    )
    if koppen_code is None:
        koppen_code = 0
        if box is not None and cfg is not None and cfg.koppen_map:
            koppen_code = koppen_code_for_box(cfg.koppen_map, *box)
    return RegionData(
        weather=weather,
        times=np.asarray(ds[time_dim].values, dtype="datetime64[ns]"),
        lats=np.asarray(ds["latitude"].values, dtype=np.float64),
        lons=np.asarray(ds["longitude"].values, dtype=np.float64),
        koppen_code=int(koppen_code),
        name=name,
    )


def load_region_cached(
    box: tuple[float, float, float, float],
    years,
    cfg: DataConfig,
    *,
    strict: bool = True,
    tag: str = "",
    name: str = "",
) -> RegionData:
    """Load a region through the NPZ cache (the equivalent of
    the reference's single-file `.nc` cache, train_hybrid_maml_v5.py:76-84)."""
    os.makedirs(cfg.cache_dir, exist_ok=True)
    # The key must encode WHAT was cached, not just which pipeline stage
    # asked: changing year ranges or quarters must miss, never serve stale
    # data.
    data_key = "y" + "+".join(years) + "_q" + "+".join(cfg.quarters)
    key = region_cache_name(*box) + (f"_{tag}" if tag else "") + "_" + data_key
    path = os.path.join(cfg.cache_dir, key + ".npz")
    if os.path.exists(path):
        return RegionData.load_npz(path)
    region = load_region(box, years, cfg, strict=strict, name=name)
    region.save_npz(path)
    return region
