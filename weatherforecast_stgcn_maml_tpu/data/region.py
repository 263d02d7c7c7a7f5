"""Region data container and coordinate helpers.

The reference passes raw xarray Datasets between pipeline stages. Since the
model only ever consumes 12 gridded surface variables plus coordinates
(featurePreprocessor.py:84-122), we use a plain numpy container that any
backend (ERA5 NetCDF via xarray, NPZ cache, synthetic generator) can produce.
This removes the hard xarray dependency from the compute path — important
because a compute machine may not ship netCDF at all.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from weatherforecast_stgcn_maml_tpu.config import NUM_WEATHER_VARS, WEATHER_VARS


def to_0360(lon: float) -> float:
    """Normalize a longitude to the [0, 360) convention ERA5 files use
    (reference: dataLoader.py:15-16)."""
    return lon if lon >= 0 else lon + 360.0


def slice_coord_dim(ds, dim: str, lo: float, hi: float):
    """Slice an xarray-like dataset along a possibly DESCENDING coordinate
    (ERA5 latitudes run north->south; reference dataLoader.py:23-28).
    Shared by the ERA5 loader and the Koppen map reader."""
    coords = ds[dim].values
    sel = slice(hi, lo) if len(coords) > 1 and coords[0] > coords[-1] else slice(lo, hi)
    return ds.sel({dim: sel})


def region_cache_name(lat_min, lat_max, lon_min, lon_max) -> str:
    """Canonical cache key for a region box (dataLoader.py:135 analogue).

    Coordinates are %g-canonicalized so int and float spellings of the same
    box share one cache entry (same canonicalization as adapted_ckpt_path);
    int-spelled boxes keep their historical names."""
    lat_min, lat_max, lon_min, lon_max = (
        f"{float(v):g}" for v in (lat_min, lat_max, lon_min, lon_max)
    )
    return f"lat{lat_min}-{lat_max}_lon{lon_min}-{lon_max}"


@dataclass
class RegionData:
    """All host-side data for one lat/lon region.

    Attributes:
      weather: [T, lat, lon, 12] float32 raw (un-normalized) variables in
        WEATHER_VARS order. May contain NaNs (filled during preprocessing).
      times: [T] datetime64[ns] timestamps (sorted ascending).
      lats: [num_lat] latitudes.
      lons: [num_lon] longitudes.
      koppen_code: majority Koppen-Geiger class code for the box (1..30),
        0 if unknown/padding, -1 if the map had no data here.
      name: human-readable region name.
    """

    weather: np.ndarray
    times: np.ndarray
    lats: np.ndarray
    lons: np.ndarray
    koppen_code: int = 0
    name: str = ""

    def __post_init__(self):
        t, la, lo, c = self.weather.shape
        if c != NUM_WEATHER_VARS:
            raise ValueError(f"expected {NUM_WEATHER_VARS} weather vars, got {c}")
        if len(self.times) != t or len(self.lats) != la or len(self.lons) != lo:
            raise ValueError("coordinate lengths do not match weather shape")

    @property
    def num_nodes(self) -> int:
        return len(self.lats) * len(self.lons)

    @property
    def num_timesteps(self) -> int:
        return self.weather.shape[0]

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            weather=self.weather.astype(np.float32),
            times=self.times.astype("datetime64[ns]").astype(np.int64),
            lats=self.lats,
            lons=self.lons,
            koppen_code=np.int64(self.koppen_code),
            name=np.str_(self.name),
            var_order=np.array(WEATHER_VARS),
        )

    @staticmethod
    def load_npz(path: str) -> "RegionData":
        with np.load(path, allow_pickle=False) as z:
            var_order = [str(v) for v in z["var_order"]]
            if tuple(var_order) != WEATHER_VARS:
                raise ValueError(f"cache {path} has variable order {var_order}")
            return RegionData(
                weather=z["weather"],
                times=z["times"].astype("datetime64[ns]"),
                lats=z["lats"],
                lons=z["lons"],
                koppen_code=int(z["koppen_code"]),
                name=str(z["name"]),
            )
