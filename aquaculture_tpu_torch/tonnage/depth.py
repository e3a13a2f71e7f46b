"""Facility depth from bathymetry: zonal statistics over cage polygons.
A copy of aquaculture_tpu/tonnage/depth.py in the PyTorch port.

Port of the reference's rasterstats-based depth assignment (reference:
src/utils_tonnage.py:591-665): union each facility's cage polygons, take
min/mean/max of EMODnet bathymetry cells under them (all_touched), convert
negative depths positive, cage depth = water depth / 2 (FAO: water depth
should be twice net depth) with a minimum threshold and a default where no
bathymetry exists. Zonal reduction uses the self-contained rasterizer
(aquaculture_tpu_torch.geo.rasterize) instead of GDAL."""

from __future__ import annotations

from typing import Optional

import numpy as np

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_MAPPING
from aquaculture_tpu_torch.data.geotiff import GeoTiff, read_geotiff
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.geo.rasterize import zonal_stats
from aquaculture_tpu_torch.utils.logging import log_info


def _facility_cage_union(row) -> _poly.Geometry:
    geoms = []
    for col in ("circle_farm_geoms", "square_farm_geoms", "rectangle_farm_geoms"):
        g = row.get(col)
        if g is not None and not getattr(g, "is_empty", True):
            geoms.append(g)
    if not geoms:
        return _poly.Empty()
    return _poly.unary_union(geoms)


def add_facility_depth(
    facility_df: "gf.GeoFrame",
    bathymetry_path: Optional[str] = None,
    bathymetry: Optional[GeoTiff] = None,
    min_cage_threshold: float = 5.0,
    default_cage_depth: float = 10.0,
    bathymetry_statistic: str = "bathy_min",
) -> "gf.GeoFrame":
    """Append bathy_depth/bathy_min/bathy_max/bathy_mean/cage_depth columns."""
    assert bathymetry_statistic in ("bathy_depth", "bathy_min")
    if bathymetry is None:
        bathymetry = read_geotiff(bathymetry_path)
    raster = np.asarray(bathymetry.array, np.float64)
    nodata_mask = ~np.isfinite(raster)
    raster = np.where(nodata_mask, np.nan, raster)

    # facility cage polygons in the raster's CRS (EMOD tiles are EPSG:4326)
    fac = facility_df.copy()
    src_crs = fac.crs or CRS_MAPPING
    unions = [_facility_cage_union(row) for _, row in fac.iterrows()]
    u_frame = gf.GeoFrame({"i": range(len(unions))}, geometry=unions, crs=src_crs)
    u_frame = u_frame.to_crs(bathymetry.epsg or 4326)

    mins, maxs, means = [], [], []
    for g in u_frame["geometry"]:
        if g is None or g.is_empty:
            mins.append(np.nan)
            maxs.append(np.nan)
            means.append(np.nan)
            continue
        st = zonal_stats(g, raster, bathymetry.bounds, nodata=np.nan, all_touched=True)
        mins.append(st.get("min", np.nan))
        maxs.append(st.get("max", np.nan))
        means.append(st.get("mean", np.nan))

    # bathymetry is negative below sea level -> positive depths
    fac["bathy_min"] = -np.asarray(mins, np.float64)   # min raster value = deepest
    fac["bathy_max"] = -np.asarray(maxs, np.float64)
    fac["bathy_mean"] = -np.asarray(means, np.float64)
    fac["bathy_depth"] = fac["bathy_mean"]

    stat = fac[bathymetry_statistic].to_numpy(np.float64)
    cage_depth = np.where(np.isnan(stat), default_cage_depth, stat / 2.0)
    cage_depth = np.maximum(cage_depth, min_cage_threshold)
    fac["cage_depth"] = cage_depth
    n_missing = int(np.isnan(stat).sum())
    if n_missing:
        log_info("no bathymetry for %d facilities; using default depth", n_missing)
    fac.crs = facility_df.crs
    return fac
