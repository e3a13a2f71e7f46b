"""French land-filter construction from coastline linework + EEZ.
A copy of aquaculture_tpu/acquire/landfilter.py in the PyTorch port.

Port of the reference's one-off builder (reference:
src/load_data/create_land_filter.py:70-137): dissect the country shape with
its coastline (polygonize the merged linework), rank the resulting faces by
equal-area size, keep the mainland pieces, then recover islands by
intersecting the full coastline polygonization with the country shape.

Differences stated explicitly: area ranking uses EPSG:3035 (an equal-area
CRS — the right tool for ranking) instead of the reference's per-centroid
UTM zone, and the reference's hand-picked face indices ("from plotting we
see keep first and fifth") are a parameter.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_AREA
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.geo.lines import polygonize
from aquaculture_tpu_torch.utils.logging import log_info


def _equal_area(geoms: Sequence[_poly.Geometry], src_crs: int = 4326) -> np.ndarray:
    frame = gf.GeoFrame({"i": range(len(geoms))}, geometry=list(geoms), crs=src_crs)
    return frame.to_crs(CRS_AREA).area.to_numpy(np.float64)


def build_land_filter(
    coastline_lines: Sequence,
    country_shape: _poly.Geometry,
    eez: Optional[_poly.Geometry] = None,
    keep_faces: Sequence[int] = (0,),
    crs: int = 4326,
) -> "gf.GeoFrame":
    """Land polygons for the ocean filter.

    Args:
        coastline_lines: coastline LineStrings (closed loops after merge)
        country_shape: the country's gross footprint polygon
        eez: marine EEZ polygon to subtract first (may be None)
        keep_faces: indices (by descending equal-area size) of the
            polygonized faces to keep as primary landmass
    Returns:
        GeoFrame of land polygons (primary landmass + recovered islands).
    """
    # Land region = country footprint minus its marine EEZ — the same
    # overlay difference the reference computes with geopandas
    # (create_land_filter.py:95), here via the exact Martinez-Rueda sweep
    # (geo/boolean.py, on its default C++ engine) on arbitrary simple
    # polygons.
    if eez is not None and not eez.is_empty:
        land_region = _poly.difference(country_shape, eez)
    else:
        land_region = country_shape

    def land_overlap(f: _poly.Geometry) -> float:
        return _poly.intersection_area(f, land_region)

    # Dissect: every closed loop in the coastline linework is a face.
    faces = [p for p in polygonize(coastline_lines) if land_overlap(p) > 0]
    if not faces:
        raise ValueError("coastline linework produced no closed faces")
    order = np.argsort(-_equal_area(faces, crs))
    primary: List[_poly.Geometry] = [faces[order[i]] for i in keep_faces if i < len(faces)]
    log_info("kept %d primary landmass faces of %d", len(primary), len(faces))

    # Island recovery: all coastline faces inside the country shape that
    # aren't already covered by the primary faces.
    islands = []
    for i, f in enumerate(faces):
        if any(f is p for p in primary):
            continue
        # faces was prefiltered to land_overlap > 0 above — no re-check.
        covered = max(_poly.intersection_area(f, p) for p in primary)
        if covered / max(f.area, 1e-12) < 0.5:
            islands.append(f)

    geoms = primary + islands
    out = gf.GeoFrame(
        {"kind": ["primary"] * len(primary) + ["island"] * len(islands)},
        geometry=geoms,
        crs=crs,
    )
    return out
