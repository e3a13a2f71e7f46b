"""Vectorized detection geocoding: tile pixels -> EPSG:3857/3035/4326.

Replaces the reference's per-label-file loop (reference:
src/process_yolo/geocode_results.py:104-197) with one batched array pass:
every detection carries its tile's (bbox_ind, x_offset, y_offset); the
download box's EPSG:3857 bounds give a linear pixel->meter map over the
6144 px parent raster (geocode_results.py:71-101), corners transform to
EPSG:3035 for area measurement and EPSG:4326 for output — all closed-form
numpy math, no PROJ. A copy of aquaculture_tpu/post/geocode.py.

Axis-order note: the reference builds ``Transformer.from_crs(3857, 3035)``
WITHOUT always_xy (geocode_results.py:31), so pyproj returns EPSG:3035
coordinates in authority order (northing, easting) and the reference stores
them swapped into its ``*_m`` columns. ``authority_order=True`` replicates
that behavior for artifact-level parity; the default stores true
(easting, northing).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import (
    IM_HEIGHT,
    IM_WIDTH,
    LARGE_TIF_SIZE,
    REVERSE_CLASS_MAPPING,
)
from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name
from aquaculture_tpu_torch.geo import crs as _crs
from aquaculture_tpu_torch.geo import polygon as _poly


def yolo_norm_to_pixels(boxes_norm: np.ndarray) -> np.ndarray:
    """Normalized cxcywh -> integer pixel xyxy, with the reference's int()
    truncation semantics (geocode_results.py:160-163)."""
    b = np.asarray(boxes_norm, np.float64)
    out = np.stack(
        [
            np.trunc(IM_WIDTH * (b[:, 0] - b[:, 2] / 2)),
            np.trunc(IM_HEIGHT * (b[:, 1] - b[:, 3] / 2)),
            np.trunc(IM_WIDTH * (b[:, 0] + b[:, 2] / 2)),
            np.trunc(IM_HEIGHT * (b[:, 1] + b[:, 3] / 2)),
        ],
        axis=1,
    )
    return out.astype(np.int64)


def pixels_to_mercator(
    px: np.ndarray,
    py: np.ndarray,
    x_offset: np.ndarray,
    y_offset: np.ndarray,
    tif_bounds: np.ndarray,
    large_tif_size: int = LARGE_TIF_SIZE,
):
    """Tile pixels -> EPSG:3857 meters (vectorized convert_pix_to_m_bboxes,
    reference geocode_results.py:71-101).

    Args:
        px, py: (N,) pixel coords within the tile
        x_offset, y_offset: (N,) tile offsets within the parent raster
        tif_bounds: (N, 4) parent download-box bounds (minx, miny, maxx, maxy)
    """
    xmin_m, ymin_m, xmax_m, ymax_m = (tif_bounds[:, i] for i in range(4))
    x_loc = np.asarray(px, np.float64) + x_offset
    y_loc = np.asarray(py, np.float64) + y_offset
    x = x_loc * ((xmax_m - xmin_m) / large_tif_size) + xmin_m
    y = ymax_m - y_loc * ((ymax_m - ymin_m) / large_tif_size)
    return x, y


def geocode_detections(
    boxes_px: np.ndarray,
    conf: np.ndarray,
    cls_id: np.ndarray,
    specs: Sequence[TileSpec],
    download_bboxes: "gf.GeoFrame",
    authority_order: bool = True,
) -> "gf.GeoFrame":
    """Assemble the geocoded detections GeoFrame.

    Args:
        boxes_px: (N, 4) integer pixel xyxy within each 1024px tile
        conf: (N,) detection confidences
        cls_id: (N,) integer class ids
        specs: per-detection TileSpec (length N)
        download_bboxes: GeoFrame of download boxes in EPSG:3857, indexed by
            bbox_ind (reference wanted_bboxes.csv)
        authority_order: store EPSG:3035 corners in the reference's swapped
            (northing, easting) order (see module docstring)
    Returns:
        GeoFrame in EPSG:4326 with the reference's detections.geojson schema
        (geocode_results.py:129-195): image, xmin/xmax/ymin/ymax px,
        xmin_m/xmax_m/ymin_m/ymax_m (EPSG:3035 corners), type, year,
        det_conf, geometry.
    """
    n = len(boxes_px)
    if not len(specs) == len(conf) == len(cls_id) == n:
        raise ValueError(f"{n} boxes but {len(conf)} confidences, {len(cls_id)} classes "
                         f"and {len(specs)} tile specs")
    if n == 0:
        out = gf.GeoFrame(
            {c: [] for c in ("image", "xmin", "xmax", "ymin", "ymax", "xmin_m", "xmax_m",
                              "ymin_m", "ymax_m", "type", "year", "det_conf", "geometry")}
        )
        out.crs = 4326
        return out

    bounds_by_ind = {int(i): g.bounds for i, g in zip(download_bboxes.index, download_bboxes["geometry"])}
    tif_bounds = np.asarray([bounds_by_ind[s.bbox_ind] for s in specs], np.float64)
    x_off = np.asarray([s.x_offset for s in specs], np.float64)
    y_off = np.asarray([s.y_offset for s in specs], np.float64)

    bx = np.asarray(boxes_px, np.float64)
    # corner mapping with the y flip (geocode_results.py:168-170)
    xmin_m, ymax_m = pixels_to_mercator(bx[:, 0], bx[:, 1], x_off, y_off, tif_bounds)
    xmax_m, ymin_m = pixels_to_mercator(bx[:, 2], bx[:, 3], x_off, y_off, tif_bounds)

    # EPSG:3035 corners for area measurement (geocode_results.py:177-178)
    ax0, ay1 = _crs.transform(3857, 3035, xmin_m, ymax_m)
    ax1, ay0 = _crs.transform(3857, 3035, xmax_m, ymin_m)
    if authority_order:  # reference's swapped unpacking
        ax0, ay1 = ay1, ax0
        ax1, ay0 = ay0, ax1

    geoms_3857 = [
        _poly.box(x0, y0, x1, y1) for x0, y0, x1, y1 in zip(xmin_m, ymin_m, xmax_m, ymax_m)
    ]
    df = pd.DataFrame(
        {
            "image": [encode_tile_name(s) for s in specs],
            "xmin": bx[:, 0].astype(np.int64),
            "ymin": bx[:, 1].astype(np.int64),
            "xmax": bx[:, 2].astype(np.int64),
            "ymax": bx[:, 3].astype(np.int64),
            "xmin_m": ax0,
            "xmax_m": ax1,
            "ymin_m": ay0,
            "ymax_m": ay1,
            "type": [REVERSE_CLASS_MAPPING[int(c)] for c in cls_id],
            "year": [s.year for s in specs],
            "det_conf": np.asarray(conf, np.float64),
        }
    )
    out = gf.GeoFrame(df, geometry=geoms_3857, crs=3857)
    return out.to_crs(4326)


def remove_land_detections(detections: "gf.GeoFrame", land: "gf.GeoFrame") -> "gf.GeoFrame":
    """Drop detections intersecting the land polygon set
    (reference geocode_results.py:200-218)."""
    land = land.to_crs(detections.crs)
    joined = detections.sjoin(land, how="inner")
    keep = ~detections.index.isin(joined.index)
    return detections[keep]
