"""Model-error distributions: detections vs human labels, per (period, type).
A copy of aquaculture_tpu/tonnage/errors.py in the PyTorch port.

Port of the reference's error fitting (reference: src/utils_tonnage.py:
130-327): match each detection to the human-labeled cage with highest
spatial overlap in the same year, take area differences, and fit a Normal
per (pass, cage_type). Also the label-side cage-area estimator
(compute_cage_area_estimates_gdf, utils_tonnage.py:206-281 semantics:
the same circle/square closed forms used for detections).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_AREA
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.post.areas import circle_areas, square_areas
from aquaculture_tpu_torch.post.dedup import deduplicate_gdf_with_bboxes


def compute_cage_area_estimates_gdf(gdf: "gf.GeoFrame", im_width: int = 1024, im_height: int = 1024) -> "gf.GeoFrame":
    """Append area estimates to human-label cages ('circle_cage' /
    'square_cage' types), using the same closed forms as detections.

    Expects pixel columns xmin/xmax/ymin/ymax and EPSG:3035 extents in
    xmin_m..ymax_m (the label files share the detection schema)."""
    w = (gdf["xmax_m"] - gdf["xmin_m"]).to_numpy(np.float64)
    h = (gdf["ymax_m"] - gdf["ymin_m"]).to_numpy(np.float64)
    jw = gdf["jpeg_width"].to_numpy() if "jpeg_width" in gdf.columns else np.full(len(gdf), im_width)
    jh = gdf["jpeg_height"].to_numpy() if "jpeg_height" in gdf.columns else np.full(len(gdf), im_height)
    xb = (gdf["xmin"].to_numpy() == 0) | (gdf["xmax"].to_numpy() == jw)
    yb = (gdf["ymin"].to_numpy() == 0) | (gdf["ymax"].to_numpy() == jh)
    types = gdf["type"].astype(str).str

    c_est, c_var, c_mn, c_mx = circle_areas(w, h, xb, yb)
    s_est, s_var, s_mn, s_mx = square_areas(w, h)
    is_circle = types.startswith("circle").to_numpy()
    out = gdf.copy()
    out["area"] = np.where(is_circle, c_est, s_est)
    out["area_var"] = np.where(is_circle, c_var, s_var)
    out["min_area"] = np.where(is_circle, c_mn, s_mn)
    out["max_area"] = np.where(is_circle, c_mx, s_mx)
    return out


def get_cage_area_errors_from_labels(query: "gf.GeoFrame", key: "gf.GeoFrame") -> pd.Series:
    """Per-detection error = best-overlap label area - detection area
    (reference utils_tonnage.py:284-327). Unmatched detections are dropped.

    Deliberate divergence from the reference: its overlap ranking
    intersects the 3035-projected query geometry with ``geometry_key``
    copied BEFORE ``to_crs`` (utils_tonnage.py:300,310-315) — geopandas
    transforms only the active geometry column, so the operands live in
    different CRSs, every overlap evaluates to 0, and "keep the highest
    overlap" degenerates to an unstable-sort-scrambled join order. Here the
    overlap is computed with both operands in EPSG:3035, so multi-match
    detections deterministically keep their true best-overlap label."""
    query = query.copy().reset_index(drop=True)
    query["index"] = query.index
    query.crs = query.crs or CRS_AREA

    q = query.to_crs(CRS_AREA)
    k = key.to_crs(CRS_AREA)
    k = k.copy()
    k["__key_pos"] = range(len(k))

    joined = q.sjoin(k, how="inner", predicate="intersects", lsuffix="query", rsuffix="key")
    if len(joined) == 0:
        return pd.Series([], dtype=float)
    joined = joined[joined["year_query"] == joined["year_key"]]

    kg = list(k["geometry"])
    overlaps = []
    for _, row in joined.iterrows():
        g_query = row["geometry"]
        g_key = kg[int(row["__key_pos"])]
        inter = _poly.intersection_area(g_query, g_key)
        overlaps.append(inter / g_query.area * 100 if g_query.area > 0 else 0.0)
    joined["spatial_overlap"] = overlaps
    joined = joined.sort_values("spatial_overlap", ascending=False, kind="stable")
    joined = joined.drop_duplicates(subset=["index"], keep="first")

    joined["area_key"] = joined["area_key"].fillna(0)
    return joined["area_key"] - joined["area_query"]


def _norm_fit(errors: np.ndarray) -> Tuple[float, float]:
    """scipy.stats.norm.fit equivalent: MLE mean and (biased) std."""
    e = np.asarray(errors, np.float64)
    if len(e) == 0:
        return 0.0, 0.0
    return float(e.mean()), float(e.std())


def define_model_error_distributions(
    cf_labels: "gf.GeoFrame",
    detections_df: "gf.GeoFrame",
    dedup_boxes: "gf.GeoFrame",
    selected_map: Callable,
    confidence_threshold: float,
) -> pd.DataFrame:
    """Normal (mean, sd) of area errors per (pass, farm_type)
    (reference utils_tonnage.py:130-203)."""
    cf = cf_labels[cf_labels["type"].isin(["circle_cage", "square_cage"])].copy()
    cf.crs = cf_labels.crs
    cf["bbox_ind"] = cf["image"].str.split("_").str[1]
    det = detections_df.copy()
    det.crs = detections_df.crs
    det["bbox_ind"] = det["image"].str.split("_").str[1]

    cf = deduplicate_gdf_with_bboxes(dedup_boxes, cf)
    det = deduplicate_gdf_with_bboxes(dedup_boxes, det)

    cf["pass"] = cf["year"].astype(int).map(selected_map)
    det["pass"] = det["year"].astype(int).map(selected_map)

    cf = compute_cage_area_estimates_gdf(cf)
    det = det[det["det_conf"] > confidence_threshold]
    det.crs = detections_df.crs

    rows = []
    for period_pass in sorted(cf["pass"].unique()):
        for cage_type in ("circle", "square"):
            labels = cf[(cf["pass"] == period_pass) & (cf["type"] == f"{cage_type}_cage")]
            preds = det[(det["pass"] == period_pass) & (det["type"] == f"{cage_type}_farm")]
            labels.crs = cf.crs
            preds.crs = det.crs
            query = gf.GeoFrame(
                pd.DataFrame(
                    {"year": preds["year"].to_numpy(), "area": preds["area"].to_numpy()}
                ),
                geometry=list(preds["geometry"]),
                crs=preds.crs,
            )
            key = gf.GeoFrame(
                pd.DataFrame(
                    {"year": labels["year"].to_numpy(), "area": labels["area"].to_numpy()}
                ),
                geometry=list(labels["geometry"]),
                crs=labels.crs,
            )
            errors = get_cage_area_errors_from_labels(query, key)
            mu, std = _norm_fit(errors.to_numpy())
            rows.append(
                {
                    "pass": period_pass,
                    "farm_type": f"{cage_type}_farm",
                    "model_error_mean": mu,
                    "model_error_sd": std,
                }
            )
    return pd.DataFrame(rows)
