"""Cage surface-area estimation from bounding boxes — vectorized (a copy of
aquaculture_tpu/post/areas.py).

Closed-form port of the reference's per-row loop (reference:
src/process_yolo/calc_net_areas.py:24-151):

* circle cages: ellipse area pi*a*b; when the box touches an image border
  the truth is interval-bounded (triangle .. quarter/half ellipse) with
  mean = midpoint and Var = (max-min)^2 / 12 (uniform-interval variance)
* square cages: orientation within the box is uniform, so area is in
  [wh/2, wh] with the same midpoint/variance rule
* other types (triangle/other/rectangle) are not assigned areas by the
  reference (its analysis keeps circle/square only); we apply the square
  rule as the conservative default so downstream stays total.
"""

from __future__ import annotations

import numpy as np


def circle_areas(
    w: np.ndarray, h: np.ndarray, x_border: np.ndarray, y_border: np.ndarray
):
    """(estimate, var, min, max) for circle cages, vectorized."""
    w = np.asarray(w, np.float64)
    h = np.asarray(h, np.float64)
    x_border = np.asarray(x_border, bool)
    y_border = np.asarray(y_border, bool)

    full = np.pi * (w / 2) * (h / 2)
    min_area = w * h / 2  # triangle lower bound at any border
    # upper bound: quarter ellipse on a corner, half ellipse on one border
    max_corner = np.pi * h * w / 4
    max_x = np.pi * (h / 2) * w / 2
    max_y = np.pi * h * (w / 2) / 2
    max_area = np.where(x_border & y_border, max_corner, np.where(x_border, max_x, max_y))

    on_border = x_border | y_border
    est = np.where(on_border, (min_area + max_area) / 2, full)
    var = np.where(on_border, (max_area - min_area) ** 2 / 12.0, 0.0)
    mn = np.where(on_border, min_area, full)
    mx = np.where(on_border, max_area, full)
    return est, var, mn, mx


def square_areas(w: np.ndarray, h: np.ndarray):
    """(estimate, var, min, max) for square cages under uniform orientation."""
    w = np.asarray(w, np.float64)
    h = np.asarray(h, np.float64)
    min_area = w * h / 2
    max_area = w * h
    est = (min_area + max_area) / 2
    var = (max_area - min_area) ** 2 / 12.0
    return est, var, min_area, max_area


def cage_areas(detections, im_width: int = 1024, im_height: int = 1024):
    """Append area/area_var/min_area/max_area columns to a detections
    GeoFrame (reference calc_all_areas, calc_net_areas.py:85-151).

    Border flags use the pixel columns against the tile dims
    (calc_net_areas.py:124-132).
    """
    w = (detections["xmax_m"] - detections["xmin_m"]).to_numpy(np.float64)
    h = (detections["ymax_m"] - detections["ymin_m"]).to_numpy(np.float64)
    xb = (detections["xmin"].to_numpy() == 0) | (detections["xmax"].to_numpy() == im_width)
    yb = (detections["ymin"].to_numpy() == 0) | (detections["ymax"].to_numpy() == im_height)
    types = detections["type"].to_numpy()

    c_est, c_var, c_mn, c_mx = circle_areas(w, h, xb, yb)
    s_est, s_var, s_mn, s_mx = square_areas(w, h)

    is_circle = types == "circle_farm"
    out = detections.copy()
    out["area"] = np.where(is_circle, c_est, s_est)
    out["area_var"] = np.where(is_circle, c_var, s_var)
    out["min_area"] = np.where(is_circle, c_mn, s_mn)
    out["max_area"] = np.where(is_circle, c_mx, s_mx)
    return out
