"""Vectorized axis-aligned box operations (numpy, host).

A copy of aquaculture_tpu/geo/boxes.py. Boxes are ``(..., 4)`` arrays
``[xmin, ymin, xmax, ymax]``.
"""

from __future__ import annotations

import numpy as np


def box_area(boxes):
    """Areas of ``(..., 4)`` boxes; degenerate boxes clamp to 0."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return np.maximum(w, 0) * np.maximum(h, 0)


def box_intersection(a, b):
    """Pairwise intersection boxes of two broadcastable box arrays."""
    lo = np.maximum(a[..., :2], b[..., :2])
    hi = np.minimum(a[..., 2:], b[..., 2:])
    return np.concatenate([lo, hi], axis=-1)


def boxes_intersect(a, b):
    """Boolean: do the boxes overlap (closed boxes: touching edges count,
    matching shapely's ``intersects`` predicate used in reference sjoins)."""
    return (
        (a[..., 0] <= b[..., 2])
        & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3])
        & (b[..., 1] <= a[..., 3])
    )


def box_iou(a, b):
    """IoU between ``(N, 4)`` and ``(M, 4)`` boxes -> ``(N, M)``."""
    inter = box_area(box_intersection(a[:, None, :], b[None, :, :]))
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def pairwise_intersects(a, b):
    """Intersects matrix between ``(N, 4)`` and ``(M, 4)`` boxes -> ``(N, M)`` bool."""
    return boxes_intersect(a[:, None, :], b[None, :, :])


def cxcywh_to_xyxy(boxes):
    """Convert ``[cx, cy, w, h]`` boxes to ``[xmin, ymin, xmax, ymax]``."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


def xyxy_to_cxcywh(boxes):
    """Convert ``[xmin, ymin, xmax, ymax]`` boxes to ``[cx, cy, w, h]``."""
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=-1)
