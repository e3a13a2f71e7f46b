"""Polygon buffering (dilation/erosion) on the exact boolean engine.
A copy of aquaculture_tpu/geo/buffer.py in the PyTorch port.

GEOS capability used by the reference to widen shorelines before coastal
tiling (reference: src/load_data/download_french_data.py:223-227,
``world_shorelines.buffer(2000)``).

Construction: the Minkowski sum of a polygon with a disc equals the polygon
unioned with one "capsule" (rectangle + two disc caps) per boundary edge —
of every ring, holes included, so hole margins fill in correctly. Erosion
(negative distance) subtracts the same capsules instead, which erodes from
all boundaries; straight edges and convex corners erode exactly, so
``box(0,0,10,10).buffer(-1)`` is exactly ``box(1,1,9,9)``.

The disc caps are ``4*quad_segs``-gon approximations (shapely's default
quad_segs=8 -> 32-gon), so dilated corners are polygonal arcs with the same
resolution shapely produces. Exactness is then up to the boolean engine's
documented lattice quantization.
"""

from __future__ import annotations

from typing import List

import numpy as np

from aquaculture_tpu_torch.geo import polygon as _poly


def _disc(cx: float, cy: float, r: float, n: int) -> "_poly.Polygon":
    th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    return _poly.Polygon(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1))


def _capsule(p0: np.ndarray, p1: np.ndarray, r: float, n: int) -> "_poly.Polygon":
    """Stadium shape around segment p0-p1: two half-disc caps joined by the
    offset sides. One simple CCW polygon."""
    d = p1 - p0
    L = float(np.hypot(d[0], d[1]))
    if L < 1e-12:
        return _disc(float(p0[0]), float(p0[1]), r, n)
    ang = float(np.arctan2(d[1], d[0]))
    half = max(2, n // 2)
    # arc around p1 from ang-90° to ang+90°, then around p0 from ang+90° to ang+270°
    t1 = ang - np.pi / 2 + np.linspace(0.0, np.pi, half + 1)
    t0 = ang + np.pi / 2 + np.linspace(0.0, np.pi, half + 1)
    pts = np.concatenate(
        [
            p1[None, :] + r * np.stack([np.cos(t1), np.sin(t1)], 1),
            p0[None, :] + r * np.stack([np.cos(t0), np.sin(t0)], 1),
        ]
    )
    return _poly.Polygon(pts)


def _ring_capsules(ring: np.ndarray, r: float, n: int) -> List["_poly.Polygon"]:
    ring = np.asarray(ring, dtype=np.float64)
    if len(ring) >= 2 and np.allclose(ring[0], ring[-1]):
        ring = ring[:-1]
    out = []
    for i in range(len(ring)):
        out.append(_capsule(ring[i], ring[(i + 1) % len(ring)], r, n))
    return out


def buffer(geom: "_poly.Geometry", distance: float, quad_segs: int = 8) -> "_poly.Geometry":
    """Dilate (distance > 0) or erode (distance < 0) a geometry.

    Supports Point (dilation -> disc), LineString/MultiLineString
    (dilation -> capsule band; erosion -> empty), Polygon and MultiPolygon
    (with holes). distance == 0 returns the geometry unchanged (the
    reference's buffer(0) validity idiom, utils_tonnage.py:1017).
    """
    from aquaculture_tpu_torch.geo.boolean import boolean_op, unary_union_tree

    if distance == 0 or geom.is_empty:
        return geom
    n = max(8, 4 * int(quad_segs))
    r = abs(float(distance))

    if isinstance(geom, _poly.Point):
        if distance < 0:
            return _poly.EMPTY
        return _disc(geom.x, geom.y, r, n)

    if isinstance(geom, (_poly.LineString, _poly.MultiLineString)):
        # Polyline dilation = union of per-segment capsules — the
        # reference's shoreline buffering use-case
        # (download_french_data.py:216-227 buffers GSHHG coastline
        # POLYLINE linework into the coastal search band). A line has no
        # interior, so erosion is empty.
        if distance < 0:
            return _poly.EMPTY
        lines = geom.geoms if isinstance(geom, _poly.MultiLineString) else [geom]
        pieces = []
        for ln in lines:
            c = ln.coords
            for i in range(len(c) - 1):
                pieces.append(_capsule(c[i], c[i + 1], r, n))
        if not pieces:
            return _poly.EMPTY
        return unary_union_tree(pieces)

    polys = geom.geoms if isinstance(geom, _poly.MultiPolygon) else [geom]
    pieces: List["_poly.Polygon"] = []
    for p in polys:
        pieces.extend(_ring_capsules(p.exterior, r, n))
        for h in p.holes:
            pieces.extend(_ring_capsules(h, r, n))
    band = unary_union_tree(pieces)
    op = "union" if distance > 0 else "difference"
    return boolean_op(geom, band, op)
