"""Ear-clipping triangulation and exact intersection areas for arbitrary
simple polygons.
A copy of aquaculture_tpu/geo/triangulate.py in the PyTorch port.

Upgrades the geometry engine's last approximation: area(a ∩ b) for
non-convex operands. Each polygon decomposes into a SIGNED triangle soup
(+1 triangles for the exterior ring, -1 for holes — holes lie inside the
exterior, so inclusion-exclusion over the products of signs is exact):

    area(a ∩ b) = Σ_ij sign_i · sign_j · area(tri_i ∩ tri_j)

Triangle ∩ triangle is exact via the Sutherland-Hodgman convex clip. This
replaces the rasterized fallback (kept only as a test oracle).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from aquaculture_tpu_torch.geo import polygon as _poly


def _tri_area2(a, b, c) -> float:
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def _point_in_tri(p, a, b, c, eps: float) -> bool:
    d1 = _tri_area2(p, a, b)
    d2 = _tri_area2(p, b, c)
    d3 = _tri_area2(p, c, a)
    has_neg = (d1 < -eps) or (d2 < -eps) or (d3 < -eps)
    has_pos = (d1 > eps) or (d2 > eps) or (d3 > eps)
    return not (has_neg and has_pos)


def ear_clip(ring: np.ndarray) -> List[np.ndarray]:
    """Triangulate a simple CCW ring (no holes) into (3, 2) triangles.

    Classic O(n^2) ear clipping with a collinear-vertex fallback: a vertex
    chain with zero-area ears is snipped anyway (contributes no area).
    """
    pts = np.asarray(ring, np.float64).reshape(-1, 2)
    if len(pts) and np.array_equal(pts[0], pts[-1]):
        pts = pts[:-1]
    n = len(pts)
    if n < 3:
        return []
    # ensure CCW
    x = pts[:, 0] - pts[:, 0].mean()
    y = pts[:, 1] - pts[:, 1].mean()
    if 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) < 0:
        pts = pts[::-1]

    scale = max(float(np.abs(pts - pts.mean(0)).max()), 1e-12)
    eps = 1e-12 * scale * scale

    idx = list(range(len(pts)))
    tris: List[np.ndarray] = []
    guard = 0
    while len(idx) > 3 and guard < 10 * n * n:
        guard += 1
        found = False
        for k in range(len(idx)):
            i0 = idx[k - 1]
            i1 = idx[k]
            i2 = idx[(k + 1) % len(idx)]
            a, b, c = pts[i0], pts[i1], pts[i2]
            cross = _tri_area2(a, b, c)
            if cross <= eps:  # reflex or degenerate: not an ear
                continue
            # no other active vertex strictly inside
            ok = True
            for j in idx:
                if j in (i0, i1, i2):
                    continue
                if _point_in_tri(pts[j], a, b, c, eps):
                    ok = False
                    break
            if ok:
                tris.append(np.asarray([a, b, c]))
                idx.pop(k)
                found = True
                break
        if not found:
            # numerically stuck (collinear runs): snip the most convex vertex
            best_k, best_cross = 0, -np.inf
            for k in range(len(idx)):
                a = pts[idx[k - 1]]
                b = pts[idx[k]]
                c = pts[idx[(k + 1) % len(idx)]]
                cr = _tri_area2(a, b, c)
                if cr > best_cross:
                    best_cross, best_k = cr, k
            a = pts[idx[best_k - 1]]
            b = pts[idx[best_k]]
            c = pts[idx[(best_k + 1) % len(idx)]]
            if best_cross > eps:
                tris.append(np.asarray([a, b, c]))
            idx.pop(best_k)
    if len(idx) == 3:
        a, b, c = pts[idx[0]], pts[idx[1]], pts[idx[2]]
        if _tri_area2(a, b, c) > eps:
            tris.append(np.asarray([a, b, c]))
    return tris


def signed_triangles(g: _poly.Geometry) -> List[Tuple[np.ndarray, float]]:
    """Polygon/MultiPolygon -> [(triangle, sign)] soup (holes negative)."""
    polys = g.geoms if isinstance(g, _poly.MultiPolygon) else [g]
    out: List[Tuple[np.ndarray, float]] = []
    for p in polys:
        if not isinstance(p, _poly.Polygon) or p.is_empty:
            continue
        for t in ear_clip(p.exterior):
            out.append((t, 1.0))
        for h in p.holes:
            for t in ear_clip(h):
                out.append((t, -1.0))
    return out


def _tri_clip_area(t1: np.ndarray, t2: np.ndarray) -> float:
    """Exact area of triangle ∩ triangle via convex clipping."""
    ring = _poly._convex_clip(t1, t2)
    if len(ring) < 3:
        return 0.0
    x = ring[:, 0] - ring[:, 0].mean()
    y = ring[:, 1] - ring[:, 1].mean()
    return abs(0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))


def exact_intersection_area(a: _poly.Geometry, b: _poly.Geometry) -> float:
    """Exact area(a ∩ b) for simple polygons / multipolygons with holes."""
    ta = signed_triangles(a)
    tb = signed_triangles(b)
    if not ta or not tb:
        return 0.0
    # bounds prefilter per triangle
    ba = np.asarray([[t[:, 0].min(), t[:, 1].min(), t[:, 0].max(), t[:, 1].max()] for t, _ in ta])
    bb = np.asarray([[t[:, 0].min(), t[:, 1].min(), t[:, 0].max(), t[:, 1].max()] for t, _ in tb])
    total = 0.0
    for i, (t1, s1) in enumerate(ta):
        ov = (
            (bb[:, 0] < ba[i, 2]) & (bb[:, 2] > ba[i, 0])
            & (bb[:, 1] < ba[i, 3]) & (bb[:, 3] > ba[i, 1])
        )
        for j in np.nonzero(ov)[0]:
            t2, s2 = tb[j]
            total += s1 * s2 * _tri_clip_area(t1, t2)
    return max(total, 0.0)
