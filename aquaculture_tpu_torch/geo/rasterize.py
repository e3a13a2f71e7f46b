"""Rasterization of geometries into boolean masks (rasterio.features
replacement, reference utils.py:513).

The polygon -> mask half of aquaculture_tpu/geo/rasterize.py, which the
land mask needs (post/landmask.py): fill and edge masks. Vectorization
(mask -> polygon) and zonal statistics come with the tonnage slice.
"""

from __future__ import annotations

import numpy as np

from aquaculture_tpu_torch.geo import polygon as _poly


def rasterize_ring(ring: np.ndarray, bounds, width: int, height: int) -> np.ndarray:
    """Scanline-rasterize one ring into a (height, width) bool mask.

    Row 0 is the TOP of the bounds (north-up image convention). A pixel is
    inside if its center is inside the ring.
    """
    minx, miny, maxx, maxy = bounds
    mask = np.zeros((height, width), dtype=bool)
    if len(ring) < 3 or maxx <= minx or maxy <= miny:
        return mask
    px_w = (maxx - minx) / width
    px_h = (maxy - miny) / height
    ys = maxy - (np.arange(height) + 0.5) * px_h  # pixel-center y, top row first
    x0, y0 = ring[:, 0], ring[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    dy = y1 - y0
    nonflat = dy != 0
    x0, y0, x1, y1, dy = x0[nonflat], y0[nonflat], x1[nonflat], y1[nonflat], dy[nonflat]
    if len(x0) == 0:
        return mask
    # For each scanline, x-crossings of each edge (E, H)
    t = (ys[None, :] - y0[:, None]) / dy[:, None]
    valid = (t >= 0) & (t < 1)
    xc = x0[:, None] + t * (x1[:, None] - x0[:, None])
    xs_center = minx + (np.arange(width) + 0.5) * px_w
    for j in range(height):
        cr = np.sort(xc[valid[:, j], j])
        if len(cr) < 2:
            continue
        # Pair up crossings (even-odd rule)
        for k in range(0, len(cr) - 1, 2):
            a, b = cr[k], cr[k + 1]
            mask[j, (xs_center >= a) & (xs_center < b)] = True
    return mask


def rasterize_geometry(geom, bounds, width: int, height: int) -> np.ndarray:
    """Rasterize any geometry (even-odd: holes carve out)."""
    mask = np.zeros((height, width), dtype=bool)
    if geom is None or geom.is_empty:
        return mask
    polys = geom.geoms if isinstance(geom, _poly.MultiPolygon) else [geom]
    for p in polys:
        m = rasterize_ring(p.exterior, bounds, width, height)
        for h in p.holes:
            m &= ~rasterize_ring(h, bounds, width, height)
        mask |= m
    return mask


def rasterize_edges(geom, bounds, width: int, height: int) -> np.ndarray:
    """Cells any ring edge (exterior or hole) passes through — conservative.

    Samples every edge at half-cell spacing and marks each sample's 3x3
    cell neighborhood, so the returned mask is a SUPERSET of the cells the
    boundary truly crosses. The guarantee the hybrid land filter needs is
    one-directional: a cell NOT marked here is crossed by no edge, hence
    uniformly inside or outside the geometry — center-sampled
    rasterize_geometry is exact on it.
    """
    mask = np.zeros((height, width), dtype=bool)
    if geom is None or geom.is_empty:
        return mask
    minx, miny, maxx, maxy = bounds
    if maxx <= minx or maxy <= miny:
        return mask
    px_w = (maxx - minx) / width
    px_h = (maxy - miny) / height
    step = 0.5 * min(px_w, px_h)
    polys = geom.geoms if isinstance(geom, _poly.MultiPolygon) else [geom]
    rings = []
    for p in polys:
        rings.append(np.asarray(p.exterior, np.float64))
        rings.extend(np.asarray(h, np.float64) for h in p.holes)
    for ring in rings:
        if len(ring) < 2:
            continue
        p0 = ring
        p1 = np.roll(ring, -1, axis=0)
        seg = p1 - p0
        lens = np.hypot(seg[:, 0], seg[:, 1])
        n = np.maximum(1, np.ceil(lens / step)).astype(np.int64)
        # t = j / n_i for j in 0..n_i per edge, flattened
        reps = n + 1
        edge_ix = np.repeat(np.arange(len(n)), reps)
        j = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
        t = j / n[edge_ix]
        pts = p0[edge_ix] + t[:, None] * seg[edge_ix]
        col = np.floor((pts[:, 0] - minx) / px_w).astype(np.int64)
        row = np.floor((maxy - pts[:, 1]) / px_h).astype(np.int64)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                r = row + dr
                c = col + dc
                ok = (r >= 0) & (r < height) & (c >= 0) & (c < width)
                mask[r[ok], c[ok]] = True
    return mask
