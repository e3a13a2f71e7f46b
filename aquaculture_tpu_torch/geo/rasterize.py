"""Rasterization and vectorization between geometries and boolean masks
(a copy of aquaculture_tpu/geo/rasterize.py).

Replaces rasterio.features (reference utils.py:513, utils_tonnage.py:629)
for the three uses the pipeline has:

* polygon -> mask    (zonal statistics, land-mask lookups)
* mask -> polygon    (largest non-blank region of a tile, utils.py:506-530)
* approximate boolean-op areas for non-rectilinear geometry
"""

from __future__ import annotations

from typing import List, Tuple

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


def _trace_boundary(mask: np.ndarray) -> List[np.ndarray]:
    """Trace outer boundaries of connected true-regions of a pixel mask.

    Returns rings in PIXEL coordinates where (x, y) = (col, row) and the ring
    follows pixel corners, matching rasterio.features.shapes' coordinate
    convention (reference utils.py:513-514). Holes are not traced (the
    reference keeps only the exterior ring of each shape).
    """
    h, w = mask.shape
    # Horizontal edges: between row j-1 and j (grid line j), cell transitions
    padded = np.zeros((h + 2, w + 2), dtype=bool)
    padded[1:-1, 1:-1] = mask
    # Build directed edge set for boundary: edge on grid where inside is to
    # the left (CCW outer rings in image space with y down -> clockwise in
    # math space; orientation is normalized by Polygon's constructor later).
    edges = {}

    def add_edge(p, q):
        edges.setdefault(p, []).append(q)

    for j in range(h + 1):
        for i in range(w):
            above = padded[j, i + 1]      # cell (j-1, i)
            below = padded[j + 1, i + 1]  # cell (j, i)
            if below and not above:
                add_edge((i, j), (i + 1, j))      # top edge of an inside cell: left→right
            elif above and not below:
                add_edge((i + 1, j), (i, j))      # bottom edge: right→left
    for i in range(w + 1):
        for j in range(h):
            left = padded[j + 1, i]       # cell (j, i-1)
            right = padded[j + 1, i + 1]  # cell (j, i)
            if right and not left:
                add_edge((i, j + 1), (i, j))      # left edge of inside cell: up
            elif left and not right:
                add_edge((i, j), (i, j + 1))      # right edge: down
    rings = []
    while edges:
        start = next(iter(edges))
        ring = [start]
        cur = start
        prev_dir = None
        while True:
            nxts = edges.get(cur)
            if not nxts:
                break
            # Prefer continuing straight to produce clean rings
            nxt = nxts.pop(0)
            if not edges.get(cur):
                edges.pop(cur, None)
            ring.append(nxt)
            cur = nxt
            if cur == start:
                break
        if len(ring) >= 4:
            rings.append(np.asarray(ring, dtype=np.float64))
    return rings


def shapes(mask: np.ndarray) -> List[Tuple[np.ndarray, int]]:
    """Extract (ring, value) exterior rings of true-regions of a mask.

    Equivalent of ``rasterio.features.shapes(mask)[... value == 1]`` as used
    at reference utils.py:513-514: connected components of the mask, each
    yielding its exterior ring in pixel corner coordinates.
    """
    labeled, n = _label(mask)
    out = []
    for lbl in range(1, n + 1):
        comp = labeled == lbl
        rings = _trace_boundary(comp)
        if not rings:
            continue
        # Keep the longest ring as the exterior
        ring = max(rings, key=lambda r: abs(_poly._ring_area(r[:-1])) if len(r) > 3 else 0)
        out.append((ring, 1))
    return out


def _label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected component labeling (two-pass union-find).

    4-connectivity (not 8) for TWO reasons: it matches
    rasterio.features.shapes' default, the exact function the reference
    calls (utils.py:513), AND it guarantees every component's boundary is
    a single ring — an 8-connected component joined only at a pixel
    corner has a pinched boundary that _trace_boundary splits into
    multiple rings, and shapes() keeping the longest silently dropped the
    far lobe (a fuzz finding)."""
    h, w = mask.shape
    labels = np.zeros((h, w), dtype=np.int32)
    parent = [0]

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def unite(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    nxt = 1
    for j in range(h):
        for i in range(w):
            if not mask[j, i]:
                continue
            neigh = []
            if j > 0 and labels[j - 1, i]:
                neigh.append(labels[j - 1, i])
            if i > 0 and labels[j, i - 1]:
                neigh.append(labels[j, i - 1])
            if neigh:
                m = min(neigh)
                labels[j, i] = m
                for nb in neigh:
                    unite(m, nb)
            else:
                parent.append(nxt)
                labels[j, i] = nxt
                nxt += 1
    # Second pass: flatten
    remap = {}
    count = 0
    for j in range(h):
        for i in range(w):
            if labels[j, i]:
                r = find(labels[j, i])
                if r not in remap:
                    count += 1
                    remap[r] = count
                labels[j, i] = remap[r]
    return labels, count


def largest_region_polygon(mask: np.ndarray) -> _poly.Polygon:
    """Largest connected true-region of a mask as a pixel-space Polygon
    (the reference's max-area shape selection, utils.py:515-522)."""
    best = None
    best_area = 0.0
    for ring, val in shapes(mask):
        p = _poly.Polygon(ring)
        if p.area > best_area:
            best, best_area = p, p.area
    return best if best is not None else _poly.Polygon()


def zonal_stats(geom, raster: np.ndarray, bounds, nodata=None, all_touched: bool = True) -> dict:
    """min/max/mean/count of raster cells under a geometry.

    Equivalent of rasterstats.zonal_stats (reference utils_tonnage.py:629-635).
    ``bounds`` is the raster's (minx, miny, maxx, maxy) with row 0 at maxy.
    ``all_touched`` extends membership to any pixel whose cell rectangle
    intersects the geometry's bounds-expanded mask (approximated by a
    half-pixel dilation, matching rasterstats' behavior for small polygons).
    """
    h, w = raster.shape
    mask = rasterize_geometry(geom, bounds, w, h)
    if all_touched and not mask.any() and geom is not None and not geom.is_empty:
        # Tiny polygon smaller than a pixel: mark the pixel under its centroid.
        c = geom.centroid
        minx, miny, maxx, maxy = bounds
        i = int((c.x - minx) / (maxx - minx) * w)
        j = int((maxy - c.y) / (maxy - miny) * h)
        if 0 <= i < w and 0 <= j < h:
            mask[j, i] = True
    elif all_touched and mask.any():
        # Dilate by one pixel (8-neighborhood) to include touched cells.
        d = mask.copy()
        d[1:, :] |= mask[:-1, :]
        d[:-1, :] |= mask[1:, :]
        d[:, 1:] |= mask[:, :-1]
        d[:, :-1] |= mask[:, 1:]
        mask = d
    vals = raster[mask]
    if nodata is not None:
        vals = vals[vals != nodata]
    vals = vals[np.isfinite(vals)]
    if len(vals) == 0:
        return {"min": None, "max": None, "mean": None, "count": 0}
    return {
        "min": float(vals.min()),
        "max": float(vals.max()),
        "mean": float(vals.mean()),
        "count": int(len(vals)),
    }
