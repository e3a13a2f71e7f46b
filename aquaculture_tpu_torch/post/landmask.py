"""Rasterized land mask: O(1) per-detection land lookup.

A copy of aquaculture_tpu/post/landmask.py. The exact polygon sjoin
(post.geocode.remove_land_detections) is fine for thousands of detections;
corpus-scale filtering rasterizes the land polygons ONCE into a boolean
grid, so that land classification is a vectorized gather per detection. Coastline detail below the cell size is lost; pick resolution
accordingly (the reference's own land filter is a coarse political
coastline).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.geo.rasterize import rasterize_edges, rasterize_geometry


@dataclasses.dataclass
class LandMask:
    mask: np.ndarray  # (H, W) bool, row 0 = north
    bounds: tuple     # (minx, miny, maxx, maxy) in `crs`
    crs: int
    # cells any land-polygon EDGE passes through (conservative superset;
    # geo.rasterize.rasterize_edges). Cells NOT in it are uniformly
    # land/water, which is what makes the hybrid filter exact.
    boundary: Optional[np.ndarray] = None

    def contains(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Vectorized point-on-land lookup (points outside bounds: False)."""
        minx, miny, maxx, maxy = self.bounds
        h, w = self.mask.shape
        fx = (np.asarray(x, np.float64) - minx) / (maxx - minx)
        fy = (maxy - np.asarray(y, np.float64)) / (maxy - miny)
        col = np.floor(fx * w).astype(np.int64)
        row = np.floor(fy * h).astype(np.int64)
        inside = (col >= 0) & (col < w) & (row >= 0) & (row < h)
        out = np.zeros(len(np.atleast_1d(col)), bool)
        cc = np.clip(col, 0, w - 1)
        rr = np.clip(row, 0, h - 1)
        out = np.where(inside, self.mask[rr, cc], False)
        return out

    def box_status(self, boxes: np.ndarray) -> np.ndarray:
        """Classify axis-aligned boxes (N, 4 = minx,miny,maxx,maxy):
        0 = certainly water, 1 = certainly touches land, 2 = boundary
        (needs an exact test). Requires ``boundary`` (build_land_mask
        with_boundary=True)."""
        if self.boundary is None:
            raise ValueError("box_status needs a boundary mask "
                             "(build_land_mask(..., with_boundary=True))")
        b = np.asarray(boxes, np.float64).reshape(-1, 4)
        minx, miny, maxx, maxy = self.bounds
        h, w = self.mask.shape
        pw = (maxx - minx) / w
        ph = (maxy - miny) / h
        c0 = np.floor((b[:, 0] - minx) / pw).astype(np.int64)
        c1 = np.floor((b[:, 2] - minx) / pw).astype(np.int64)
        r0 = np.floor((maxy - b[:, 3]) / ph).astype(np.int64)
        r1 = np.floor((maxy - b[:, 1]) / ph).astype(np.int64)
        overlaps = (c1 >= 0) & (c0 < w) & (r1 >= 0) & (r0 < h)
        out = np.zeros(len(b), np.int8)  # off-grid boxes: water
        todo = np.nonzero(overlaps)[0]
        if not len(todo):
            return out
        c0t = np.clip(c0[todo], 0, w - 1)
        c1t = np.clip(c1[todo], 0, w - 1)
        r0t = np.clip(r0[todo], 0, h - 1)
        r1t = np.clip(r1[todo], 0, h - 1)
        # detection boxes are a few cells; gather the (sr, sc) window per
        # box in one broadcast. Oversized outliers go one-by-one.
        big = (r1t - r0t + 1).astype(np.int64) * (c1t - c0t + 1) > 4096
        for i, rr0, rr1, cc0, cc1 in zip(
            todo[big], r0t[big], r1t[big], c0t[big], c1t[big]
        ):
            win_b = self.boundary[rr0:rr1 + 1, cc0:cc1 + 1]
            win_l = self.mask[rr0:rr1 + 1, cc0:cc1 + 1]
            out[i] = 2 if win_b.any() else (1 if win_l.any() else 0)
        todo, r0t, r1t, c0t, c1t = (
            a[~big] for a in (todo, r0t, r1t, c0t, c1t))
        if len(todo):
            # Chunk the broadcast gather so one large-window box can't
            # size the (N, sr, sc) scratch for ALL boxes: sorted by window
            # area, each chunk keeps n_chunk * max_window_cells under a
            # fixed cell budget (~16 MB bool per gather), so memory is
            # bounded at corpus scale instead of max_window * N.
            areas = ((r1t - r0t + 1) * (c1t - c0t + 1)).astype(np.int64)
            order = np.argsort(areas, kind="stable")
            budget = 1 << 24
            pos = 0
            while pos < len(order):
                end = pos + 1
                while end < len(order) and (
                    (end + 1 - pos) * areas[order[end]] <= budget
                ):
                    end += 1
                sel = order[pos:end]
                pos = end
                sr = int((r1t[sel] - r0t[sel]).max()) + 1
                sc = int((c1t[sel] - c0t[sel]).max()) + 1
                rows = r0t[sel, None] + np.arange(sr)[None, :]
                cols = c0t[sel, None] + np.arange(sc)[None, :]
                rv = rows <= r1t[sel, None]
                cv = cols <= c1t[sel, None]
                rows = np.minimum(rows, h - 1)
                cols = np.minimum(cols, w - 1)
                valid = rv[:, :, None] & cv[:, None, :]
                any_b = (self.boundary[rows[:, :, None], cols[:, None, :]] & valid).any((1, 2))
                any_l = (self.mask[rows[:, :, None], cols[:, None, :]] & valid).any((1, 2))
                out[todo[sel]] = np.where(any_b, 2, np.where(any_l, 1, 0)).astype(np.int8)
        return out


def build_land_mask(
    land: "gf.GeoFrame",
    resolution_m: float = 50.0,
    crs: int = 3857,
    bounds: Optional[tuple] = None,
    max_cells: int = 64_000_000,
    with_boundary: bool = False,
) -> LandMask:
    """Rasterize land polygons to a boolean grid at ~resolution_m.

    ``resolution_m`` is the cell size in units of ``crs`` (meters for
    3857/3035, degrees for 4326 — callers convert)."""
    land_p = land.to_crs(crs)
    land_p.crs = crs
    if bounds is None:
        b = land_p.bounds_array()
        bounds = (
            float(np.nanmin(b[:, 0])),
            float(np.nanmin(b[:, 1])),
            float(np.nanmax(b[:, 2])),
            float(np.nanmax(b[:, 3])),
        )
    minx, miny, maxx, maxy = bounds
    w = max(int(np.ceil((maxx - minx) / resolution_m)), 1)
    h = max(int(np.ceil((maxy - miny) / resolution_m)), 1)
    if w * h > max_cells:
        raise ValueError(f"land mask {w}x{h} exceeds max_cells; raise resolution_m")
    mask = np.zeros((h, w), bool)
    boundary = np.zeros((h, w), bool) if with_boundary else None
    for g in land_p["geometry"]:
        if g is None or g.is_empty:
            continue
        mask |= rasterize_geometry(g, bounds, w, h)
        if with_boundary:
            boundary |= rasterize_edges(g, bounds, w, h)
    return LandMask(mask=mask, bounds=bounds, crs=crs, boundary=boundary)


def remove_land_detections_hybrid(
    detections: "gf.GeoFrame",
    land: "gf.GeoFrame",
    mask: Optional[LandMask] = None,
    resolution_m: float = 50.0,
) -> "gf.GeoFrame":
    """EXACTLY post.geocode.remove_land_detections, at near-mask speed.

    Three-way split on the boundary-aware mask (box_status): detections
    whose bbox window contains no land cell are certainly water (kept —
    cells free of polygon edges are uniformly land/water, so the
    center-sampled fill mask is exact there); bboxes over land-only
    windows are certainly intersecting (dropped — valid when the geometry
    fills its bbox, i.e. axis-aligned boxes; others fall through); only
    the boundary-window remainder pays the exact polygon sjoin
    (reference semantics: geocode_results.py:200-218). Results are
    row-for-row identical to the exact filter; only the cost moves.

    Exactness requires the mask to be rasterized in the detections' CRS
    AND to cover the land's full extent (see the inline comments); a
    provided ``mask`` violating either is rebuilt.
    """
    from aquaculture_tpu_torch.post.geocode import remove_land_detections

    if len(detections) == 0:
        return detections
    rebuild = mask is None or mask.boundary is None or mask.crs != detections.crs
    if not rebuild:
        # A caller-provided mask must also COVER the land: box_status
        # treats off-grid boxes as "certainly water", which is only exact
        # if no land exists outside the grid. A mask built over an AOI
        # subset of the land would silently keep on-land detections
        # beyond its bounds — rebuild instead of trusting it. (A mask
        # built from DIFFERENT land polygons is uncheckable; the contract
        # is that ``mask`` was built from this ``land``.)
        lb = land.to_crs(detections.crs).bounds_array()
        eps = 1e-9
        rebuild = not (
            mask.bounds[0] <= float(np.nanmin(lb[:, 0])) + eps
            and mask.bounds[1] <= float(np.nanmin(lb[:, 1])) + eps
            and mask.bounds[2] >= float(np.nanmax(lb[:, 2])) - eps
            and mask.bounds[3] >= float(np.nanmax(lb[:, 3])) - eps
        )
    if rebuild:
        # Classify in the DETECTIONS' CRS. The exact filter sjoins against
        # land.to_crs(detections.crs) — STRAIGHT segments in that space.
        # Rasterizing in any other CRS tests the chord between reprojected
        # vertices, which for a long polygon segment deviates from the
        # true reprojected edge by arbitrarily many cells (kilometres for
        # EEZ-scale faces, not sub-mm), silently flipping "certain" cells.
        # Same-CRS rasterization sees the identical straight-segment
        # geometry, so edge-free cells really are uniformly land/water and
        # exactness holds. resolution_m is converted to CRS units only
        # approximately — exactness is resolution-independent (cell size
        # just sets the exact-tested boundary-band width) — and the grid
        # auto-coarsens to fit the cell budget instead of erroring at
        # country-scale bounds. A caller-provided mask in a different CRS
        # is rebuilt here for the same reason.
        target = detections.crs
        unit_per_m = (1.0 / 111_320.0) if target == 4326 else 1.0
        land_t = land.to_crs(target)
        land_t.crs = target
        b = land_t.bounds_array()
        span_x = float(np.nanmax(b[:, 2]) - np.nanmin(b[:, 0]))
        span_y = float(np.nanmax(b[:, 3]) - np.nanmin(b[:, 1]))
        budget = 32_000_000
        fit = ((span_x * span_y) / budget) ** 0.5 if span_x > 0 and span_y > 0 else 0.0
        res = max(resolution_m * unit_per_m, fit)
        # land_t is already in the target crs — hand it over so
        # build_land_mask's to_crs is a cheap copy, not a reprojection
        mask = build_land_mask(
            land_t, resolution_m=res, crs=target, with_boundary=True,
            max_cells=2 * budget,
        )
    bb = detections.bounds_array()
    status = mask.box_status(bb)
    water = status == 0
    land_hit = status == 1
    # "certainly land" is only a certain INTERSECTION for geometries that
    # fill their bbox (axis-aligned rectangles); others fall through to
    # the exact test. Area is only consulted for status==1 rows, so only
    # compute it there (it's a per-geometry Python loop).
    fills_bbox = np.zeros(len(detections), bool)
    idx = np.nonzero(land_hit)[0]
    if len(idx):
        geoms = detections["geometry"].to_numpy()
        bba = (bb[idx, 2] - bb[idx, 0]) * (bb[idx, 3] - bb[idx, 1])
        areas = np.array([geoms[i].area for i in idx], np.float64)
        fills_bbox[idx] = np.isclose(areas, bba, rtol=1e-9)
    needs_exact = (status == 2) | (land_hit & ~fills_bbox)
    exact_keep = np.zeros(len(detections), bool)
    if needs_exact.any():
        sub = detections[needs_exact].copy()
        sub.crs = detections.crs
        kept = remove_land_detections(sub, land)
        exact_keep = (
            np.asarray(detections.index.isin(kept.index)) & needs_exact
        )
    out = detections[water | exact_keep].copy()
    out.crs = detections.crs
    return out


def remove_land_detections_masked(detections: "gf.GeoFrame", mask: LandMask) -> "gf.GeoFrame":
    """Mask-based equivalent of remove_land_detections: drop detections
    whose centroid falls on a land cell."""
    dets = detections.to_crs(mask.crs)
    cx = np.asarray([g.centroid.x for g in dets["geometry"]])
    cy = np.asarray([g.centroid.y for g in dets["geometry"]])
    on_land = mask.contains(cx, cy) if len(dets) else np.zeros(0, bool)
    out = detections[~on_land].copy()
    out.crs = detections.crs
    return out
