"""Overlapping-imagery deduplication via exact rectilinear region algebra.

The download boxes overlap (adjacent 1200 m boxes share borders across WMS
requests); the reference deduplicates by a greedy pass — each box keeps only
the part not covered by earlier boxes — then clips every detection to its
box's surviving region (reference: src/utils.py:241-322). GEOS overlay is
replaced by :mod:`aquaculture_tpu_torch.geo.region`: boxes and their successive
differences are rectilinear, so the difference is exact and near-linear via
a bounds grid. A copy of aquaculture_tpu/post/dedup.py.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.geo.region import Region, from_geometry as _region_of, to_geometry as _region_to_geom


def deduplicate_download_boxes(bboxes: "gf.GeoFrame") -> "gf.GeoFrame":
    """Greedy coverage dedup: box i keeps (box_i \\ union of boxes < i).

    Matches reference utils.py:241-273 semantics; returns a GeoFrame in
    EPSG:3857 with a ``bbox_ind`` column, dropping fully-covered boxes.
    """
    bboxes = bboxes.to_crs(3857)
    inds = list(bboxes.index)
    geoms = list(bboxes["geometry"])
    kept_inds, kept_geoms = [], []
    coverage: Optional[Region] = None
    for ind, g in zip(inds, geoms):
        r = _region_of(g)
        if coverage is None:
            new = r
            coverage = r
        else:
            new = r.difference(coverage)
            if not new.is_empty:
                coverage = coverage.union(new)
        if ind == inds[0] or not new.is_empty:
            # reference keeps row 0 unconditionally (utils.py:256)
            kept_inds.append(ind)
            kept_geoms.append(_region_to_geom(new if ind != inds[0] else r))
    out = gf.GeoFrame({"bbox_ind": kept_inds}, geometry=kept_geoms, crs=3857)
    out.index = kept_inds
    return out


def deduplicate_gdf_with_bboxes(dedup_boxes: "gf.GeoFrame", gdf: "gf.GeoFrame") -> "gf.GeoFrame":
    """Clip each row's geometry to its download box's deduped region; drop
    rows whose geometry empties (reference utils.py:276-322)."""
    if "bbox_ind" not in gdf.columns:
        raise ValueError("gdf must include a bbox_ind column")
    src_crs = gdf.crs
    dedup_boxes = dedup_boxes.to_crs(3857)
    gdf = gdf.to_crs(3857)

    region_by_ind: Dict[int, Region] = {
        int(bi): _region_of(g)
        for bi, g in zip(dedup_boxes["bbox_ind"], dedup_boxes["geometry"])
    }

    # Vectorized fast path: a row whose geometry bbox lies inside ONE rect
    # of its box's surviving region is unchanged by the clip (bbox ⊆ rect
    # ⟹ geometry ⊆ region ⟹ intersection == geometry). In a real corpus
    # most boxes survive dedup whole, so this skips the Region algebra for
    # the vast majority of rows.
    bnds = gdf.bounds_array()
    binds = np.asarray([int(b) for b in gdf["bbox_ind"]], np.int64)
    contained = np.zeros(len(gdf), bool)
    order = np.argsort(binds, kind="stable")
    uniq, starts = np.unique(binds[order], return_index=True)
    for gi, bi in enumerate(uniq):
        reg = region_by_ind.get(int(bi))
        if reg is None or reg.is_empty:
            continue
        stop = starts[gi + 1] if gi + 1 < len(starts) else len(order)
        rows = order[starts[gi]:stop]
        b = bnds[rows]
        r = reg.rects
        inside = (
            (b[:, None, 0] >= r[None, :, 0])
            & (b[:, None, 1] >= r[None, :, 1])
            & (b[:, None, 2] <= r[None, :, 2])
            & (b[:, None, 3] <= r[None, :, 3])
        ).any(axis=1)
        contained[rows[inside]] = True

    keep_rows = []
    new_geoms = []
    geoms = list(gdf["geometry"])
    for idx, (bi, g) in enumerate(zip(binds, geoms)):
        if contained[idx]:
            keep_rows.append(idx)
            new_geoms.append(g)
            continue
        reg = region_by_ind.get(int(bi))
        if reg is None:
            continue
        clipped = _region_of(g).intersection(reg)
        if clipped.is_empty:
            continue
        keep_rows.append(idx)
        new_geoms.append(_region_to_geom(clipped))

    out = gdf.iloc[keep_rows].copy()
    out["geometry"] = new_geoms
    out.crs = 3857
    return out.to_crs(src_crs)


def nms_cross_tile(det: "gf.GeoFrame", iou_thresh: float = 0.5) -> "gf.GeoFrame":
    """Greedy confidence-ordered IoU dedup across overlapping tiles.

    Overlap serving (pipeline.run_pipeline(overlap=...)) detects the same
    physical cage in every overlapped tile that covers it; this collapses
    the copies to the highest-confidence one. Boxes compare in the
    EPSG:3035 meter frame (the xmin_m.. columns geocode emits), class-aware
    within a year — the reference has no equivalent because its grid never
    overlaps (tile_tifs.py hard grid).
    """
    if len(det) == 0:
        return det
    raw = det[["xmin_m", "ymin_m", "xmax_m", "ymax_m"]].to_numpy(np.float64)
    # geocode's _m columns carry the reference's EPSG:3035 authority-order
    # swap (post/geocode.py authority_order=True): "xmin_m" can exceed
    # "xmax_m". Sort each corner pair so the IoU math sees real min/max —
    # without this every intersection is zero and NMS silently no-ops.
    boxes = np.empty_like(raw)
    boxes[:, 0] = np.minimum(raw[:, 0], raw[:, 2])
    boxes[:, 2] = np.maximum(raw[:, 0], raw[:, 2])
    boxes[:, 1] = np.minimum(raw[:, 1], raw[:, 3])
    boxes[:, 3] = np.maximum(raw[:, 1], raw[:, 3])
    conf = det["det_conf"].to_numpy(np.float64)
    years = det["year"].to_numpy()
    types = det["type"].to_numpy()

    keep_mask = np.zeros(len(det), bool)
    groups: dict = {}
    for i, (y, t) in enumerate(zip(years, types)):
        groups.setdefault((y, t), []).append(i)
    for idx in groups.values():
        idx = np.asarray(idx)
        order = idx[np.argsort(-conf[idx], kind="stable")]
        # Exact grid-bucketed greedy NMS: with cell >= a box's side, any
        # intersecting pair of such boxes lands in min-corner cells that
        # differ by <= 1 on each axis, so each candidate only checks kept
        # boxes in its 3x3 cell neighborhood — near-linear instead of the
        # all-pairs scan. The cell is the group's max side CAPPED at
        # 2x the 95th-percentile side: one outlier-large box would
        # otherwise inflate the cell until every box shares a handful of
        # cells and the bucketing degenerates back to O(n^2), while a
        # plain p95 cell makes 5% of boxes "big" BY CONSTRUCTION and big
        # candidates pay an all-pairs scan. With the cap, ordinary size distributions
        # (max <= 2*p95) have ZERO big boxes; only genuine outliers take
        # the split: they compare all-pairs against every kept box, and
        # every normal candidate also checks the kept big boxes — exact
        # either way (mirrors frame's _candidate_pairs wide-box split).
        gb = boxes[order]
        sides = np.maximum(gb[:, 2] - gb[:, 0], gb[:, 3] - gb[:, 1])
        p95 = np.percentile(sides, 95.0)
        cell = float(max(min(float(sides.max()), 2.0 * p95), 1e-9))
        big = sides > cell
        cx = np.floor(gb[:, 0] / cell).astype(np.int64)
        cy = np.floor(gb[:, 1] / cell).astype(np.int64)
        cells: dict = {}
        kept: list = []
        kept_big: list = []
        for j, i in enumerate(order):
            if big[j]:
                neigh = kept  # big candidate: all-pairs vs every kept box
            else:
                neigh = list(kept_big)
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        neigh.extend(cells.get((cx[j] + dx, cy[j] + dy), ()))
            if neigh:
                kb = boxes[neigh]
                lt = np.maximum(kb[:, :2], boxes[i, :2])
                rb = np.minimum(kb[:, 2:], boxes[i, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
                ak = (kb[:, 2] - kb[:, 0]) * (kb[:, 3] - kb[:, 1])
                iou = inter / np.maximum(a + ak - inter, 1e-12)
                if (iou > iou_thresh).any():
                    continue
            kept.append(int(i))
            if big[j]:
                kept_big.append(int(i))
            else:
                cells.setdefault((int(cx[j]), int(cy[j])), []).append(int(i))
        keep_mask[kept] = True

    out = det.iloc[np.flatnonzero(keep_mask)].copy()
    out.crs = det.crs
    return out
