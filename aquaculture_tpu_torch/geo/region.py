"""Exact rectilinear region algebra.

A ``Region`` is a set of points of the plane represented as a collection of
DISJOINT axis-aligned rectangles. All pipeline overlay semantics operate on
rectilinear geometry (download boxes, image tiles and their successive
differences — reference utils.py:241-273 and utils_tonnage.py:686-713), so
this algebra gives exact results with no GEOS dependency:

* ``intersection``: pairwise rect∩rect (disjointness is preserved for free)
* ``difference``:   per-rectangle local coordinate compression
* ``union``:        a ∪ b  =  a  +  (b \\ a)

Complexity is local: ops only touch rectangles whose bounds overlap, so the
greedy coverage loops stay near-linear.
"""

from __future__ import annotations

from typing import List

import numpy as np

from aquaculture_tpu_torch.geo import polygon as _poly

_EPS = 1e-9


def _any_overlap(r: np.ndarray) -> bool:
    """True if any pair of rects overlaps with positive area."""
    ix = np.minimum(r[:, None, 2], r[None, :, 2]) - np.maximum(r[:, None, 0], r[None, :, 0])
    iy = np.minimum(r[:, None, 3], r[None, :, 3]) - np.maximum(r[:, None, 1], r[None, :, 1])
    ov = (ix > _EPS) & (iy > _EPS)
    np.fill_diagonal(ov, False)
    return bool(ov.any())


class Region:
    __slots__ = ("rects",)

    def __init__(self, rects: np.ndarray, _assume_disjoint: bool = False):
        r = np.asarray(rects, dtype=np.float64).reshape(-1, 4)
        # Drop degenerate rectangles
        keep = (r[:, 2] - r[:, 0] > _EPS) & (r[:, 3] - r[:, 1] > _EPS)
        r = r[keep]
        # The algebra requires disjoint rects; normalize overlapping input
        # (internal ops pass _assume_disjoint — their outputs are disjoint
        # by construction). Found by fuzzing: Region(overlapping).union(x)
        # silently double-counted area.
        if not _assume_disjoint and len(r) > 1 and _any_overlap(r):
            acc = r[:1]
            base = Region(acc, _assume_disjoint=True)
            for rect in r[1:]:
                extra = Region(rect[None, :], _assume_disjoint=True).difference(base)
                if not extra.is_empty:
                    base = Region(
                        np.concatenate([base.rects, extra.rects]), _assume_disjoint=True
                    )
            r = base.rects
        self.rects = r

    @property
    def is_empty(self) -> bool:
        return len(self.rects) == 0

    @property
    def area(self) -> float:
        if self.is_empty:
            return 0.0
        return float(
            np.sum((self.rects[:, 2] - self.rects[:, 0]) * (self.rects[:, 3] - self.rects[:, 1]))
        )

    @property
    def bounds(self):
        if self.is_empty:
            return (np.nan, np.nan, np.nan, np.nan)
        return (
            float(self.rects[:, 0].min()),
            float(self.rects[:, 1].min()),
            float(self.rects[:, 2].max()),
            float(self.rects[:, 3].max()),
        )

    # -- algebra ------------------------------------------------------------

    def intersection(self, other: "Region") -> "Region":
        if self.is_empty or other.is_empty:
            return Region(np.zeros((0, 4)))
        a, b = self.rects, other.rects
        lo = np.maximum(a[:, None, :2], b[None, :, :2])
        hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
        valid = np.all(hi - lo > _EPS, axis=2)
        out = np.concatenate([lo[valid], hi[valid]], axis=1)
        return Region(out, _assume_disjoint=True)

    def difference(self, other: "Region") -> "Region":
        if self.is_empty:
            return Region(np.zeros((0, 4)))
        if other.is_empty:
            return Region(self.rects.copy(), _assume_disjoint=True)
        pieces: List[np.ndarray] = []
        b = other.rects
        for rect in self.rects:
            # Local prefilter: only subtrahend rects overlapping this rect.
            ov = (
                (b[:, 0] < rect[2] - _EPS)
                & (b[:, 2] > rect[0] + _EPS)
                & (b[:, 1] < rect[3] - _EPS)
                & (b[:, 3] > rect[1] + _EPS)
            )
            sub = b[ov]
            if len(sub) == 0:
                pieces.append(rect[None, :])
                continue
            sub = np.clip(sub, [rect[0], rect[1], rect[0], rect[1]], [rect[2], rect[3], rect[2], rect[3]])
            xs = np.unique(np.concatenate([[rect[0], rect[2]], sub[:, 0], sub[:, 2]]))
            ys = np.unique(np.concatenate([[rect[1], rect[3]], sub[:, 1], sub[:, 3]]))
            cx = (xs[:-1] + xs[1:]) / 2
            cy = (ys[:-1] + ys[1:]) / 2
            # covered[j, i] = cell (i, j) covered by any subtrahend rect
            covered = np.zeros((len(cy), len(cx)), dtype=bool)
            for s in sub:
                ix = (cx > s[0]) & (cx < s[2])
                iy = (cy > s[1]) & (cy < s[3])
                covered |= iy[:, None] & ix[None, :]
            kept = ~covered
            if kept.any():
                pieces.append(_cells_to_rects(xs, ys, kept))
        if not pieces:
            return Region(np.zeros((0, 4)))
        return Region(np.concatenate(pieces, axis=0), _assume_disjoint=True)

    def union(self, other: "Region") -> "Region":
        extra = other.difference(self)
        if self.is_empty:
            return extra
        if extra.is_empty:
            return Region(self.rects.copy(), _assume_disjoint=True)
        return Region(
            np.concatenate([self.rects, extra.rects], axis=0), _assume_disjoint=True
        )

    def contains_point(self, x: float, y: float) -> bool:
        r = self.rects
        return bool(
            np.any((r[:, 0] - _EPS <= x) & (x <= r[:, 2] + _EPS) & (r[:, 1] - _EPS <= y) & (y <= r[:, 3] + _EPS))
        )

    def __repr__(self):
        return f"Region({len(self.rects)} rects, area={self.area:.3f})"


def _cells_to_rects(xs: np.ndarray, ys: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Merge a boolean cell grid into maximal rectangles.

    Greedy: merge horizontal runs per row, then stack identical runs across
    adjacent rows. keep has shape (len(ys)-1, len(xs)-1).
    """
    rects = []
    open_strips = {}  # (i0, i1) -> y_start index
    ny = keep.shape[0]
    for j in range(ny + 1):
        row_runs = set()
        if j < ny:
            row = keep[j]
            i = 0
            n = len(row)
            while i < n:
                if row[i]:
                    i0 = i
                    while i < n and row[i]:
                        i += 1
                    row_runs.add((i0, i))
                else:
                    i += 1
        # Close strips not continued by this row
        for run in list(open_strips):
            if run not in row_runs:
                j0 = open_strips.pop(run)
                rects.append((xs[run[0]], ys[j0], xs[run[1]], ys[j]))
        # Open new strips
        for run in row_runs:
            if run not in open_strips:
                open_strips[run] = j
    return np.array(rects, dtype=np.float64).reshape(-1, 4)


def from_geometry(g) -> Region:
    """Decompose a rectilinear geometry into a disjoint-rectangle Region."""
    polys = g.geoms if isinstance(g, _poly.MultiPolygon) else [g]
    pieces = []
    for p in polys:
        if p.is_empty:
            continue
        if isinstance(p, _poly.Polygon) and p.is_rectangle:
            # the dominant dedup input is a plain box — skip the
            # grid-decomposition machinery
            pieces.append(np.asarray([p.bounds], np.float64))
            continue
        xs_all = [p.exterior[:, 0]] + [h[:, 0] for h in p.holes]
        ys_all = [p.exterior[:, 1]] + [h[:, 1] for h in p.holes]
        xs = np.unique(np.concatenate(xs_all))
        ys = np.unique(np.concatenate(ys_all))
        if len(xs) < 2 or len(ys) < 2:
            continue
        cx = (xs[:-1] + xs[1:]) / 2
        cy = (ys[:-1] + ys[1:]) / 2
        keep = np.zeros((len(cy), len(cx)), dtype=bool)
        for j, yv in enumerate(cy):
            for i, xv in enumerate(cx):
                keep[j, i] = p.contains_point(float(xv), float(yv))
        if keep.any():
            pieces.append(_cells_to_rects(xs, ys, keep))
    if not pieces:
        return Region(np.zeros((0, 4)))
    return Region(np.concatenate(pieces, axis=0))


def to_geometry(r: Region):
    """Region -> Polygon / MultiPolygon (one rectangle polygon per piece,
    after a merge pass; pieces are disjoint so MultiPolygon.area is exact)."""
    if r.is_empty:
        return _poly.EMPTY
    merged = _merge_rects(r.rects)
    polys = [_poly.box(*rect) for rect in merged]
    if len(polys) == 1:
        return polys[0]
    return _poly.MultiPolygon(polys)


def _merge_axis(rs, axis: int):
    """One sorted merge pass along one axis: group rects sharing the exact
    cross-axis extent (keys snapped to the _EPS grid), sort along the merge
    axis, and coalesce runs whose edges abut within _EPS. O(n log n)."""
    groups: dict = {}
    if axis == 0:  # horizontal merge: same (y0, y1)
        lo, hi, k0, k1 = 0, 2, 1, 3
    else:          # vertical merge: same (x0, x1)
        lo, hi, k0, k1 = 1, 3, 0, 2
    for r in rs:
        key = (round(r[k0] / _EPS), round(r[k1] / _EPS))
        groups.setdefault(key, []).append(r)
    out = []
    changed = False
    for grp in groups.values():
        if len(grp) == 1:
            out.append(grp[0])
            continue
        grp.sort(key=lambda r: r[lo])
        cur = list(grp[0])
        for r in grp[1:]:
            if r[lo] - cur[hi] < _EPS:  # abutting (or overlapping) runs merge
                if r[hi] > cur[hi]:
                    cur[hi] = r[hi]
                changed = True
            else:
                out.append(tuple(cur))
                cur = list(r)
        out.append(tuple(cur))
    return out, changed


def _merge_rects(rects: np.ndarray) -> np.ndarray:
    """Best-effort merge of rectangles sharing a full edge.

    Alternating sorted passes per axis, O(n log n) each, instead of an
    all-pairs scan."""
    rs = [tuple(r) for r in rects]
    changed = True
    while changed and len(rs) > 1:
        rs, ch_h = _merge_axis(rs, 0)
        rs, ch_v = _merge_axis(rs, 1)
        changed = ch_h or ch_v
    return np.array(rs, dtype=np.float64).reshape(-1, 4)
