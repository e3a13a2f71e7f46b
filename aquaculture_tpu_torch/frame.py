"""GeoFrame: a minimal geo-dataframe (geopandas replacement).

A ``pandas.DataFrame`` subclass carrying a ``geometry`` object column of
``aquaculture_tpu_torch.geo.polygon`` geometries and an integer EPSG ``crs``.
A copy of aquaculture_tpu/frame.py as far as the aq-pipeline path reaches
it (reference: geopandas calls in src/process_yolo/): ``to_crs``,
``bounds_array``, ``sjoin`` (intersects), GeoJSON read/write, and WKT
column parsing. ``overlay``, ``buffer``, ``dissolve`` and the exact ``within``
predicate need the boolean engine and come with a later slice of the port.

Spatial joins are vectorized: a bounds-overlap prefilter via searchsorted on
sorted x-intervals, then the exact ``intersects`` predicate on candidates.
"""

from __future__ import annotations

from typing import List

import numpy as np
import pandas as pd

from aquaculture_tpu_torch.geo import crs as _crs
from aquaculture_tpu_torch.geo import io as _geoio
from aquaculture_tpu_torch.geo import polygon as _poly


class GeoFrame(pd.DataFrame):
    _metadata = ["crs"]

    def __init__(self, data=None, *args, geometry=None, crs=None, **kwargs):
        super().__init__(data, *args, **kwargs)
        if geometry is not None:
            self["geometry"] = list(geometry)
        if crs is not None:
            self.crs = _parse_crs(crs)
        elif not hasattr(self, "crs"):
            self.crs = None

    @property
    def _constructor(self):
        return GeoFrame

    # -- geometry accessors ---------------------------------------------------

    def bounds_array(self) -> np.ndarray:
        return np.array(
            [g.bounds if g is not None else (np.nan,) * 4 for g in self["geometry"]],
            dtype=np.float64,
        ).reshape(-1, 4)

    # -- CRS ------------------------------------------------------------------

    def to_crs(self, crs, inplace: bool = False):
        dst = _parse_crs(crs)
        src = self.crs
        if src is None:
            raise ValueError("GeoFrame has no CRS set")
        if dst == src:
            if inplace:
                return None
            out = self.copy()
            out.crs = src
            return out
        fn = lambda x, y: _crs.transform(src, dst, x, y)
        new_geoms = _batch_transform(list(self["geometry"]), fn)
        if inplace:
            self["geometry"] = new_geoms
            self.crs = dst
            return None
        out = self.copy()
        out["geometry"] = new_geoms
        out.crs = dst
        return out

    # -- spatial join -----------------------------------------------------------

    def sjoin(
        self,
        other: "GeoFrame",
        how: str = "inner",
        predicate: str = "intersects",
        lsuffix: str = "left",
        rsuffix: str = "right",
    ) -> "GeoFrame":
        """Spatial join matching geopandas.sjoin semantics for the
        'intersects' predicate (the reference's land filter,
        geocode_results.py:200-218)."""
        if how not in ("inner", "left"):
            raise ValueError(f"how must be 'inner' or 'left', not {how!r}")
        if predicate != "intersects":
            raise ValueError(f"predicate {predicate!r}: only 'intersects' is in this "
                             "slice of the port ('within' needs the boolean engine)")
        if self.crs != other.crs:
            raise ValueError(f"CRS mismatch in sjoin: {self.crs} vs {other.crs}")

        li, ri = _candidate_pairs(self.bounds_array(), other.bounds_array())
        lg = list(self["geometry"])
        rg = list(other["geometry"])
        # Rectangle fast path: for two axis-aligned rectangles the bounds
        # overlap (already established by the candidate filter) IS the
        # intersects predicate — most pipeline geometry (detections, tiles,
        # download boxes) is rectangles, so this skips the exact test.
        # dtype=bool matters: on an empty frame np.asarray([]) defaults to
        # float64 and the masked `&` below would raise.
        l_rect = np.asarray([isinstance(g, _poly.Polygon) and g.is_rectangle for g in lg], bool)
        r_rect = np.asarray([isinstance(g, _poly.Polygon) and g.is_rectangle for g in rg], bool)
        l_ok = np.asarray([g is not None and not g.is_empty for g in lg], bool)
        r_ok = np.asarray([g is not None and not g.is_empty for g in rg], bool)
        keep = np.zeros(len(li), dtype=bool)
        valid = l_ok[li] & r_ok[ri] if len(li) else np.zeros(0, bool)
        # Rect x rect resolves fully vectorized (bounds overlap IS the
        # predicate); only mixed/non-rect pairs pay the Python loop.
        both_rect = valid & l_rect[li] & r_rect[ri]
        keep[both_rect] = True
        for k in np.where(valid & ~both_rect)[0]:
            keep[k] = _poly.intersects(lg[li[k]], rg[ri[k]])
        li, ri = li[keep], ri[keep]

        left_idx = self.index.to_numpy()
        right_idx = other.index.to_numpy()

        # Build joined table
        overlap = set(self.columns) & set(other.columns) - {"geometry"}
        lcols = {c: (f"{c}_{lsuffix}" if c in overlap else c) for c in self.columns}
        rcols = {
            c: (f"{c}_{rsuffix}" if c in overlap else c) for c in other.columns if c != "geometry"
        }

        ldata = self.rename(columns=lcols)
        matched = ldata.iloc[li].copy()
        matched.index = left_idx[li]
        rdata = pd.DataFrame(other.drop(columns=["geometry"])).rename(columns=rcols)
        rpart = rdata.iloc[ri].copy()
        rpart.index = matched.index
        joined = pd.concat([matched, rpart], axis=1)
        joined[f"index_{rsuffix}"] = right_idx[ri]

        if how == "left":
            unmatched_mask = ~np.isin(np.arange(len(self)), li)
            if unmatched_mask.any():
                un = ldata.iloc[unmatched_mask].copy()
                un.index = left_idx[unmatched_mask]
                for c in list(rcols.values()) + [f"index_{rsuffix}"]:
                    un[c] = np.nan
                joined = pd.concat([joined, un], axis=0)
            joined = joined.sort_index(kind="stable")

        out = GeoFrame(joined)
        out.crs = self.crs
        return out

    def to_file(self, path: str, driver: str = "GeoJSON", index: bool = False):
        recs = self.drop(columns=["geometry"]).to_dict("records")
        if index:
            for i, rec in zip(self.index, recs):
                rec["index"] = rec.get("index", i)
        _geoio.write_feature_collection(path, recs, list(self["geometry"]), self.crs or 4326)

    def copy(self, deep: bool = True) -> "GeoFrame":
        out = super().copy(deep=deep)
        out.crs = self.crs
        return out


# Right-side boxes wider than _WIDE_FACTOR x the median are swept separately
# against all left rows: one huge box (a land polygon) must not blow up the
# searchsorted window that prunes the narrow majority.
_WIDE_FACTOR = 16.0

# Cap on candidate pairs materialized per expansion chunk (~8 int64/bool
# arrays of this length live at once => ~300 MB peak at 4M).
_PAIR_CHUNK = 4_000_000


def _candidate_pairs(ab: np.ndarray, bb: np.ndarray):
    """Bounds-overlap candidate pairs between two (N,4)/(M,4) bounds arrays.

    Two-sided interval pruning on x, fully vectorized: right boxes sorted by
    minx, each left row's candidate window is
    ``minx ∈ [left.minx - max_right_width, left.maxx]`` (both searchsorted),
    then the exact 4-way overlap test filters the window. Near-linear on
    clustered data, where a one-sided sweep (no lower bound) degrades
    toward O(N·M).
    """
    if len(ab) == 0 or len(bb) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)

    a_ok = np.isfinite(ab).all(axis=1)
    b_ok = np.isfinite(bb).all(axis=1)
    widths = np.where(b_ok, bb[:, 2] - bb[:, 0], np.nan)
    med = np.nanmedian(widths) if b_ok.any() else 0.0
    cutoff = max(_WIDE_FACTOR * med, 0.0)
    wide = b_ok & (widths > cutoff)
    narrow = b_ok & ~wide

    pairs_l: List[np.ndarray] = []
    pairs_r: List[np.ndarray] = []

    ai = np.where(a_ok)[0]
    if ai.size and narrow.any():
        order = np.where(narrow)[0][np.argsort(bb[narrow, 0], kind="stable")]
        bx0 = bb[order, 0]
        wmax = float(np.max(widths[narrow]))
        lo = np.searchsorted(bx0, ab[ai, 0] - wmax, side="left")
        hi = np.searchsorted(bx0, ab[ai, 2], side="right")
        counts = np.maximum(hi - lo, 0)
        # Chunk the expansion so peak temporaries stay bounded even when the
        # windows are fat (heavy-tailed widths below the wide cutoff can push
        # counts.sum() toward N*M; the exact `sel` filter prunes AFTER
        # materialization, so the cap must come first).
        cum = np.cumsum(counts)
        total = int(cum[-1]) if counts.size else 0
        if total:
            starts = [0]
            while True:
                done = cum[starts[-1] - 1] if starts[-1] else 0
                nxt = int(np.searchsorted(cum, done + _PAIR_CHUNK, side="left")) + 1
                if nxt >= len(ai):
                    break
                starts.append(nxt)
            starts.append(len(ai))
            for s, e in zip(starts[:-1], starts[1:]):
                c = counts[s:e]
                n = int(c.sum())
                if not n:
                    continue
                li = np.repeat(ai[s:e], c)
                offs = np.concatenate([[0], np.cumsum(c[:-1])])
                pos = np.arange(n) - np.repeat(offs, c) + np.repeat(lo[s:e], c)
                ri = order[pos]
                sel = (
                    (bb[ri, 2] >= ab[li, 0])
                    & (bb[ri, 0] <= ab[li, 2])
                    & (bb[ri, 1] <= ab[li, 3])
                    & (bb[ri, 3] >= ab[li, 1])
                )
                pairs_l.append(li[sel])
                pairs_r.append(ri[sel])

    if ai.size and wide.any():
        for j in np.where(wide)[0]:
            sel = (
                (ab[ai, 0] <= bb[j, 2])
                & (ab[ai, 2] >= bb[j, 0])
                & (ab[ai, 1] <= bb[j, 3])
                & (ab[ai, 3] >= bb[j, 1])
            )
            hit = ai[sel]
            pairs_l.append(hit)
            pairs_r.append(np.full(len(hit), j, dtype=np.int64))

    if not pairs_l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    li = np.concatenate(pairs_l).astype(np.int64)
    ri = np.concatenate(pairs_r).astype(np.int64)
    # stable (left, insertion) order: sort by left
    # row, keeping narrow-before-wide right order within a left row stable
    order = np.argsort(li, kind="stable")
    return li[order], ri[order]


def _batch_transform(geoms: list, fn) -> list:
    """Transform a geometry list, batching hole-free Polygons and Points
    through ONE vectorized ``fn`` call each.

    A per-row ``g.transform(fn)`` pays one transform call plus
    ``Polygon.__init__`` re-validation per geometry. The batch path
    transforms all exterior rings in one call and re-validates orientation with a
    vectorized cyclic shoelace (``np.add.reduceat`` over concatenated
    rings), falling back to the exact per-geometry path for holes,
    multi-geometries, empties, and rings that degenerate under ``fn``.
    """
    out = list(geoms)
    poly_idx = [
        i
        for i, g in enumerate(geoms)
        if type(g) is _poly.Polygon and not g.holes and len(g.exterior) >= 3
    ]
    done = set()
    if len(poly_idx) >= 16:
        lens = np.fromiter((len(geoms[i].exterior) for i in poly_idx), np.int64, len(poly_idx))
        coords = np.concatenate([geoms[i].exterior for i in poly_idx])
        tx, ty = fn(coords[:, 0], coords[:, 1])
        pts = np.stack(
            [np.asarray(tx, np.float64), np.asarray(ty, np.float64)], axis=1
        )
        offs = np.zeros(len(poly_idx), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        x, y = pts[:, 0], pts[:, 1]
        mx = np.repeat(np.add.reduceat(x, offs) / lens, lens)
        my = np.repeat(np.add.reduceat(y, offs) / lens, lens)
        xc, yc = x - mx, y - my
        nxt = np.arange(1, len(x) + 1)
        nxt[offs + lens - 1] = offs
        cross = xc * yc[nxt] - xc[nxt] * yc
        areas = 0.5 * np.add.reduceat(cross, offs)
        # fn collapsing a ring's first/last vertex would need __init__'s
        # duplicate strip — detect vectorized, handle via full validation
        dup = (pts[offs] == pts[offs + lens - 1]).all(axis=1)
        for k, i in enumerate(poly_idx):
            ring = pts[offs[k]: offs[k] + lens[k]]
            if dup[k]:
                out[i] = _poly.Polygon(ring)
            elif areas[k] < 0:
                out[i] = _poly._polygon_from_ccw(ring[::-1].copy())
            else:
                # copy() so a surviving polygon doesn't keep the whole
                # corpus-sized pts array alive through a slice view
                out[i] = _poly._polygon_from_ccw(ring.copy())
        done.update(poly_idx)
    pt_idx = [i for i, g in enumerate(geoms) if type(g) is _poly.Point]
    if len(pt_idx) >= 16:
        px = np.fromiter((geoms[i].x for i in pt_idx), np.float64, len(pt_idx))
        py = np.fromiter((geoms[i].y for i in pt_idx), np.float64, len(pt_idx))
        tx, ty = fn(px, py)
        tx = np.asarray(tx, np.float64)
        ty = np.asarray(ty, np.float64)
        for k, i in enumerate(pt_idx):
            out[i] = _poly.Point(tx[k], ty[k])
        done.update(pt_idx)
    for i, g in enumerate(geoms):
        if i in done:
            continue
        out[i] = g.transform(fn) if g is not None and not g.is_empty else g
    return out


def _parse_crs(crs) -> int:
    if isinstance(crs, int):
        return crs
    if isinstance(crs, str):
        s = crs.upper().replace("EPSG:", "").strip(": ")
        return int(s)
    raise ValueError(f"Cannot parse CRS: {crs!r}")


# ---------------------------------------------------------------------------
# IO constructors
# ---------------------------------------------------------------------------

def read_file(path: str) -> GeoFrame:
    """Read a GeoJSON feature collection into a GeoFrame."""
    props, geoms, crs = _geoio.read_feature_collection(path)
    df = pd.DataFrame(props)
    out = GeoFrame(df)
    out["geometry"] = geoms
    out.crs = crs
    return out


def from_wkt_column(df: pd.DataFrame, column: str = "geometry", crs=None) -> GeoFrame:
    """Build a GeoFrame from a DataFrame with a WKT string column
    (the wanted_bboxes.csv format, reference utils.py:37-43)."""
    geoms = [_geoio.from_wkt(w) for w in df[column]]
    out = GeoFrame(df.drop(columns=[column]))
    out["geometry"] = geoms
    out.crs = _parse_crs(crs) if crs is not None else None
    return out
