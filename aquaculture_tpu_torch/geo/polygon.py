"""Lightweight geometry types (GEOS/shapely replacement for this pipeline).

A copy of aquaculture_tpu/geo/polygon.py as far as the aq-pipeline path
reaches it (reference: src/utils.py, src/process_yolo/): points, axis-aligned
boxes, simple polygons, multipolygons; predicates (intersects / contains),
measures (area, bounds, centroid) and affine/CRS vertex transforms. The overlay operations (intersection,
difference, union, buffer) and the boolean engine under them come with a
later slice of the port; download-box dedup runs on the exact rectilinear
algebra of ``aquaculture_tpu_torch.geo.region`` instead. ``centroid_array``
(the port's own) takes many centroids at once, bit for bit.

Coordinates are float64 NumPy arrays. Geometries are immutable.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

_EPS = 1e-12


class Geometry:
    """Base class for all geometry types."""

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    @property
    def area(self) -> float:
        raise NotImplementedError

    @property
    def bounds(self):
        raise NotImplementedError

    def intersects(self, other: "Geometry") -> bool:
        return intersects(self, other)


class Empty(Geometry):
    """The empty geometry (e.g. a region clipped away by dedup)."""

    @property
    def is_empty(self) -> bool:
        return True

    @property
    def area(self) -> float:
        return 0.0

    @property
    def bounds(self):
        return (np.nan, np.nan, np.nan, np.nan)

    @property
    def centroid(self) -> "Point":
        return Point(np.nan, np.nan)

    def transform(self, fn) -> "Empty":
        return self

    def __repr__(self):
        return "EMPTY"


EMPTY = Empty()


class Point(Geometry):
    __slots__ = ("x", "y")

    def __init__(self, x: float, y: float):
        self.x = float(x)
        self.y = float(y)

    @property
    def is_empty(self) -> bool:
        return False

    @property
    def area(self) -> float:
        return 0.0

    @property
    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    @property
    def centroid(self) -> "Point":
        return self

    def transform(self, fn) -> "Point":
        x, y = fn(np.array([self.x]), np.array([self.y]))
        return Point(float(x[0]), float(y[0]))

    def __repr__(self):
        return f"POINT ({self.x} {self.y})"


class LineString(Geometry):
    """A polyline (N, 2), as GeoJSON and WKT carry it; no boolean ops."""

    __slots__ = ("coords",)

    def __init__(self, coords):
        self.coords = np.asarray(coords, dtype=np.float64).reshape(-1, 2)

    @property
    def is_empty(self) -> bool:
        return len(self.coords) < 2

    @property
    def area(self) -> float:
        return 0.0

    @property
    def bounds(self):
        c = self.coords
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())

    @property
    def centroid(self) -> "Point":
        c = self.coords.mean(axis=0)
        return Point(float(c[0]), float(c[1]))

    def transform(self, fn) -> "LineString":
        x, y = fn(self.coords[:, 0], self.coords[:, 1])
        return LineString(np.stack([np.asarray(x), np.asarray(y)], axis=1))

    def __repr__(self):
        return f"LINESTRING ({len(self.coords)} pts)"


class MultiLineString(Geometry):
    __slots__ = ("geoms",)

    def __init__(self, lines):
        self.geoms = [l if isinstance(l, LineString) else LineString(l) for l in lines]

    @property
    def is_empty(self) -> bool:
        return all(l.is_empty for l in self.geoms)

    @property
    def area(self) -> float:
        return 0.0

    @property
    def bounds(self):
        bs = np.asarray([l.bounds for l in self.geoms if not l.is_empty])
        if len(bs) == 0:
            return (np.nan,) * 4
        return (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())

    @property
    def centroid(self) -> "Point":
        pts = np.concatenate([l.coords for l in self.geoms]) if self.geoms else np.zeros((0, 2))
        c = pts.mean(axis=0) if len(pts) else (np.nan, np.nan)
        return Point(float(c[0]), float(c[1]))

    def transform(self, fn) -> "MultiLineString":
        return MultiLineString([l.transform(fn) for l in self.geoms])

    def __repr__(self):
        return f"MULTILINESTRING ({len(self.geoms)} lines)"


def _ring_area(ring: np.ndarray) -> float:
    """Signed shoelace area of a closed or open ring array (N, 2).

    Computed about the ring's own mean: at projected-CRS magnitudes the raw
    cross products lose ~13 digits to cancellation."""
    x = ring[:, 0] - ring[:, 0].mean()
    y = ring[:, 1] - ring[:, 1].mean()
    # slice-based cyclic shoelace (np.roll would allocate two copies per
    # call, and Polygon.__init__ calls this for every ring)
    s = float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))
    s += float(x[-1] * y[0] - x[0] * y[-1])
    return 0.5 * s


def _close_ring(ring: np.ndarray) -> np.ndarray:
    if not np.array_equal(ring[0], ring[-1]):
        return np.vstack([ring, ring[:1]])
    return ring


def _polygon_from_ccw(ext: np.ndarray) -> "Polygon":
    """Trusted fast constructor: ``ext`` must be an open, CCW, hole-free
    exterior ring with >= 3 distinct vertices (used by the vectorized
    GeoFrame.to_crs batch path, which validates orientation itself)."""
    p = Polygon.__new__(Polygon)
    p.exterior = ext
    p.holes = []
    p._bounds = None
    p._area = None
    return p


class Polygon(Geometry):
    """Simple polygon: one exterior ring, optional holes.

    The exterior is stored counter-clockwise, holes clockwise; the closing
    vertex is not duplicated.
    """

    __slots__ = ("exterior", "holes", "_bounds", "_area")

    def __init__(self, exterior: Sequence = (), holes: Iterable[Sequence] = ()):
        ext = np.asarray(exterior, dtype=np.float64).reshape(-1, 2)
        if len(ext) and np.array_equal(ext[0], ext[-1]):
            ext = ext[:-1]
        if len(ext) >= 3 and _ring_area(ext) < 0:
            ext = ext[::-1]
        hole_rings: List[np.ndarray] = []
        for h in holes:
            hr = np.asarray(h, dtype=np.float64).reshape(-1, 2)
            if len(hr) and np.array_equal(hr[0], hr[-1]):
                hr = hr[:-1]
            if len(hr) >= 3:
                if _ring_area(hr) > 0:
                    hr = hr[::-1]
                hole_rings.append(hr)
        self.exterior = ext
        self.holes = hole_rings
        self._bounds = None
        self._area = None

    @property
    def is_empty(self) -> bool:
        return len(self.exterior) < 3

    @property
    def area(self) -> float:
        if self._area is None:
            if self.is_empty:
                self._area = 0.0
            else:
                a = _ring_area(self.exterior)
                a += sum(_ring_area(h) for h in self.holes)  # holes are CW (negative)
                self._area = abs(a) if not self.holes else max(a, 0.0)
        return self._area

    @property
    def bounds(self):
        if self._bounds is None:
            if self.is_empty:
                self._bounds = (np.nan, np.nan, np.nan, np.nan)
            else:
                self._bounds = (
                    float(self.exterior[:, 0].min()),
                    float(self.exterior[:, 1].min()),
                    float(self.exterior[:, 0].max()),
                    float(self.exterior[:, 1].max()),
                )
        return self._bounds

    @property
    def centroid(self) -> Point:
        if self.is_empty:
            return Point(np.nan, np.nan)
        # Area-weighted centroid over exterior minus holes. Coordinates are
        # shifted to a local origin first: at projected-CRS magnitudes
        # (EPSG:3035 ~ 3e6 m) the shoelace cross terms reach ~1e19 and
        # cancel catastrophically, displacing small polygons' centroids by
        # hundreds of meters.
        ox = float(self.exterior[:, 0].mean())
        oy = float(self.exterior[:, 1].mean())

        def ring_c(ring):
            r = _close_ring(ring)
            x, y = r[:-1, 0] - ox, r[:-1, 1] - oy
            xn, yn = r[1:, 0] - ox, r[1:, 1] - oy
            cross = x * yn - xn * y
            a = 0.5 * np.sum(cross)
            if abs(a) < _EPS:
                return 0.0, float(np.mean(x)), float(np.mean(y))
            cx = float(np.sum((x + xn) * cross) / (6.0 * a))
            cy = float(np.sum((y + yn) * cross) / (6.0 * a))
            return a, cx, cy

        a0, cx, cy = ring_c(self.exterior)
        if a0 == 0.0:
            return Point(cx + ox, cy + oy)
        num_x, num_y, den = a0 * cx, a0 * cy, a0
        for h in self.holes:
            ah, hx, hy = ring_c(h)
            num_x += ah * hx
            num_y += ah * hy
            den += ah
        if abs(den) < _EPS:
            return Point(float(np.mean(self.exterior[:, 0])), float(np.mean(self.exterior[:, 1])))
        return Point(num_x / den + ox, num_y / den + oy)

    @property
    def is_rectangle(self) -> bool:
        """True for an axis-aligned solid rectangle (4 vertices spanning the
        bounds, no holes). Enables the sjoin fast path: for two rectangles,
        bounds overlap IS the intersects predicate."""
        if self.holes or len(self.exterior) != 4:
            return False
        minx, miny, maxx, maxy = self.bounds
        xs = self.exterior[:, 0]
        ys = self.exterior[:, 1]
        on_x = (np.abs(xs - minx) < 1e-12) | (np.abs(xs - maxx) < 1e-12)
        on_y = (np.abs(ys - miny) < 1e-12) | (np.abs(ys - maxy) < 1e-12)
        return bool(np.all(on_x) and np.all(on_y)) and abs(
            self.area - (maxx - minx) * (maxy - miny)
        ) < 1e-9 * max(self.area, 1.0)

    def contains_point(self, x: float, y: float) -> bool:
        if not _pip(self.exterior, x, y):
            return False
        return not any(_pip(h, x, y) for h in self.holes)

    def transform(self, fn) -> "Polygon":
        """Apply ``fn(x_array, y_array) -> (x, y)`` to every vertex."""
        ex, ey = fn(self.exterior[:, 0], self.exterior[:, 1])
        holes = []
        for h in self.holes:
            hx, hy = fn(h[:, 0], h[:, 1])
            holes.append(np.stack([hx, hy], axis=1))
        return Polygon(np.stack([ex, ey], axis=1), holes)

    def __repr__(self):
        return f"POLYGON({len(self.exterior)} pts, {len(self.holes)} holes)"


class MultiPolygon(Geometry):
    __slots__ = ("geoms",)

    def __init__(self, polygons: Iterable[Polygon] = ()):
        self.geoms: List[Polygon] = [p for p in polygons if isinstance(p, Polygon) and not p.is_empty]

    @property
    def is_empty(self) -> bool:
        return len(self.geoms) == 0

    @property
    def area(self) -> float:
        # Exact for disjoint members (the common case: distinct cages and
        # the disjoint rectangles of a region).
        return sum(p.area for p in self.geoms)

    @property
    def bounds(self):
        if self.is_empty:
            return (np.nan, np.nan, np.nan, np.nan)
        bs = np.array([p.bounds for p in self.geoms])
        return (
            float(bs[:, 0].min()),
            float(bs[:, 1].min()),
            float(bs[:, 2].max()),
            float(bs[:, 3].max()),
        )

    @property
    def centroid(self) -> Point:
        if self.is_empty:
            return Point(np.nan, np.nan)
        areas = np.array([p.area for p in self.geoms])
        cs = np.array([[p.centroid.x, p.centroid.y] for p in self.geoms])
        if areas.sum() < _EPS:
            return Point(float(cs[:, 0].mean()), float(cs[:, 1].mean()))
        w = areas / areas.sum()
        return Point(float(np.dot(w, cs[:, 0])), float(np.dot(w, cs[:, 1])))

    def contains_point(self, x: float, y: float) -> bool:
        return any(p.contains_point(x, y) for p in self.geoms)

    def transform(self, fn) -> "MultiPolygon":
        return MultiPolygon([p.transform(fn) for p in self.geoms])

    @property
    def wkt(self) -> str:
        from aquaculture_tpu_torch.geo.io import to_wkt

        return to_wkt(self)

    def __iter__(self):
        return iter(self.geoms)

    def __len__(self):
        return len(self.geoms)

    def __repr__(self):
        return f"MULTIPOLYGON({len(self.geoms)} polys)"


def box(minx: float, miny: float, maxx: float, maxy: float) -> Polygon:
    """Axis-aligned rectangle polygon (shapely.geometry.box equivalent)."""
    if maxx < minx:
        minx, maxx = maxx, minx
    if maxy < miny:
        miny, maxy = maxy, miny
    return Polygon([(maxx, miny), (maxx, maxy), (minx, maxy), (minx, miny)])


def centroid_array(geoms: Sequence[Geometry]) -> np.ndarray:
    """(N, 2) centroids of ``geoms``, bit for bit ``[g.centroid.x,
    g.centroid.y]``. Open hole-free polygons are computed together, one
    (M, n) array per vertex count n, with ``Polygon.centroid``'s operations
    in its order (each row reduces as its 1-D ring would); the rest one by
    one. The k-fold sweep and the clustering take every detection's
    centroid, many times over in a k-fold evaluation."""
    out = np.empty((len(geoms), 2), np.float64)
    groups: dict = {}
    for i, g in enumerate(geoms):
        if type(g) is Polygon and not g.holes and len(g.exterior) >= 3 \
                and not np.array_equal(g.exterior[0], g.exterior[-1]):
            groups.setdefault(len(g.exterior), []).append(i)
        else:
            c = g.centroid
            out[i] = (c.x, c.y)
    for idx in groups.values():
        ext = np.stack([geoms[i].exterior for i in idx])
        ox = ext[:, :, 0].mean(axis=1)[:, None]
        oy = ext[:, :, 1].mean(axis=1)[:, None]
        x, y = ext[:, :, 0] - ox, ext[:, :, 1] - oy
        nxt = np.roll(ext, -1, axis=1)
        xn, yn = nxt[:, :, 0] - ox, nxt[:, :, 1] - oy
        cross = x * yn - xn * y
        a = 0.5 * np.sum(cross, axis=1)
        flat = np.abs(a) < _EPS
        with np.errstate(divide="ignore", invalid="ignore"):
            cx = np.sum((x + xn) * cross, axis=1) / (6.0 * a)
            cy = np.sum((y + yn) * cross, axis=1) / (6.0 * a)
            px = np.where(flat, np.mean(x, axis=1) + ox[:, 0], (a * cx) / a + ox[:, 0])
            py = np.where(flat, np.mean(y, axis=1) + oy[:, 0], (a * cy) / a + oy[:, 0])
        out[idx] = np.stack([px, py], 1)
    return out


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

def _pip(ring: np.ndarray, x: float, y: float) -> bool:
    """Point-in-ring via crossing number; boundary points count as inside."""
    n = len(ring)
    if n < 3:
        return False
    xs, ys = ring[:, 0], ring[:, 1]
    xn, yn = np.roll(xs, -1), np.roll(ys, -1)
    # On-edge check
    dx, dy = xn - xs, yn - ys
    t_num = (x - xs) * dx + (y - ys) * dy
    seg_len2 = dx * dx + dy * dy
    t = np.divide(t_num, np.where(seg_len2 == 0, 1, seg_len2))
    t = np.clip(t, 0, 1)
    px, py = xs + t * dx, ys + t * dy
    if np.any((px - x) ** 2 + (py - y) ** 2 < _EPS):
        return True
    # Crossing number
    cond = (ys > y) != (yn > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = xs + (y - ys) / (yn - ys) * (xn - xs)
    crossings = np.count_nonzero(cond & (x < np.where(cond, x_int, np.inf)))
    return crossings % 2 == 1


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _segments_intersect(p1, p2, q1, q2) -> bool:
    d1 = _cross2(q2 - q1, p1 - q1)
    d2 = _cross2(q2 - q1, p2 - q1)
    d3 = _cross2(p2 - p1, q1 - p1)
    d4 = _cross2(p2 - p1, q2 - p1)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True

    def on_seg(a, b, c):
        return (
            min(a[0], b[0]) - _EPS <= c[0] <= max(a[0], b[0]) + _EPS
            and min(a[1], b[1]) - _EPS <= c[1] <= max(a[1], b[1]) + _EPS
        )

    if abs(d1) < _EPS and on_seg(q1, q2, p1):
        return True
    if abs(d2) < _EPS and on_seg(q1, q2, p2):
        return True
    if abs(d3) < _EPS and on_seg(p1, p2, q1):
        return True
    if abs(d4) < _EPS and on_seg(p1, p2, q2):
        return True
    return False


def _rings_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Any edge of ring a intersects any edge of ring b (vectorized prefilter)."""
    ra, rb = _close_ring(a), _close_ring(b)
    a0, a1 = ra[:-1], ra[1:]
    b0, b1 = rb[:-1], rb[1:]
    # Bounding-box prefilter on edge pairs
    amin = np.minimum(a0, a1)[:, None, :]
    amax = np.maximum(a0, a1)[:, None, :]
    bmin = np.minimum(b0, b1)[None, :, :]
    bmax = np.maximum(b0, b1)[None, :, :]
    overlap = np.all((amin <= bmax + _EPS) & (bmin <= amax + _EPS), axis=2)
    idx = np.argwhere(overlap)
    for i, j in idx:
        if _segments_intersect(a0[i], a1[i], b0[j], b1[j]):
            return True
    return False


def intersects(a: Geometry, b: Geometry) -> bool:
    """Shapely-compatible ``intersects`` predicate (boundaries touch => True)."""
    if a.is_empty or b.is_empty:
        return False
    ab, bb = a.bounds, b.bounds
    if ab[0] > bb[2] or bb[0] > ab[2] or ab[1] > bb[3] or bb[1] > ab[3]:
        return False
    if isinstance(a, Point):
        if isinstance(b, Point):
            return abs(a.x - b.x) < _EPS and abs(a.y - b.y) < _EPS
        return b.contains_point(a.x, a.y)
    if isinstance(b, Point):
        return a.contains_point(b.x, b.y)
    if isinstance(a, MultiPolygon):
        return any(intersects(p, b) for p in a.geoms)
    if isinstance(b, MultiPolygon):
        return any(intersects(a, p) for p in b.geoms)
    # Polygon vs Polygon — hole-aware: HOLE rings are boundary too, and a
    # ring of b crossing only a hole ring of a (e.g. a box straddling a
    # lake edge) is an intersection the exterior-only test misses. With
    # every ring pair checked, no crossings means each polygon lies
    # entirely within ONE face of the other's arrangement, so the single
    # vertex-containment probe below is sound (contains_point is
    # hole-aware).
    for ra in (a.exterior, *a.holes):
        for rb in (b.exterior, *b.holes):
            if _rings_intersect(ra, rb):
                return True
    if a.contains_point(*b.exterior[0]) or b.contains_point(*a.exterior[0]):
        return True
    return False
