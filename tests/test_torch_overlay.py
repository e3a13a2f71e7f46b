"""The port's overlay engine (geo/boolean.py, triangulate, buffer, lines,
the overlay half of polygon.py, GeoFrame.overlay/dissolve/sjoin within,
rasterize's vectorization, the land flag) against the JAX package's, on the
CPU.

- Boolean ops on the operand families of tests/test_boolean.py (stars,
  integer hulls, hole-bearing operands, staircase dissolves, the known
  degenerate cases): the same rings as the JAX package's Python sweep,
  coordinate for coordinate, with the same hole parenting, for
  intersection, union, difference and xor. Against the JAX package's C++
  sweep, what its own differential test compares: polygon count, hole
  count and area.
- Everything above the sweep (the polygon API, unary_union_tree,
  union_area, intersection_area, buffer, GeoFrame frames, vectorization,
  zonal statistics, the evaluation's land flag): equal, tolerance 0.
"""

import contextlib
import pathlib
import subprocess

import numpy as np
import pandas as pd
import pytest

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.data import labels as jlabels
from aquaculture_tpu.eval import datasets as jdatasets
from aquaculture_tpu.geo import boolean as jbool
from aquaculture_tpu.geo import buffer as jbuffer
from aquaculture_tpu.geo import lines as jlines
from aquaculture_tpu.geo import native_boolean
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.geo import rasterize as jras
from aquaculture_tpu.geo import triangulate as jtri
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.data import labels as tlabels
from aquaculture_tpu_torch.eval import datasets as tdatasets
from aquaculture_tpu_torch.geo import boolean as tbool
from aquaculture_tpu_torch.geo import buffer as tbuffer
from aquaculture_tpu_torch.geo import lines as tlines
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.geo import rasterize as tras
from aquaculture_tpu_torch.geo import triangulate as ttri

from test_torch_eval import _dataset_inputs, assert_plain_frames_equal
from test_torch_post import assert_frames_equal

REPO = pathlib.Path(__file__).resolve().parent.parent
OPS = ("intersection", "union", "difference", "xor")


@contextlib.contextmanager
def jax_python_sweep():
    """The JAX package with its C++ sweep unset (as tests/test_boolean.py's
    differential test does), so that its Python sweep runs."""
    native_boolean.load_library()
    lib, native_boolean._lib = native_boolean._lib, None
    try:
        yield
    finally:
        native_boolean._lib = lib


def _members(g):
    name = type(g).__name__
    if name == "MultiPolygon":
        return list(g.geoms)
    return [] if g.is_empty else [g]


def assert_same_rings(got, want):
    """The same geometry type, members in the same order, each exterior and
    each of its holes coordinate for coordinate."""
    assert type(got).__name__ == type(want).__name__
    gm, wm = _members(got), _members(want)
    assert len(gm) == len(wm)
    for g, w in zip(gm, wm):
        if type(w).__name__ != "Polygon":
            assert type(g).__name__ == type(w).__name__
            continue
        np.testing.assert_array_equal(g.exterior, w.exterior)
        assert len(g.holes) == len(w.holes)
        for gh, wh in zip(g.holes, w.holes):
            np.testing.assert_array_equal(gh, wh)


# ---------------------------------------------------------------------------
# operand families (tests/test_boolean.py's), as builders over a package
# ---------------------------------------------------------------------------

def _star_xy(rng):
    n = rng.integers(3, 12)
    cx, cy = rng.uniform(-3, 3, 2)
    th = np.sort(rng.uniform(0, 2 * np.pi, 2 * n))
    if np.min(np.diff(th)) < 1e-3:
        th = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False) + rng.uniform(0, 1)
    r = rng.uniform(0.3, 3.0, 2 * n)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)


def _hull_xy(rng):
    pts = np.unique(rng.integers(-4, 5, (12, 2)).astype(float), axis=0)
    if len(pts) < 3:
        return None
    c = pts.mean(0)
    return pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]


def _simple(xy):
    poly = jpoly.Polygon(xy)
    r = jpoly._close_ring(poly.exterior)
    n = len(r) - 1
    for i in range(n):
        for j in range(i + 2, n):
            if not (i == 0 and j == n - 1) and jpoly._segments_intersect(r[i], r[i + 1], r[j], r[j + 1]):
                return False
    return not poly.is_empty


def _poly_spec(ext, holes=()):
    return lambda P: P.Polygon(ext, list(holes))


def _box_spec(*b):
    return lambda P: P.box(*b)


def _random_pairs(kind, seed, count):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        if kind == "stars":
            a, b = _star_xy(rng), _star_xy(rng)
        elif kind == "star_hull":
            a, b = _star_xy(rng), _hull_xy(rng)
        else:
            a, b = _hull_xy(rng), _hull_xy(rng)
        if a is None or b is None or not (_simple(a) and _simple(b)):
            continue
        out.append((_poly_spec(a), _poly_spec(b)))
    return out


def _hole_pairs(seed=77, count=8):
    rng = np.random.default_rng(seed)

    def ring():
        x0, y0 = rng.uniform(-4, 0, 2)
        w, h = rng.uniform(4, 8, 2)
        hx0, hy0 = x0 + w * rng.uniform(0.15, 0.4), y0 + h * rng.uniform(0.15, 0.4)
        hx1, hy1 = x0 + w * rng.uniform(0.6, 0.85), y0 + h * rng.uniform(0.6, 0.85)
        return _poly_spec(jpoly.box(x0, y0, x0 + w, y0 + h).exterior, [jpoly.box(hx0, hy0, hx1, hy1).exterior])

    ring_a = _poly_spec(jpoly.box(0, 0, 10, 10).exterior, [jpoly.box(3, 3, 7, 7).exterior])
    ring_b = _poly_spec(jpoly.box(5, 5, 15, 15).exterior, [jpoly.box(8, 8, 12, 12).exterior])
    fixed = [(ring_a, ring_b), (ring_a, _box_spec(2, 2, 9, 9)), (_box_spec(2, 2, 9, 9), ring_a),
             (_poly_spec(jpoly.box(0, 0, 20, 20).exterior, [jpoly.box(5, 5, 15, 15).exterior]),
              _poly_spec(np.array([(10, -2), (24, 10), (10, 22), (3, 10)], float)))]
    return fixed + [(ring(), ring()) for _ in range(count)]


def _staircase_pairs(seed=11, count=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        bounds = []
        x = 0.0
        for _ in range(4):
            w, h = float(rng.uniform(0.8, 2.0)), float(rng.uniform(0.8, 2.0))
            y = float(rng.uniform(-0.5, 0.5))
            bounds.append((x, y, x + w, y + h))
            x += w if rng.random() < 0.5 else w * float(rng.uniform(0.5, 1.0))
        clip = _star_xy(rng)
        out.append(((lambda bs: (lambda P: P.unary_union([P.box(*b) for b in bs])))(bounds), _poly_spec(clip)))
    return out


def _degenerate_pairs():
    tri = np.array([(0, 0), (8, 0), (4, 6)], float)
    ring = jpoly.box(0, 0, 20, 20).exterior, [jpoly.box(5, 5, 15, 15).exterior]
    th = 0.3
    rot = (np.asarray(jpoly.box(3, 3, 6, 6).exterior) - 4.5) @ np.array(
        [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).T + 4.5
    return [
        (_box_spec(0, 0, 2, 2), _box_spec(0, 0, 2, 1)),
        (_box_spec(0, 0, 2, 2), _box_spec(0, -1, 2, 0)),                     # edge touch
        (_box_spec(0, 0, 1, 1), _box_spec(1, 1, 2, 2)),                      # corner touch
        (_box_spec(0, 0, 2, 2), _poly_spec(np.array([(1, -1), (3, 1), (1, 3), (-1, 1)], float))),  # inscribed
        (_box_spec(0, 0, 10, 10), _poly_spec(rot)),                          # difference makes a hole
        (_poly_spec(tri), _poly_spec(np.array([(0, 0), (8, 0), (4, -6)], float))),   # shared base edge
        (_poly_spec(tri), _poly_spec(np.array([(2, 0), (6, 0), (4, 3)], float))),    # collinear sub-edge
        (_box_spec(0, 0, 10, 1e-4), _box_spec(5, -1, 6, 1)),                 # sliver crossing
        (_poly_spec(np.array([(0, 0), (10, 0), (10, 10), (5, 5), (0, 10)], float)),  # notch vertex on edge
         _box_spec(5, 5, 15, 15)),
        (_poly_spec(*ring), _box_spec(5, 5, 15, 15)),                        # clip exactly the hole
        (_poly_spec(*ring), _poly_spec(jpoly.box(2, 2, 18, 18).exterior, [jpoly.box(6, 6, 14, 14).exterior])),
        (_poly_spec(np.array([(0, 0), (4, 0), (4, 4), (0, 4)], float) + [0.5, 0.0]),
         _poly_spec(np.array([(2, -1), (6, 2), (2, 5), (-1, 2)], float))),
    ]


FAMILIES = {
    "stars": lambda: _random_pairs("stars", 2024, 10),
    "star_hull": lambda: _random_pairs("star_hull", 2025, 10),
    "int_hulls": lambda: _random_pairs("int_hulls", 2026, 12),
    "holes": _hole_pairs,
    "staircase": _staircase_pairs,
    "degenerate": _degenerate_pairs,
}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_boolean_op_rings_equal_python_sweep(family, op):
    for k, (sa, sb) in enumerate(FAMILIES[family]()):
        got = tbool.boolean_op(sa(tpoly), sb(tpoly), op)
        with jax_python_sweep():
            want = jbool.boolean_op(sa(jpoly), sb(jpoly), op)
        assert_same_rings(got, want)
        assert got.area == want.area, (family, op, k)


@pytest.fixture(scope="module")
def jax_native_sweep():
    """The JAX package's C++ sweep, built with make if it is missing (as
    tests/test_native.py does)."""
    if not (REPO / "native" / "libaquatile.so").exists():
        try:
            subprocess.run(["make", "-C", str(REPO / "native")], check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            pytest.skip("native toolchain unavailable")
    native_boolean._lib_checked = False
    if native_boolean.load_library() is None:
        pytest.skip("libaquatile.so failed to load")
    return native_boolean


def _stats(g):
    polys = _members(g)
    return len(polys), sum(len(p.holes) for p in polys), g.area


@pytest.mark.parametrize("family", list(FAMILIES))
def test_boolean_op_matches_native_sweep_counts_and_area(family, jax_native_sweep):
    for sa, sb in FAMILIES[family]():
        a, b = sa(tpoly), sb(tpoly)
        for op in OPS:
            n_p, h_p, a_p = _stats(tbool.boolean_op(a, b, op))
            n_n, h_n, a_n = _stats(jbool.boolean_op(sa(jpoly), sb(jpoly), op))
            assert (n_p, h_p) == (n_n, h_n), (family, op)
            assert abs(a_p - a_n) < 1e-9 * max(a.area, b.area, 1.0) + 1e-12, (family, op, a_p, a_n)


# ---------------------------------------------------------------------------
# the API above the sweep
# ---------------------------------------------------------------------------

def _api_operands(P):
    a = P.Polygon(np.array([(0, 0), (6, 0), (6, 6), (3, 2.5), (0, 6)], float))
    b = P.Polygon(np.array([(1.5, -1), (7, 3), (2, 7.5), (-1, 3.5)], float))
    ring = P.Polygon(P.box(0, 0, 10, 10).exterior, [P.box(3, 3, 7, 7).exterior])
    return a, b, ring


API = {
    "intersection": lambda P, a, b, r: P.intersection(a, b),
    "union": lambda P, a, b, r: P.union(a, r),
    "difference": lambda P, a, b, r: P.difference(r, b),
    "symmetric_difference": lambda P, a, b, r: P.symmetric_difference(a, b),
    "methods": lambda P, a, b, r: a.intersection(r).union(b.difference(a)).symmetric_difference(r),
    "rectilinear": lambda P, a, b, r: P.union(P.difference(r, P.box(2, 2, 4, 12)), P.box(-2, -2, 1, 1)),
    "convex_clip": lambda P, a, b, r: P.intersection(a, P.box(1, 1, 5, 3)),
    "buffer_out": lambda P, a, b, r: a.buffer(0.75),
    "buffer_in": lambda P, a, b, r: r.buffer(-0.5, quad_segs=4),
    "simplify": lambda P, a, b, r: P.Polygon(np.array([(0, 0), (1, 0.01), (2, 0), (2, 2), (1, 2.02), (0, 2)],
                                                      float)).simplify(0.05),
}


@pytest.mark.parametrize("name", list(API))
def test_polygon_api_equal(name):
    got = API[name](tpoly, *_api_operands(tpoly))
    with jax_python_sweep():
        want = API[name](jpoly, *_api_operands(jpoly))
    assert_same_rings(got, want)


def test_measures_and_predicates_equal():
    (ta, tb, tr), (ja, jb, jr) = _api_operands(tpoly), _api_operands(jpoly)
    with jax_python_sweep():
        want = (jpoly.intersection_area(ja, jb), jpoly.intersection_area(jr, jb),
                jpoly.union_area([ja, jb, jr]), jtri.exact_intersection_area(ja, jr),
                ja.is_convex, jb.is_convex, jr.is_rectilinear, jpoly.box(0, 0, 1, 2).is_rectilinear)
    got = (tpoly.intersection_area(ta, tb), tpoly.intersection_area(tr, tb),
           tpoly.union_area([ta, tb, tr]), ttri.exact_intersection_area(ta, tr),
           ta.is_convex, tb.is_convex, tr.is_rectilinear, tpoly.box(0, 0, 1, 2).is_rectilinear)
    assert got == want
    assert [g.coords.tolist() for g in tr.boundary] == [g.coords.tolist() for g in jr.boundary]


@pytest.mark.parametrize("rectilinear", [True, False])
def test_unary_union_tree_equal(rectilinear):
    rng = np.random.default_rng(5)
    if rectilinear:
        xy = rng.uniform(0, 40, (60, 2))
        specs = [_box_spec(x, y, x + w, y + h) for (x, y), (w, h) in zip(xy, rng.uniform(1, 6, (60, 2)))]
    else:
        specs = [_poly_spec(_star_xy(rng) * 0.6 + rng.uniform(-6, 6, 2)) for _ in range(14)]
    got = tbool.unary_union_tree([s(tpoly) for s in specs])
    with jax_python_sweep():
        want = jbool.unary_union_tree([s(jpoly) for s in specs])
    assert_same_rings(got, want)
    assert tbool.union_area([s(tpoly) for s in specs]) == got.area
    assert_same_rings(tpoly.unary_union([s(tpoly) for s in specs]), want)


def test_buffer_module_and_lines_equal():
    rng = np.random.default_rng(3)
    xy = _star_xy(rng)
    got = tbuffer.buffer(tpoly.Polygon(xy), 0.4, quad_segs=3)
    with jax_python_sweep():
        want = jbuffer.buffer(jpoly.Polygon(xy), 0.4, quad_segs=3)
    assert_same_rings(got, want)
    segs = [[(0, 0), (2, 0)], [(2, 0), (2, 2)], [(2, 2), (0, 2)], [(0, 2), (0, 0)], [(5, 5), (6, 6)]]
    tl = tlines.linemerge([tpoly.LineString(s) for s in segs])
    jl = jlines.linemerge([jpoly.LineString(s) for s in segs])
    assert [l.coords.tolist() for l in tl] == [l.coords.tolist() for l in jl]
    tp = tlines.polygonize(tl)
    jp = jlines.polygonize(jl)
    assert len(tp) == len(jp) == 1
    for g, w in zip(tp, jp):
        assert_same_rings(g, w)


@pytest.mark.xfail(reason="known residual class (round 5): two union-tree "
                   "intermediates sharing a LONG near-duplicate boundary "
                   "run (sub-quantum offsets snap into chained overlap "
                   "merges) can still split the outer ring at a "
                   "degenerate multi-visit point; the corpus-level impact "
                   "after the round-5 fixes is ~1.4% on the 4,142-cage "
                   "dissolve (133.3k vs the 135.2k Monte-Carlo oracle, "
                   "from 6.2% before)", strict=False)
def test_near_duplicate_boundary_run_union():
    """tests/test_boolean.py's xfail, on the port's Python sweep."""
    A = tpoly.Polygon(np.array([
        [4072597.6312563606, 2268896.2053702455], [4072602.814958491, 2268895.9937248584],
        [4072602.7675134134, 2268894.7587140887], [4072603.357540616, 2268894.7346246643],
        [4072603.2646708, 2268892.3171887165], [4072604.6935305283, 2268892.258850586],
        [4072604.6098377933, 2268890.080244946], [4072613.074947477, 2268889.734634422],
        [4072613.042073359, 2268888.878866744], [4072612.41983342, 2268888.9042715286],
        [4072612.2883130917, 2268885.4806068903], [4072613.8346939054, 2268885.4174737437],
        [4072613.8244079417, 2268885.149720332], [4072625.091799488, 2268884.689717946],
        [4072625.2335975543, 2268888.381135173], [4072621.8896367964, 2268888.5176553484],
        [4072622.0038526193, 2268891.4909824906], [4072614.616432093, 2268891.792583995],
        [4072614.620030206, 2268891.886258327], [4072615.7623537807, 2268891.839619411],
        [4072616.0822584433, 2268900.1673303675], [4072613.7556193243, 2268900.2623208817],
        [4072613.9338896214, 2268904.9029859817], [4072611.849606533, 2268904.988082919],
        [4072611.86975317, 2268905.512536279], [4072606.812593731, 2268905.719011538],
        [4072606.834833097, 2268906.2979030167], [4072598.0327906436, 2268906.657280806]]))
    B = tpoly.Polygon(np.array([
        [4072609.0057195667, 2268889.043661097], [4072619.8081910913, 2268888.60262963],
        [4072623.0092465687, 2268888.471944142], [4072623.163526171, 2268888.465645623],
        [4072623.074060587, 2268886.1366072963], [4072632.0467415764, 2268885.77030052],
        [4072632.136204403, 2268888.099339536], [4072631.3897847054, 2268888.1298105274],
        [4072631.6928153858, 2268896.018771183], [4072631.4194719153, 2268896.029930254],
        [4072631.5026162313, 2268898.1944563836], [4072626.0989119345, 2268898.415062421],
        [4072626.209605121, 2268901.296746362], [4072622.1436485723, 2268901.462742713],
        [4072622.205430864, 2268903.0710944855], [4072619.0943979584, 2268903.1981064687],
        [4072619.2034801524, 2268906.037753635], [4072609.782977675, 2268906.422364514],
        [4072609.6277764225, 2268902.382303104], [4072609.394278308, 2268902.3918360164],
        [4072609.0670930785, 2268893.874817092], [4072609.191116074, 2268893.8697531847]]))
    u = tbool.boolean_op(A, B, "union")
    i = tbool.boolean_op(A, B, "intersection")
    want = A.area + B.area - i.area
    assert u.area == pytest.approx(want, rel=1e-3), (u.area, want)


# ---------------------------------------------------------------------------
# GeoFrame: overlay, dissolve, sjoin within, measures
# ---------------------------------------------------------------------------

def _frames(G, P):
    rng = np.random.default_rng(9)
    # the last three lie within the first right box, within the ring's
    # body, and in the ring's hole (not within)
    left = G.GeoFrame({"a": np.arange(9), "v": rng.random(9)},
                      geometry=[P.box(x, y, x + 30, y + 20) for x, y in rng.integers(0, 80, (5, 2))]
                      + [P.Polygon(_star_xy(np.random.default_rng(1)) * 8 + 50), P.box(30, 30, 40, 40),
                         P.box(62, 62, 70, 70), P.box(85, 85, 95, 95)], crs=3857)
    right = G.GeoFrame({"a": [10, 11, 12], "w": ["p", "q", "r"]},
                       geometry=[P.box(20, 20, 70, 60), P.Polygon(np.array([(0, 0), (60, 10), (30, 50)], float)),
                                 P.Polygon(P.box(60, 60, 120, 120).exterior, [P.box(80, 80, 100, 100).exterior])],
                       crs=3857)
    return left, right


@pytest.mark.parametrize("how", ["intersection", "difference", "union", "symmetric_difference", "identity"])
def test_geoframe_overlay_equal(how):
    tl, tr = _frames(tgf, tpoly)
    jl, jr = _frames(jgf, jpoly)
    got = tl.overlay(tr, how=how)
    with jax_python_sweep():
        want = jl.overlay(jr, how=how)
    assert len(want) > 0
    assert_frames_equal(got, want)


def test_geoframe_dissolve_buffer_and_measures_equal():
    tl, _ = _frames(tgf, tpoly)
    jl, _ = _frames(jgf, jpoly)
    with jax_python_sweep():
        want_d, want_b = jl.dissolve(), jl.buffer(2.0, quad_segs=2)
    assert_frames_equal(tl.dissolve(), want_d)
    assert_frames_equal(tl.buffer(2.0, quad_segs=2), want_b)
    pd.testing.assert_series_equal(tl.area, jl.area, check_exact=True)
    pd.testing.assert_frame_equal(tl.bounds, jl.bounds, check_exact=True)
    np.testing.assert_array_equal(tl.total_bounds, jl.total_bounds)
    assert [(c.x, c.y) for c in tl.centroid] == [(c.x, c.y) for c in jl.centroid]
    pts = pd.DataFrame({"lon": [1.0, 2.5], "lat": [43.0, 43.5], "k": ["a", "b"]})
    assert_frames_equal(tgf.from_xy(pts, "lon", "lat", crs=4326), jgf.from_xy(pts, "lon", "lat", crs=4326))
    assert_frames_equal(tgf.points_frame([1.0, 2.0], [3.0, 4.0], crs=3857, k=[5, 6]),
                        jgf.points_frame([1.0, 2.0], [3.0, 4.0], crs=3857, k=[5, 6]))


@pytest.mark.parametrize("how", ["inner", "left"])
def test_sjoin_within_equal(how):
    tl, tr = _frames(tgf, tpoly)
    jl, jr = _frames(jgf, jpoly)
    got = tl.sjoin(tr, how=how, predicate="within")
    with jax_python_sweep():
        want = jl.sjoin(jr, how=how, predicate="within")
    assert_frames_equal(got, want)
    assert len(want) >= (2 if how == "inner" else len(jl))


# ---------------------------------------------------------------------------
# rasterize's vectorization half
# ---------------------------------------------------------------------------

def _mask():
    rng = np.random.default_rng(4)
    m = np.zeros((40, 48), bool)
    m[3:20, 5:30] = True
    m[8:12, 10:14] = False          # a hole
    m[25:37, 30:45] = True
    m[28:30, 20:31] = True          # a spur
    m[rng.integers(0, 40, 30), rng.integers(0, 48, 30)] = True
    return m


def test_shapes_equal():
    m = _mask()
    tr, jr = tras.shapes(m), jras.shapes(m)
    assert len(tr) == len(jr) > 2
    for (g, gv), (w, wv) in zip(tr, jr):
        np.testing.assert_array_equal(g, w)
        assert gv == wv


def test_largest_region_polygon_equal():
    m = _mask()
    assert_same_rings(tras.largest_region_polygon(m), jras.largest_region_polygon(m))
    assert_same_rings(tras.largest_region_polygon(~m), jras.largest_region_polygon(~m))


def test_zonal_stats_equal():
    rng = np.random.default_rng(8)
    raster = rng.normal(-30, 8, (30, 40))
    raster[rng.random((30, 40)) < 0.1] = np.nan
    bounds = (0.0, 0.0, 40.0, 30.0)
    for spec in (_box_spec(3.2, 4.1, 11.7, 9.9), _poly_spec(_star_xy(np.random.default_rng(2)) * 3 + [20, 15])):
        for touched in (True, False):
            got = tras.zonal_stats(spec(tpoly), raster, bounds, nodata=np.nan, all_touched=touched)
            want = jras.zonal_stats(spec(jpoly), raster, bounds, nodata=np.nan, all_touched=touched)
            assert got == want and got["count"] > 0


# ---------------------------------------------------------------------------
# the evaluation's land flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("indent", [0.0, 40.0])
def test_mark_land_images_equal(indent):
    t_in, j_in = _dataset_inputs(tgf, tpoly), _dataset_inputs(jgf, jpoly)
    got = tlabels.mark_land_images(t_in[2], t_in[6], land_indent=indent)
    with jax_python_sweep():
        want = jlabels.mark_land_images(j_in[2], j_in[6], land_indent=indent)
    pd.testing.assert_series_equal(got, want, check_exact=True)


def test_assemble_evaluation_datasets_with_land_equal():
    t_in, j_in = _dataset_inputs(tgf, tpoly), _dataset_inputs(jgf, jpoly)
    got = tdatasets.assemble_evaluation_datasets(*t_in)
    with jax_python_sweep():
        want = jdatasets.assemble_evaluation_datasets(*j_in)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], jgf.GeoFrame):
            assert_frames_equal(got[k], want[k])
        else:
            assert_plain_frames_equal(got[k], want[k])
