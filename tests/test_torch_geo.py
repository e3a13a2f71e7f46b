"""The port's geometry (aquaculture_tpu_torch.geo, .frame) against the JAX
package's. Both sides run the same numpy on the same seeded inputs, so
every comparison is exact (tolerance 0): CRS transforms, WKT and GeoJSON
round trips, the rectilinear region algebra, rasterized masks, predicates
and the GeoFrame operations the aq-pipeline path calls."""

import numpy as np
import pandas as pd
import pytest

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.geo import crs as jcrs
from aquaculture_tpu.geo import io as jio
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.geo import rasterize as jras
from aquaculture_tpu.geo import region as jreg
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.geo import crs as tcrs
from aquaculture_tpu_torch.geo import io as tio
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.geo import rasterize as tras
from aquaculture_tpu_torch.geo import region as treg

DIRECTIONS = ((4326, 3857), (3857, 4326), (4326, 3035), (3035, 4326), (3857, 3035), (3035, 3857))


def _points(crs, n=500, seed=0):
    rng = np.random.default_rng(seed)
    lon, lat = rng.uniform(-10, 30, n), rng.uniform(35, 65, n)
    return jcrs.transform(4326, crs, lon, lat) if crs != 4326 else (lon, lat)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_crs_transform_identical(src, dst):
    x, y = _points(src)
    gx, gy = tcrs.transform(src, dst, x, y)
    wx, wy = jcrs.transform(src, dst, x, y)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


def _shapes(P):
    """One geometry of each type, built from package P (polygon module)."""
    ring = [(0.5, 0.25), (10.125, 0.0), (12.0, 7.75), (3.0, 9.5)]
    hole = [(4.0, 3.0), (6.0, 3.0), (5.0, 5.0)]
    return {
        "point": P.Point(1.5, -2.25),
        "linestring": P.LineString([(0, 0), (1.5, 2.5), (3.25, 1.0)]),
        "multilinestring": P.MultiLineString([[(0, 0), (1, 1)], [(2, 2), (3, 1), (4, 4)]]),
        "polygon_with_hole": P.Polygon(ring, [hole]),
        "multipolygon": P.MultiPolygon([P.box(0, 0, 1, 1), P.Polygon(ring)]),
        "empty": P.EMPTY,
    }


def _coords(g):
    """Every coordinate of a geometry of either package, as one array."""
    name = type(g).__name__
    if name == "Point":
        return np.array([[g.x, g.y]])
    if name == "LineString":
        return g.coords
    if name in ("MultiLineString", "MultiPolygon"):
        parts = [_coords(p) for p in g.geoms]
        return np.concatenate(parts) if parts else np.zeros((0, 2))
    if name == "Polygon":
        return np.concatenate([g.exterior, *g.holes]) if len(g.exterior) else np.zeros((0, 2))
    return np.zeros((0, 2))


def assert_same_geometry(got, want):
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(_coords(got), _coords(want))
    if type(want).__name__ == "Polygon":
        assert len(got.holes) == len(want.holes)


@pytest.mark.parametrize("kind", list(_shapes(jpoly)))
def test_wkt_round_trip_identical(kind):
    got, want = _shapes(tpoly)[kind], _shapes(jpoly)[kind]
    assert tio.to_wkt(got) == jio.to_wkt(want)
    assert_same_geometry(tio.from_wkt(tio.to_wkt(got)), jio.from_wkt(jio.to_wkt(want)))


def test_geojson_round_trip_identical(tmp_path):
    geoms_t, geoms_j = list(_shapes(tpoly).values()), list(_shapes(jpoly).values())
    recs = [{"i": np.int64(i), "v": np.float32(0.5) if i % 2 else np.nan} for i in range(len(geoms_t))]
    tio.write_feature_collection(str(tmp_path / "t.geojson"), recs, geoms_t, 3857)
    jio.write_feature_collection(str(tmp_path / "j.geojson"), recs, geoms_j, 3857)
    assert (tmp_path / "t.geojson").read_bytes() == (tmp_path / "j.geojson").read_bytes()
    props, geoms, crs = tio.read_feature_collection(str(tmp_path / "t.geojson"))
    jprops, jgeoms, jcrs_ = jio.read_feature_collection(str(tmp_path / "j.geojson"))
    assert props == jprops and crs == jcrs_ == 3857
    for g, w in zip(geoms, jgeoms):
        assert_same_geometry(g, w)


def _rects(rng, n):
    x0, y0 = rng.integers(0, 40, n).astype(float), rng.integers(0, 40, n).astype(float)
    return np.stack([x0, y0, x0 + rng.integers(1, 15, n), y0 + rng.integers(1, 15, n)], axis=1)


@pytest.mark.parametrize("seed", range(4))
def test_region_algebra_identical(seed):
    rng = np.random.default_rng(seed)
    a, b = _rects(rng, 6), _rects(rng, 5)  # overlapping inputs get normalized
    ta, tb, ja, jb = treg.Region(a), treg.Region(b), jreg.Region(a), jreg.Region(b)
    np.testing.assert_array_equal(ta.rects, ja.rects)
    for op in ("union", "difference", "intersection"):
        got, want = getattr(ta, op)(tb), getattr(ja, op)(jb)
        np.testing.assert_array_equal(got.rects, want.rects, err_msg=op)
        assert_same_geometry(treg.to_geometry(got), jreg.to_geometry(want))
    # an L-shaped rectilinear polygon decomposes identically
    ell = [(0, 0), (10, 0), (10, 4), (4, 4), (4, 9), (0, 9)]
    np.testing.assert_array_equal(treg.from_geometry(tpoly.Polygon(ell)).rects,
                                  jreg.from_geometry(jpoly.Polygon(ell)).rects)


def _jagged(P, seed=3):
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 100, 23)
    ring = np.concatenate([np.stack([xs, 40 + rng.uniform(-15, 15, len(xs))], 1), [[100, 0], [0, 0]]])
    return P.MultiPolygon([P.Polygon(ring, [[(20, 5), (30, 5), (25, 15)]]), P.box(110, 10, 130, 30)])


@pytest.mark.parametrize("fn", ["rasterize_geometry", "rasterize_edges"])
def test_rasterized_masks_identical(fn):
    bounds = (-5.0, -5.0, 135.0, 60.0)
    got = getattr(tras, fn)(_jagged(tpoly), bounds, 97, 41)
    want = getattr(jras, fn)(_jagged(jpoly), bounds, 97, 41)
    assert got.dtype == want.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)
    ring = np.asarray([(0, 0), (50, 10), (20, 50)], float)
    np.testing.assert_array_equal(tras.rasterize_ring(ring, bounds, 30, 20),
                                  jras.rasterize_ring(ring, bounds, 30, 20))


def test_polygon_measures_and_predicates_identical():
    rng = np.random.default_rng(11)
    tshapes, jshapes = _shapes(tpoly), _shapes(jpoly)
    for k in ("polygon_with_hole", "multipolygon"):
        t, j = tshapes[k], jshapes[k]
        assert t.area == j.area and t.bounds == j.bounds
        assert (t.centroid.x, t.centroid.y) == (j.centroid.x, j.centroid.y)
        for x, y in rng.uniform(-1, 13, (50, 2)):
            assert t.contains_point(x, y) == j.contains_point(x, y)
    jag_t, jag_j = _jagged(tpoly), _jagged(jpoly)
    for b in _rects(rng, 60) * 3.0 - 5.0:
        bt, bj = tpoly.box(*b), jpoly.box(*b)
        assert tpoly.intersects(bt, jag_t) == jpoly.intersects(bj, jag_j)
        assert bt.is_rectangle == bj.is_rectangle is True
    fn = lambda x, y: (2.0 * x + 1.0, y - 3.0)  # noqa: E731
    assert_same_geometry(tshapes["polygon_with_hole"].transform(fn), jshapes["polygon_with_hole"].transform(fn))


def _frames(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, 1000, n), rng.uniform(0, 1000, n)
    w = rng.uniform(5, 60, n)
    cols = {"id": np.arange(n), "conf": rng.random(n)}
    out = []
    for G, P in ((tgf, tpoly), (jgf, jpoly)):
        det = G.GeoFrame(dict(cols), geometry=[P.box(a, b, a + c, b + c) for a, b, c in zip(x0, y0, w)],
                         crs=3857)
        land = G.GeoFrame({"name": ["a", "b"]}, geometry=[_jagged(P).geoms[0], P.box(600, 600, 900, 700)],
                          crs=3857)
        out.append((det, land))
    return out


def test_frame_to_crs_sjoin_and_io_identical(tmp_path):
    (tdet, tland), (jdet, jland) = _frames()
    for crs in (4326, 3035):
        got, want = tdet.to_crs(crs), jdet.to_crs(crs)
        assert got.crs == want.crs == crs
        for g, w in zip(got["geometry"], want["geometry"]):
            assert_same_geometry(g, w)
        np.testing.assert_array_equal(got.bounds_array(), want.bounds_array())
    for how in ("inner", "left"):
        got, want = tdet.sjoin(tland, how=how), jdet.sjoin(jland, how=how)
        pd.testing.assert_frame_equal(pd.DataFrame(got.drop(columns=["geometry"])),
                                      pd.DataFrame(want.drop(columns=["geometry"])))
    with pytest.raises(ValueError, match="within"):
        tdet.sjoin(tland, predicate="within")
    tdet.to_file(str(tmp_path / "t.geojson"))
    jdet.to_file(str(tmp_path / "j.geojson"))
    assert (tmp_path / "t.geojson").read_bytes() == (tmp_path / "j.geojson").read_bytes()
    back, jback = tgf.read_file(str(tmp_path / "t.geojson")), jgf.read_file(str(tmp_path / "j.geojson"))
    pd.testing.assert_frame_equal(pd.DataFrame(back.drop(columns=["geometry"])),
                                  pd.DataFrame(jback.drop(columns=["geometry"])))
    assert back.crs == jback.crs == 3857
    csv = pd.DataFrame({"geometry": [jio.to_wkt(jpoly.box(0, 0, 1200, 1200)),
                                     jio.to_wkt(jpoly.box(600, 0, 1800, 1200))]})
    got, want = tgf.from_wkt_column(csv, crs=3857), jgf.from_wkt_column(csv, crs=3857)
    assert got.crs == want.crs == 3857 and len(got) == 2
    for g, w in zip(got["geometry"], want["geometry"]):
        assert_same_geometry(g, w)
