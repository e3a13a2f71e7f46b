"""The port's host epilogue (aquaculture_tpu_torch.post) against the JAX
package's: geocode, download-box dedup, cage areas, the exact and hybrid
land filters and cross-tile NMS. Both sides run the same numpy on the same
seeded inputs, so frames must be equal: same columns, dtypes, index and
row order, values exactly equal, geometry coordinates exactly equal."""

import numpy as np
import pandas as pd
import pytest

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.data.filenames import TileSpec as JTileSpec
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.post import areas as jareas
from aquaculture_tpu.post import dedup as jdedup
from aquaculture_tpu.post import geocode as jgeo
from aquaculture_tpu.post import landmask as jland
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.data.filenames import TileSpec as TTileSpec
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.post import areas as tareas
from aquaculture_tpu_torch.post import dedup as tdedup
from aquaculture_tpu_torch.post import geocode as tgeo
from aquaculture_tpu_torch.post import landmask as tland

from test_torch_geo import assert_same_geometry

PACKAGES = ((tgf, tpoly), (jgf, jpoly))


def assert_frames_equal(got, want):
    """Port GeoFrame vs JAX GeoFrame: equal in everything but the classes."""
    assert type(got).__name__ == type(want).__name__ == "GeoFrame"
    assert got.crs == want.crs
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    plain = [c for c in want.columns if c != "geometry"]
    pd.testing.assert_frame_equal(pd.DataFrame(got[plain]), pd.DataFrame(want[plain]), check_exact=True)
    if "geometry" in want.columns:
        assert len(got["geometry"]) == len(want["geometry"])
        for g, w in zip(got["geometry"], want["geometry"]):
            assert_same_geometry(g, w)


def _boxes_frames(bounds_list, crs=3857):
    return [G.GeoFrame({"d": range(len(bounds_list))}, geometry=[P.box(*b) for b in bounds_list], crs=crs)
            for G, P in PACKAGES]


# Download boxes: 0 and 1 overlap by half, 2 is disjoint, 3 touches 2 and
# 4 is covered by 0 and 1 (dropped by dedup).
DOWNLOAD_BOXES = [[0.0, 0.0, 1200.0, 1200.0], [600.0, 0.0, 1800.0, 1200.0],
                  [2400.0, 0.0, 3600.0, 1200.0], [3600.0, 0.0, 4800.0, 1200.0],
                  [300.0, 100.0, 1500.0, 1100.0]]


def _detections(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 1000, n)
    y0 = rng.integers(0, 1000, n)
    boxes = np.stack([x0, y0, np.minimum(x0 + rng.integers(4, 80, n), 1024),
                      np.minimum(y0 + rng.integers(4, 80, n), 1024)], 1)
    boxes[:5, 0] = 0      # border cases for the areas
    boxes[5:10, 3] = 1024
    conf = rng.random(n)
    cls = rng.integers(0, 5, n)
    bbox = rng.integers(0, 5, n)
    xo, yo = rng.integers(0, 6, n) * 1024, rng.integers(0, 6, n) * 1024
    specs = {S: [S(year=2014, bbox_ind=int(b), x_offset=int(x), y_offset=int(y)) for b, x, y in zip(bbox, xo, yo)]
             for S in (TTileSpec, JTileSpec)}
    return boxes, conf, cls, specs


def test_pixel_maps_identical():
    rng = np.random.default_rng(1)
    norm = rng.random((200, 4))
    np.testing.assert_array_equal(tgeo.yolo_norm_to_pixels(norm), jgeo.yolo_norm_to_pixels(norm))
    args = (rng.uniform(0, 1024, 50), rng.uniform(0, 1024, 50), rng.integers(0, 6, 50) * 1024.0,
            rng.integers(0, 6, 50) * 1024.0, np.tile([1e5, 2e5, 1.012e5, 2.012e5], (50, 1)))
    for g, w in zip(tgeo.pixels_to_mercator(*args), jgeo.pixels_to_mercator(*args)):
        np.testing.assert_array_equal(g, w)


def _geocoded():
    boxes, conf, cls, specs = _detections()
    tdl, jdl = _boxes_frames(DOWNLOAD_BOXES)
    got = tgeo.geocode_detections(boxes, conf, cls, specs[TTileSpec], tdl)
    want = jgeo.geocode_detections(boxes, conf, cls, specs[JTileSpec], jdl)
    return got, want, specs, (tdl, jdl)


def test_geocode_detections_equal():
    got, want, _, _ = _geocoded()
    assert got.crs == 4326 and len(got) == 300
    assert_frames_equal(got, want)
    empty = tgeo.geocode_detections(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int), [],
                                    _boxes_frames(DOWNLOAD_BOXES)[0])
    assert_frames_equal(empty, jgeo.geocode_detections(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int), [],
                                                       _boxes_frames(DOWNLOAD_BOXES)[1]))
    with pytest.raises(ValueError, match="tile specs"):
        tgeo.geocode_detections(np.zeros((2, 4)), np.zeros(2), np.zeros(2, int), [], got)


def test_download_box_dedup_equal():
    tdl, jdl = _boxes_frames(DOWNLOAD_BOXES)
    tdd, jdd = tdedup.deduplicate_download_boxes(tdl), jdedup.deduplicate_download_boxes(jdl)
    assert_frames_equal(tdd, jdd)
    assert tdd["bbox_ind"].tolist() == [0, 1, 2, 3]  # box 4 is covered
    got, want, specs, _ = _geocoded()
    got["bbox_ind"] = [s.bbox_ind for s in specs[TTileSpec]]
    want["bbox_ind"] = [s.bbox_ind for s in specs[JTileSpec]]
    tout = tdedup.deduplicate_gdf_with_bboxes(tdd, got)
    jout = jdedup.deduplicate_gdf_with_bboxes(jdd, want)
    assert_frames_equal(tout, jout)
    assert 0 < len(tout) < len(got)  # rows of box 4 and in box 1's covered half go
    clipped = sum(g.bounds != w.bounds for g, w in zip(tout["geometry"], got.loc[tout.index, "geometry"]))
    assert clipped > 0  # and rows straddling box 1's cut are clipped
    with pytest.raises(ValueError, match="bbox_ind"):
        tdedup.deduplicate_gdf_with_bboxes(tdd, got.drop(columns=["bbox_ind"]))


def test_cage_areas_equal_on_border_cases():
    """tests/test_post.py's border cases (a circle on the x border, in a
    corner, on the y border, inside; squares and the other types), plus the
    geocoded frame."""
    cols = {
        "xmin": [0, 100, 0, 10, 100, 0, 5], "xmax": [50, 200, 1024, 60, 1024, 40, 30],
        "ymin": [10, 20, 0, 0, 30, 0, 5], "ymax": [60, 120, 40, 1024, 90, 1024, 25],
        "xmin_m": [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 2.0], "xmax_m": [10.0, 8.0, 8.0, 6.0, 4.0, 3.5, 7.25],
        "ymin_m": [0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 1.0], "ymax_m": [6.0, 8.0, 8.0, 10.0, 5.0, 9.0, 2.5],
        "type": ["circle_farm", "square_farm", "circle_farm", "circle_farm", "square_farm",
                 "triangle_farm", "rectangle_farm"],
    }
    frames = [G.GeoFrame(dict(cols), geometry=[P.box(0, 0, 1, 1)] * 7, crs=4326) for G, P in PACKAGES]
    assert_frames_equal(tareas.cage_areas(frames[0]), jareas.cage_areas(frames[1]))
    got, want, _, _ = _geocoded()
    assert_frames_equal(tareas.cage_areas(got), jareas.cage_areas(want))
    w, h = np.r_[10.0, 8.0, 3.0], np.r_[6.0, 8.0, 9.0]
    xb, yb = np.r_[True, True, False], np.r_[False, True, True]
    for g, v in zip(tareas.circle_areas(w, h, xb, yb), jareas.circle_areas(w, h, xb, yb)):
        np.testing.assert_array_equal(g, v)
    for g, v in zip(tareas.square_areas(w, h), jareas.square_areas(w, h)):
        np.testing.assert_array_equal(g, v)


def _coast_and_detections(n, seed=7):
    """tests/test_post.py's jagged coast with n square detections that
    straddle the coast band, in EPSG:3857, from each package."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1000, 41)
    ys = 400 + rng.uniform(-150, 150, len(xs))
    ring = np.concatenate([np.stack([xs, ys], 1), [[1000, 0], [0, 0]]], 0)
    cx, cy, s = rng.uniform(-50, 1050, n), rng.uniform(0, 800, n), rng.uniform(2, 30, n)
    out = []
    for G, P in PACKAGES:
        land = G.GeoFrame({"n": [0]}, geometry=[P.Polygon(ring)], crs=3857)
        dets = G.GeoFrame({"id": np.arange(n)},
                          geometry=[P.box(x - w, y - w, x + w, y + w) for x, y, w in zip(cx, cy, s)],
                          crs=3857)
        out.append((land, dets))
    return out


def test_exact_land_filter_equal():
    (tl, td), (jl, jd) = _coast_and_detections(400)
    got, want = tgeo.remove_land_detections(td, tl), jgeo.remove_land_detections(jd, jl)
    assert_frames_equal(got, want)
    assert 0 < len(got) < 400


@pytest.mark.parametrize("crs", [3857, 4326])
def test_hybrid_land_filter_equal_above_switch(crs):
    """Above the 2,000-row switch of run_pipeline, in the detections' own
    CRS (geocode emits 4326): the port's hybrid filter equals the JAX
    package's and both equal the exact filter row for row."""
    (tl, td), (jl, jd) = _coast_and_detections(2500)
    td, jd = td.to_crs(crs), jd.to_crs(crs)
    got = tland.remove_land_detections_hybrid(td, tl)
    assert_frames_equal(got, jland.remove_land_detections_hybrid(jd, jl))
    assert got["id"].tolist() == tgeo.remove_land_detections(td, tl)["id"].tolist()
    assert 0 < len(got) < 2500


def test_land_mask_equal():
    (tl, td), (jl, jd) = _coast_and_detections(300)
    tm = tland.build_land_mask(tl, resolution_m=20.0, with_boundary=True)
    jm = jland.build_land_mask(jl, resolution_m=20.0, with_boundary=True)
    np.testing.assert_array_equal(tm.mask, jm.mask)
    np.testing.assert_array_equal(tm.boundary, jm.boundary)
    assert tm.bounds == jm.bounds and tm.crs == jm.crs
    np.testing.assert_array_equal(tm.box_status(td.bounds_array()), jm.box_status(jd.bounds_array()))
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-100, 1100, 500), rng.uniform(-100, 900, 500)
    np.testing.assert_array_equal(tm.contains(x, y), jm.contains(x, y))
    assert_frames_equal(tland.remove_land_detections_masked(td, tm), jland.remove_land_detections_masked(jd, jm))


def test_nms_cross_tile_equal():
    got, want, _, _ = _geocoded()
    assert_frames_equal(tdedup.nms_cross_tile(got, 0.3), jdedup.nms_cross_tile(want, 0.3))
