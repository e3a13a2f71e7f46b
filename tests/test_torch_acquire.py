"""The port's acquisition layer (aquaculture_tpu_torch.acquire, geo.shapefile,
data.imageboxes) against the JAX package's, on the CPU.

The same seeded inputs go through both packages; tolerance is "equal"
everywhere: the same stored keys and bytes, the same transport calls, the
same frames (columns, dtypes, values, coordinates), byte-identical files.
Nothing reaches the network: transports and fetchers are injected.
"""

import datetime
import io
import os
import sys
import zipfile

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.acquire import bathymetry as jbathy
from aquaculture_tpu.acquire import landfilter as jland
from aquaculture_tpu.acquire import shapefiles as jshapes
from aquaculture_tpu.acquire import wms as jwms
from aquaculture_tpu.data import imageboxes as jboxes
from aquaculture_tpu.data.filenames import TileSpec as JTileSpec
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.geo import shapefile as jshp
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.acquire import bathymetry as tbathy
from aquaculture_tpu_torch.acquire import landfilter as tland
from aquaculture_tpu_torch.acquire import shapefiles as tshapes
from aquaculture_tpu_torch.acquire import wms as twms
from aquaculture_tpu_torch.data import imageboxes as tboxes
from aquaculture_tpu_torch.data.filenames import TileSpec as TTileSpec, encode_tile_name
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.geo import shapefile as tshp

from test_torch_geo import assert_same_geometry
from test_torch_overlay import assert_same_rings, jax_python_sweep
from test_torch_post import assert_frames_equal

# (port, JAX) module pairs, in that order everywhere below
PACKAGES = ((tgf, tpoly), (jgf, jpoly))


class _StoppedDate:
    """datetime's view for the shapefile writers, with today() fixed: both
    stamp the .dbf header with the date, so their files are byte-identical
    within one day only."""

    class date:
        @staticmethod
        def today():
            return datetime.date(2026, 1, 2)


@pytest.fixture
def stopped_date(monkeypatch):
    for mod in (tshp, jshp):
        monkeypatch.setattr(mod, "datetime", _StoppedDate)


def _tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ------------------------------------------------------------------ wms


@pytest.mark.parametrize("year", [2000, 2014, 2020, 2021, "2021", np.int64(2018)])
def test_layer_name_equal(year):
    assert twms.layer_name(year) == jwms.layer_name(year)
    assert (twms.IGN_WMS_URL, twms.PROBE_SIZE, twms.FULL_SIZE) == (jwms.IGN_WMS_URL, jwms.PROBE_SIZE, 6144)


def _coast_shapes(P, case):
    rng = np.random.default_rng(7)
    if case == "exact_multiple":  # bounds on the 1200 m grid: the float step's extra column
        return [P.box(0.0, 0.0, 2400.0, 1200.0)]
    if case == "mercator_offsets":  # the coast's real magnitude, off the grid by fractions
        return [P.box(560_000.3, 5_330_000.7, 563_600.3, 5_331_200.7), P.box(1e6 / 3, 1e6 / 7, 1e6 / 3 + 3600, 1e6 / 7 + 10)]
    if case == "star":
        th = np.sort(rng.uniform(0, 2 * np.pi, 14))
        r = rng.uniform(800, 4000, 14)
        return [P.Polygon(np.stack([20_000 + r * np.cos(th), 30_000 + r * np.sin(th)], 1))]
    # holes, a multipolygon, an empty and a zero-area geometry (skipped)
    ring = [(0, 0), (6000, 0), (6000, 5000), (0, 5000)]
    hole = [(1500, 1500), (4500, 1500), (4500, 3500), (1500, 3500)]
    return [P.Polygon(ring, [hole]), P.MultiPolygon([P.box(9000, 0, 9100, 100), P.box(12_000, 50, 14_500, 2000)]),
            P.EMPTY, P.Polygon([(0, 0), (10, 0), (20, 0)])]


@pytest.mark.parametrize("case", ["exact_multiple", "mercator_offsets", "star", "holes_multi_empty"])
@pytest.mark.parametrize("size", [1200.0, 700.0])
def test_tile_shapefile_boxes_equal(case, size):
    got = twms.tile_shapefile(_coast_shapes(tpoly, case), size)
    want = jwms.tile_shapefile(_coast_shapes(jpoly, case), size)
    assert len(got) == len(want) > 0
    assert [b.bounds for b in got] == [b.bounds for b in want]
    for g, w in zip(got, want):
        assert_same_geometry(g, w)


class FakeTransport:
    """Blank below y=0, imagery above; box ``flaky`` raises ConnectionError
    on its first request, box ``down`` on every request. Records calls."""

    def __init__(self, flaky=(), down=()):
        self.calls, self.flaky, self.down, self.seen = [], set(flaky), set(down), set()

    def getmap(self, layer, bbox, size):
        self.calls.append((layer, tuple(bbox), size))
        key = (round(bbox[0]), round(bbox[1]))
        if key in self.down or (key in self.flaky and key not in self.seen):
            self.seen.add(key)
            raise ConnectionError(f"reset by peer at {key}")
        v = 255 if bbox[1] < 0 else 40 + int(bbox[0] // 1200) % 150
        buf = io.BytesIO()
        Image.fromarray(np.full((8, 8, 3), v, np.uint8)).save(buf, format="TIFF")
        return buf.getvalue()


def _download(wms, P, root, years, **transport):
    coast = [P.box(1, -1199, 4799, 1199)]  # 4 x 2 boxes of 1200 m (odd indices above y=0), the lower row blank
    t = FakeTransport(**transport)
    store = wms.LocalBlobStore(str(root))
    frame = wms.download_images_within_shape(coast, years, t, store, box_size=1200.0)
    return frame, t, store


@pytest.mark.parametrize("years", [[2014], [2003, 2021]])
def test_download_loop_equal_with_blanks_retries_and_resume(tmp_path, years):
    runs = {}
    for name, wms, (_, P) in (("port", twms, PACKAGES[0]), ("jax", jwms, PACKAGES[1])):
        frame, t, store = _download(wms, P, tmp_path / name, years, flaky={(1201, 1)}, down={(3601, 1)})
        stored = _tree_bytes(tmp_path / name)
        # resume: stored boxes are skipped; the blank, and the box that stayed down, are probed again
        _, t2, _ = _download(wms, P, tmp_path / name, years)
        runs[name] = frame, t.calls, stored, t2.calls
    (frame, calls, stored, resume), (jframe, jcalls, jstored, jresume) = runs["port"], runs["jax"]
    assert_frames_equal(frame, jframe)
    assert calls == jcalls and resume == jresume
    assert stored == jstored
    layers = [twms.layer_name(y) for y in years]
    assert sorted(stored) == sorted(f"coastal_french_data/tifs/{lay}_{i}.tif" for lay in layers for i in (1, 3, 5))
    assert sum(c[2] == 6144 for c in calls) == 3 * len(years)
    assert sum(c[2] == 6144 for c in resume) == len(years)  # the box that was down, fetched now
    assert len(frame) == 8 and frame.crs == 3857


def test_wms_reexports_the_ports_store():
    from aquaculture_tpu_torch.data import store

    assert twms.LocalBlobStore is store.LocalBlobStore and twms.BlobStore is store.BlobStore
    assert twms.HttpWmsTransport().url == jwms.HttpWmsTransport().url == twms.IGN_WMS_URL


# ------------------------------------------------------------------ asc


ASC = """ncols {n}
nrows 3
{xkey} {x0}
{ykey} 40.0
cellsize 0.5
NODATA_value -9999
{rows}"""


def _asc(seed, x0, center=False, n=4):
    rng = np.random.default_rng(seed)
    vals = np.round(rng.uniform(-60, -1, (3, n)), 3)
    vals[rng.random((3, n)) < 0.2] = -9999
    rows = "\n".join(" ".join(f"{v:g}" for v in r) for r in vals) + "\n"
    keys = ("xllcenter", "yllcenter") if center else ("xllcorner", "yllcorner")
    return ASC.format(n=n, xkey=keys[0], x0=x0, ykey=keys[1], rows=rows)


def _same_grid(got, want):
    np.testing.assert_array_equal(got.array, want.array)  # NaN in place
    assert got.array.dtype == want.array.dtype == np.float32
    assert (got.origin_x, got.origin_y, got.pixel_w, got.pixel_h, got.epsg) == \
        (want.origin_x, want.origin_y, want.pixel_w, want.pixel_h, want.epsg)
    assert got.bounds == want.bounds


@pytest.mark.parametrize("center", [False, True])
def test_read_asc_equal(tmp_path, center):
    text = _asc(1, 10.0, center)
    _same_grid(tbathy.read_asc(text), jbathy.read_asc(text))
    path = tmp_path / "g.asc"
    path.write_text(text)
    _same_grid(tbathy.read_asc(str(path)), jbathy.read_asc(str(path)))
    assert np.isnan(tbathy.read_asc(text).array).any()


def test_merge_asc_grids_first_wins_equal():
    texts = [_asc(2, 10.0), _asc(3, 11.0, n=6), _asc(4, 12.25, center=True), _asc(5, 10.0, n=3)]
    got = tbathy.merge_asc_grids([tbathy.read_asc(t) for t in texts])
    want = jbathy.merge_asc_grids([jbathy.read_asc(t) for t in texts])
    _same_grid(got, want)
    assert got.array.shape == (4, 8)  # the center-registered grid sits half a cell lower


def test_build_bathymetry_geotiff_byte_equal(tmp_path):
    grids = {"F4": _asc(6, 4.0), "F5": _asc(7, 6.0), "E5": _asc(8, 4.0, center=True)}
    fetched = []

    def fetch(tile):
        fetched.append(tile)
        return grids[tile]

    got = tbathy.build_bathymetry(str(tmp_path / "t" / "EMOD.tif"), fetch=fetch)
    want = jbathy.build_bathymetry(str(tmp_path / "j" / "EMOD.tif"), fetch=fetch)
    _same_grid(got, want)
    assert fetched == list(tbathy.EMOD_TILES) * 2 and tbathy.EMOD_URL == jbathy.EMOD_URL
    assert (tmp_path / "t" / "EMOD.tif").read_bytes() == (tmp_path / "j" / "EMOD.tif").read_bytes()


# ------------------------------------------------------------------ shapefiles (download)


def test_load_shapefiles_offline_equal(tmp_path, monkeypatch):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("coast/coast.prj", "GEOGCS")
        z.writestr("readme.txt", "seeded payload")
    payload = buf.getvalue()
    out, warned = {}, {}
    for name, mod in (("port", tshapes), ("jax", jshapes)):
        calls, warnings = [], []
        monkeypatch.setattr(mod, "log_warning", lambda msg, *a, w=warnings: w.append(msg % a))

        def fetch(url, calls=calls):
            calls.append(url)
            return payload

        root = tmp_path / name
        first = mod.load_shapefiles(str(root), fetch=fetch)
        second = mod.load_shapefiles(str(root), fetch=fetch)  # resumes: fetches nothing
        assert first == second and calls == list(mod.SOURCES.values())
        out[name] = ({k: os.path.relpath(v, root) for k, v in first.items()}, _tree_bytes(root), calls)
        warned[name] = [w.replace(str(root), "ROOT") for w in warnings]
    assert out["port"] == out["jax"]
    assert warned["port"] == warned["jax"] and len(warned["port"]) == 2  # the EEZ stays a manual download
    assert tshapes.SOURCES == jshapes.SOURCES and tshapes.EEZ_MANUAL_URL == jshapes.EEZ_MANUAL_URL


# ------------------------------------------------------------------ geo.shapefile


def _shape_frames(G, P, kind):
    if kind == "points":
        return G.GeoFrame({"id": [1, 2, 3], "val": [1.5, np.nan, -2.25], "name": ["a", "bb", "ccc"]},
                          geometry=[P.Point(1.5, 2.5), P.Point(-3.0, 4.0), P.Point(1e6 / 3, 43.125)], crs=4326)
    ccw = [(20, 0), (30, 0), (30, 10), (20, 10)]
    cw_hole = [(22, 2), (22, 8), (28, 8), (28, 2)]
    return G.GeoFrame(
        {"name": ["box", "holes", "multi", "null"], "area_m2": [100.0, 64.0, 5.5, 0.0], "n": [1, 2, 3, 4]},
        geometry=[P.box(0, 0, 10, 10), P.Polygon(ccw, [cw_hole, [(23, 3), (24, 3), (24, 4)]]),
                  P.MultiPolygon([P.box(40, 0, 41, 1), P.Polygon([(50, 0), (54, 0), (52, 3)])]), P.EMPTY],
        crs=3857)


@pytest.mark.parametrize("kind", ["points", "polygons"])
def test_shapefile_writes_byte_identical_and_reads_across(tmp_path, stopped_date, kind):
    for name, shp, (G, P) in (("port", tshp, PACKAGES[0]), ("jax", jshp, PACKAGES[1])):
        (tmp_path / name).mkdir()
        shp.write_shapefile(str(tmp_path / name / "s.shp"), _shape_frames(G, P, kind))
    for ext in (".shp", ".shx", ".dbf"):
        assert (tmp_path / "port" / f"s{ext}").read_bytes() == (tmp_path / "jax" / f"s{ext}").read_bytes(), ext
    assert (tmp_path / "port" / "s.dbf").read_bytes()[1:4] == bytes([126, 1, 2])
    # each package reads the other's files, as the writer's own package does
    for src in ("port", "jax"):
        got = tshp.read_shapefile(str(tmp_path / src / "s.shp"), crs=4326)
        want = jshp.read_shapefile(str(tmp_path / src / "s.shp"), crs=4326)
        assert_frames_equal(got, want)
    assert len(got) == (3 if kind == "points" else 4)


def _polyline_record(parts):
    pts = np.concatenate(parts).astype("<f8")
    bx = (*pts.min(0), *pts.max(0))
    offs = np.cumsum([0] + [len(p) for p in parts[:-1]])
    body = np.array([3], "<u4").tobytes() + np.array(bx, "<f8").tobytes()
    body += np.array([len(parts), len(pts), *offs], "<u4").tobytes() + pts.tobytes()
    return body


def _write_handmade(base, records, fields, rows, deleted=()):
    """A .shp of the given record bodies (PolyLine, Null, Point) and a .dbf
    with fields of type C, N, F and L, written from the spec."""
    import struct

    shp = b"".join(struct.pack(">II", i + 1, len(r) // 2) + r for i, r in enumerate(records))
    head = struct.pack(">I", 9994) + b"\0" * 20 + struct.pack(">I", 50 + len(shp) // 2)
    head += struct.pack("<II", 1000, 3) + b"\0" * 64
    with open(base + ".shp", "wb") as f:
        f.write(head + shp)
    desc = b"".join(n.encode().ljust(11, b"\0") + t.encode() + b"\0" * 4 + bytes([w, d]) + b"\0" * 14
                    for n, t, w, d in fields)
    size = 1 + sum(w for _, _, w, _ in fields)
    with open(base + ".dbf", "wb") as f:
        f.write(struct.pack("<B3BIHH20x", 3, 126, 1, 2, len(rows), 32 + len(desc) + 1, size) + desc + b"\r")
        for i, row in enumerate(rows):
            f.write((b"*" if i in deleted else b" ") + b"".join(
                str(v).encode("latin-1")[:w].rjust(w) for v, (_, _, w, _) in zip(row, fields)))
        f.write(b"\x1a")


FIELDS = [("NAME", "C", 8, 0), ("COUNT", "N", 6, 0), ("DEPTH", "N", 9, 3), ("RATIO", "F", 10, 4), ("WET", "L", 1, 0)]


@pytest.mark.parametrize("deleted", [(), (1,)])
def test_polyline_null_and_dbf_types_read_equal(tmp_path, deleted):
    import struct

    rng = np.random.default_rng(11)
    records = [_polyline_record([rng.uniform(0, 100, (5, 2))]),
               _polyline_record([rng.uniform(0, 100, (3, 2)), rng.uniform(0, 100, (4, 2))]),
               struct.pack("<I", 0),
               struct.pack("<Idd", 1, 2.5, -7.25)]
    rows = [("coast", 12, "1.500", "0.2500", "T"), ("isles", "", "", "x", "N"),
            ("", 7, "-3.125", "1e-3", "y"), ("point", "abc", "4", "", "?")]
    base = str(tmp_path / "lines")
    _write_handmade(base, records, FIELDS, rows, deleted)
    got, want = tshp.read_shapefile(base), jshp.read_shapefile(base)
    assert_frames_equal(got, want)
    assert [type(g).__name__ for g in got["geometry"]] == ["LineString", "MultiLineString", "Empty", "Point"]
    if not deleted:
        assert got["WET"].tolist() == [True, False, True, False]
        assert got["COUNT"].iloc[0] == 12 and got["DEPTH"].iloc[2] == -3.125
    else:  # a deleted record leaves fewer attribute rows than shapes: geometry only
        assert list(got.columns) == ["geometry"]


@pytest.mark.parametrize("sibling", ["t.dbf", "t.shx", "t.prj", "t.shp", "t", "T.SHP"])
def test_shapefile_read_by_sibling_extension_equal(tmp_path, stopped_date, sibling):
    base = "T" if sibling == "T.SHP" else "t"
    tshp.write_shapefile(str(tmp_path / f"{base}.shp"), _shape_frames(tgf, tpoly, "polygons"))
    (tmp_path / f"{base}.prj").write_text("PROJCS")
    assert_frames_equal(tshp.read_shapefile(str(tmp_path / sibling)), jshp.read_shapefile(str(tmp_path / sibling)))


# ------------------------------------------------------------------ land filter


def _land_inputs(P, case):
    if case == "rectilinear":
        return ([[(0, 0), (10, 0), (10, 10), (0, 10), (0, 0)], [(12, 2), (14, 2), (14, 4), (12, 4), (12, 2)]],
                P.box(-1, -1, 15, 11), None, (0,))
    if case == "triangle_eez":
        return ([[(0, 0), (10, 0), (10, 10), (0, 10), (0, 0)], [(20, 0), (26, 0), (26, 6), (20, 6), (20, 0)]],
                P.box(-1, -1, 30, 11), P.Polygon([(18, -1), (30, -1), (30, 11), (18, 11)]), (0,))
    # a jagged shore with land to the north, two islands (one half under
    # the EEZ), a skewed EEZ and two primary faces kept
    rng = np.random.default_rng(5)
    xs = np.linspace(0, 40, 21)
    ys = 10 + rng.uniform(-1.5, 1.5, len(xs))
    shore = [*zip(xs, ys), (40, 30), (0, 30), (xs[0], ys[0])]
    islands = [[(5, 3), (8, 3), (8, 6), (5, 6), (5, 3)], [(20, 0), (23, 1), (22, 4), (19, 3), (20, 0)],
               [(30, 14), (33, 14), (33, 17), (30, 17), (30, 14)]]
    eez = P.Polygon([(-5, -5), (45, -5), (45, 2.5), (-5, 1.0)])
    return [shore, *islands], P.box(-5, -5, 45, 35), eez, (0, 1)


@pytest.mark.parametrize("case", ["rectilinear", "triangle_eez", "jagged_islands"])
def test_build_land_filter_same_rings(case):
    lines, country, eez, keep = _land_inputs(tpoly, case)
    got = tland.build_land_filter(lines, country, eez, keep_faces=keep, crs=3857)
    lines, country, eez, keep = _land_inputs(jpoly, case)
    with jax_python_sweep():
        want = jland.build_land_filter(lines, country, eez, keep_faces=keep, crs=3857)
    assert got.crs == want.crs == 3857
    assert got["kind"].tolist() == want["kind"].tolist()
    assert "primary" in got["kind"].tolist()
    for g, w in zip(got["geometry"], want["geometry"]):
        assert_same_rings(g, w)
    pd.testing.assert_frame_equal(pd.DataFrame(got).drop(columns="geometry"),
                                  pd.DataFrame(want).drop(columns="geometry"))


def test_build_land_filter_refuses_open_linework():
    for mod, P in ((tland, tpoly), (jland, jpoly)):
        with pytest.raises(ValueError, match="no closed faces"):
            mod.build_land_filter([[(0, 0), (5, 5)]], P.box(-1, -1, 6, 6))


# ------------------------------------------------------------------ image boxes


SPECS = [(2014, 0, 0, 0), (2014, 3, 1024, 0), (2021, 1, 5120, 5120), (2003, 2, 3072, 4096)]
TIF_BOUNDS = [(0.0, 0.0, 1200.0, 1200.0), (560_000.3, 5_330_000.7, 561_200.3, 5_331_200.7),
              (1e6 / 3, 1e6 / 7, 1e6 / 3 + 1200, 1e6 / 7 + 1200)]


@pytest.mark.parametrize("bounds", TIF_BOUNDS)
def test_image_box_for_spec_equal(bounds):
    for year, b, x, y in SPECS:
        got = tboxes.image_box_for_spec(TTileSpec(year, b, x, y), bounds)
        want = jboxes.image_box_for_spec(JTileSpec(year, b, x, y), bounds)
        assert got.bounds == want.bounds
        assert_same_geometry(got, want)


def _download_boxes(G, P):
    return G.GeoFrame({"d": [0, 1, 2, 3]}, geometry=[P.box(*TIF_BOUNDS[1]), P.box(0, 0, 1200, 1200),
                                                      P.box(600, 0, 1800, 1200), P.box(*TIF_BOUNDS[2])], crs=3857)


FILES = ["ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.jpeg", "ORTHOIMAGERY.ORTHOPHOTOS2014_1_1024_0.jpeg",
         "ORTHOIMAGERY.ORTHOPHOTOS2014_2_2048_1024.jpeg", "ORTHOIMAGERY.ORTHOPHOTOS.ORTHO-EXPRESS.2021_3_0_5120.jpeg",
         "ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0 (1).jpeg", "ORTHOIMAGERY.ORTHOPHOTOS(1)2014_0_1024_0.jpeg",
         "ORTHOIMAGERY.ORTHOPHOTOS2014_9_0_0.jpeg",
         "ORTHOIMAGERY.ORTHOPHOTOS2014_3.tif", "sub/ORTHOIMAGERY.ORTHOPHOTOS2009_1_5120_3072.jpg"]


def test_build_image_boxes_equal():
    got = tboxes.build_image_boxes(FILES, _download_boxes(*PACKAGES[0]))
    want = jboxes.build_image_boxes(FILES, _download_boxes(*PACKAGES[1]))
    assert_frames_equal(got, want)
    # the duplicate-suffix names (one would decode), the unknown box and the download name are skipped
    assert len(got) == 5 and "ORTHOIMAGERY.ORTHOPHOTOS2009_1_5120_3072.jpg" in list(got["image_file"])


def _images(seed):
    """Seeded tiles: complete, blank (white, near-white, black), partly
    blank (white rows, white columns, an irregular white area)."""
    rng = np.random.default_rng(seed)
    sea = rng.integers(20, 200, (64, 64, 3), dtype=np.uint8)
    rows, cols, blob = sea.copy(), sea.copy(), sea.copy()
    rows[40:] = 255
    cols[:, :23] = 252
    yy, xx = np.mgrid[:64, :64]
    blob[(yy - 10) ** 2 + (xx - 50) ** 2 < 300] = 255
    blob[:, 60:] = 251
    hole = sea.copy()
    hole[:, 30:34] = 255  # splits the tile: the larger side stays
    return {"complete": sea, "white": np.full((64, 64, 3), 255, np.uint8),
            "near_white": np.full((64, 64, 3), 251, np.uint8), "black": np.zeros((64, 64, 3), np.uint8),
            "rows": rows, "cols": cols, "blob": blob, "split": hole, "none": None}


@pytest.mark.parametrize("seed", [0, 1])
def test_classify_blank_status_equal(seed):
    statuses = {k: tboxes.classify_blank_status(im) for k, im in _images(seed).items()}
    assert statuses == {k: jboxes.classify_blank_status(im) for k, im in _images(seed).items()}
    assert statuses["complete"] == "complete" and statuses["none"] == statuses["white"] == "blank"
    assert statuses["rows"] == statuses["cols"] == statuses["blob"] == "partly blank"


@pytest.mark.parametrize("kind", ["rows", "cols", "blob", "split", "white"])
def test_correct_partly_blank_geom_equal(kind):
    img = _images(3)[kind]
    got = tboxes.correct_partly_blank_geom(img, tpoly.box(*TIF_BOUNDS[1]))
    want = jboxes.correct_partly_blank_geom(img, jpoly.box(*TIF_BOUNDS[1]))
    assert_same_geometry(got, want)
    assert got.is_empty == (kind == "white")
    if not got.is_empty:
        assert 0 < got.area < tpoly.box(*TIF_BOUNDS[1]).area


def _write_tiles(d):
    """One tile per kind on a 2 x 2 grid of three download boxes, as JPEG
    (white reads back 254-255), plus a duplicate-suffix file."""
    d.mkdir()
    kinds = ["complete", "white", "rows", "cols", "blob", "split", "black", "complete"]
    for i, kind in enumerate(kinds):
        spec = TTileSpec(2014, i % 3 + 1, 1024 * (i // 3), 1024 * (i % 2))
        Image.fromarray(_images(i)[kind]).save(d / encode_tile_name(spec), quality=90)
    Image.fromarray(_images(0)["complete"]).save(d / "ORTHOIMAGERY.ORTHOPHOTOS(1)2014_1_0_1024.jpeg")


def test_load_final_image_boxes_with_and_without_cache(tmp_path):
    _write_tiles(tmp_path / "tiles")
    got = tboxes.load_final_image_boxes(_download_boxes(*PACKAGES[0]), tboxes.LocalImageStore(str(tmp_path / "tiles")),
                                        cache_dir=str(tmp_path / "t"))
    want = jboxes.load_final_image_boxes(_download_boxes(*PACKAGES[1]),
                                         jboxes.LocalImageStore(str(tmp_path / "tiles")), cache_dir=str(tmp_path / "j"))
    assert_frames_equal(got, want)
    # white and black are blank; box 2's tiles lie in the part box 1 covers (dedup)
    assert sorted(set(got["image_status"])) == ["complete", "partly blank"] and len(got) == 4
    assert (tmp_path / "t" / "image_boxes_rmblank.geojson").read_bytes() == \
        (tmp_path / "j" / "image_boxes_rmblank.geojson").read_bytes()
    # the cached artifact reads back in place of the screening
    cached = tboxes.load_final_image_boxes(None, None, cache_dir=str(tmp_path / "t"))
    assert_frames_equal(cached, jboxes.load_final_image_boxes(None, None, cache_dir=str(tmp_path / "j")))
    uncached = tboxes.load_final_image_boxes(_download_boxes(*PACKAGES[0]),
                                             tboxes.LocalImageStore(str(tmp_path / "tiles")))
    assert_frames_equal(uncached, got)


def test_remove_white_image_boxes_with_blank_key_equal(tmp_path):
    _write_tiles(tmp_path / "tiles")
    frames = []
    for boxes, (G, P) in ((tboxes, PACKAGES[0]), (jboxes, PACKAGES[1])):
        ib = boxes.build_image_boxes(sorted(os.listdir(tmp_path / "tiles")), _download_boxes(G, P))
        ib = ib.drop(columns="image_file")  # rebuilt from the codec's columns
        ib.crs = 3857
        store = boxes.LocalImageStore(str(tmp_path / "tiles"))
        key = pd.DataFrame({"image_file": store.list_images()[:4],
                            "image_status": ["complete", "partly blank", "blank", "partly blank"]})
        frames.append((boxes.remove_white_image_boxes(ib, store), boxes.remove_white_image_boxes(ib, store, key)))
    for got, want in zip(*frames):
        assert_frames_equal(got, want)


def test_gcs_image_store_needs_google_cloud_storage(monkeypatch):
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    messages = []
    for mod in (tboxes, jboxes):
        with pytest.raises(ImportError) as e:
            mod.GcsImageStore("bucket")
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "LocalImageStore" in messages[0]
