"""aq-acquire of the port (aquaculture_tpu_torch.cli.acquire) against the JAX
package's CLI on the same inputs, on the CPU, and the flag sets of
cli.acquire and cli.figures against the JAX package's, read by AST.

- ``shapefiles`` with the download injected, ``wms`` through each
  package's real HttpWmsTransport against a WMS endpoint on 127.0.0.1 (a
  thread of the test process), ``bathymetry`` on local .asc grids,
  ``landfilter`` on GeoJSON and .shp linework: the written files (the
  extracted tree, the stored imagery and wanted_bboxes.csv, the GeoTIFF,
  the land GeoJSON) are byte-identical, and the requests are the same.
- cli.acquire has the JAX CLI's subcommands, flags and defaults, and no
  --device (host only); cli.figures has the JAX CLI's plus --device.
"""

import ast
import io
import pathlib
import zipfile

import numpy as np
import pytest
from PIL import Image

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.cli import acquire as jcli
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli import acquire as tcli
from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.geo.shapefile import write_shapefile

import chip_smoke
from test_torch_acquire import _tree_bytes
from test_torch_overlay import jax_python_sweep

ROOT = pathlib.Path(__file__).resolve().parent.parent
CLIS = (("port", tcli), ("jax", jcli))


def test_acquire_shapefiles_equal_and_resumable(tmp_path, monkeypatch):
    def fetch(url):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            z.writestr("shapes/x.txt", url)
        return buf.getvalue()

    def refuse(url):
        raise AssertionError(f"fetched {url} again")

    for name, cli in CLIS:
        mod = "aquaculture_tpu_torch" if cli is tcli else "aquaculture_tpu"
        monkeypatch.setattr(f"{mod}.acquire.shapefiles._default_fetch", fetch)
        cli.main(["shapefiles", "--out", str(tmp_path / name)])
        monkeypatch.setattr(f"{mod}.acquire.shapefiles._default_fetch", refuse)
        cli.main(["shapefiles", "--out", str(tmp_path / name)])
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got == want and sorted(got) == ["raw/europe_coastline/shapes/x.txt", "raw/france_grid/shapes/x.txt"]


def _tiny_tiff(layer, bbox, size):
    """8 px answers: white below y = 0 (a blank probe), texture above."""
    v = 255 if bbox[1] < 0 else 30 + int(abs(bbox[0]) // 1200) % 90
    img = np.full((8, 8, 3), v, np.uint8)
    img[::2, ::3] += 0 if v == 255 else 17
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="TIFF")
    return buf.getvalue()


def _coast(tmp_path, crs):
    ring = [(560_001.0, 5_329_001.0), (563_599.0, 5_329_001.0), (563_599.0, 5_331_199.0), (561_000.0, 5_330_400.0)]
    frame = tgf.GeoFrame({"name": ["coast"]}, geometry=[tpoly.Polygon(ring)], crs=3857).to_crs(crs)
    path = str(tmp_path / f"coast{crs}.geojson")
    frame.to_file(path)
    return path


@pytest.mark.parametrize("crs,years", [(3857, ["2014"]), (4326, ["2009", "2021"])])
def test_acquire_wms_equal_through_loopback(tmp_path, crs, years):
    coast = _coast(tmp_path, crs)
    with chip_smoke.loopback_only(), chip_smoke.WmsLoopback(_tiny_tiff) as wms:
        requests = {}
        for name, cli in CLIS:
            argv = ["wms", "--coast", coast, "--years", *years, "--store", str(tmp_path / name), "--url", wms.url]
            start = len(wms.requests)
            cli.main([*argv, "--bboxes-out", str(tmp_path / f"{name}.csv")])
            middle = len(wms.requests)
            cli.main(argv)  # resumes: only the blank boxes are probed again
            requests[name] = (wms.requests[start:middle], wms.requests[middle:])
    assert requests["port"] == requests["jax"]
    first, resume = requests["port"]
    assert all(size == 1024 for _, _, size in resume) and len(resume) == sum(s == 1024 for _, _, s in first) \
        - sum(s == 6144 for _, _, s in first)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    stored = _tree_bytes(tmp_path / "port")
    assert stored == _tree_bytes(tmp_path / "jax") and len(stored) == sum(s == 6144 for _, _, s in first) > 0
    boxes = load_download_bboxes(str(tmp_path / "port.csv"))
    assert boxes.crs == 3857 and list(boxes["bbox_ind"]) == list(range(len(boxes))) and len(boxes) >= 4


ASC = """ncols 5
nrows 2
{key} {x0}
{ykey} 42.0
cellsize 0.25
NODATA_value -9999
-3 -5 -9999 -8 -13
-2 -4 -6 -9 -12
"""


def test_acquire_bathymetry_equal(tmp_path):
    paths = []
    for name, key, x0 in (("F4_2022", "xllcorner", 4.0), ("F5_2022", "xllcenter", 5.125), ("E5", "xllcorner", 4.5)):
        p = tmp_path / f"{name}.asc"
        p.write_text(ASC.format(key=key, x0=x0, ykey=key.replace("x", "y", 1)))
        paths.append(str(p))
    for name, cli in CLIS:
        cli.main(["bathymetry", "--out", str(tmp_path / name / "EMOD_2022.tif"), "--asc", *paths])
    got = (tmp_path / "port" / "EMOD_2022.tif").read_bytes()
    assert got == (tmp_path / "jax" / "EMOD_2022.tif").read_bytes() and len(got) > 100


def _linework(tmp_path, fmt):
    """Mainland and island loops, country and a skewed EEZ in lon/lat: as
    GeoJSON LineStrings, or as .shp polygons (the CLI takes their rings)."""
    x0, y0 = 5.0, 43.0
    rng = np.random.default_rng(3)
    xs = np.linspace(x0, x0 + 0.4, 17)
    shore = np.stack([xs, y0 + 0.1 + rng.uniform(-0.01, 0.01, len(xs))], 1)
    mainland = np.concatenate([shore, [[x0 + 0.4, y0 + 0.3], [x0, y0 + 0.3]]], 0)
    islands = [np.array([(x0 + 0.1, y0 + 0.03), (x0 + 0.12, y0 + 0.03), (x0 + 0.12, y0 + 0.05), (x0 + 0.1, y0 + 0.05)]),
               np.array([(x0 + 0.3, y0 + 0.01), (x0 + 0.33, y0 + 0.0), (x0 + 0.32, y0 + 0.04)])]
    country = tpoly.box(x0 - 0.1, y0 - 0.1, x0 + 0.5, y0 + 0.4)
    eez = tpoly.Polygon([(x0 - 0.1, y0 - 0.1), (x0 + 0.5, y0 - 0.1), (x0 + 0.5, y0 + 0.02), (x0 - 0.1, y0 + 0.01)])
    paths = {k: str(tmp_path / f"{k}.{'shp' if fmt == 'shp' else 'geojson'}") for k in ("coast", "country", "eez")}
    if fmt == "shp":
        rings = [tpoly.Polygon(r) for r in (mainland, *islands)]
        write_shapefile(paths["coast"], tgf.GeoFrame({"n": [0, 1, 2]}, geometry=rings, crs=4326))
        write_shapefile(paths["country"], tgf.GeoFrame({"n": [0]}, geometry=[country], crs=4326))
        write_shapefile(paths["eez"], tgf.GeoFrame({"n": [0]}, geometry=[eez], crs=4326))
        paths["country"] = paths["country"][:-4] + ".dbf"  # any sibling of the set
    else:
        lines = [tpoly.LineString(np.concatenate([r, r[:1]])) for r in (mainland, *islands)]
        tgf.GeoFrame({"n": [0, 1, 2]}, geometry=lines, crs=4326).to_file(paths["coast"])
        tgf.GeoFrame({"n": [0]}, geometry=[country], crs=4326).to_file(paths["country"])
        tgf.GeoFrame({"n": [0]}, geometry=[eez], crs=4326).to_file(paths["eez"])
    return paths


@pytest.mark.parametrize("fmt", ["geojson", "shp"])
@pytest.mark.parametrize("keep", [["0"], ["0", "1"]])
def test_acquire_landfilter_equal(tmp_path, fmt, keep):
    p = _linework(tmp_path, fmt)
    argv = ["landfilter", "--coastline", p["coast"], "--country", p["country"], "--eez", p["eez"],
            "--keep-faces", *keep]
    tcli.main([*argv, "--out", str(tmp_path / "port.geojson")])
    with jax_python_sweep():
        jcli.main([*argv, "--out", str(tmp_path / "jax.geojson")])
    got = (tmp_path / "port.geojson").read_bytes()
    assert got == (tmp_path / "jax.geojson").read_bytes()
    land = jgf.read_file(str(tmp_path / "jax.geojson"))
    assert land["kind"].tolist().count("primary") == len(keep) and "island" in land["kind"].tolist()


def test_acquire_landfilter_without_linework_exits(tmp_path):
    pts = str(tmp_path / "pts.geojson")
    jgf.GeoFrame({"n": [0]}, geometry=[jpoly.Point(5.0, 43.0)], crs=4326).to_file(pts)
    messages = []
    for _, cli in CLIS:
        with pytest.raises(SystemExit) as e:
            cli.main(["landfilter", "--coastline", pts, "--country", pts, "--out", str(tmp_path / "x.geojson")])
        messages.append(str(e.value))
    assert messages[0] == messages[1] == f"no linework found in {pts}"


def _flags(path):
    """{parser: {option: keywords}} of every add_argument call in a CLI,
    with each subparser's name; values as source text."""
    out = {}
    parsers = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and \
                getattr(node.value.func, "attr", None) == "add_parser":
            parsers[node.targets[0].id] = ast.literal_eval(node.value.args[0])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            parser = parsers.get(node.func.value.id, "main")
            opts = tuple(ast.literal_eval(a) for a in node.args)
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords if k.arg != "help"}
            out.setdefault(parser, {})[opts] = kw
    return out


def test_acquire_flags_and_defaults_equal_the_jax_clis():
    got = _flags(ROOT / "aquaculture_tpu_torch" / "cli" / "acquire.py")
    want = _flags(ROOT / "aquaculture_tpu" / "cli" / "acquire.py")
    assert got == want
    assert sorted(got) == ["bathymetry", "landfilter", "shapefiles", "wms"]
    assert not any(opt == ("--device",) for flags in got.values() for opt in flags)


def test_figures_flags_are_the_jax_clis_plus_device():
    got = _flags(ROOT / "aquaculture_tpu_torch" / "cli" / "figures.py")["main"]
    want = _flags(ROOT / "aquaculture_tpu" / "cli" / "figures.py")["main"]
    device = got.pop(("--device",))
    assert got == want and len(want) == 9
    assert device == {"choices": "('cuda', 'cpu')", "default": "'cuda'"}
