"""The figures of the port (results.maps, cli.figures) against the JAX
package's, on the CPU.

- The four facility-map cases of tests/test_results.py run through both
  packages with frames equal (tolerance 0): the Trujillo classification
  and unique locations, the map outputs (the HTML map byte-identical),
  the period comparison, and Figure 4's true-positive -> classified frames.
- cli.figures --device cpu end to end beside the JAX CLI on one seeded
  world (a facility pickle that the JAX package's cli.facilities wrote):
  the P/R PDF, Figure 4 and the per-period PNGs byte-identical where
  matplotlib imports; the clustered stage's frame equal; the facility map
  HTML of the CLI's classification byte-identical.
- --facility-pickle goes through the restricted unpickler: a JAX pickle
  loads, a crafted one is refused with no command run; without a GPU the
  CLI raises unless given --device cpu.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.cli import facilities as jcli_facilities
from aquaculture_tpu.cli import figures as jcli_figures
from aquaculture_tpu.eval import kfold as jkfold
from aquaculture_tpu.geo import crs as jcrs
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.results import maps as jmaps
from aquaculture_tpu.results import tonnage_report as jreport
from aquaculture_tpu.tonnage import periods as jperiods
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli import figures as tcli_figures
from aquaculture_tpu_torch.eval import kfold as tkfold
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.results import maps as tmaps
from aquaculture_tpu_torch.results import tonnage_report as treport
from aquaculture_tpu_torch.tonnage import facility as tfacility
from aquaculture_tpu_torch.tonnage import periods as tperiods

from test_torch_overlay import jax_python_sweep
from test_torch_post import assert_frames_equal
from test_torch_tonnage import _labels_from, world_arrays, world_frames
from test_torch_tonnage_cli import _call_pickle

# (port, JAX) triples, in that order everywhere below
PACKAGES = ((tgf, tpoly, tmaps), (jgf, jpoly, jmaps))


# ------------------------------------------------------------------ the test_results.py cases


def test_trujillo_classification_and_unique_locations_equal():
    counts = []
    for G, P, M in PACKAGES:
        trujillo = G.GeoFrame({"n": [0, 1]}, geometry=[P.Point(1000.0, 1000.0), P.Point(20_000.0, 3000.0)], crs=3857)
        boxes = M.trujillo_1km_boxes(trujillo)
        fac = G.GeoFrame({"pass": ["2013-2015", "2013-2015", "2016-2018"]},
                         geometry=[P.Point(1100.0, 1100.0), P.Point(9000.0, 9000.0), P.Point(20_500.0, 2500.0)],
                         crs=3857)
        tagged = M.classify_facilities(fac, boxes)
        pair = G.GeoFrame({"pass": ["a", "b"]}, geometry=[P.Point(0.0, 0.0), P.Point(100.0, 0.0)], crs=3857)
        chain = G.GeoFrame({"pass": ["a", "b", "c"]},
                           geometry=[P.box(0, 0, 10, 10), P.box(8, 0, 18, 10), P.box(16, 0, 26, 10)], crs=3857)
        counts.append((tagged, boxes, [M.unique_locations(fac), M.unique_locations(pair, radius_m=500.0),
                                       M.unique_locations(pair), M.unique_locations(chain),
                                       M.unique_locations(fac.to_crs(4326), radius_m=10_000.0),
                                       M.unique_locations(fac.iloc[:0])]))
    (tagged, boxes, n), (jtagged, jboxes, jn) = counts
    assert_frames_equal(tagged, jtagged)
    assert_frames_equal(boxes, jboxes)
    assert tagged["status"].tolist() == ["known", "additional", "known"]
    assert n == jn == [3, 1, 2, 2, 1, 0]


def _map_frame(G, P, group):
    cols = {"status": ["known", "additional", "additional"]}
    if group:
        cols[group] = ["2013-2015", "2016-2018", "2013-2015"] if group == "pass" else [2014, 2017, 2014]
    return G.GeoFrame(cols, geometry=[P.Point(500000.0, 5200000.0), P.Point(510000.0, 5210000.0),
                                      P.box(505000.0, 5205000.0, 505100.0, 5205200.0)], crs=3857)


@pytest.mark.parametrize("group", ["pass", "year", None])
def test_facility_map_html_byte_equal(tmp_path, group):
    for (G, P, M), name in zip(PACKAGES, ("port", "jax")):
        # without the group column every point falls in one group, "all"
        M.facility_map_html(_map_frame(G, P, group), str(tmp_path / f"{name}.html"), group_col=group or "pass")
    html = (tmp_path / "port.html").read_text()
    assert html == (tmp_path / "jax.html").read_text()
    assert "<svg" in html and html.count('"lon"') == 3
    assert ("2013-2015" if group == "pass" else "2017" if group == "year" else '"all"') in html


def test_plot_facility_map_draws(tmp_path):
    pytest.importorskip("matplotlib")
    for (G, P, M), name in zip(PACKAGES, ("port", "jax")):
        fac = _map_frame(G, P, "pass")
        tru = G.GeoFrame({"n": [0]}, geometry=[P.Point(501000.0, 5201000.0)], crs=3857)
        fig = M.plot_facility_map(fac, trujillo=tru, period="2013-2015", out_path=str(tmp_path / f"{name}.png"))
        assert len(fig.axes) == 1 and (tmp_path / f"{name}.png").stat().st_size > 1000


def test_period_comparison_equal():
    assert treport.PERIOD_COMPARISON == jreport.PERIOD_COMPARISON
    assert (tmaps.TRUJILLO_PERIODS, tmaps.POST_TRUJILLO_PERIODS) == (jmaps.TRUJILLO_PERIODS, jmaps.POST_TRUJILLO_PERIODS)


def _figure4_inputs(G, P):
    def cages(cx, cy):
        return P.MultiPolygon([P.box(cx, cy, cx + 10, cy + 10)])

    fac = G.GeoFrame(
        {"facility_index": [0, 1, 2, 3], "pass": ["2005-2009", "2005-2009", "2013-2015", "2016-2018"],
         "cage_ids": [[1, 2], [3], [4, 5, 6], [7]],
         "circle_farm_geoms": [cages(500000, 5300000), cages(600000, 5300000), cages(500000, 5300000), P.EMPTY],
         "square_farm_geoms": [P.EMPTY, P.EMPTY, P.EMPTY, cages(700000, 5300000)]},
        geometry=[P.Point(0, 0)] * 4, crs=3857)
    labels = G.GeoFrame({"year": [2006, 2007, 2014, 2017, 2019]},
                        geometry=[P.box(500000, 5300000, 500010, 5300010), P.box(600000, 5300000, 600010, 5300010),
                                  P.box(500000, 5300000, 500010, 5300010), P.box(700002, 5300002, 700008, 5300008),
                                  P.box(800000, 5300000, 800010, 5300010)], crs=3857)
    trujillo = G.GeoFrame({"num_cages": [40, 7]}, geometry=[P.Point(500005.0, 5300005.0), P.Point(900000.0, 5.3e6)],
                          crs=3857)
    return fac, labels, trujillo


def _figure4(G, P, M, per):
    fac, labels, trujillo = _figure4_inputs(G, P)
    tp = M.true_positive_facilities(fac, labels, per.map_year_to_image_pass)
    combined = M.classify_our_facilities(tp, M.trujillo_1km_boxes(trujillo, box_crs=3035), trujillo)
    return tp, combined


def test_figure4_classification_frames_equal():
    (tp, combined), (jtp, jcombined) = _figure4(*PACKAGES[0], tperiods), _figure4(*PACKAGES[1], jperiods)
    assert_frames_equal(tp, jtp)
    assert_frames_equal(combined, jcombined)
    assert sorted(tp["facility_index"]) == [0, 1, 2, 3]
    during_add = combined[(combined["type"] == "Additional facility") & (combined["pass"] == "2005-2009")]
    assert len(during_add) == 1 and (combined["type"] == "Known facility").sum() == 7


def test_plot_combined_map_draws(tmp_path):
    pytest.importorskip("matplotlib")
    _, combined = _figure4(*PACKAGES[0], tperiods)
    tmaps.plot_combined_map(combined, out_path=str(tmp_path / "fig4.png"))
    assert (tmp_path / "fig4.png").stat().st_size > 1000


# ------------------------------------------------------------------ cli.figures


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A seeded world of three passes: detections, labels, an ocean cut of
    the detections, a facilities GeoJSON and a facility pickle written by
    the JAX package's cli.facilities, and Trujillo points at two sites."""
    d = tmp_path_factory.mktemp("figures_world")
    preds, boxes = world_frames(tgf, tpoly, world_arrays(seed=8))
    p = {k: str(d / f) for k, f in (("detections", "det.geojson"), ("labels", "labels.geojson"),
                                    ("ocean", "ocean.geojson"), ("image_boxes", "boxes.geojson"),
                                    ("facilities", "facilities.geojson"), ("pickle", "jax.pkl"),
                                    ("trujillo", "trujillo.csv"))}
    preds.to_file(p["detections"])
    preds.iloc[::3].to_crs(4326).to_file(p["ocean"])
    boxes.to_file(p["image_boxes"])
    _labels_from(preds, tgf).to_file(p["labels"])
    with jax_python_sweep():
        jcli_facilities.main(["--detections", p["detections"], "--image-boxes", p["image_boxes"], "--out", p["pickle"]])
    with open(p["pickle"], "rb") as f:
        final = pickle.load(f).final_facilities
    jgf.GeoFrame(pd.DataFrame({"pass": final["pass"], "facility_index": final["facility_index"]}),
                 geometry=list(final["geometry"]), crs=final.crs).to_file(p["facilities"])
    xy = np.array([g.centroid.x for g in final["geometry"][:2]]), np.array([g.centroid.y for g in final["geometry"][:2]])
    lon, lat = jcrs.transform(final.crs or 3857, 4326, *xy)
    pd.DataFrame({"lon": lon, "lat": lat, "num_cages": [30, 60]}).to_csv(p["trujillo"], index=False)
    p["dir"] = d
    return p


def _figures_argv(p, out, pkl=None):
    return ["--detections", p["detections"], "--labels", p["labels"], "--ocean-detections", p["ocean"],
            "--facilities", p["facilities"], "--facility-pickle", pkl or p["pickle"], "--trujillo", p["trujillo"],
            "--out-dir", out]


@pytest.fixture(scope="module")
def runs(world):
    pytest.importorskip("matplotlib")
    os.environ["SOURCE_DATE_EPOCH"] = "1700000000"  # the PDFs' creation date
    try:
        out = {name: str(world["dir"] / name) for name in ("port", "jax")}
        with jax_python_sweep():
            jcli_figures.main(_figures_argv(world, out["jax"]))
        tcli_figures.main(_figures_argv(world, out["port"]) + ["--device", "cpu"])
    finally:
        del os.environ["SOURCE_DATE_EPOCH"]
    return out


def test_cli_figures_writes_the_jax_clis_files(runs):
    got, want = sorted(os.listdir(runs["port"])), sorted(os.listdir(runs["jax"]))
    assert got == want
    assert {"performance_across_confidence.pdf", "facilities.pdf"} <= set(got)
    pngs = [f for f in got if f.startswith("facility_map_")]
    assert len(pngs) == 3  # one per pass
    for f in got:
        with open(os.path.join(runs["port"], f), "rb") as a, open(os.path.join(runs["jax"], f), "rb") as b:
            assert a.read() == b.read(), f


def test_cli_figures_map_html_and_clustered_stage_equal(world, tmp_path):
    """The CLI's --facilities classification and its clustered stage, through
    both packages: the facility map HTML byte-identical, the frames equal."""
    for (G, P, M), per, name in zip(PACKAGES, (tperiods, jperiods), ("port", "jax")):
        tagged = M.classify_facilities(G.read_file(world["facilities"]),
                                       M.trujillo_1km_boxes(per.load_trujillo_locations(world["trujillo"])))
        M.facility_map_html(tagged, str(tmp_path / f"{name}.html"))
    html = (tmp_path / "port.html").read_bytes()
    assert html == (tmp_path / "jax.html").read_bytes() and html.count(b'"lon"') == len(tgf.read_file(world["facilities"]))
    det, jdet = tgf.read_file(world["detections"]), jgf.read_file(world["detections"])
    got = tkfold.clustered_detections(det, 0.0, 50.0, 5, device="cpu")
    want = jkfold.clustered_detections(jdet, 0.0, 50.0, 5)
    assert 0 < len(want) < len(jdet)
    assert_frames_equal(got, want)


def test_port_reads_the_jax_facility_pickle(world):
    """The JAX package's pickle loads through the restricted unpickler, and
    Figure 4's frames from it equal the JAX package's."""
    fac = tfacility.load_AquaFacility(world["pickle"])
    assert type(fac) is tfacility.AquaFacility and type(fac.final_facilities) is tgf.GeoFrame
    with open(world["pickle"], "rb") as f:
        jfac = pickle.load(f)
    frames = []
    for (G, P, M), per, f in zip(PACKAGES, (tperiods, jperiods), (fac, jfac)):
        labels = G.read_file(world["labels"])
        tru = per.load_trujillo_locations(world["trujillo"])
        tp = M.true_positive_facilities(f.final_facilities, labels.to_crs(f.final_facilities.crs or 3857),
                                        per.map_year_to_image_pass)
        frames.append((tp, M.classify_our_facilities(tp, M.trujillo_1km_boxes(tru, box_crs=3035), tru)))
    assert len(frames[1][0]) > 0
    for got, want in zip(*frames):
        assert_frames_equal(got, want)


def test_cli_figures_refuses_a_crafted_pickle(world, tmp_path):
    pytest.importorskip("matplotlib")
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(_call_pickle("aquaculture_tpu.tonnage.facility", "os.system", f"touch {tmp_path / 'ran'}"))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tcli_figures.main(_figures_argv(world, str(tmp_path / "out"), pkl=str(bad)) + ["--device", "cpu"])
    assert not (tmp_path / "ran").exists()


def test_cli_figures_needs_a_gpu_unless_asked(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli_figures.main(_figures_argv(world, str(tmp_path / "out")))
    assert not (tmp_path / "out").exists()
