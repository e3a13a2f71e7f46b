"""The facility evaluation of the port (aquaculture_tpu_torch.eval: metrics,
kfold, buckets, datasets; data.labels; cli.evaluate) against the JAX
package's on the CPU.

Frames must be equal exactly (tolerance 0, NaN in the same places): the
grid sweep's closed-form membership counts the same members as the
per-combination BFS, and precision and recall are the same integer ratios
in float64. The one tolerance is on the facility boxes of
test_set_performance: the JAX package takes the bounds of a boolean-engine
union, which snaps to a lattice of about span / 2^25, the port the cages'
joint bounds; they agree within 1e-6 of the span."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.cli import evaluate as jcli
from aquaculture_tpu.data import labels as jlabels
from aquaculture_tpu.eval import buckets as jbuckets
from aquaculture_tpu.eval import datasets as jdatasets
from aquaculture_tpu.eval import kfold as jkfold
from aquaculture_tpu.eval import metrics as jmetrics
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.post import cluster as jcluster
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli import evaluate as tcli
from aquaculture_tpu_torch.data import labels as tlabels
from aquaculture_tpu_torch.eval import buckets as tbuckets
from aquaculture_tpu_torch.eval import datasets as tdatasets
from aquaculture_tpu_torch.eval import kfold as tkfold
from aquaculture_tpu_torch.eval import metrics as tmetrics
from aquaculture_tpu_torch.geo import polygon as tpoly

from test_torch_post import assert_frames_equal

PACKAGES = ((tgf, tpoly), (jgf, jpoly))
X0, Y0 = 500_000.0, 5_300_000.0  # EPSG:3857, the French Mediterranean coast
TILE_M = 200.0                   # one 1024 px tile


def world(G, P, seed=0, years=(2014, 2018), sites=8, noise=12, n_labels_extra=6, n_empty_images=10):
    """(detections, labels, images) in EPSG:3857: per year, facilities of
    3-8 cages at 8-20 m spacing and scattered noise, det_conf from a beta,
    circle/square/rectangle types; labels are jittered copies of half the
    detections plus unmatched boxes; images name 200 m tiles per year, with
    a 3-stratum bucket column."""
    rng = np.random.default_rng(seed)
    site_xy = rng.uniform(0, 1200, (sites, 2))
    det = {"year": [], "type": [], "image": []}
    geoms = []

    def image_of(year, x, y):
        return f"ORTHOIMAGERY.ORTHOPHOTOS{year}_0_{int(x // TILE_M)}_{int(y // TILE_M)}.jpeg"

    for year in years:
        cages = []
        for sx, sy in site_xy:
            step = rng.uniform(8, 20)
            for k in range(int(rng.integers(3, 9))):
                cages.append((sx + step * (k % 3) + rng.normal(0, 1), sy + step * (k // 3) + rng.normal(0, 1)))
        cages += [tuple(p) for p in rng.uniform(0, 1300, (noise, 2))]
        for x, y in cages:
            s = rng.uniform(5, 12)
            geoms.append(P.box(X0 + x, Y0 + y, X0 + x + s, Y0 + y + s))
            det["year"].append(year)
            det["type"].append(str(rng.choice(["circle_farm", "square_farm", "rectangle_farm"], p=[.5, .4, .1])))
            det["image"].append(image_of(year, x, y))
    n = len(geoms)
    det["det_conf"] = np.round(rng.beta(4, 2, n), 3)
    dets = G.GeoFrame(det, geometry=geoms, crs=3857)

    pick = np.sort(rng.choice(n, n // 2, replace=False))
    lab = {"year": [det["year"][i] for i in pick], "type": [det["type"][i] for i in pick],
           "image": [det["image"][i] for i in pick]}
    lgeoms = []
    for i in pick:
        b = np.asarray(geoms[i].bounds) + rng.normal(0, 1.0, 4)
        lgeoms.append(P.box(*b))
    for _ in range(n_labels_extra):
        x, y = rng.uniform(0, 1300, 2)
        year = int(rng.choice(years))
        lgeoms.append(P.box(X0 + x, Y0 + y, X0 + x + 8, Y0 + y + 8))
        lab["year"].append(year)
        lab["type"].append("circle_farm")
        lab["image"].append(image_of(year, x, y))
    labels = G.GeoFrame(lab, geometry=lgeoms, crs=3857)

    names = sorted(set(det["image"]) | set(lab["image"]))
    names += [f"ORTHOIMAGERY.ORTHOPHOTOS2016_1_{k}_0.jpeg" for k in range(n_empty_images)]
    images = pd.DataFrame({"image": names})
    images["bucket"] = [("a", "b", "c")[k % 3] for k in range(len(images))]
    return dets, labels, images


@pytest.fixture(scope="module")
def worlds():
    return [world(G, P) for G, P in PACKAGES]


def assert_plain_frames_equal(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_default_grid_equals_the_jax_package():
    assert dataclasses.asdict(tkfold.GridConfig()) == dataclasses.asdict(jkfold.GridConfig())
    g = tkfold.GridConfig()
    assert len(g.confidence_thresholds) * len(g.distance_thresholds) * len(g.minimum_cluster_sizes) == 6560
    assert g.confidence_thresholds[-1] == 1.005


def test_get_tp_and_stats_total_equal(worlds):
    (td, tl, _), (jd, jl, _) = worlds
    pd.testing.assert_series_equal(tmetrics.get_tp(td, tl), jmetrics.get_tp(jd, jl))
    pd.testing.assert_series_equal(tmetrics.get_tp(tl, td), jmetrics.get_tp(jl, jd))
    assert tmetrics.get_stats_total(tl, td) == jmetrics.get_stats_total(jl, jd)
    # the reference's index-0 truthiness bug stays fixed: a key at index 0 matches
    one = [G.GeoFrame({"year": [2014], "type": ["circle_farm"]}, geometry=[P.box(0, 0, 10, 10)], crs=3857)
           for G, P in PACKAGES]
    assert tmetrics.get_tp(one[0], one[0]).tolist() == jmetrics.get_tp(one[1], one[1]).tolist() == [True]
    empty = [o.iloc[:0].copy() for o in one]
    for e, o in zip(empty, one):
        e.crs = o.crs
    assert tmetrics.get_tp(empty[0], one[0]).tolist() == []
    assert tmetrics.get_tp(one[0], empty[0]).tolist() == jmetrics.get_tp(one[1], empty[1]).tolist() == [False]


# conf 1.005 keeps nothing (NaN precision), min size 8 at eps 15 leaves
# some years without members
SMALL_GRID = dict(confidence_thresholds=(0.3, 0.55, 0.785, 0.9, 1.005), distance_thresholds=(15.0, 40.0, 150.0),
                  minimum_cluster_sizes=(1, 3, 8))


@pytest.mark.parametrize("labels_kept", ["all", "none"])
def test_grid_search_equals_the_jax_package(worlds, labels_kept):
    (td, tl, _), (jd, jl, _) = worlds
    if labels_kept == "none":
        tl, jl = tl.iloc[:0].copy(), jl.iloc[:0].copy()
        tl.crs = jl.crs = 3857
    got = tkfold.grid_search(td, tl, tkfold.GridConfig(**SMALL_GRID), device="cpu")
    want = jkfold.grid_search(jd, jl, jkfold.GridConfig(**SMALL_GRID))
    assert len(want) == 45 and want["precision"].isna().any()
    assert want["recall"].isna().all() == (labels_kept == "none")
    assert_plain_frames_equal(got, want)
    assert_plain_frames_equal(tkfold.grid_search_plain(td, tl, tkfold.GridConfig(**SMALL_GRID)), want)


def test_grid_search_in_chunks_and_without_preds(worlds, monkeypatch):
    (td, tl, _), (jd, jl, _) = worlds
    want = jkfold.grid_search(jd, jl, jkfold.GridConfig(**SMALL_GRID))
    # one conf threshold per block
    monkeypatch.setattr(tkfold, "_SWEEP_BLOCK", 1)
    assert_plain_frames_equal(tkfold.grid_search(td, tl, tkfold.GridConfig(**SMALL_GRID), device="cpu"), want)
    none_t, none_j = td.iloc[:0].copy(), jd.iloc[:0].copy()
    none_t.crs = none_j.crs = 3857
    assert_plain_frames_equal(tkfold.grid_search(none_t, tl, tkfold.GridConfig(**SMALL_GRID), device="cpu"),
                              jkfold.grid_search(none_j, jl, jkfold.GridConfig(**SMALL_GRID)))


@pytest.mark.parametrize("op", [(0.785, 50.0, 5), (0.3, 15.0, 1), (0.6, 40.0, 3), (1.005, 50.0, 1)])
def test_clustered_detections_equal(worlds, op):
    (td, _, _), (jd, _, _) = worlds
    got = tkfold.clustered_detections(td, *op, device="cpu")
    want = jkfold.clustered_detections(jd, *op)
    assert_frames_equal(got, want)


@pytest.mark.parametrize("n_folds,seed", [(5, 1), (3, 7)])
def test_stratified_kfold_indices_equal(worlds, n_folds, seed):
    strata = worlds[0][2]["bucket"]
    got = tkfold.stratified_kfold_indices(strata, n_folds, seed)
    want = jkfold.stratified_kfold_indices(strata, n_folds, seed)
    for (gtr, gte), (wtr, wte) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gtr, wtr)
        np.testing.assert_array_equal(gte, wte)


def test_kfold_cluster_performance_equal(worlds):
    (td, tl, ti), (jd, jl, ji) = worlds
    grid = dict(SMALL_GRID, folds=3, seed=1)
    got = tkfold.kfold_cluster_performance(ti, td, tl, ti["bucket"], tkfold.GridConfig(**grid), device="cpu")
    want = jkfold.kfold_cluster_performance(ji, jd, jl, ji["bucket"], jkfold.GridConfig(**grid))
    assert len(want) == 6
    assert_plain_frames_equal(got, want)


def _jax_facility_bounds(frame, conf, eps, ms):
    """The JAX package's facility boxes (kfold.test_set_performance :279-307)."""
    f = frame.reset_index(drop=True)
    f.crs = frame.crs
    if "det_conf" not in f.columns:
        f["det_conf"] = 1.0
    f["index"] = f.index
    f3035 = f.to_crs(3035)
    fac = jcluster.predictions_cluster(f3035, "year", conf, eps, ms, include_area=False)
    out = []
    for _, row in fac.iterrows():
        u = jpoly.unary_union([row["square_farm_geoms"], row["circle_farm_geoms"]])
        out.append(None if u.is_empty else u.bounds)
    return out


def _rectangles_only(G, P):
    """One facility of rectangle cages and one of circles: the first has
    no box (the JAX package leaves rectangles out of the union)."""
    xs = X0 + np.arange(5) * 12.0
    return G.GeoFrame({"year": [2014] * 10, "type": ["rectangle_farm"] * 5 + ["circle_farm"] * 5},
                      geometry=[P.box(x, Y0 + dy, x + 8, Y0 + dy + 8) for dy in (0.0, 500.0) for x in xs],
                      crs=3857)


@pytest.mark.parametrize("which", ["preds", "labels", "rectangles"])
def test_facility_boxes_within_a_millionth_of_the_span(worlds, which):
    (td, tl, _), (jd, jl, _) = worlds
    t, j, conf = {"preds": (td, jd, 0.6), "labels": (tl, jl, 0.0),
                  "rectangles": (_rectangles_only(tgf, tpoly), _rectangles_only(jgf, jpoly), 0.0)}[which]
    got = tkfold._facility_boxes(t, conf, 40.0, 3, "cpu")
    want = _jax_facility_bounds(j, conf, 40.0, 3)
    assert len(got) == len(want) >= 2
    assert list(got["type"]) == ["facility"] * len(want) and got.crs == 3857
    for g, w in zip(got["geometry"], want):
        if w is None:  # rectangle cages only: the JAX package's Empty()
            assert g.is_empty
            continue
        span = max(w[2] - w[0], w[3] - w[1])
        np.testing.assert_allclose(g.bounds, w, rtol=0, atol=1e-6 * span)
    assert (want[0] is None) == (which == "rectangles")


@pytest.mark.parametrize("op", [(0.6, 40.0, 3), (0.5, 20.0, 2), (0.7, 50.0, 3)])
def test_test_set_performance_equal(worlds, op):
    (td, tl, ti), (jd, jl, ji) = worlds
    half_t, half_j = ti.iloc[::2], ji.iloc[::2]
    got = tkfold.test_set_performance(half_t, td, tl, *op, device="cpu")
    want = jkfold.test_set_performance(half_j, jd, jl, *op)
    assert_plain_frames_equal(got, want)


def test_test_set_performance_without_a_facility_raises_in_both(worlds):
    """A quirk of the reference kept in the port: when no facility forms
    among the held-out detections, the facility frame has no 'year'
    column and both packages raise KeyError."""
    (td, tl, ti), (jd, jl, ji) = worlds
    with pytest.raises(KeyError, match="year"):
        jkfold.test_set_performance(ji.iloc[::2], jd, jl, 0.785, 50.0, 5)
    with pytest.raises(KeyError, match="year"):
        tkfold.test_set_performance(ti.iloc[::2], td, tl, 0.785, 50.0, 5, device="cpu")


def _bucket_inputs(G, P):
    images = G.GeoFrame(
        {"image": ["a", "b", "c", "d", "e"], "in_sample": [True, True, False, True, True],
         "only_land": [False, False, False, True, False]},
        geometry=[P.box(0, 0, 10, 10), P.box(100, 100, 110, 110), P.box(200, 200, 210, 210),
                  P.box(300, 300, 310, 310), P.box(400, 400, 410, 410)],
        crs=3857,
    )
    dets = G.GeoFrame(
        {"image": ["a", "a", "e"], "det_conf": [0.8, 0.35, 0.95], "year": [2014] * 3,
         "type": ["circle_farm"] * 3},
        geometry=[P.box(1, 1, 2, 2), P.box(3, 3, 4, 4), P.box(401, 401, 402, 402)], crs=3857)
    labels = G.GeoFrame({"image": ["a", "e"], "year": [2014] * 2, "type": ["circle_farm"] * 2},
                        geometry=[P.box(1, 1, 2, 2), P.box(405, 405, 406, 406)], crs=3857)
    trujillo = G.GeoFrame({"n": [0]}, geometry=[P.box(95, 95, 120, 120)], crs=3857)
    return images, dets, labels, trujillo


def test_buckets_equal():
    (ti, td, tl, tt), (ji, jd, jl, jt) = (_bucket_inputs(G, P) for G, P in PACKAGES)
    ts, js = tbuckets.set_image_stats(ti, td, tl), jbuckets.set_image_stats(ji, jd, jl)
    assert_frames_equal(ts, js)
    tb, jb = tbuckets.set_buckets(ts, tt), jbuckets.set_buckets(js, jt)
    assert_frames_equal(tb, jb)
    assert tbuckets.CONF_BINS == jbuckets.CONF_BINS
    assert_plain_frames_equal(tbuckets.get_bucket_info_table(tb), jbuckets.get_bucket_info_table(jb))


def _dataset_inputs(G, P):
    img_name = "ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.jpeg"
    img2 = "ORTHOIMAGERY.ORTHOPHOTOS2014_0_1024_0.jpeg"
    img3 = "ORTHOIMAGERY.ORTHOPHOTOS2014_1_0_0.jpeg"
    dl = G.GeoFrame({"d": [0, 1]}, geometry=[P.box(0, 0, 1200, 1200), P.box(600, 0, 1800, 1200)], crs=3857)
    image_boxes = G.GeoFrame(
        {"image": [img_name, img2, img3], "year": [2014] * 3, "bbox_ind": [0, 0, 1],
         "x_offset": [0, 1024, 0], "y_offset": [0, 0, 0]},
        geometry=[P.box(0, 1000, 200, 1200), P.box(170, 1000, 370, 1200), P.box(600, 1000, 800, 1200)],
        crs=3857,
    )
    dets = G.GeoFrame(
        {"image": [img_name, img_name, img3, img3], "year": [2014] * 4,
         "type": ["circle_farm", "triangle_farm", "square_farm", "circle_farm"], "det_conf": [0.9, 0.9, 0.4, 0.7]},
        geometry=[P.box(10, 1010, 20, 1020), P.box(30, 1030, 40, 1040), P.box(610, 1010, 620, 1020),
                  P.box(1300, 1010, 1310, 1020)],
        crs=3857,
    )
    labels = G.GeoFrame(
        {"image": [img_name, img3], "year": [2014, 2014], "type": ["circle_cage", "square_cage"]},
        geometry=[P.box(12, 1012, 22, 1022), P.box(611, 1011, 621, 1021)],
        crs=3857,
    )
    trujillo = G.GeoFrame({"n": [0]}, geometry=[P.Point(15.0, 1015.0)], crs=3857)
    sampled = pd.DataFrame({"image": [img_name, img3]})
    land = G.GeoFrame({"n": [0]}, geometry=[P.box(150, 990, 400, 1210)], crs=3857)
    return dets, labels, image_boxes, dl, trujillo, sampled, land


def test_assemble_evaluation_datasets_without_land_equal():
    t_in, j_in = (_dataset_inputs(G, P) for G, P in PACKAGES)
    got = tdatasets.assemble_evaluation_datasets(*t_in[:6])
    want = jdatasets.assemble_evaluation_datasets(*j_in[:6])
    assert list(got) == list(want)
    assert len(want["detections"]) == 2
    for k in want:
        if isinstance(want[k], jgf.GeoFrame):
            assert_frames_equal(got[k], want[k])
        else:
            assert_plain_frames_equal(got[k], want[k])


def test_land_flag_waits_for_the_overlay_engine():
    t_in = _dataset_inputs(tgf, tpoly)
    with pytest.raises(ValueError, match="boolean engine"):
        tdatasets.assemble_evaluation_datasets(*t_in)
    with pytest.raises(ValueError, match=r"sjoin\(predicate='within'\)"):
        tlabels.mark_land_images(t_in[2], t_in[6])


def test_label_loaders_equal(tmp_path, worlds):
    (_, tl, ti), (_, jl, _) = worlds
    tl.to_crs(4326).to_file(str(tmp_path / "labels.geojson"))
    ti.to_csv(tmp_path / "images.csv", index=False)
    assert_frames_equal(tlabels.load_cf_labels(str(tmp_path / "labels.geojson")),
                        jlabels.load_cf_labels(str(tmp_path / "labels.geojson")))
    assert_plain_frames_equal(tlabels.load_cf_images(str(tmp_path / "images.csv")),
                              jlabels.load_cf_images(str(tmp_path / "images.csv")))


def test_cli_evaluate_cpu_equals_the_jax_cli(tmp_path, worlds):
    _, (jd, jl, ji) = worlds
    jd.to_file(str(tmp_path / "det.geojson"))
    jl.to_file(str(tmp_path / "lab.geojson"))
    ji.to_csv(tmp_path / "images.csv", index=False)
    argv = ["--detections", str(tmp_path / "det.geojson"), "--labels", str(tmp_path / "lab.geojson"),
            "--images", str(tmp_path / "images.csv"), "--folds", "3", "--seed", "2",
            "--test-conf", "0.6", "--test-distance", "40", "--test-min-size", "3"]
    # the full 6,560-combination grid
    res, test, seconds = tcli.main(argv + ["--out", str(tmp_path / "t.csv"), "--device", "cpu"])
    jcli.main(argv + ["--out", str(tmp_path / "j.csv")])
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert len(res) == 6 and set(seconds) == {"read", "kfold", "held_out"}
    want = jkfold.test_set_performance(ji, jgf.read_file(str(tmp_path / "det.geojson")),
                                       jgf.read_file(str(tmp_path / "lab.geojson")), 0.6, 40.0, 3)
    assert_plain_frames_equal(test, want)


def test_cli_evaluate_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--detections", "d", "--labels", "l", "--images", "i", "--out", str(tmp_path / "o.csv")])
    assert not (tmp_path / "o.csv").exists()
