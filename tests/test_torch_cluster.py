"""Facility clustering of the port (aquaculture_tpu_torch.post.cluster,
cli.cluster) against the JAX package's on the CPU.

DBSCAN labels must be equal elementwise (tolerance 0) for the tensor route
on CPU tensors and for the plain BFS. The facility frames must be equal
column by column, geometries by their coordinates (tolerance 0: both sides
run the same float64 numpy on the same labels)."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.cli import cluster as jcli
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.post import cluster as jcluster
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli import cluster as tcli
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.post import cluster as tcluster

from test_torch_geo import assert_same_geometry

PACKAGES = ((tgf, tpoly), (jgf, jpoly))


def _blobs(seed, n_centers=6, per=12, noise=15, spread=1.5, extent=60.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, extent, (n_centers, 2))
    pts = c[rng.integers(0, n_centers, n_centers * per)] + rng.normal(0, spread, (n_centers * per, 2))
    return rng.permutation(np.concatenate([pts, rng.uniform(0, extent, (noise, 2))]))


def _chain(n=40, step=1.0):
    # a long chain in scrambled index order: labels must still follow the
    # smallest core index, and propagation must cross the whole chain
    pts = np.stack([np.arange(n) * step, np.zeros(n)], 1)
    return pts[np.random.default_rng(3).permutation(n)]


# (points, eps, min_samples)
CASES = {
    "blobs_2_5": (_blobs(0), 2.0, 5),
    "blobs_3_3": (_blobs(1), 3.0, 3),
    "blobs_1.5_6": (_blobs(2), 1.5, 6),
    "blobs_6_1": (_blobs(3, spread=4.0), 6.0, 1),
    "uniform_4_4": (np.random.default_rng(4).uniform(0, 40, (120, 2)), 4.0, 4),
    # a border point (index 0) at exactly eps from a core of each of two
    # clusters: core 6 of cluster 0 (smallest core 1) and core 2 of cluster
    # 1 (smallest core 2); sklearn gives it the smaller cluster number, 0,
    # not the cluster of its smallest-indexed adjacent core
    "border_between_two": (np.array([[0.0, 0.0], [3.5, 0.0], [-2.0, 0.0], [-3.5, 0.0], [-5.0, 0.0],
                                     [3.5, 1.0], [2.0, 0.0], [5.0, 0.0], [-3.5, 1.0]]), 2.0, 4),
    "chain": (_chain(), 1.0, 3),
    "chain_min_1": (_chain(60, 0.5), 0.5, 1),
    "duplicates": (np.repeat(np.array([[0.0, 0.0], [5.0, 5.0], [5.0, 5.5], [20.0, 0.0]]), [4, 3, 1, 2], axis=0),
                   0.6, 3),
    # |p - q| == eps exactly (3-4-5): the pair is adjacent (<=)
    "pair_at_eps": (np.array([[0.0, 0.0], [3.0, 4.0], [100.0, 100.0]]), 5.0, 2),
    "pair_just_beyond_eps": (np.array([[0.0, 0.0], [3.0, 4.0]]), np.nextafter(5.0, 0.0), 2),
    "empty": (np.zeros((0, 2)), 1.0, 3),
    "all_noise": (np.array([[0.0, 0.0], [100.0, 0.0], [0.0, 100.0]]), 1.0, 2),
    "single_point_core": (np.array([[7.0, 7.0]]), 1.0, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dbscan_labels_equal_the_jax_package(case):
    pts, eps, ms = CASES[case]
    want = jcluster.dbscan(pts, eps, ms)
    got = tcluster.dbscan(pts, eps, ms, device="cpu")
    plain = tcluster.dbscan_plain(pts, eps, ms)
    assert got.dtype == plain.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    if len(pts):
        from sklearn.cluster import DBSCAN

        np.testing.assert_array_equal(got, DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_)
    if case == "border_between_two":
        assert want.tolist() == [0, 0, 1, 1, 1, 0, 0, 0, 1]
    if case == "pair_at_eps":
        assert want.tolist() == [0, 0, -1]


def test_dbscan_matches_jax_on_many_random_sets():
    """300 small sets, clustered and uniform, coordinates rounded so that
    ties and exact-eps pairs occur."""
    for seed in range(300):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(0, 61))
        if seed % 2:
            pts = rng.uniform(0, 40, (n, 2))
        else:
            c = rng.uniform(0, 40, (max(1, n // 8), 2))
            pts = c[rng.integers(0, len(c), n)] + rng.normal(0, 2, (n, 2))
        pts = np.round(pts, int(rng.integers(0, 3)))
        eps, ms = float(rng.uniform(1.5, 6.0)), int(rng.integers(1, 8))
        np.testing.assert_array_equal(tcluster.dbscan(pts, eps, ms, device="cpu"),
                                      jcluster.dbscan(pts, eps, ms), err_msg=f"seed {seed}")


def test_pairwise_d2_equals_numpy_bit_for_bit():
    pts = np.random.default_rng(0).uniform(3.5e6, 3.6e6, (200, 2))
    want = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    got = tcluster.pairwise_d2(pts, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def _mixed_geometries(P, n=3000, seed=0):
    """Boxes at EPSG:3035 magnitudes, star polygons of 3-17 vertices (both
    sides of numpy's 8-element pairwise-sum block), near-zero-area slivers,
    a holed polygon, a point, a multipolygon and the empty geometry."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 0:
            x, y = rng.uniform(3.5e6, 4e6, 2)
            w, h = rng.uniform(1, 30, 2)
            out.append(P.box(x, y, x + w, y + h))
        elif i % 3 == 1:
            k = int(rng.choice([3, 4, 5, 8, 9, 17]))
            t, r = np.sort(rng.uniform(0, 2 * np.pi, k)), rng.uniform(1, 20, k)
            c = rng.uniform(3.5e6, 4e6, 2)
            out.append(P.Polygon(np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], 1)))
        else:
            x, y = rng.uniform(-10, 10, 2)
            out.append(P.Polygon([(x, y), (x + 1e-9, y), (x, y + 1e-9)]))
    return out + [P.Polygon([(0, 0), (4, 0), (4, 4), (0, 4)], [[(1, 1), (2, 1), (2, 2)]]), P.Point(1.5, 2.5),
                  P.MultiPolygon([P.box(0, 0, 1, 1), P.box(5, 5, 7, 6)]), P.EMPTY]


def test_centroid_array_equals_each_centroid_bit_for_bit():
    got = tpoly.centroid_array(_mixed_geometries(tpoly))
    want = np.array([[g.centroid.x, g.centroid.y] for g in _mixed_geometries(jpoly)])
    np.testing.assert_array_equal(got, want)  # NaN (the empty geometry) in place
    assert tpoly.centroid_array([]).shape == (0, 2)


def test_dbscan_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcluster.dbscan(np.zeros((3, 2)), 1.0, 2)


def _cages(G, P, seed=0, n_years=3, include_area=True):
    """Cage boxes in EPSG:3035 (meters): per year, facilities of 3-9 cages
    at 8-20 m spacing plus noise, the three farm types, confidences from a
    beta, area columns, and a non-default index."""
    rng = np.random.default_rng(seed)
    geoms, rec = [], {"year": [], "type": [], "det_conf": [], "area": [], "area_var": [], "min_area": [],
                      "max_area": []}
    for y in [2021, 2000, 2014][:n_years]:
        for f in range(6):
            cx, cy = rng.uniform(3.6e6, 3.61e6), rng.uniform(2.2e6, 2.21e6)
            step = rng.uniform(8, 20)
            for k in range(int(rng.integers(3, 10))):
                x, y0 = cx + step * (k % 3), cy + step * (k // 3)
                s = rng.uniform(4, 9)
                geoms.append(P.box(x, y0, x + s, y0 + s))
                rec["type"].append(str(rng.choice(["circle_farm", "square_farm", "rectangle_farm"])))
                rec["year"].append(y)
        for _ in range(8):
            x, y0 = rng.uniform(3.6e6, 3.61e6), rng.uniform(2.2e6, 2.21e6)
            geoms.append(P.box(x, y0, x + 6, y0 + 6))
            rec["type"].append("circle_farm")
            rec["year"].append(y)
    n = len(geoms)
    rec["det_conf"] = rng.beta(5, 2, n)
    rec["area"] = rng.uniform(10, 60, n)
    rec["area_var"] = rng.uniform(0, 5, n)
    rec["min_area"] = rec["area"] * 0.5
    rec["max_area"] = rec["area"] * 1.5
    if not include_area:
        for k in ("area", "area_var", "min_area", "max_area"):
            del rec[k]
    df = G.GeoFrame(rec, geometry=geoms, crs=3035)
    df.index = np.arange(n) * 3 + 7
    df["index"] = np.arange(n) + 100
    return df


def assert_facilities_equal(got, want):
    """Facility frames: columns, dtypes and index equal; geometry columns
    (the centroid Points and the per-type MultiPolygons) by coordinates."""
    assert got.crs == want.crs
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    geo = ["geometry"] + [c for c in want.columns if c.endswith("_farm_geoms")]
    plain = [c for c in want.columns if c not in geo]
    pd.testing.assert_frame_equal(pd.DataFrame(got[plain]), pd.DataFrame(want[plain]), check_exact=True)
    for c in geo:
        assert len(got[c]) == len(want[c])
        for g, w in zip(got[c], want[c]):
            assert_same_geometry(g, w)


@pytest.mark.parametrize("eps,ms,include_area", [(50.0, 5, True), (10.0, 1, True), (25.0, 3, False)])
def test_cluster_facilities_equal_the_jax_package(eps, ms, include_area):
    got, want = (P_cluster.cluster_facilities(_cages(G, P, include_area=include_area), "year", eps, ms,
                                              include_area, **kw)
                 for (G, P), P_cluster, kw in zip(PACKAGES, (tcluster, jcluster), ({"device": "cpu"}, {})))
    assert len(want) > 0
    assert_facilities_equal(got, want)


def test_predictions_cluster_equal_the_jax_package():
    got = tcluster.predictions_cluster(_cages(tgf, tpoly, seed=1), "year", 0.7, 30.0, 3, device="cpu")
    want = jcluster.predictions_cluster(_cages(jgf, jpoly, seed=1), "year", 0.7, 30.0, 3)
    assert 0 < len(want)
    assert_facilities_equal(got, want)


def test_cli_cluster_cpu_writes_the_jax_file(tmp_path):
    det = _cages(jgf, jpoly, seed=2).to_crs(3857).reset_index(drop=True).drop(columns=["index"])
    det.crs = 3857
    src = str(tmp_path / "det.geojson")
    det.to_file(src)
    argv = ["--detections", src, "--conf", "0.6", "--distance", "40", "--min-size", "4"]
    fac = tcli.main(argv + ["--out", str(tmp_path / "t.geojson"), "--device", "cpu"])
    jcli.main(argv + ["--out", str(tmp_path / "j.geojson")])
    got = json.loads((tmp_path / "t.geojson").read_text())
    want = json.loads((tmp_path / "j.geojson").read_text())
    assert len(want["features"]) == len(fac) > 0
    assert got == want


def test_cli_cluster_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--detections", str(tmp_path / "none.geojson"), "--out", str(tmp_path / "o.geojson")])
    assert not (tmp_path / "o.geojson").exists()
