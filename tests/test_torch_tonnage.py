"""The port's tonnage path (tonnage/*, utils/xlsx.py, data/geotiff.py,
results/tonnage_report.py) against the JAX package's, on the CPU.

- Host code (periods, factors, the error fit, the year dedup, depth, the
  facility construction with its min/max selections, GeoTIFF IO, the
  bootstrap's input lattice): equal to the JAX package's, tolerance 0.
- The bootstrap draws from torch's generator, not ``jax.random``, so it is
  held on what both must share: closed forms where the distributions are
  degenerate, scipy's truncated-normal mean, the positive-area guarantee,
  each period's mean within 4 Monte-Carlo standard errors of the JAX
  package's (the sd over sqrt(K)) and its variance within 10% on a seeded
  lattice at K = 20,000, and bit-for-bit repeats under one seed.
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.data import geotiff as jgeotiff
from aquaculture_tpu.geo import io as jio
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.tonnage import bootstrap as jboot
from aquaculture_tpu.tonnage import dedup_years as jdedup
from aquaculture_tpu.tonnage import errors as jerrors
from aquaculture_tpu.tonnage import facility as jfacility
from aquaculture_tpu.tonnage import factors as jfactors
from aquaculture_tpu.tonnage import periods as jperiods
from aquaculture_tpu.utils import xlsx as jxlsx
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.data import geotiff as tgeotiff
from aquaculture_tpu_torch.geo import io as tio
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.results import tonnage_report as treport
from aquaculture_tpu_torch.tonnage import bootstrap as tboot
from aquaculture_tpu_torch.tonnage import dedup_years as tdedup
from aquaculture_tpu_torch.tonnage import errors as terrors
from aquaculture_tpu_torch.tonnage import facility as tfacility
from aquaculture_tpu_torch.tonnage import factors as tfactors
from aquaculture_tpu_torch.tonnage import periods as tperiods
from aquaculture_tpu_torch.utils import xlsx as txlsx

import chip_smoke
from test_torch_eval import assert_plain_frames_equal
from test_torch_overlay import jax_python_sweep
from test_torch_post import assert_frames_equal

PACKAGES = ((tgf, tpoly), (jgf, jpoly))
YEARS = (2010, 2013, 2014, 2017)   # 2013 and 2014 share the 2013-2015 pass
TILE_M = 200.0
COLS, ROWS = 12, 6                   # two 1200 m download boxes of 6 x 6 tiles


# ---------------------------------------------------------------------------
# a seeded facility world over 3 passes, built in either package
# ---------------------------------------------------------------------------

def world_arrays(seed=0, sites=7):
    """Detections at facility sites (5-9 cages each, present in a year with
    probability 0.85) plus scattered noise, in EPSG:3857 meters near the
    French coast; one image box per tile and year, 2014's cut by whitespace
    on about half the tiles."""
    rng = np.random.default_rng(seed)
    x0, y0 = 400_000.0, 5_300_000.0
    centers = np.stack([rng.uniform(100, COLS * TILE_M - 200, sites), rng.uniform(100, ROWS * TILE_M - 150, sites)], 1)
    recs = {k: [] for k in ("x", "y", "size", "year", "type", "det_conf")}
    for year in YEARS:
        for (cx, cy), n in zip(centers, rng.integers(5, 10, sites)):
            if rng.random() > 0.85:
                continue
            k = np.arange(n)
            recs["x"] += list(x0 + cx + 16 * (k % 3) + rng.normal(0, 0.5, n))
            recs["y"] += list(y0 + cy + 16 * (k // 3) + rng.normal(0, 0.5, n))
            recs["size"] += list(rng.uniform(8, 12, n))
            recs["year"] += [year] * n
            recs["type"] += list(rng.choice(["circle_farm", "square_farm"], n, p=[0.6, 0.4]))
            recs["det_conf"] += list(rng.uniform(0.8, 1.0, n))
        m = 6
        recs["x"] += list(x0 + rng.uniform(0, COLS * TILE_M - 20, m))
        recs["y"] += list(y0 + rng.uniform(0, ROWS * TILE_M - 20, m))
        recs["size"] += list(rng.uniform(8, 12, m))
        recs["year"] += [year] * m
        recs["type"] += ["circle_farm"] * m
        recs["det_conf"] += list(rng.uniform(0.5, 1.0, m))
    det = {k: np.asarray(v) for k, v in recs.items()}
    tx = np.floor((det["x"] - x0) / TILE_M).astype(int)
    ty = np.floor((det["y"] - y0) / TILE_M).astype(int)
    det["image"] = np.asarray([f"ORTHOIMAGERY.ORTHOPHOTOS{y}_{a // 6}_{(a % 6) * 1024}_{b * 1024}.jpeg"
                               for y, a, b in zip(det["year"], tx, ty)])
    s = det["size"]
    circle = det["type"] == "circle_farm"
    det["area"] = np.where(circle, np.pi * s * s / 4, s * s)
    det["area_var"] = np.where(circle & (rng.random(len(s)) < 0.5), 0.0, 4.0)
    det["min_area"], det["max_area"] = det["area"] * 0.8, det["area"] * 1.1
    boxes = {k: [] for k in ("bbox_ind", "x_offset", "y_offset", "year", "image_file", "bounds")}
    cut = rng.random((COLS, ROWS)) < 0.5
    for year in YEARS:
        for a in range(COLS):
            for b in range(ROWS):
                right = 0.55 if (year == 2014 and cut[a, b]) else 1.0
                boxes["bbox_ind"].append(a // 6)
                boxes["x_offset"].append((a % 6) * 1024)
                boxes["y_offset"].append(b * 1024)
                boxes["year"].append(year)
                boxes["image_file"].append(f"{year}_{a}_{b}")
                boxes["bounds"].append((x0 + a * TILE_M, y0 + b * TILE_M, x0 + (a + right) * TILE_M,
                                        y0 + (b + 1) * TILE_M))
    return det, boxes


def world_frames(G, P, arrays):
    det, boxes = arrays
    cols = {k: v for k, v in det.items() if k not in ("x", "y", "size")}
    preds = G.GeoFrame(cols, geometry=[P.box(x - s / 2, y - s / 2, x + s / 2, y + s / 2)
                                       for x, y, s in zip(det["x"], det["y"], det["size"])], crs=3857)
    bcols = {k: v for k, v in boxes.items() if k != "bounds"}
    return preds, G.GeoFrame(bcols, geometry=[P.box(*b) for b in boxes["bounds"]], crs=3857)


def bathymetry_array(seed=0):
    return -(4.0 + 50.0 * np.random.default_rng(seed).random((40, 60)))


BATHY_BOUNDS = (3.5, 42.8, 3.9, 43.2)


def build_facilities(arrays, selection="random"):
    """AquaFacility of both packages on the world, with min/max cages and
    depth from a GeoTIFF-like raster over the world (EPSG:4326)."""
    out = []
    for (G, P), fac_mod, geo, per in ((PACKAGES[0], tfacility, tgeotiff, tperiods),
                                      (PACKAGES[1], jfacility, jgeotiff, jperiods)):
        preds, boxes = world_frames(G, P, arrays)
        kw = {"device": "cpu"} if fac_mod is tfacility else {}
        fac = fac_mod.AquaFacility(preds, boxes, per.map_year_to_image_pass, image_selection=selection,
                                   min_cluster_size=5, **kw)
        fac.compute_min_max_cages()
        arr = bathymetry_array()
        bt = geo.GeoTiff(array=arr, origin_x=BATHY_BOUNDS[0], origin_y=BATHY_BOUNDS[3],
                         pixel_w=(BATHY_BOUNDS[2] - BATHY_BOUNDS[0]) / arr.shape[1],
                         pixel_h=(BATHY_BOUNDS[3] - BATHY_BOUNDS[1]) / arr.shape[0], epsg=4326)
        fac.add_depth(min_cage_threshold=5.0, default_cage_depth=10.0, bathymetry=bt)
        out.append(fac)
    return out


@pytest.fixture(scope="module")
def facilities():
    with jax_python_sweep():
        return build_facilities(world_arrays())


GEOMETRY_TYPES = {"Point", "Polygon", "MultiPolygon", "Empty", "LineString", "MultiLineString"}


def assert_geo_frames_equal(got, want):
    """assert_frames_equal, with geometry-valued columns besides
    ``geometry`` (the facilities' *_farm_geoms) compared as WKT."""
    def plain(frame, io):
        frame = frame.copy()
        for c in frame.columns:
            if c != "geometry" and frame[c].dtype == object and any(
                    type(v).__name__ in GEOMETRY_TYPES for v in frame[c]):
                frame[c] = [io.to_wkt(v) if type(v).__name__ in GEOMETRY_TYPES else v for v in frame[c]]
        frame.crs = getattr(frame, "crs", None)
        return frame

    assert_frames_equal(plain(got, tio), plain(want, jio))


def assert_facilities_equal(got, want):
    assert got.time_group == want.time_group and got.image_selection == want.image_selection
    assert_geo_frames_equal(got.final_facilities, want.final_facilities)
    assert_frames_equal(got.preds, want.preds)
    assert_frames_equal(got.facility_cages, want.facility_cages)
    assert list(got.annual_coverage) == list(want.annual_coverage)
    for p in want.annual_coverage:
        assert_frames_equal(got.annual_coverage[p], want.annual_coverage[p])


def test_facility_frames_equal(facilities):
    got, want = facilities
    f = want.final_facilities
    assert f["pass"].nunique() == 3 and len(f) >= 12
    # the overlapping pass's min and max selections differ somewhere
    assert any(a != b for a, b in zip(f["cage_ids_min"], f["cage_ids_max"]))
    for c in ("facility_index", "pass", "cage_ids", "cage_ids_min", "cage_ids_max", "cage_depth"):
        assert got.final_facilities[c].tolist() == f[c].tolist(), c
    assert [g.area for g in got.final_facilities["circle_farm_geoms"]] == [g.area for g in f["circle_farm_geoms"]]
    assert_facilities_equal(got, want)


@pytest.mark.parametrize("selection", ["min", "max"])
def test_facility_selections_equal(selection):
    with jax_python_sweep():
        got, want = build_facilities(world_arrays(seed=3, sites=5), selection)
    assert_facilities_equal(got, want)


@pytest.mark.parametrize("selection", ["min", "max", "random"])
def test_year_dedup_equal(selection):
    arrays = world_arrays(seed=1, sites=5)
    (tp, tb), (jp, jb) = (world_frames(G, P, arrays) for G, P in PACKAGES)
    got, gcov = tdedup.dedup_cages_in_overlap_years_with_white_space(tp, tb, tperiods.map_year_to_image_pass,
                                                                     selection, seed=4)
    want, wcov = jdedup.dedup_cages_in_overlap_years_with_white_space(jp, jb, jperiods.map_year_to_image_pass,
                                                                      selection, seed=4)
    assert_frames_equal(got, want)
    assert list(gcov) == list(wcov)
    for p in wcov:
        assert_frames_equal(gcov[p], wcov[p])


def test_depth_from_geotiff_equal(tmp_path, facilities):
    """GeoTIFF written by each package, read by the other, and the depth
    columns from the file equal."""
    arr = bathymetry_array(5).astype(np.float32)
    tgeotiff.write_geotiff(str(tmp_path / "t.tif"), arr, BATHY_BOUNDS, epsg=4326)
    jgeotiff.write_geotiff(str(tmp_path / "j.tif"), arr, BATHY_BOUNDS, epsg=4326)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    got, want = tgeotiff.read_geotiff(str(tmp_path / "j.tif")), jgeotiff.read_geotiff(str(tmp_path / "t.tif"))
    assert dataclasses.astuple(dataclasses.replace(got, array=None)) == dataclasses.astuple(
        dataclasses.replace(want, array=None))
    np.testing.assert_array_equal(got.array, want.array)
    assert got.bounds == want.bounds and got.pixel_box_to_crs(1, 2, 3, 4) == want.pixel_box_to_crs(1, 2, 3, 4)
    tfac, jfac = facilities
    for stat in ("bathy_min", "bathy_depth"):
        from aquaculture_tpu.tonnage.depth import add_facility_depth as jdepth
        from aquaculture_tpu_torch.tonnage.depth import add_facility_depth as tdepth

        base_t = tfac.final_facilities.drop(columns=["bathy_min", "bathy_max", "bathy_mean", "bathy_depth",
                                                      "cage_depth"])
        base_j = jfac.final_facilities.drop(columns=["bathy_min", "bathy_max", "bathy_mean", "bathy_depth",
                                                      "cage_depth"])
        base_t.crs = base_j.crs = 3857
        g = tdepth(base_t, bathymetry_path=str(tmp_path / "t.tif"), bathymetry_statistic=stat)
        with jax_python_sweep():
            w = jdepth(base_j, bathymetry_path=str(tmp_path / "t.tif"), bathymetry_statistic=stat)
        assert_geo_frames_equal(g, w)
        assert np.isfinite(g["bathy_min"]).all()


# ---------------------------------------------------------------------------
# factors, periods, errors, xlsx
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def factor_files(tmp_path_factory):
    return chip_smoke.write_factor_inputs(str(tmp_path_factory.mktemp("factors")), seed=2)


def test_xlsx_and_factor_tables_equal(factor_files):
    xlsx, fao = factor_files
    assert_plain_frames_equal(txlsx.read_xlsx(xlsx, sheet_name="Production Factors"),
                              jxlsx.read_xlsx(xlsx, sheet_name="Production Factors"))
    got, want = tfactors.load_production_factors(xlsx), jfactors.load_production_factors(xlsx)
    assert_plain_frames_equal(got, want)
    assert set(want["Parameter"]) == {"Stocking density", "Annual harvest frequency"}
    gf_, wf = (m.load_fao_french_mediterranean(fao, p.map_year_to_image_pass)
               for m, p in ((tfactors, tperiods), (jfactors, jperiods)))
    assert_plain_frames_equal(gf_, wf)
    gp, wp = tfactors.generate_period_production_factors(got, gf_, "pass"), \
        jfactors.generate_period_production_factors(want, wf, "pass")
    assert_plain_frames_equal(gp, wp)
    assert len(wp) == 6 and np.isfinite(wp.drop(columns=["pass"]).to_numpy(np.float64)).all()
    assert_plain_frames_equal(tfactors.factor_columns_for_bootstrap(gp), jfactors.factor_columns_for_bootstrap(wp))


def test_periods_and_trujillo_equal(tmp_path):
    assert [tperiods.map_year_to_image_pass(y) for y in range(1998, 2024)] == \
        [jperiods.map_year_to_image_pass(y) for y in range(1998, 2024)]
    pd.DataFrame({"lon": [3.1, 4.2], "lat": [43.1, 43.3]}).to_csv(tmp_path / "t.csv", index=False)
    assert_frames_equal(tperiods.load_trujillo_locations(str(tmp_path / "t.csv")),
                        jperiods.load_trujillo_locations(str(tmp_path / "t.csv")))
    from aquaculture_tpu.results.maps import trujillo_1km_boxes as jboxes
    from aquaculture_tpu_torch.results.maps import trujillo_1km_boxes as tboxes

    for crs in (3857, 3035):
        assert_frames_equal(tboxes(tperiods.load_trujillo_locations(str(tmp_path / "t.csv")), box_crs=crs),
                            jboxes(jperiods.load_trujillo_locations(str(tmp_path / "t.csv")), box_crs=crs))


def _labels_from(det_frame, G, rng_seed=6):
    """Human labels: jittered copies of half the detections, as cage types,
    with the pixel and meter columns the error fit reads."""
    rng = np.random.default_rng(rng_seed)
    pick = np.arange(0, len(det_frame), 2)
    lab = det_frame.iloc[pick].copy()
    lab["type"] = lab["type"].str.replace("_farm", "_cage")
    lab["geometry"] = [type(g)(g.exterior + rng.normal(0, 0.8, (1, 2))) for g in lab["geometry"]]
    lab.crs = det_frame.crs
    b = lab.to_crs(3035).bounds_array()
    for i, c in enumerate(("xmin_m", "ymin_m", "xmax_m", "ymax_m")):
        lab[c] = b[:, i]
    lab["xmin"], lab["ymin"], lab["xmax"], lab["ymax"] = 100, 100, 150, 150
    return lab


def test_model_error_distributions_equal():
    arrays = world_arrays(seed=2)
    out = []
    for (G, P), m, dd in ((PACKAGES[0], terrors, "aquaculture_tpu_torch"), (PACKAGES[1], jerrors, "aquaculture_tpu")):
        preds, _ = world_frames(G, P, arrays)
        dl = G.GeoFrame({"d": [0, 1]}, geometry=[P.box(400_000.0, 5_300_000.0, 401_200.0, 5_301_200.0),
                                                  P.box(401_200.0, 5_300_000.0, 402_400.0, 5_301_200.0)], crs=3857)
        dedup = __import__(dd + ".post.dedup", fromlist=["x"]).deduplicate_download_boxes(dl)
        out.append(m.define_model_error_distributions(_labels_from(preds, G), preds, dedup,
                                                      jperiods.map_year_to_image_pass, 0.785))
    got, want = out
    assert len(want) == 6 and (want["model_error_sd"] > 0).all()
    assert_plain_frames_equal(got, want)


# ---------------------------------------------------------------------------
# the bootstrap
# ---------------------------------------------------------------------------

def lattice_frames(seed=0, m=8, cages_per=9, passes=("2013-2015", "2016-2018")):
    """A seeded facility frame (m facilities over the passes, overlapping
    min/max/random cage lists), its predictions, error table and factor
    table, as the bootstrap takes them."""
    rng = np.random.default_rng(seed)
    n_cages = m * cages_per
    ids = [sorted(rng.choice(n_cages, cages_per, replace=False).tolist()) for _ in range(m)]
    fac = pd.DataFrame({"facility_index": range(m), "pass": [passes[i % len(passes)] for i in range(m)],
                        "cage_depth": rng.uniform(6, 30, m), "cage_ids": ids,
                        "cage_ids_min": [i[:max(1, len(i) - 3)] for i in ids],
                        "cage_ids_max": [i + [int(x) for x in rng.choice(n_cages, 3)] for i in ids]})
    types = rng.choice(["circle_farm", "square_farm"], n_cages)
    preds = pd.DataFrame({"index": np.arange(n_cages), "type": types, "farm_type": types,
                          "area": rng.uniform(50, 500, n_cages),
                          "area_var": np.where(rng.random(n_cages) < 0.3, 0.0, 5.0)})
    errs = pd.DataFrame({"pass": [p for p in passes for _ in range(2)],
                         "farm_type": ["circle_farm", "square_farm"] * len(passes),
                         "model_error_mean": rng.normal(0, 20, 2 * len(passes)),
                         "model_error_sd": rng.uniform(5, 30, 2 * len(passes))})
    pft = pd.DataFrame({"pass": list(passes), "s_mean": rng.uniform(10, 15, len(passes)),
                        "s_sd": rng.uniform(1, 3, len(passes)), "h_mean": rng.uniform(0.5, 0.8, len(passes)),
                        "h_sd": rng.uniform(0.02, 0.1, len(passes))})
    return fac, preds, errs, pft


def assert_inputs_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, list):
            assert g == w, f.name
        else:
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), f.name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepare_bootstrap_inputs_equal(seed):
    fac, preds, errs, pft = lattice_frames(seed, m=5 + 4 * seed)
    if seed == 2:   # a missing list, a NaN list, an error-table gap
        fac.loc[1, "cage_ids_min"] = None
        fac["cage_ids_max"] = fac["cage_ids_max"].astype(object)
        fac.at[2, "cage_ids_max"] = float("nan")
        errs = errs.iloc[1:]
    want = jboot.prepare_bootstrap_inputs(fac, preds, errs, pft, "pass")
    got = tboot.prepare_bootstrap_inputs(fac, preds, errs, pft, "pass")
    assert len(want.cage_fac) > 20
    assert_inputs_equal(got, want)


def simple_inputs(mod):
    """tests/test_tonnage.py's one-facility, one-circle-cage lattice."""
    return mod.BootstrapInputs(
        cage_fac=np.asarray([0], np.int32), area_orig=np.asarray([100.0]), var_zero_circle=np.asarray([True]),
        is_circle=np.asarray([True]), err_mean=np.asarray([0.0]), err_sd=np.asarray([0.0]),
        in_min=np.asarray([True]), in_max=np.asarray([True]), in_random=np.asarray([True]),
        fac_period=np.asarray([0], np.int32), cage_depth=np.asarray([10.0]), s_mean=np.asarray([12.0]),
        s_sd=np.asarray([0.0]), h_mean=np.asarray([0.6]), h_sd=np.asarray([0.0]), periods=["2013-2015"])


def test_bootstrap_closed_form_bracket():
    """Depth from the mixture's first component only: tonnage inside the
    closed-form bracket [area*5*s*h, area*10*s*h]/1000, in both packages."""
    for mod, kw in ((tboot, {"device": "cpu"}), (jboot, {})):
        est = mod.run_bootstrap(simple_inputs(mod), seed=0, K=4000, min_cage_threshold=5.0,
                                depth_dist_mixture_param=1.0, **kw)
        assert 3.6 <= float(est["tonnage"].iloc[0]) <= 7.2 and float(est["tonnage_var"].iloc[0]) > 0


def test_bootstrap_truncnorm_mean_matches_scipy():
    from scipy.stats import truncnorm

    c = 10.0
    want = 100.0 * truncnorm.mean(a=0, b=1.96, loc=c, scale=c / 1.96) * 12.0 * 0.6 / 1000.0
    est = tboot.run_bootstrap(simple_inputs(tboot), seed=1, K=20000, min_cage_threshold=5.0,
                              depth_dist_mixture_param=0.0, device="cpu")
    assert float(est["tonnage"].iloc[0]) == pytest.approx(want, rel=0.02)


def test_bootstrap_positive_area_under_large_negative_error_mean():
    inp = simple_inputs(tboot)
    inp.err_mean[:], inp.err_sd[:] = -200.0, 50.0
    est = tboot.run_bootstrap(inp, seed=2, K=5000, min_cage_threshold=5.0, depth_dist_mixture_param=0.5,
                              device="cpu")
    assert float(est["tonnage"].iloc[0]) > 0
    # area_orig + err is a normal truncated at -area_orig: its mean, times
    # the closed-form factors, brackets the estimate
    assert np.isfinite(est.to_numpy()).all()


def test_bootstrap_degenerate_variance_is_the_closed_form():
    """Every distribution degenerate (sds 0, depth at the threshold, the
    mixture's first component, min == max area, one cage list): each
    period's total is
    sum(area) * depth * s * h / 1000 in every draw, variance 0."""
    fac, preds, errs, pft = lattice_frames(4, m=6)
    errs["model_error_sd"] = 0.0
    pft["s_sd"] = pft["h_sd"] = 0.0
    fac["cage_depth"] = 5.0
    fac["cage_ids_min"] = fac["cage_ids_max"] = fac["cage_ids"]
    preds["type"] = preds["farm_type"] = "circle_farm"
    preds["area_var"] = 0.0
    inp = tboot.prepare_bootstrap_inputs(fac, preds, errs, pft, "pass")
    est = tboot.run_bootstrap(inp, seed=3, K=300, min_cage_threshold=5.0, depth_dist_mixture_param=1.0,
                              device="cpu")
    area = (inp.area_orig + inp.err_mean) * inp.in_min
    fac_area = np.bincount(inp.cage_fac, area, minlength=len(fac))
    tonnage = fac_area * 5.0 * inp.s_mean * inp.h_mean / 1000.0
    want = np.bincount(inp.fac_period, tonnage)
    np.testing.assert_allclose(est["tonnage"].to_numpy(), want, rtol=2e-6)
    assert (est["tonnage_sd"].to_numpy() <= 1e-6 * want).all()


@pytest.fixture(scope="module")
def lattice_runs():
    """One JAX bootstrap and two port bootstraps (one seed) on a seeded
    lattice of 10 facilities over 2 passes at K = 20,000."""
    fac, preds, errs, pft = lattice_frames(7, m=10)
    kw = dict(facility_df=fac, period_factor_table=pft.rename(columns={
        "s_mean": "Factor Stocking density", "s_sd": "Standard deviation Stocking density",
        "h_mean": "Factor Annual harvest frequency", "h_sd": "Standard deviation Annual harvest frequency"}),
        period_var="pass", min_cage_threshold=5.0, preds_df=preds, model_error_distributions=errs,
        depth_dist_mixture_param=0.8, K=20_000, seed=11)
    want = jboot.compute_facility_tonnage_estimates(**kw)
    got = tboot.compute_facility_tonnage_estimates(**kw, device="cpu")
    again = tboot.compute_facility_tonnage_estimates(**kw, device="cpu")
    other = tboot.compute_facility_tonnage_estimates(**{**kw, "seed": 12}, device="cpu")
    return want, got, again, other


def test_bootstrap_moments_within_monte_carlo_error(lattice_runs):
    want, got, _, _ = lattice_runs
    assert list(got.index) == list(want.index) == ["2013-2015", "2016-2018"]
    assert list(got.columns) == list(want.columns) and list(got.dtypes) == list(want.dtypes)
    se = np.sqrt(want["tonnage_var"].to_numpy(np.float64) / 20_000)
    z = np.abs(got["tonnage"].to_numpy(np.float64) - want["tonnage"].to_numpy(np.float64)) / se
    assert (z < 4).all(), z
    ratio = got["tonnage_var"].to_numpy(np.float64) / want["tonnage_var"].to_numpy(np.float64)
    assert (np.abs(ratio - 1) < 0.10).all(), ratio


def test_bootstrap_same_seed_is_bit_identical(lattice_runs):
    _, got, again, other = lattice_runs
    pd.testing.assert_frame_equal(got, again, check_exact=True)
    assert not got.equals(other)


def test_bootstrap_default_device_raises_without_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tboot.run_bootstrap(simple_inputs(tboot), seed=0, K=10, min_cage_threshold=5.0,
                            depth_dist_mixture_param=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfacility.AquaFacility(*world_frames(tgf, tpoly, world_arrays(sites=2)), tperiods.map_year_to_image_pass)


def test_bootstrap_empty_lattice_equal():
    fac, preds, errs, pft = lattice_frames(0, m=3)
    for c in ("cage_ids", "cage_ids_min", "cage_ids_max"):
        fac[c] = [[] for _ in range(3)]
    got = tboot.run_bootstrap(tboot.prepare_bootstrap_inputs(fac, preds, errs, pft, "pass"), 0, 50, 5.0, 0.5,
                              device="cpu")
    want = jboot.run_bootstrap(jboot.prepare_bootstrap_inputs(fac, preds, errs, pft, "pass"), 0, 50, 5.0, 0.5)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


# ---------------------------------------------------------------------------
# the CRS-invariance cases of tests/test_tonnage.py, on the port
# ---------------------------------------------------------------------------

def _two_period_world():
    recs = {k: [] for k in ("image", "year", "det_conf", "type", "area", "area_var", "min_area", "max_area")}
    geoms = []
    for year, x0 in ((2013, 100.0), (2017, 5000.0)):
        for i in range(6):
            x = x0 + 14 * i
            geoms.append(tpoly.box(x, 100, x + 10, 110))
            for k, v in zip(recs, (f"ORTHOIMAGERY.ORTHOPHOTOS{year}_0_0_0.jpeg", year, 0.9, "circle_farm",
                                   78.5, 0.0, 78.5, 78.5)):
                recs[k].append(v)
    preds = tgf.GeoFrame(recs, geometry=geoms, crs=3857)
    boxes = tgf.GeoFrame({"bbox_ind": [0, 0], "x_offset": [0, 0], "y_offset": [0, 0], "year": [2013, 2017],
                          "image_file": ["a", "b"]}, geometry=[tpoly.box(0, 0, 6000, 1200)] * 2, crs=3857)
    errs = pd.DataFrame({"pass": ["2013-2015", "2016-2018"], "farm_type": ["circle_farm"] * 2,
                         "model_error_mean": [0.0] * 2, "model_error_sd": [5.0] * 2})
    pft = pd.DataFrame({"pass": ["2013-2015", "2016-2018"], "Factor Stocking density": [12.0] * 2,
                        "Standard deviation Stocking density": [1.0] * 2,
                        "Factor Annual harvest frequency": [0.6] * 2,
                        "Standard deviation Annual harvest frequency": [0.05] * 2})
    return preds, boxes, errs, pft


def _facility_from(preds, boxes):
    fac = tfacility.AquaFacility(preds, boxes, tperiods.map_year_to_image_pass, min_cluster_size=5, device="cpu")
    fac.compute_min_max_cages()
    fac.final_facilities["cage_depth"] = 12.0
    return fac


def test_period_imputation_crs_invariance():
    preds, boxes, errs, pft = _two_period_world()
    fac_m = _facility_from(preds, boxes)
    preds_deg = preds.to_crs(4326)
    preds_deg.crs = 4326
    fac_deg = _facility_from(preds_deg, boxes)
    kw = dict(current_period="2016-2018", compare_period="2013-2015", model_error_distributions=errs,
              min_cage_threshold=5.0, period_factor_table=pft, depth_dist_mixture_param=0.8, K=500, seed=0)
    t_m = float(tfacility.compute_complete_period_tonnage_estimates(fac_m, **kw).loc["2016-2018", "tonnage"])
    t_deg = float(tfacility.compute_complete_period_tonnage_estimates(fac_deg, **kw).loc["2016-2018", "tonnage"])
    assert t_m == pytest.approx(t_deg, rel=1e-9)
    direct = tboot.compute_facility_tonnage_estimates(
        facility_df=fac_m.final_facilities[fac_m.final_facilities["pass"] == "2016-2018"],
        period_factor_table=pft, period_var="pass", min_cage_threshold=5.0, preds_df=fac_m.preds,
        model_error_distributions=errs, depth_dist_mixture_param=0.8, K=500, seed=0, device="cpu")
    assert t_m == pytest.approx(float(direct.loc["2016-2018", "tonnage"]), rel=1e-9)


def test_bounded_tonnage_crs_invariance():
    preds, boxes, errs, pft = _two_period_world()
    fac_m = _facility_from(preds, boxes)
    preds_deg = preds.to_crs(4326)
    preds_deg.crs = 4326
    fac_deg = _facility_from(preds_deg, boxes)
    bound = tpoly.box(100 - 1000, 100 - 1000, 200 + 1000, 110 + 1000)
    out = {}
    for name, fac in (("m", fac_m), ("deg", fac_deg)):
        cmp = treport.trujillo_comparison(fac, bound, errs, pft, 5.0, 0.8, compare_period="2013-2015", K=500,
                                          bound_crs=3857)
        pred = cmp[cmp["Source"] == "Predicted"].set_index("Measure")["Value"]
        out[name] = (float(pred["Tonnage"]), int(pred["Number of cages"]))
    assert out["m"][1] == 6 and out["m"][0] > 0
    assert out["deg"] == pytest.approx(out["m"])


def test_combined_tonnage_plot_draws(tmp_path):
    """The Figure-6 plot (matplotlib, on the CPU only: the card's machine
    has no matplotlib)."""
    pytest.importorskip("matplotlib")
    est = pd.DataFrame({"tonnage": [100.0, 150.0], "tonnage_sd": [10.0, 12.0]},
                       index=pd.Index(["2013-2015", "2016-2018"], name="pass"))
    fig = treport.combined_tonnage_plot(est, fao_by_period=pd.Series([90.0, 160.0], index=est.index),
                                        out_path=str(tmp_path / "fig6.png"))
    assert os.path.getsize(tmp_path / "fig6.png") > 1000 and len(fig.axes) == 1
