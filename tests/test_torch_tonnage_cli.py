"""cli.facilities -> cli.tonnage of the port against the JAX package's CLIs
on the same files, on the CPU: a seeded world of 3 passes (two survey
years overlapping inside one), a bathymetry GeoTIFF, a written factor
workbook, FAO CSV and Trujillo CSV.

- The facility pickles hold equal frames (tolerance 0).
- The tonnage CSVs have the same index, and each period's mean lies within
  4 Monte-Carlo standard errors of the JAX package's at K = 500.
- The port loads the JAX package's pickle (restricted unpickler) and gives
  the same table from it as from its own; it refuses a pickle naming
  anything else (a dotted name on an allowed module, pandas' own loader of
  a second pickle); both CLIs raise without a GPU unless given
  --device cpu.
"""

import io
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from aquaculture_tpu.cli import facilities as jcli_facilities
from aquaculture_tpu.cli import tonnage as jcli_tonnage
from aquaculture_tpu.geo import crs as jcrs
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli import facilities as tcli_facilities
from aquaculture_tpu_torch.cli import tonnage as tcli_tonnage
from aquaculture_tpu_torch.data.geotiff import write_geotiff
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.tonnage import facility as tfacility

import chip_smoke
from test_torch_overlay import jax_python_sweep
from test_torch_tonnage import (BATHY_BOUNDS, _labels_from, assert_facilities_equal, bathymetry_array,
                                world_arrays, world_frames)

K = 500


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tonnage_world")
    preds, boxes = world_frames(tgf, tpoly, world_arrays(seed=8))
    paths = {"detections": str(d / "detections.geojson"), "image_boxes": str(d / "image_boxes.geojson"),
             "labels": str(d / "labels.geojson"), "bboxes": str(d / "wanted_bboxes.csv"),
             "bathymetry": str(d / "bathymetry.tif"), "trujillo": str(d / "trujillo.csv"), "dir": d}
    preds.to_file(paths["detections"])
    boxes.to_file(paths["image_boxes"])
    _labels_from(preds, tgf).to_file(paths["labels"])
    chip_smoke.write_boxes_csv(paths["bboxes"], [(400_000.0, 5_300_000.0, 401_200.0, 5_301_200.0),
                                                 (401_200.0, 5_300_000.0, 402_400.0, 5_301_200.0)])
    write_geotiff(paths["bathymetry"], bathymetry_array(1).astype(np.float32), BATHY_BOUNDS, epsg=4326)
    lon, lat = jcrs.transform(3857, 4326, np.array([400_600.0, 401_900.0]), np.array([5_300_500.0, 5_300_700.0]))
    pd.DataFrame({"lon": lon, "lat": lat}).to_csv(paths["trujillo"], index=False)
    paths["factors"], paths["fao"] = chip_smoke.write_factor_inputs(str(d), seed=3)
    return paths


def _facilities_argv(p, out):
    return ["--detections", p["detections"], "--image-boxes", p["image_boxes"], "--out", out,
            "--bathymetry", p["bathymetry"]]


def _tonnage_argv(p, pkl, out):
    return ["--facility", pkl, "--labels", p["labels"], "--detections", p["detections"], "--download-bboxes",
            p["bboxes"], "--prod-factors", p["factors"], "--fao", p["fao"], "--trujillo", p["trujillo"],
            "--out", out, "--K", str(K)]


@pytest.fixture(scope="module")
def runs(files):
    d = files["dir"]
    with jax_python_sweep():
        jcli_facilities.main(_facilities_argv(files, str(d / "j.pkl")))
        jcli_tonnage.main(_tonnage_argv(files, str(d / "j.pkl"), str(d / "j.csv")))
    port_fac = tcli_facilities.main(_facilities_argv(files, str(d / "t.pkl")) + ["--device", "cpu"])
    port_est = tcli_tonnage.main(_tonnage_argv(files, str(d / "t.pkl"), str(d / "t.csv"))
                                 + ["--device", "cpu", "--plot", str(d / "fig6.png")])
    from_jax = tcli_tonnage.main(_tonnage_argv(files, str(d / "j.pkl"), str(d / "tj.csv")) + ["--device", "cpu"])
    with open(d / "j.pkl", "rb") as f:
        jax_fac = pickle.load(f)
    return {"jax_fac": jax_fac, "port_fac": port_fac, "port_est": port_est, "from_jax": from_jax,
            "jax_csv": pd.read_csv(d / "j.csv", index_col=0), "port_csv": pd.read_csv(d / "t.csv", index_col=0)}


def test_facility_pickles_equal(runs, files):
    want = runs["jax_fac"]
    assert want.final_facilities["pass"].nunique() == 3 and "cage_depth" in want.final_facilities
    assert_facilities_equal(runs["port_fac"], want)
    loaded = tfacility.load_AquaFacility(str(files["dir"] / "t.pkl"))
    assert type(loaded) is tfacility.AquaFacility and loaded.device == "cpu"
    assert_facilities_equal(loaded, want)


def test_tonnage_csv_within_monte_carlo_error(runs):
    got, want = runs["port_csv"], runs["jax_csv"]
    assert list(got.index) == list(want.index) and len(want) == 3
    assert list(got.columns) == list(want.columns) == ["tonnage", "tonnage_var", "tonnage_sd"]
    se = np.sqrt((got["tonnage_var"] + want["tonnage_var"]).to_numpy() / K)
    z = np.abs(got["tonnage"] - want["tonnage"]).to_numpy() / se
    assert (want["tonnage"] > 0).all() and (z < 4).all(), z


def test_port_loads_the_jax_pickle_and_gives_the_same_table(runs, files):
    """The JAX package's pickle loads as port classes (with the class's
    default device, overridden by --device), and the same facility gives
    the same table bit for bit."""
    fac = tfacility.load_AquaFacility(str(files["dir"] / "j.pkl"))
    assert type(fac) is tfacility.AquaFacility and type(fac.final_facilities) is tgf.GeoFrame
    assert fac.selected_map(2014) == "2013-2015" and fac.device == "cuda"
    assert_facilities_equal(fac, runs["jax_fac"])
    pd.testing.assert_frame_equal(runs["from_jax"], runs["port_est"], check_exact=True)
    assert os.path.getsize(files["dir"] / "fig6.png") > 1000


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def _call_pickle(module, name, arg):
    """A protocol-0 pickle that calls ``module.name(arg)`` on load."""
    return f"c{module}\n{name}\n(S'{arg}'\ntR.".encode()


# each payload names a callable an open allow-list would reach: a module
# outside the list, a dotted name followed from an allowed module (the port's
# or the JAX package's facility module imports os and importlib), and an
# allowed package's own loader of a second, unrestricted pickle
_PAYLOADS = {
    "os_system": lambda tmp: pickle.dumps(_Evil()),
    "builtins_eval": lambda tmp: pickle.dumps(eval),
    "port_module_os_system": lambda tmp: _call_pickle("aquaculture_tpu_torch.tonnage.facility", "os.system",
                                                      f"touch {tmp / 'ran'}"),
    "jax_module_os_system": lambda tmp: _call_pickle("aquaculture_tpu.tonnage.facility", "os.system",
                                                     f"touch {tmp / 'ran'}"),
    "port_module_import_module": lambda tmp: _call_pickle("aquaculture_tpu_torch.tonnage.facility",
                                                          "importlib.import_module", "aquaculture_tpu"),
    "pandas_read_pickle": lambda tmp: _call_pickle("pandas", "read_pickle", tmp / "inner.pkl"),
    "numpy_load": lambda tmp: _call_pickle("numpy", "load", tmp / "inner.pkl"),
}


@pytest.mark.parametrize("payload", list(_PAYLOADS))
def test_facility_unpickler_refuses_other_globals(payload, tmp_path):
    (tmp_path / "inner.pkl").write_bytes(_call_pickle("os", "system", f"touch {tmp_path / 'ran'}"))
    blob = _PAYLOADS[payload](tmp_path)
    path = tmp_path / "bad.pkl"
    path.write_bytes(blob)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tfacility.load_AquaFacility(str(path))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tfacility._FacilityUnpickler(io.BytesIO(blob)).load()
    assert not (tmp_path / "ran").exists()


def test_clis_need_a_gpu_unless_asked(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli_facilities.main(_facilities_argv(files, str(tmp_path / "f.pkl")))
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli_tonnage.main(_tonnage_argv(files, str(files["dir"] / "t.pkl"), str(tmp_path / "t.csv")))
    assert not os.path.exists(tmp_path / "f.pkl") and not os.path.exists(tmp_path / "t.csv")
