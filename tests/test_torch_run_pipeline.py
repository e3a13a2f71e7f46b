"""The port's aq-pipeline (run_pipeline, cli.pipeline, cli.geocode,
cli.areas) against the JAX package's, on the CPU.

- bf16 (the serving dtype) at the golden bar of
  tests/test_golden_pipeline.py: box IoU >= 0.99, confidence within 1e-3,
  same class, over the top 20 rows by confidence (of the tile, or of each
  image for the CLI): bf16 rounds at other places in the two frameworks.
- f32 on a rendered 8-tile world with the committed trained fixture at
  160 px, with dedup and land: the same rows and columns, pixel boxes
  within 1 px (np.trunc of boxes that differ by reassociation), meter
  columns within 1e-6 relative, and the rest exactly equal.
- The staged CLIs are host code on the same numpy: identical files.
- Overlap serving (overlap=256 on 2048 px rasters: tiles step by 768 px,
  cross-tile NMS after dedup) and decode-at-scale, f32 with the trained
  fixture, against the JAX package on its Python loader (the port's only
  one): the f32 bar above.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.cli import areas as jax_areas_cli
from aquaculture_tpu.cli import geocode as jax_geocode_cli
from aquaculture_tpu.cli import pipeline as jax_pipeline_cli
from aquaculture_tpu.cli.detect import load_model as jax_load_model
from aquaculture_tpu.cli.geocode import load_download_bboxes as jax_load_bboxes
from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu.pipeline import run_pipeline as jax_run_pipeline
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch import pipeline as tpipeline
from aquaculture_tpu_torch.cli import areas as torch_areas_cli
from aquaculture_tpu_torch.cli import geocode as torch_geocode_cli
from aquaculture_tpu_torch.cli import pipeline as torch_pipeline_cli
from aquaculture_tpu_torch.cli.detect import load_model
from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.models.weights import load_jax_params
from aquaculture_tpu_torch.models.yolov5 import yolov5_init
from aquaculture_tpu_torch.ops import nms_cuda
from aquaculture_tpu_torch.pipeline import run_pipeline

from test_torch_pipeline import _golden_tile, golden_iou

FIXTURE = str(Path(__file__).parent / "data" / "demo_ckpt_n160")
PX = ["xmin", "ymin", "xmax", "ymax"]
METERS = ["xmin_m", "xmax_m", "ymin_m", "ymax_m"]


def _top_rows(det, n=20):
    det = det.sort_values("det_conf", ascending=False, kind="stable").head(n)
    return list(zip(det[PX].to_numpy(np.float64).tolist(), det["det_conf"].tolist(), det["type"].tolist()))


def assert_golden_bar(got, want, least=20):
    assert len(got) == len(want) >= least
    for (gb, gc, gk), (wb, wc, wk) in zip(got, want):
        assert golden_iou(gb, wb) >= 0.99, (gb, wb)
        assert abs(gc - wc) <= 1e-3
        assert gk == wk


def test_run_pipeline_bf16_meets_golden_bar(tmp_path):
    """tests/test_golden_pipeline.py's tile and download box."""
    path = _golden_tile(str(tmp_path))
    jmodel, jparams = jax_init("n", num_classes=5, seed=7)
    model, params = yolov5_init("n", num_classes=5, seed=7)
    load_jax_params(model, params)
    kw = dict(conf_threshold=3e-5, max_detections=50)
    jdl = jgf.GeoFrame({"d": [0]}, geometry=[jpoly.box(0, 0, 1200, 1200)], crs=3857)
    tdl = tgf.GeoFrame({"d": [0]}, geometry=[tpoly.box(0, 0, 1200, 1200)], crs=3857)
    want, _ = jax_run_pipeline([path], jmodel, jmodel.fuse(jparams), jdl, JaxDetectConfig(**kw),
                               batch_size=1, use_native=False)
    launches = nms_cuda.launches
    got, stats = run_pipeline([path], model, tdl, DetectConfig(**kw), batch_size=1, device="cpu")
    assert nms_cuda.launches == launches  # the CPU path never touches the kernel
    assert got.crs == want.crs == 4326
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    assert_golden_bar(_top_rows(got), _top_rows(want))
    assert list(stats.stage_seconds) == list(stats.stage_rows) == ["detect", "geocode", "dedup", "areas"]
    assert stats.stage_rows["areas"] == len(got) and stats.land_filter == ""


def _land(d):
    """A jagged coast over the world's first row of download boxes, with
    the second row on land, written as EPSG:4326 GeoJSON."""
    xs = np.linspace(-100, 1500, 17)
    ys = 1100 + np.random.default_rng(3).uniform(-60, 60, len(xs))
    ring = np.concatenate([np.stack([xs, ys], 1), [[1500, 2500], [-100, 2500]]], 0)
    land = tgf.GeoFrame({"name": ["coast"]}, geometry=[tpoly.Polygon(ring)], crs=3857).to_crs(4326)
    path = os.path.join(d, "land.geojson")
    land.to_file(path)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from end_to_end_demo import render_world

    out = str(tmp_path_factory.mktemp("world"))
    img_dir, lab_dir = render_world(out, n_images=8, seed=0)
    return {"images": img_dir, "labels": lab_dir, "bboxes": os.path.join(out, "wanted_bboxes.csv"),
            "land": _land(out)}


def test_run_pipeline_f32_trained_world_with_land(world):
    paths = sorted(os.path.join(world["images"], f) for f in os.listdir(world["images"]))
    kw = dict(img_size=160, conf_threshold=0.05, dtype="float32")
    jmodel, jparams = jax_load_model(FIXTURE, "n", 2)
    want, _ = jax_run_pipeline(paths, jmodel, jparams, jax_load_bboxes(world["bboxes"]), JaxDetectConfig(**kw),
                               batch_size=4, land=jgf.read_file(world["land"]), use_native=False)
    got, stats = run_pipeline(paths, load_model(FIXTURE, "n", 2), load_download_bboxes(world["bboxes"]),
                              DetectConfig(**kw), batch_size=4, land=tgf.read_file(world["land"]),
                              device="cpu")
    assert stats.land_filter == "exact" and stats.batches == 2 and stats.tiles == 8
    assert stats.stage_rows["land_filter"] == len(got) < stats.stage_rows["areas"]  # land removed rows
    assert_f32_frames_match(got, want)


def assert_f32_frames_match(got, want, least=20):
    """The f32 bar of the module docstring."""
    assert len(got) == len(want) >= least and got.crs == want.crs == 4326
    assert list(got.columns) == list(want.columns) and list(got.dtypes) == list(want.dtypes)
    assert got["image"].tolist() == want["image"].tolist() and got["type"].tolist() == want["type"].tolist()
    px_diff = np.abs(got[PX].to_numpy() - want[PX].to_numpy())
    assert px_diff.max() <= 1
    np.testing.assert_allclose(got[METERS].to_numpy(), want[METERS].to_numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["det_conf"], want["det_conf"], atol=1e-5, rtol=0)
    same = (px_diff == 0).all(axis=1)
    assert same.mean() >= 0.9
    for c in ("area", "area_var", "min_area", "max_area"):
        np.testing.assert_array_equal(got[c].to_numpy()[same], want[c].to_numpy()[same])


def test_hybrid_branch_from_the_switch(world, monkeypatch):
    """run_pipeline takes the hybrid land filter from
    HYBRID_LAND_FILTER_ROWS detections on (2,000, as the JAX package), and
    it returns the exact branch's rows."""
    assert tpipeline.HYBRID_LAND_FILTER_ROWS == 2000
    paths = sorted(os.path.join(world["images"], f) for f in os.listdir(world["images"]))[:4]
    model = load_model(FIXTURE, "n", 2)
    args = (paths, model, load_download_bboxes(world["bboxes"]), DetectConfig(img_size=160, conf_threshold=0.05))
    land = tgf.read_file(world["land"])
    exact, stats = run_pipeline(*args, land=land, device="cpu")
    monkeypatch.setattr(tpipeline, "HYBRID_LAND_FILTER_ROWS", 1)
    hybrid, hstats = run_pipeline(*args, land=land, device="cpu")
    assert (stats.land_filter, hstats.land_filter) == ("exact", "hybrid")
    assert hybrid.index.tolist() == exact.index.tolist() and len(hybrid) > 0


def _features(path):
    with open(path) as f:
        return json.load(f)["features"]


def test_cli_pipeline_matches_jax_cli(world, tmp_path):
    """bf16, the random n model at 256 px from two 1024 px tiles with the
    world's download boxes and land (box 1's tile is partly on land, box
    2's is not): the written GeoJSONs at the golden bar per image."""
    from PIL import Image

    src = tmp_path / "tiles"
    src.mkdir()
    rng = np.random.default_rng(42)
    for i in range(2):
        img = rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
        img[100 + 200 * i: 200 + 200 * i, 100:200] = 240
        Image.fromarray(img).save(src / f"ORTHOIMAGERY.ORTHOPHOTOS2014_{2 - i}_0_0.png")
    args = ["--source", str(src), "--download-bboxes", world["bboxes"], "--land", world["land"],
            "--variant", "n", "--num-classes", "5", "--img", "256", "--conf", "3e-5", "--batch", "2"]
    jax_pipeline_cli.main(args + ["--out", str(tmp_path / "jax.geojson")])
    det, stats = torch_pipeline_cli.main(args + ["--out", str(tmp_path / "torch.geojson"), "--device", "cpu"])
    assert list(stats.stage_seconds) == ["detect", "geocode", "dedup", "areas", "land_filter", "write"]
    got, want = tgf.read_file(str(tmp_path / "torch.geojson")), jgf.read_file(str(tmp_path / "jax.geojson"))
    assert len(got) == len(det) and list(got.columns) == list(want.columns)
    assert sorted(set(got["image"])) == sorted(set(want["image"])) and len(set(got["image"])) == 2
    for image in set(want["image"]):
        assert_golden_bar(_top_rows(got[got["image"] == image]), _top_rows(want[want["image"] == image]),
                          least=10)


def test_staged_clis_write_identical_files(world, tmp_path):
    """cli.geocode (dedup, land, ocean output) and then cli.areas on the
    world's label files: the same bytes from both packages."""
    args = ["--labels", world["labels"], "--download-bboxes", world["bboxes"], "--land", world["land"]]
    for name, cli in (("jax", jax_geocode_cli), ("torch", torch_geocode_cli)):
        cli.main(args + ["--out", str(tmp_path / f"{name}.geojson"),
                         "--ocean-out", str(tmp_path / f"{name}_ocean.geojson")])
    for name, cli in (("jax", jax_areas_cli), ("torch", torch_areas_cli)):
        cli.main(["--detections", str(tmp_path / f"{name}.geojson"),
                  "--out", str(tmp_path / f"{name}_areas.geojson")])
    for suffix in ("", "_ocean", "_areas"):
        got = (tmp_path / f"torch{suffix}.geojson").read_bytes()
        assert got == (tmp_path / f"jax{suffix}.geojson").read_bytes(), suffix
    n, n_ocean = len(_features(tmp_path / "torch.geojson")), len(_features(tmp_path / "torch_ocean.geojson"))
    assert 0 < n_ocean < n
    assert "area" in _features(tmp_path / "torch_areas.geojson")[0]["properties"]


def test_pipeline_needs_cuda_unless_cpu_is_asked(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = yolov5_init("n", num_classes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline([], load_jax_params(model, params), load_download_bboxes(world["bboxes"]))
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_pipeline_cli.main(["--source", world["images"], "--download-bboxes", world["bboxes"],
                                 "--out", str(tmp_path / "x.geojson"), "--variant", "n"])
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def rasters(world, tmp_path_factory):
    """Two 2048 px JPEG rasters, each the world's tiles 4r..4r+3 in a 2 x 2
    grid, named for download boxes 0 and 1 at offset 0."""
    from PIL import Image

    d = tmp_path_factory.mktemp("rasters")
    tiles = sorted(os.listdir(world["images"]))
    paths = []
    for r in range(2):
        quad = [np.asarray(Image.open(os.path.join(world["images"], t)).convert("RGB"))
                for t in tiles[4 * r: 4 * r + 4]]
        raster = np.concatenate([np.concatenate(quad[:2], 1), np.concatenate(quad[2:], 1)], 0)
        paths.append(str(d / f"ORTHOIMAGERY.ORTHOPHOTOS2014_{r}_0_0.jpeg"))
        Image.fromarray(raster).save(paths[-1], quality=92)
    return paths


def test_run_pipeline_overlap_matches_jax(world, rasters):
    kw = dict(img_size=160, conf_threshold=0.05, dtype="float32")
    jmodel, jparams = jax_load_model(FIXTURE, "n", 2)
    want, jstats = jax_run_pipeline(rasters, jmodel, jparams, jax_load_bboxes(world["bboxes"]),
                                    JaxDetectConfig(**kw), batch_size=6, land=jgf.read_file(world["land"]),
                                    use_native=False, overlap=256)
    got, stats = run_pipeline(rasters, load_model(FIXTURE, "n", 2), load_download_bboxes(world["bboxes"]),
                              DetectConfig(**kw), batch_size=6, land=tgf.read_file(world["land"]),
                              device="cpu", overlap=256)
    assert stats.tiles == jstats.tiles == 18 and stats.batches == 3  # 3 x 3 tiles per raster
    assert list(stats.stage_rows) == ["detect", "geocode", "dedup", "cross_tile", "areas", "land_filter"]
    assert stats.stage_rows["cross_tile"] < stats.stage_rows["dedup"]  # overlap copies collapsed
    assert_f32_frames_match(got, want)


def test_run_pipeline_decode_scale_matches_jax(world):
    """256 px from 1024 px tiles (2/8): the host resizes, the device does not."""
    paths = sorted(os.path.join(world["images"], f) for f in os.listdir(world["images"]))
    kw = dict(img_size=256, conf_threshold=0.05, dtype="float32")
    jmodel, jparams = jax_load_model(FIXTURE, "n", 2)
    want, _ = jax_run_pipeline(paths, jmodel, jparams, jax_load_bboxes(world["bboxes"]), JaxDetectConfig(**kw),
                               batch_size=4, use_native=False, decode_scale=True)
    got, stats = run_pipeline(paths, load_model(FIXTURE, "n", 2), load_download_bboxes(world["bboxes"]),
                              DetectConfig(**kw), batch_size=4, device="cpu", decode_scale=True,
                              decode_threads=1)
    assert stats.loader == "python" and stats.tiles == 8
    assert_f32_frames_match(got, want, least=10)


def test_cli_pipeline_passes_the_new_flags(world, tmp_path, monkeypatch):
    seen = {}

    def fake_run_pipeline(paths, model, dl, cfg, batch, **kw):
        seen.update(kw, img_size=cfg.img_size, variant=model.variant)
        return tgf.GeoFrame({"a": []}, geometry=[], crs=4326), tpipeline.PipelineStats()

    monkeypatch.setattr(torch_pipeline_cli, "run_pipeline", fake_run_pipeline)
    base = ["--source", world["images"], "--download-bboxes", world["bboxes"], "--device", "cpu",
            "--out", str(tmp_path / "x.geojson")]
    torch_pipeline_cli.main(base + ["--variant", "n6", "--num-classes", "2", "--overlap", "256",
                                    "--decode-threads", "2"])
    assert (seen["img_size"], seen["variant"], seen["overlap"], seen["decode_threads"], seen["decode_scale"]) \
        == (1280, "n6", 256, 2, False)
    torch_pipeline_cli.main(base + ["--variant", "n", "--num-classes", "2", "--decode-scale"])
    assert (seen["img_size"], seen["overlap"], seen["decode_scale"]) == (640, 0, True)


@pytest.mark.parametrize("flag", ["--profile=trace", "--aot=x.aqx"])
def test_cli_pipeline_rejects_flags_of_later_slices(flag, world, tmp_path):
    with pytest.raises(SystemExit):
        torch_pipeline_cli.main(["--source", world["images"], "--download-bboxes", world["bboxes"],
                                 "--out", str(tmp_path / "x.geojson"), "--device", "cpu", flag])
