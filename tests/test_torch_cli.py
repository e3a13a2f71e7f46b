"""The port's detection CLI against the JAX package's: the same label files,
rows within the golden bar of tests/test_golden_pipeline.py (box IoU >=
0.99, confidence within 1e-3, same class over each file's top 20; bf16),
also with --int8 (each package calibrates and quantizes on its own; the
pipeline CLI's GeoJSON per image at the same bar)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu import frame as jgf
from aquaculture_tpu.cli import detect as jax_cli
from aquaculture_tpu.cli import pipeline as jax_pipeline_cli
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli import detect as torch_cli
from aquaculture_tpu_torch.cli import pipeline as torch_pipeline_cli
from aquaculture_tpu_torch.models import layers
from aquaculture_tpu_torch.ops import int8_conv, nms_cuda
from aquaculture_tpu_torch.pipeline import detect_files

from test_torch_run_pipeline import _top_rows, assert_golden_bar


def _cxcywh_to_xyxy(r):
    cx, cy, w, h = r
    return (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)


def _iou(a, b):
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0)
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(42)
    for i in range(2):
        img = rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
        img[100 + 200 * i : 200 + 200 * i, 100:200] = 240
        Image.fromarray(img).save(d / f"ORTHOIMAGERY.ORTHOPHOTOS2014_5_{1024 * i}_0.png")
    return str(d)


def test_cli_labels_match_jax(tiles, tmp_path):
    args = ["--source", tiles, "--variant", "n", "--num-classes", "5", "--img", "256",
            "--conf", "3e-5", "--batch", "2"]
    jax_cli.main(args + ["--out", str(tmp_path / "jax")])
    launches = nms_cuda.launches
    stats = torch_cli.main(args + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    assert nms_cuda.launches == launches  # the CPU path never touches the kernel
    assert stats.tiles == 2 and stats.batches == 1
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 2
    for name in names:
        want = np.loadtxt(tmp_path / "jax" / name, ndmin=2)
        got = np.loadtxt(tmp_path / "torch" / name, ndmin=2)
        assert got.shape == want.shape and len(got) >= 20
        for g, w in zip(got[:20], want[:20]):
            assert g[0] == w[0]
            assert _iou(_cxcywh_to_xyxy(g[1:5]), _cxcywh_to_xyxy(w[1:5])) >= 0.99, (g, w)
            assert abs(g[5] - w[5]) <= 1e-3


def _assert_label_files_match(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == 2
    for name in names:
        want = np.loadtxt(os.path.join(want_dir, name), ndmin=2)
        got = np.loadtxt(os.path.join(got_dir, name), ndmin=2)
        assert got.shape == want.shape and len(got) >= 20
        for g, w in zip(got[:20], want[:20]):
            assert g[0] == w[0]
            assert _iou(_cxcywh_to_xyxy(g[1:5]), _cxcywh_to_xyxy(w[1:5])) >= 0.99, (g, w)
            assert abs(g[5] - w[5]) <= 1e-3


def test_cli_int8_labels_match_jax(tiles, tmp_path, monkeypatch):
    """--int8: the localization-safe split calibrated on the source tiles
    (bf16 letterbox at --img) by each package; on the CPU every int8 conv
    takes the plain route, and the labels meet the golden bar."""
    served = []
    monkeypatch.setattr(torch_cli, "detect_files", lambda paths, model, *a, **k: (
        served.append(model), detect_files(paths, model, *a, **k))[1])
    args = ["--source", tiles, "--variant", "n", "--num-classes", "5", "--img", "256",
            "--conf", "3e-5", "--batch", "2", "--int8"]
    jax_cli.main(args + ["--out", str(tmp_path / "jax")])
    int8_conv.mm_calls = int8_conv.plain_calls = 0
    torch_cli.main(args + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    assert int8_conv.mm_calls == 0 and int8_conv.plain_calls > 0
    qblocks = {n for n, m in served[0].named_modules() if isinstance(m, layers.QConvBlock)}
    assert "b5" in qblocks and not any(n.startswith(("b0", "b4.", "n17.", "head")) for n in qblocks)
    _assert_label_files_match(tmp_path / "jax", tmp_path / "torch")


def test_cli_pipeline_int8_matches_jax(tiles, tmp_path):
    """cli.pipeline --int8 (which calibrates at 640 px whatever --img says,
    in both packages): the GeoJSON rows of each image at the golden bar."""
    boxes = tmp_path / "wanted_bboxes.csv"
    boxes.write_text("geometry\n" + "".join(
        f'"POLYGON (({x} 0, {x + 1200} 0, {x + 1200} 1200, {x} 1200, {x} 0))"\n' for x in range(0, 7200, 1200)))
    args = ["--source", tiles, "--download-bboxes", str(boxes), "--variant", "n", "--num-classes", "5",
            "--img", "256", "--conf", "3e-5", "--batch", "2", "--int8"]
    jax_pipeline_cli.main(args + ["--out", str(tmp_path / "jax.geojson")])
    det, stats = torch_pipeline_cli.main(args + ["--out", str(tmp_path / "torch.geojson"), "--device", "cpu"])
    assert stats.tiles == 2 and stats.batches == 1
    got, want = tgf.read_file(str(tmp_path / "torch.geojson")), jgf.read_file(str(tmp_path / "jax.geojson"))
    assert len(got) == len(det) and sorted(set(got["image"])) == sorted(set(want["image"]))
    for image in set(want["image"]):
        assert_golden_bar(_top_rows(got[got["image"] == image]), _top_rows(want[want["image"] == image]))


def test_cli_without_gpu_raises_unless_cpu_is_asked(tiles, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_cli.main(["--source", tiles, "--out", str(tmp_path), "--variant", "n"])
    assert not os.listdir(tmp_path)


def test_cli_tta_multi_label_labels_match_jax(tiles, tmp_path):
    """--augment --multi-label: the 3-pass TTA pool, one candidate per
    (box, class), in bf16 at the golden bar."""
    args = ["--source", tiles, "--variant", "n", "--num-classes", "3", "--img", "128",
            "--conf", "1e-5", "--batch", "2", "--augment", "--multi-label"]
    jax_cli.main(args + ["--out", str(tmp_path / "jax")])
    stats = torch_cli.main(args + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    assert stats.tiles == 2 and stats.loader == "python"
    for name in sorted(os.listdir(tmp_path / "jax")):
        want = np.loadtxt(tmp_path / "jax" / name, ndmin=2)
        got = np.loadtxt(tmp_path / "torch" / name, ndmin=2)
        assert got.shape == want.shape and len(got) >= 20
        for g, w in zip(got[:20], want[:20]):
            assert g[0] == w[0]
            assert _iou(_cxcywh_to_xyxy(g[1:5]), _cxcywh_to_xyxy(w[1:5])) >= 0.99, (g, w)
            assert abs(g[5] - w[5]) <= 1e-3


@pytest.mark.parametrize("argv,img,flags", [
    (["--variant", "n6"], 1280, (False, False, False)),
    (["--variant", "m6", "--img", "640"], 640, (False, False, False)),
    (["--variant", "mt", "--augment", "--multi-label"], 640, (True, True, False)),
    (["--variant", "n", "--decode-scale"], 640, (False, False, True)),
])
def test_cli_new_flags_parse(argv, img, flags, tiles, tmp_path, monkeypatch):
    seen = {}

    def fake_detect_files(paths, model, cfg, batch, **kw):
        seen.update(cfg=cfg, model=model, **kw)
        from aquaculture_tpu_torch.pipeline import PipelineStats

        return np.zeros((0, 4), np.int64), np.zeros(0), np.zeros(0, np.int64), [], PipelineStats()

    monkeypatch.setattr(torch_cli, "detect_files", fake_detect_files)
    torch_cli.main(["--source", tiles, "--out", str(tmp_path), "--device", "cpu", "--num-classes", "2"] + argv)
    cfg = seen["cfg"]
    assert cfg.img_size == img and seen["model"].variant == argv[1]
    assert (cfg.augment, cfg.multi_label, seen["decode_scale"]) == flags


@pytest.mark.parametrize("flag", ["--profile=trace", "--aot=x.aqx"])
def test_cli_rejects_flags_of_later_slices(flag, tiles, tmp_path):
    """Both flags were a later slice's until the serving tooling came
    (tests/test_torch_profiler.py and test_torch_aot.py drive them); what
    is still refused is a flag without its value and, for --aot, a file
    that is not the port's artifact, before any model is built."""
    name, value = flag.split("=")
    base = ["--source", tiles, "--out", str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(SystemExit):
        torch_cli.main(base + [name])
    if name == "--aot":
        (tmp_path / value).write_bytes(b"nope")
        with pytest.raises(ValueError, match="not an aquaculture_tpu_torch AOT artifact"):
            torch_cli.main(base + [f"--aot={tmp_path / value}"])
    assert not os.path.exists(tmp_path / "out")
