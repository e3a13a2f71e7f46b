"""PyTorch port serving program and file pipeline against the JAX package.

make_infer_fn in f32 (exact masks, boxes within 1e-3 px: the same NMS on
predictions that differ by reassociation only), detect_files in bf16 at the
golden bar of tests/test_golden_pipeline.py (box IoU >= 0.99, confidence
within 1e-3, same classes over the top 20): bf16 rounds at other places in
the two frameworks. Also the port's loader against the JAX package's."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
from aquaculture_tpu.data import loader as jloader
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu.pipeline import detect_files as jax_detect_files
from aquaculture_tpu.pipeline import make_infer_fn as jax_make_infer_fn
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data import loader as tloader
from aquaculture_tpu_torch.models.weights import load_jax_params
from aquaculture_tpu_torch.models.yolov5 import yolov5_init
from aquaculture_tpu_torch.pipeline import detect_files, make_infer_fn


def golden_iou(a, b):
    """tests/test_golden_pipeline.py's box IoU."""
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    iw = max(min(ax1, bx1) - max(ax0, bx0), 0)
    ih = max(min(ay1, by1) - max(ay0, by0), 0)
    inter = iw * ih
    ua = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / ua if ua > 0 else 0.0


def assert_golden_bar(got, want, top=20):
    """got/want: lists of (box, conf, cls) sorted by conf descending."""
    assert len(got) >= top and len(want) >= top
    for (gb, gc, gk), (wb, wc, wk) in zip(got[:top], want[:top]):
        assert golden_iou(gb, wb) >= 0.99, (gb, wb)
        assert abs(gc - wc) <= 1e-3
        assert gk == wk


def test_make_infer_fn_f32_matches_jax():
    jmodel, jparams = jax_init("n", num_classes=5, seed=7)
    model, params = yolov5_init("n", num_classes=5, seed=7)
    load_jax_params(model, params)
    images = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    kw = dict(img_size=128, conf_threshold=3e-5, max_detections=50, dtype="float32")
    det_j, val_j = jax_make_infer_fn(jmodel, jmodel.fuse(jparams), JaxDetectConfig(**kw),
                                     tile=256, batch_size=2)(jmodel.fuse(jparams), images)
    det_t, val_t = make_infer_fn(model, DetectConfig(**kw), tile=256, device="cpu")(
        torch.from_numpy(images))
    det_j, val_j = np.asarray(det_j), np.asarray(val_j)
    np.testing.assert_array_equal(val_t.numpy(), val_j)
    assert val_j.sum() > 0
    np.testing.assert_allclose(det_t.numpy()[..., :4], det_j[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(det_t.numpy()[..., 4], det_j[..., 4], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(det_t.numpy()[..., 5], det_j[..., 5])


def _golden_tile(d):
    """The golden test's fixed 1024 px PNG tile."""
    rng = np.random.default_rng(42)
    img = rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)
    img[100:200, 100:200] = 240
    path = os.path.join(d, "ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.png")
    Image.fromarray(img).save(path)
    return path


def _rows(boxes, conf, cls):
    order = np.argsort(-conf, kind="stable")
    return [(boxes[i].tolist(), float(conf[i]), int(cls[i])) for i in order]


def test_detect_files_bf16_meets_golden_bar(tmp_path):
    path = _golden_tile(str(tmp_path))
    jmodel, jparams = jax_init("n", num_classes=5, seed=7)
    model, params = yolov5_init("n", num_classes=5, seed=7)
    load_jax_params(model, params)
    kw = dict(conf_threshold=3e-5, max_detections=50)
    jb, jc, jk, jspecs, _ = jax_detect_files([path], jmodel, jmodel.fuse(jparams),
                                             JaxDetectConfig(**kw), batch_size=1, use_native=False)
    tb, tc, tk, tspecs, stats = detect_files([path], model, DetectConfig(**kw), batch_size=1,
                                             device="cpu")
    assert tb.dtype == np.int64 and tk.dtype == np.int64
    assert stats.tiles == 1 and stats.batches == 1 and stats.detections == len(tb)
    assert len(tb) == len(jb)
    assert {s.name for s in tspecs} == {s.name for s in jspecs}
    assert_golden_bar(_rows(tb, tc, tk), _rows(jb, jc, jk))


def test_loader_batches_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    # a 2x1 raster split on the hard grid, a small image padded into its slot
    big = rng.integers(0, 255, (256, 512, 3), dtype=np.uint8)
    small = rng.integers(0, 255, (100, 80, 3), dtype=np.uint8)
    for name, img in (("ORTHOIMAGERY.ORTHOPHOTOS2019_3_512_0.png", big), ("plain.png", small)):
        paths.append(os.path.join(tmp_path, name))
        Image.fromarray(img).save(paths[-1])
    want = list(jloader.tile_batches(paths, batch_size=2, tile=256))
    got = list(tloader.tile_batches(paths, batch_size=2, tile=256))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images.numpy(), w.images)
        np.testing.assert_array_equal(g.valid, w.valid)
        assert [None if s is None else (s.name, s.bbox_ind, s.x_offset, s.y_offset) for s in g.specs] == \
            [None if s is None else (s.name, s.bbox_ind, s.x_offset, s.y_offset) for s in w.specs]


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = yolov5_init("n", num_classes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_infer_fn(load_jax_params(model, params), DetectConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detect_files([], model)
