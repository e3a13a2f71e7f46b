"""The port's serving options against the JAX package, f32 on the CPU.

Tolerances, each with its reason:
- letterbox, the TTA resize + pad and the preprocess upscale: 5e-5 on
  [0, 1] pixel values, an eightieth of one uint8 level (the same
  antialiased bilinear filter, its weights computed and summed in another
  order); sizes, gains, pads and pad values exactly equal;
- unletterbox_boxes: exactly equal (one subtraction and one division);
- tta_predict: 1e-3 px on decoded coordinates and 1e-5 on scores, the
  forward tests' tolerance (reassociated conv sums);
- multi-label NMS on a pool full of tied scores: candidates, keep masks and
  the kept rows exactly equal (the same f32 arithmetic on the same rows,
  ties in lax.top_k's order);
- batched_nms_feats: validity masks and classes exactly equal, kept rows
  within 1e-3 px and scores within 1e-6 (sigmoid may round differently in
  the last bit in the two frameworks);
- approx_topk=True: exactly batched_nms's result, as the JAX package's
  approx_max_k is exact off the TPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.models.weights import load_jax_params
from aquaculture_tpu_torch.models.yolov5 import yolov5_init
from aquaculture_tpu_torch.ops import letterbox as tlb
from aquaculture_tpu_torch.ops import nms as tnms
from aquaculture_tpu_torch.ops import tta as ttta
from aquaculture_tpu_torch.pipeline import preprocess

from test_torch_yolov5 import _assert_preds_close

# the JAX package's ops/__init__ re-exports functions named after these modules
jlb = importlib.import_module("aquaculture_tpu.ops.letterbox")
jnms = importlib.import_module("aquaculture_tpu.ops.nms")
jtta = importlib.import_module("aquaculture_tpu.ops.tta")

PIXEL_TOL = 5e-5


# ---------------------------------------------------------------------------
# letterbox
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(300, 500), (900, 700), (640, 400)])
def test_letterbox_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want, wgain, wpad = jlb.letterbox(jnp.asarray(img), 640, dtype=jnp.float32)
    got, gain, pad = tlb.letterbox(torch.from_numpy(img), 640, dtype=torch.float32)
    assert (gain, pad) == (wgain, wpad)
    assert tuple(got.shape) == tuple(want.shape) == (640, 640, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIXEL_TOL, rtol=0)


def test_letterbox_batch_matches_jax():
    imgs = np.random.default_rng(3).integers(0, 256, (2, 360, 500, 3), dtype=np.uint8)
    want, wgain, wpad = jlb.letterbox_batch(jnp.asarray(imgs), 320, dtype=jnp.float32)
    got, gain, pad = tlb.letterbox_batch(torch.from_numpy(imgs), 320, dtype=torch.float32)
    assert (gain, pad) == (wgain, wpad) and pad == (0, 45)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIXEL_TOL, rtol=0)


def test_unletterbox_boxes_matches_jax():
    boxes = np.random.default_rng(4).uniform(0, 640, (2, 50, 4)).astype(np.float32)
    gain, pad = 640 / 900, (70, 0)
    want = jlb.unletterbox_boxes(jnp.asarray(boxes), gain, pad)
    got = tlb.unletterbox_boxes(torch.from_numpy(boxes), gain, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# resize: the P6 upscale in preprocess, the TTA scale + pad
# ---------------------------------------------------------------------------

def test_preprocess_upscale_matches_jax_resize():
    """1024 -> 1280 for P6 at 1/4 size: 256 -> 320 (scale 1.25, border
    pixels weighted by the clipped triangle filter in both)."""
    images = np.random.default_rng(5).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    x = jnp.asarray(images).astype(jnp.float32) / 255.0
    want = jax.image.resize(x, (2, 320, 320, 3), method="bilinear")
    got = preprocess(torch.from_numpy(images), 320, torch.float32)
    assert got.shape == (2, 320, 320, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIXEL_TOL, rtol=0)


@pytest.mark.parametrize("size,ratio,gs", [(640, 0.83, 32), (640, 0.67, 32), (1280, 0.83, 64),
                                           (1280, 0.67, 64), (160, 0.67, 32)])
def test_tta_scale_pad_matches_jax(size, ratio, gs):
    """The pass sizes of the issue's list: 531 and 428 px from 640, 1062 and
    857 from 1280, each padded bottom/right with 0.447 to a multiple of the
    largest stride."""
    rng = np.random.default_rng(size + int(100 * ratio))
    x = rng.random((1, size, size, 3), dtype=np.float32)
    want = np.asarray(jtta._scale_pad(jnp.asarray(x), ratio, gs))
    got = ttta._scale_pad(torch.from_numpy(x), ratio, gs).numpy()
    n = int(size * ratio)
    assert got.shape == want.shape == (1, -(-n // gs) * gs, -(-n // gs) * gs, 3)
    assert (got[:, n:] == np.float32(0.447)).all() and (got[:, :, n:] == np.float32(0.447)).all()
    np.testing.assert_allclose(got, want, atol=PIXEL_TOL, rtol=0)


@pytest.mark.parametrize("variant,size", [("n", 160), ("n6", 256)])
def test_tta_predict_matches_jax(variant, size):
    jmodel, jparams = jax_init(variant, num_classes=3, seed=2)
    model, params = yolov5_init(variant, num_classes=3, seed=2)
    load_jax_params(model, params)
    x = np.random.default_rng(7).random((2, size, size, 3), dtype=np.float32)
    fused = jmodel.fuse(jparams)
    want = jax.jit(lambda p, x: jtta.tta_predict(jmodel, p, x))(fused, jnp.asarray(x))
    with torch.no_grad():
        got = ttta.tta_predict(model, torch.from_numpy(x))
    n_pass = [sum(3 * (-(-int(size * r) // max(model.strides)) * max(model.strides) // s) ** 2
                  for s in model.strides) for r in (1.0, 0.83, 0.67)]
    assert got.shape[1] == sum(n_pass)
    _assert_preds_close(got.numpy(), np.asarray(want))


def test_tta_geometry_must_pair_up():
    with pytest.raises(ValueError, match="same length"):
        DetectConfig(tta_scales=(1.0, 0.83), tta_flips=(None,))
    with pytest.raises(ValueError, match="same length"):
        JaxDetectConfig(tta_scales=(1.0, 0.83), tta_flips=(None,))
    assert (DetectConfig().tta_scales, DetectConfig().tta_flips) == \
        (JaxDetectConfig().tta_scales, JaxDetectConfig().tta_flips) == ((1.0, 0.83, 0.67), (None, "lr", None))


# ---------------------------------------------------------------------------
# NMS: multi-label, single image, feature maps, approx_topk
# ---------------------------------------------------------------------------

def _tied_pool(seed, b=2, n=600, nc=4, tied=True):
    """Decoded rows crowded into a 200 px square. tied: scores from a few
    values, so many (row, class) scores tie exactly, at the top-k cut too;
    else uniform scores."""
    rng = np.random.default_rng(seed)
    preds = np.zeros((b, n, 5 + nc), np.float32)
    preds[..., 0:2] = rng.integers(100, 300, (b, n, 2))
    preds[..., 2:4] = rng.integers(20, 80, (b, n, 2))
    if tied:
        preds[..., 4] = rng.choice([0.5, 1.0], (b, n))
        preds[..., 5:] = rng.choice([0.0, 0.25, 0.5, 0.75], (b, n, nc))
    else:
        preds[..., 4:] = rng.random((b, n, 1 + nc))
    return preds


@jax.jit
def _jax_suppress(boxes, valid):
    return jax.vmap(lambda b_, v: jnms._greedy_suppress(jnms._iou_matrix(b_), v, 0.45))(boxes, valid)


@pytest.mark.parametrize("pre_topk", [1024, 4096])
def test_multi_label_candidates_and_keep_equal_jax(pre_topk):
    preds = _tied_pool(pre_topk)
    n, nc = preds.shape[1], preds.shape[2] - 5
    k = min(pre_topk, n * nc)
    want = jax.vmap(lambda p: jnms._prepare_candidates(p, 0.1, k, False, True))(jnp.asarray(preds))
    got = tnms._prepare_candidates(torch.from_numpy(preds), 0.1, pre_topk, False, multi_label=True)
    for name, g, w in zip(("boxes", "nms_boxes", "scores", "cls", "valid"), got, want):
        assert g.shape[1] == k
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    scores = got[2].numpy()
    assert (scores[:, 1:] == scores[:, :-1]).mean() > 0.5  # mostly ties
    # one row picked under several classes, each copy with its own offset
    assert (got[1][..., 0] - got[0][..., 0]).unique().numel() == nc
    keep = tnms.greedy_suppress_plain(got[1], got[4], 0.45).numpy()
    np.testing.assert_array_equal(keep, np.asarray(_jax_suppress(want[1], want[4])))
    assert 0 < keep.sum() < got[4].sum()


def test_multi_label_batched_nms_equals_jax():
    preds = _tied_pool(11)
    det_w, val_w = jnms.batched_nms(jnp.asarray(preds), 0.1, max_det=300, multi_label=True)
    det, val = tnms.batched_nms(torch.from_numpy(preds), 0.1, max_det=300, multi_label=True)
    val_w = np.asarray(val_w)
    np.testing.assert_array_equal(val.numpy(), val_w)
    np.testing.assert_array_equal(det.numpy()[val_w], np.asarray(det_w)[val_w])
    # more kept than argmax-class on this pool: several classes per box
    _, val_ml = tnms.batched_nms(torch.from_numpy(preds), 0.1, max_det=2400, multi_label=True)
    _, val_argmax = tnms.batched_nms(torch.from_numpy(preds), 0.1, max_det=2400)
    assert val_ml.sum() > val_argmax.sum()


@pytest.mark.parametrize("multi_label", [False, True])
def test_single_image_nms_equals_jax(multi_label):
    pred = _tied_pool(13, b=1)[0]
    det_w, val_w = jnms.nms(jnp.asarray(pred), 0.1, multi_label=multi_label)
    det, val = tnms.nms(torch.from_numpy(pred), 0.1, multi_label=multi_label)
    val_w = np.asarray(val_w)
    assert det.shape == (300, 6)
    np.testing.assert_array_equal(val.numpy(), val_w)
    np.testing.assert_array_equal(det.numpy()[val_w], np.asarray(det_w)[val_w])


def _head_maps(variant, size, seed=3):
    """Raw NHWC head maps of a random model on a random image, as numpy."""
    model, params = yolov5_init(variant, num_classes=3, seed=seed)
    load_jax_params(model, params)
    x = torch.from_numpy(np.random.default_rng(seed).random((2, size, size, 3), dtype=np.float32))
    with torch.no_grad():
        return model, [f.numpy() for f in model.features(x)]


@pytest.mark.parametrize("variant,size", [("n", 160), ("n6", 256)])
def test_batched_nms_feats_matches_jax(variant, size):
    model, feats = _head_maps(variant, size)
    anchors = np.asarray(model.anchor_table, np.float32)
    det_w, val_w = jnms.batched_nms_feats([jnp.asarray(f) for f in feats], anchors, model.strides,
                                          conf_thresh=1e-5, pre_topk=512)
    det, val = tnms.batched_nms_feats([torch.from_numpy(f) for f in feats], model.anchor_table,
                                      model.strides, conf_thresh=1e-5, pre_topk=512)
    val_w = np.asarray(val_w)
    assert val_w.sum() > 20
    np.testing.assert_array_equal(val.numpy(), val_w)
    got, want = det.numpy()[val_w], np.asarray(det_w)[val_w]
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])


def test_batched_nms_feats_equals_rows_path():
    """The (anchor, position) order changes nothing here (no tied scores):
    the feature-map path keeps what batched_nms keeps on decoded rows."""
    model, feats = _head_maps("n", 160, seed=4)
    tfeats = [torch.from_numpy(f) for f in feats]
    det_f, val_f = tnms.batched_nms_feats(tfeats, model.anchor_table, model.strides, conf_thresh=1e-5)
    with torch.no_grad():
        det_r, val_r = tnms.batched_nms(model.decode(tfeats), conf_thresh=1e-5)
    np.testing.assert_array_equal(val_f.numpy(), val_r.numpy())
    np.testing.assert_allclose(det_f.numpy()[val_r.numpy()], det_r.numpy()[val_r.numpy()], atol=1e-3, rtol=0)


@pytest.mark.parametrize("multi_label", [False, True])
def test_approx_topk_is_exact(multi_label):
    """On distinct scores: the JAX package's approx_max_k off the TPU picks
    the exact set but may order exact ties otherwise than lax.top_k."""
    preds = _tied_pool(17, tied=False)
    det, val = tnms.batched_nms(torch.from_numpy(preds), 0.1, multi_label=multi_label)
    det_a, val_a = tnms.batched_nms(torch.from_numpy(preds), 0.1, multi_label=multi_label, approx_topk=True)
    np.testing.assert_array_equal(val_a.numpy(), val.numpy())
    np.testing.assert_array_equal(det_a.numpy(), det.numpy())
    det_w, val_w = jnms.batched_nms(jnp.asarray(preds), 0.1, multi_label=multi_label, approx_topk=True)
    val_w = np.asarray(val_w)
    np.testing.assert_array_equal(val_a.numpy(), val_w)
    np.testing.assert_array_equal(det_a.numpy()[val_w], np.asarray(det_w)[val_w])
