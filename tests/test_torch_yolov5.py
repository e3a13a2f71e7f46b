"""PyTorch port YOLOv5 (aquaculture_tpu_torch.models.yolov5) against the JAX
package, f32: decode(features(x)) vs YoloV5.apply(model.fuse(params), x).
Tolerances: 1e-3 px on decoded coordinates and 1e-5 on sigmoided scores
(reassociated conv sums through ~60 layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu_torch.models.weights import flatten_tree, load_jax_params
from aquaculture_tpu_torch.models.yolov5 import CHANNEL_OVERRIDES, YoloV5, yolov5_init


def _jax_flat(params):
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _assert_preds_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant,size,seed", [("n", 128, 7), ("mt", 64, 0)])
def test_forward_matches_jax(variant, size, seed):
    jmodel, jparams = jax_init(variant, num_classes=5, seed=seed)
    model, params = yolov5_init(variant, num_classes=5, seed=seed)
    # the numpy init draws the JAX package's random tree exactly
    jflat, tflat = _jax_flat(jparams), flatten_tree(params)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    if variant in CHANNEL_OVERRIDES:
        assert model.channels() == jmodel.channels()
    load_jax_params(model, params)
    x = np.random.default_rng(1).random((2, size, size, 3), dtype=np.float32)
    want, _ = jax.jit(jmodel.apply)(jmodel.fuse(jparams), jnp.asarray(x))
    with torch.no_grad():
        got = model.decode(model.features(torch.from_numpy(x)))
    _assert_preds_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stem_s2d,down_s2d", [(False, ()), (True, ("b1", "b3", "n18"))])
def test_kernel_layout_dispatch_matches_jax(stem_s2d, down_s2d):
    # the k6 stem and the k2 space-to-depth downsamples load and run as in
    # the JAX package's features()
    jmodel, jparams = jax_init("n", num_classes=2, seed=3)
    model, params = yolov5_init("n", num_classes=2, seed=3)
    fused = jmodel.fuse(jparams, stem_s2d=stem_s2d, down_s2d=down_s2d)
    load_jax_params(model, model.fuse(params, stem_s2d=stem_s2d, down_s2d=down_s2d))
    assert model.b0.weight.shape[-1] == (3 if stem_s2d else 6)
    x = np.random.default_rng(2).random((1, 96, 96, 3), dtype=np.float32)
    want, _ = jax.jit(jmodel.apply)(fused, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_preds_close(got.numpy(), np.asarray(want))


def test_decode_row_order_matches_jax():
    # head maps with distinct values per (y, x, anchor, channel): the rows
    # must come out in the JAX order (y, x, anchor), not ultralytics' (anchor, y, x)
    jmodel, _ = jax_init("n", num_classes=2)
    model = YoloV5("n", num_classes=2)
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((1, s, s, model.na * model.no)).astype(np.float32) for s in (8, 4, 2)]
    want = jmodel.decode([jnp.asarray(f) for f in feats])
    got = model.decode([torch.from_numpy(f) for f in feats])
    _assert_preds_close(got.numpy(), np.asarray(want))


def test_load_rejects_missing_and_extra_leaves():
    model, params = yolov5_init("n", num_classes=2)
    fused = model.fuse(params)
    missing = {k: v for k, v in fused.items() if k != "n10"}
    with pytest.raises(KeyError, match="n10"):
        load_jax_params(model, missing)
    extra = {**fused, "b99": {"w": np.zeros((1, 1, 1, 1), np.float32)}}
    with pytest.raises(KeyError, match="b99"):
        load_jax_params(model, extra)
    wrong = {**fused, "n10": {**fused["n10"], "w": fused["n10"]["w"][:, :, :-1]}}
    with pytest.raises(ValueError, match="n10"):
        load_jax_params(model, wrong)


def test_m_builds_the_jax_architecture():
    # m (depth 0.67, width 0.75) builds from the same code as mt and n: the
    # same tree of parameter shapes as the JAX package's init, loadable
    jmodel = JaxYoloV5("m", num_classes=5)
    jshapes = {k: v.shape for k, v in _jax_flat(jmodel.init(0)).items()}
    model, params = yolov5_init("m", num_classes=5)
    assert {k: v.shape for k, v in flatten_tree(params).items()} == jshapes
    assert (model.channels(), model.depths()) == (jmodel.channels(), jmodel.depths())
    load_jax_params(model, params)
    with torch.no_grad():
        out = model(torch.zeros((1, 64, 64, 3)))
    assert out.shape == (1, 3 * (8 * 8 + 4 * 4 + 2 * 2), 10) and torch.isfinite(out).all()
