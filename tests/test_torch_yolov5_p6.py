"""The port's P6 family (n6..x6: stride-64 level, 4-level PANet) against the
JAX package, f32 on the CPU.

- init: the numpy tree equals the JAX package's ``YoloV5.init`` leaf for
  leaf (tolerance 0), and m6 builds the JAX package's architecture;
- forward: decode(features(x)) of the fused n6 at 256 px against
  ``YoloV5.apply``, within the P5 tests' tolerance (1e-3 px on decoded
  coordinates, 1e-5 on sigmoided scores: reassociated conv sums);
- ``fuse(down_s2d=...)`` on all eight P6 downsample names gives the JAX
  package's fused tree exactly and an exactly reparametrized forward
  (the same tolerance: summation order only), and a P5 name raises in
  both;
- a P6 state dict in ultralytics numbering (model.0..33, written by the
  JAX package's exporter) reads into the JAX reader's tree and its
  (4, 3, 2) anchors, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.models.export import export_ultralytics_pt
from aquaculture_tpu.models.weights import load_pretrained as jax_load_pretrained
from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu_torch.models.weights import flatten_tree, load_jax_params, load_pretrained
from aquaculture_tpu_torch.models.yolov5 import (
    DEFAULT_ANCHORS_P6, DOWN_LAYERS_P6, STRIDES_P6, YoloV5, yolov5_init)

from test_torch_yolov5 import _assert_preds_close, _jax_flat


@pytest.fixture(scope="module")
def n6():
    """(JAX model, JAX tree, port model, port tree): n6, 3 classes, seed 5."""
    jmodel, jparams = jax_init("n6", num_classes=3, seed=5)
    model, params = yolov5_init("n6", num_classes=3, seed=5)
    return jmodel, jparams, model, params


def test_init_tree_equals_jax(n6):
    jmodel, jparams, model, params = n6
    jflat, tflat = _jax_flat(jparams), flatten_tree(params)
    assert jflat.keys() == tflat.keys()
    assert {"b9/w", "b11/cv2/w", "n32/cv3/w", "head/3/w"} <= set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    assert model.is_p6 and model.strides == STRIDES_P6 == jmodel.strides
    assert model.anchor_table == DEFAULT_ANCHORS_P6 == jmodel.anchor_table
    assert (model.channels(), model.depths()) == (jmodel.channels(), jmodel.depths())


def test_m6_builds_the_jax_architecture():
    jmodel = JaxYoloV5("m6", num_classes=5)
    model = YoloV5("m6", num_classes=5)
    assert model.channels() == jmodel.channels() == {"c1": 48, "c2": 96, "c3": 192, "c4": 384,
                                                      "c5": 576, "c6": 768}
    shapes = {k: v.shape for k, v in flatten_tree(model.init(0)).items()}
    assert shapes == {k: v.shape for k, v in _jax_flat(jmodel.init(0)).items()}
    load_jax_params(model, model.init(0))  # every leaf of the P6 tree taken once


def test_forward_matches_jax(n6):
    jmodel, jparams, model, params = n6
    load_jax_params(model, params)
    x = np.random.default_rng(1).random((2, 256, 256, 3), dtype=np.float32)
    want, _ = jax.jit(jmodel.apply)(jmodel.fuse(jparams), jnp.asarray(x))
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x))
        got = model.decode(feats)
    assert [tuple(f.shape[1:3]) for f in feats] == [(32, 32), (16, 16), (8, 8), (4, 4)]
    assert got.shape == (2, 3 * (32 * 32 + 16 * 16 + 8 * 8 + 4 * 4), 8)
    _assert_preds_close(got.numpy(), np.asarray(want))


def test_decode_four_levels_row_order_matches_jax():
    jmodel, _ = jax_init("n6", num_classes=2)
    model = YoloV5("n6", num_classes=2)
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((1, s, s, model.na * model.no)).astype(np.float32) for s in (8, 4, 2, 1)]
    want = jmodel.decode([jnp.asarray(f) for f in feats])
    got = model.decode([torch.from_numpy(f) for f in feats])
    _assert_preds_close(got.numpy(), np.asarray(want))


def test_fuse_down_s2d_on_all_p6_names(n6):
    jmodel, jparams, model, params = n6
    names = ("b1", "b3", "b5", "b7", "b9", "n24", "n27", "n30")
    assert set(names) == set(DOWN_LAYERS_P6)
    fused = model.fuse(params, down_s2d=names)
    jflat, tflat = _jax_flat(jmodel.fuse(jparams, down_s2d=names)), flatten_tree(fused)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    for name in names:
        assert tflat[f"{name}/w"].shape[:2] == (2, 2), name
    x = torch.from_numpy(np.random.default_rng(2).random((1, 128, 128, 3), dtype=np.float32))
    s2d = load_jax_params(YoloV5("n6", num_classes=3), fused)
    plain = load_jax_params(YoloV5("n6", num_classes=3), model.fuse(params))
    assert all(getattr(s2d, n).weight.shape[-1] == 2 for n in names)
    with torch.no_grad():
        _assert_preds_close(s2d(x).numpy(), plain(x).numpy())


@pytest.mark.parametrize("name", ["n18", "n21", "b11"])
def test_fuse_rejects_names_outside_p6_downsamples(n6, name):
    jmodel, jparams, model, params = n6
    with pytest.raises(ValueError, match="P6"):
        model.fuse(params, down_s2d=("b1", name))
    with pytest.raises(ValueError, match="P6"):
        jmodel.fuse(jparams, down_s2d=("b1", name))


def test_p5_fuse_rejects_p6_names():
    model, params = yolov5_init("n", num_classes=2)
    with pytest.raises(ValueError, match="P5"):
        model.fuse(params, down_s2d=("n24",))


def test_p6_state_dict_reads_into_jax_tree(n6, tmp_path):
    jmodel, jparams, _, _ = n6
    path = str(tmp_path / "n6.pt")
    export_ultralytics_pt(jmodel, jparams, path)
    want, want_anchors = jax_load_pretrained(JaxYoloV5("n6", 3), path)
    tree, got_anchors = load_pretrained(YoloV5("n6", 3), path)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    got = flatten_tree(tree)
    assert sorted(got) == sorted(want) and "b11/cv1/bn/var" in got and "head/3/b" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_anchors == want_anchors
    assert np.asarray(got_anchors).shape == (4, 3, 2)
    np.testing.assert_allclose(np.asarray(got_anchors), np.asarray(DEFAULT_ANCHORS_P6), rtol=1e-6)
    # the .pt model runs as the tree it was written from
    x = torch.from_numpy(np.random.default_rng(6).random((1, 128, 128, 3), dtype=np.float32))
    from_pt = load_jax_params(YoloV5("n6", 3, anchors=got_anchors), tree)
    from_tree = load_jax_params(YoloV5("n6", 3), n6[3])
    with torch.no_grad():
        _assert_preds_close(from_pt(x).numpy(), from_tree(x).numpy())


def test_p5_tree_does_not_load_into_p6_model():
    _, params = yolov5_init("n", num_classes=3)
    with pytest.raises(KeyError, match="n32"):
        load_jax_params(YoloV5("n6", num_classes=3), params)
