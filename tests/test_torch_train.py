"""The port's training slice against the JAX package on the same numpy-seeded
inputs: loss, target assignment, optimizer, EMA, training forward in f32 and
bf16, whole f32 train steps, remat, checkpoints and the state tree.

Tolerances, stated per test:
- elementwise f32 code (ciou, BCE, the schedule, SGD, EMA): rtol 1e-6 or
  exact where the arithmetic is the same operation order;
- the target assignment: exact;
- gradients of the loss wrt the head maps: rtol 1e-5 (reassociated sums);
- whole train steps of n at 64 px, batch 2, f32: the loss to rtol 1e-5, and
  every leaf of params, EMA and momentum to 3e-3 of the leaf's largest
  magnitude. That is ten times the port's own float32-vs-float64 gradient
  error on the same step (median 1.7e-4, worst 3.0e-4 of the leaf's
  magnitude): BatchNorm over 2 images of 2x2 to 16x16 maps is
  ill-conditioned, so f32 reassociation shows at that level;
- bf16 (the default compute dtype): one block on the same bf16 input to
  within one bf16 spacing on all but a few percent of the outputs, the
  running variance to 1e-6; one training forward and loss of n at 256 px
  within bf16's own distance from f32 (each bound stated in its test);
- multi-process steps (spawned gloo ranks, each on its rows of the global
  batch: 2x1, 1x1 and 2x2 meshes, an elastic restart, cli.train --mesh 2):
  the bars of the whole train steps above, against the JAX step or the
  single-process run.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.config import TrainConfig as JaxTrainConfig
from aquaculture_tpu.models import layers as jax_layers
from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_yolov5_init
from aquaculture_tpu.train import ema as jax_ema
from aquaculture_tpu.train import loss as jax_loss
from aquaculture_tpu.train import optimizer as jax_opt
from aquaculture_tpu.train.trainer import init_train_state as jax_init_state
from aquaculture_tpu.train.trainer import make_train_step as jax_make_step
from aquaculture_tpu.utils import checkpoint as jax_ckpt
from aquaculture_tpu_torch.config import TrainConfig
from aquaculture_tpu_torch.models import layers
from aquaculture_tpu_torch.models.weights import (
    flatten_tree, load_train_params, to_tree, train_state)
from aquaculture_tpu_torch.models.yolov5 import HeadConv, YoloV5, yolov5_init
from aquaculture_tpu_torch.train import ema, loss, optimizer
from aquaculture_tpu_torch.train.trainer import (
    init_train_state, load_state_tree, make_train_step, state_tree)
from aquaculture_tpu_torch.parallel.mesh import batch_sharding, make_mesh, param_shardings, shard_batch
from aquaculture_tpu_torch.parallel.sharded import sharded_train_step
from aquaculture_tpu_torch.utils import checkpoint

import torch_dist_workers as workers

LEAF_RTOL = 3e-3


def _np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _assert_leaves_close(want_tree, got_tree, rtol=LEAF_RTOL):
    want, got = _np(want_tree), flatten_tree(got_tree)
    assert set(want) == set(got), sorted(set(want) ^ set(got))
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= rtol * scale + 1e-9, (k, err, scale)


def _labels(rng, b, m, img, n_valid, num_classes):
    """(B, M, 5) pixel labels, the first n_valid rows of each image valid."""
    labels = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        n = n_valid[i]
        wh = rng.uniform(4, img / 2, (n, 2))
        cxy = rng.uniform(0, img, (n, 2))
        labels[i, :n] = np.concatenate([rng.integers(0, num_classes, (n, 1)), cxy, wh], 1)
        mask[i, :n] = True
    # a padded row with nonzero content and a degenerate valid row
    labels[0, m - 1] = [0, 10, 10, 8, 8]
    labels[1, n_valid[1]] = [0, 12, 12, 0, 5]
    mask[1, n_valid[1]] = True
    return labels, mask


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_ciou_matches_jax():
    rng = np.random.default_rng(0)
    b1 = np.concatenate([rng.uniform(0, 8, (256, 2)), rng.uniform(0.1, 4, (256, 2))], 1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(0, 8, (256, 2)), rng.uniform(0.1, 4, (256, 2))], 1).astype(np.float32)
    b2[:8] = b1[:8]  # identical boxes
    want = np.asarray(jax_loss.ciou(jnp.asarray(b1), jnp.asarray(b2)))
    got = loss.ciou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # gradient wrt the first box (alpha detached in both), rtol 1e-5
    gw = np.asarray(jax.grad(lambda a: jax_loss.ciou(a, jnp.asarray(b2)).sum())(jnp.asarray(b1)))
    t = torch.tensor(b1, requires_grad=True)
    gg = torch.autograd.grad(loss.ciou(t, torch.from_numpy(b2)).sum(), t)[0].numpy()
    np.testing.assert_allclose(gg, gw, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gh,gw", [(8, 8), (5, 7)])
def test_level_matches_exact(gh, gw):
    rng = np.random.default_rng(gh * gw)
    labels, mask = _labels(rng, 3, 12, 8 * gw, [9, 5, 0], 3)
    lab = labels.copy()
    lab[..., 1:5] /= 8.0
    anc = np.asarray([[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]], np.float32)
    want = jax_loss._level_matches(jnp.asarray(lab), jnp.asarray(mask), jnp.asarray(anc), gh, gw, 4.0)
    got = loss._level_matches(torch.from_numpy(lab), torch.from_numpy(mask), torch.from_numpy(anc), gh, gw, 4.0)
    assert int(np.asarray(want["valid"]).sum()) > 10
    for k in ("valid", "gi", "gj", "txy", "twh", "tcls"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("variant,num_classes,smoothing", [
    ("n", 1, 0.0),
    ("n", 3, 0.1),
    ("n6", 2, 0.0),
])
def test_yolo_loss_and_grad_match_jax(variant, num_classes, smoothing):
    """Loss, components and d(loss)/d(maps) on 3- and 4-level maps with
    padded labels: values rtol 1e-6, gradients rtol 1e-5 with an atol of
    1e-6 of the map's largest gradient (reassociated sums near zero)."""
    model = JaxYoloV5(variant, num_classes)
    img = 128
    rng = np.random.default_rng(len(variant) + num_classes)
    feats = [rng.standard_normal((2, img // s, img // s, 3 * (5 + num_classes))).astype(np.float32)
             for s in model.strides]
    labels, mask = _labels(rng, 2, 10, img, [6, 4], num_classes)
    kw = dict(strides=model.strides, label_smoothing=smoothing)

    def jloss(fs):
        return jax_loss.yolo_loss(fs, jnp.asarray(labels), jnp.asarray(mask), model.anchor_table,
                                  num_classes, **kw)

    (want, wm), wgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))([jnp.asarray(f) for f in feats])
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    got, gm = loss.yolo_loss(tf, torch.from_numpy(labels), torch.from_numpy(mask), model.anchor_table,
                             num_classes, **kw)
    ggrad = torch.autograd.grad(got, tf)
    for k in ("box", "obj", "cls", "total"):
        np.testing.assert_allclose(float(gm[k].detach()), float(wm[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    for w, g in zip(wgrad, ggrad):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6 * float(np.abs(w).max()))


def test_yolo_loss_refuses_level_mismatch():
    feats = [torch.zeros((1, 64 // s, 64 // s, 21)) for s in (8, 16, 32, 64)]
    with pytest.raises(ValueError, match="level mismatch"):
        loss.yolo_loss(feats, torch.zeros((1, 1, 5)), torch.zeros((1, 1), dtype=torch.bool),
                       JaxYoloV5("n").anchor_table, 2)


# ---------------------------------------------------------------------------
# optimizer and EMA
# ---------------------------------------------------------------------------

def test_train_config_is_the_jax_packages():
    """TrainConfig is copied field for field (names, order and defaults),
    except the JAX package's phase_grad_dx: the port takes every input
    gradient from the library's convolution backward."""
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls) if f.name != "phase_grad_dx"]
    assert fields(TrainConfig) == fields(JaxTrainConfig)
    assert "phase_grad_dx" not in {f.name for f in dataclasses.fields(TrainConfig)}
    assert TrainConfig().compute_dtype == "bfloat16" and TrainConfig().max_boxes_per_image == 120


@pytest.mark.parametrize("variant", ["n", "n6"])
def test_group_tree_matches_jax(variant):
    params = JaxYoloV5(variant, 2).init(0)
    want = flatten_tree(jax_opt.group_tree(params))
    got = flatten_tree(optimizer.group_tree(params))
    assert got == want
    # the training model's names classify the same way
    model = YoloV5(variant, 2, trainable=True)
    from aquaculture_tpu_torch.models.weights import tree_key
    assert {tree_key(n): optimizer.group_of(n) for n in train_state(model)} == {
        k: int(v) for k, v in want.items()}


@pytest.mark.parametrize("step", [0, 1, 99, 100, 101, 149, 150, 400])
def test_lr_at_matches_jax(step):
    """Exact in float32 across the warmup edge (100 steps here), at the
    last epoch (steps 149, 150 with 3 steps/epoch, 50 epochs) and past it."""
    cfg, jcfg = TrainConfig(), JaxTrainConfig()
    want = [np.float32(v) for v in jax_opt.lr_at(step, 3, jcfg)]
    got = optimizer.lr_at(step, 3, cfg)
    assert [g.dtype for g in got] == [np.float32] * 3
    assert list(got) == want


def _random_like(tree, rng):
    return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flatten_tree(tree).items()}


def test_sgd_update_matches_jax():
    params = JaxYoloV5("n", 2).init(0)
    rng = np.random.default_rng(1)
    flat = _random_like(params, rng)
    grads, bufs = _random_like(params, rng), _random_like(params, rng)
    cfg, jcfg = TrainConfig(), JaxTrainConfig()
    from aquaculture_tpu_torch.models.weights import unflatten_paths
    tree = lambda d: jax.tree_util.tree_map(jnp.asarray, unflatten_paths(d))
    new_p, new_s = jax.jit(lambda p, g, s: jax_opt.sgd_update(p, g, s, 7, jcfg))(
        tree(flat), tree(grads), jax_opt.SGDState(tree(bufs), jnp.int32(120)))
    p = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    b = {k: torch.from_numpy(v.copy()) for k, v in bufs.items()}
    optimizer.sgd_update(p, {k: torch.from_numpy(v) for k, v in grads.items()}, b, 120, 7, cfg)
    # rtol 1e-6, atol 1e-6: XLA fuses the update into FMAs (one rounding
    # fewer), values are O(1)
    for k, want in _np(new_p).items():
        np.testing.assert_allclose(p[k].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=k)
    for k, want in _np(new_s.momentum).items():
        np.testing.assert_allclose(b[k].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(new_s.step) == 121


def test_ema_update_matches_jax():
    params = JaxYoloV5("n", 2).init(0)
    rng = np.random.default_rng(2)
    e, p = _random_like(params, rng), _random_like(params, rng)
    from aquaculture_tpu_torch.models.weights import unflatten_paths
    tree = lambda d: jax.tree_util.tree_map(jnp.asarray, unflatten_paths(d))
    want = _np(jax_ema.ema_update(tree(e), tree(p), 37, 0.9999))
    got = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    ema.ema_update(got, {k: torch.from_numpy(v) for k, v in p.items()}, 37, 0.9999)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

def test_training_forward_matches_jax():
    """n at 64 px, f32, train mode: head maps within 1e-4 of their largest
    magnitude (five times the port's own float32-vs-float64 error there,
    1.8e-5) and every running statistic after one forward, including the
    biased batch variance (rtol 1e-4)."""
    model_j, params = jax_yolov5_init("n", 2, seed=0)
    x = np.random.default_rng(5).random((2, 64, 64, 3), dtype=np.float32)
    want_feats, want_params = jax.jit(lambda p, x_: model_j.features(p, x_, True))(params, jnp.asarray(x))
    model = load_train_params(YoloV5("n", 2, trainable=True), params).train()
    got_feats = model.features(torch.from_numpy(x))
    for w, g in zip(want_feats, got_feats):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()))
    got = flatten_tree(to_tree(train_state(model)))
    want, init = _np(want_params), flatten_tree(params)
    stats = [k for k in want if k.endswith(("/bn/mean", "/bn/var"))]
    assert len(stats) == 2 * 57
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        assert not np.array_equal(got[k], init[k]), k  # moved
    # the variance is the biased one: recompute one block's by hand
    conv_out = []
    hook = model.b1.bn.register_forward_pre_hook(lambda m, a: conv_out.append(a[0].detach()))
    before = model.b1.bn.var.clone()
    model.features(torch.from_numpy(x))
    hook.remove()
    batch_var = conv_out[0].double().var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(model.b1.bn.var.numpy(), (0.97 * before.double() + 0.03 * batch_var).numpy(),
                               rtol=1e-6)


def test_eval_forward_equals_fused_serving_model():
    """In eval mode the training model uses its running statistics: it
    computes what the BN-folded serving model computes (rtol 1e-5)."""
    from aquaculture_tpu_torch.models.weights import load_jax_params
    _, params = yolov5_init("n", 2, seed=4)
    rng = np.random.default_rng(4)
    for k, v in flatten_tree(params).items():  # non-trivial running statistics
        if k.endswith(("/bn/mean", "/bn/var")):
            v[...] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    x = torch.from_numpy(rng.random((1, 64, 64, 3), dtype=np.float32))
    train_model = load_train_params(YoloV5("n", 2, trainable=True), params).eval()
    serving = load_jax_params(YoloV5("n", 2), params).eval()
    with torch.no_grad():
        for a, b in zip(train_model.features(x), serving.features(x)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_load_train_params_checks_every_leaf():
    _, params = yolov5_init("n", 2)
    model = YoloV5("n", 2, trainable=True)
    fused = YoloV5("n", 2).fuse(params)
    with pytest.raises(KeyError, match="missing"):
        load_train_params(model, fused)
    extra = {**params, "zz": {"w": np.zeros((1, 1, 1, 1), np.float32)}}
    with pytest.raises(KeyError, match="extra"):
        load_train_params(model, extra)
    round_trip = flatten_tree(to_tree(train_state(load_train_params(model, params))))
    for k, v in flatten_tree(params).items():
        np.testing.assert_array_equal(round_trip[k], v)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_steps():
    """Two f32 train steps of n at 64 px, batch 2, 2 classes, the same init
    and batches through both packages (JAX jitted once)."""
    jmodel, params = jax_yolov5_init("n", 2, seed=0)
    rng = np.random.default_rng(3)
    labels, mask = _labels(rng, 2, 6, 64, [3, 4], 2)
    images = rng.random((2, 2, 64, 64, 3), dtype=np.float32)
    jcfg = JaxTrainConfig(img_size=64, batch_size=2, compute_dtype="float32")
    jstate = jax_init_state(jmodel, params)
    jstep = jax.jit(jax_make_step(jmodel, jcfg, 1))
    model = load_train_params(YoloV5("n", 2, trainable=True), params)
    state = init_train_state(model)
    step = make_train_step(model, TrainConfig(img_size=64, batch_size=2, compute_dtype="float32"), 1)
    jl, gl = [], []
    for i in range(2):
        jstate, m = jstep(jstate, {"images": jnp.asarray(images[i]), "labels": jnp.asarray(labels),
                                   "label_mask": jnp.asarray(mask)})
        jl.append({k: float(v) for k, v in m.items()})
        m = step(state, {"images": torch.from_numpy(images[i]), "labels": torch.from_numpy(labels),
                         "label_mask": torch.from_numpy(mask)})
        gl.append({k: float(v) for k, v in m.items()})
    return {"jax_state": jstate, "jax_losses": jl, "state": state, "losses": gl, "params": params,
            "images": images, "labels": labels, "mask": mask}


def test_two_steps_losses_match_jax(two_steps):
    for want, got in zip(two_steps["jax_losses"], two_steps["losses"]):
        for k in ("box", "obj", "cls", "total"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert two_steps["state"].step == two_steps["state"].opt_step == 2


@pytest.mark.parametrize("part,jax_part", [
    ("params", lambda s: s.params),
    ("ema", lambda s: s.ema),
    ("opt_momentum", lambda s: s.opt.momentum),
])
def test_two_steps_state_matches_jax(two_steps, part, jax_part):
    """Every leaf after two steps, within LEAF_RTOL of its magnitude; the
    BN running statistics' momenta are zeros in both."""
    got = state_tree(two_steps["state"])
    _assert_leaves_close(jax_part(two_steps["jax_state"]), got[part])
    if part == "opt_momentum":
        for k, v in flatten_tree(got[part]).items():
            if k.endswith(("/mean", "/var")):
                assert not v.any(), k


def test_state_tree_saves_as_jax_does(two_steps, tmp_path):
    """The port's state/ and the JAX package's hold the same keys, shapes
    and dtypes (int32 step counters), in the same npz order and treedef;
    each package reads the other's files."""
    jax_state = two_steps["jax_state"]
    jtree = {"params": jax_state.params, "opt_momentum": jax_state.opt.momentum,
             "opt_step": jax_state.opt.step, "ema": jax_state.ema, "step": jax_state.step}
    jax_ckpt.save_params(str(tmp_path / "jax"), jtree, metadata={"epoch": 1})
    checkpoint.save_params(str(tmp_path / "torch"), state_tree(two_steps["state"]), metadata={"epoch": 1})
    spec = [json.loads((tmp_path / d / "treedef.json").read_text()) for d in ("jax", "torch")]
    assert spec[0] == spec[1] and list(json.dumps(spec[0])) == list(json.dumps(spec[1]))
    zj, zt = (np.load(tmp_path / d / "params.npz") for d in ("jax", "torch"))
    assert zj.files == zt.files
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
    assert int(zt["step"]) == int(zt["opt_step"]) == 2 and zt["step"].dtype == np.int32
    # JAX reads the port's files, the port reads (and resumes from) JAX's
    back = jax_ckpt.load_params(str(tmp_path / "torch"))
    saved = flatten_tree(state_tree(two_steps["state"]))
    for k, v in _np(back).items():
        np.testing.assert_array_equal(v, saved[k])
    fresh = init_train_state(load_train_params(YoloV5("n", 2, trainable=True), two_steps["params"]))
    load_state_tree(fresh, checkpoint.load_params(str(tmp_path / "jax")))
    assert fresh.step == fresh.opt_step == 2
    _assert_leaves_close(jax_state.ema, to_tree(fresh.ema), rtol=0.0)
    _assert_leaves_close(jax_state.params, to_tree(train_state(fresh.model)), rtol=0.0)


def _port_steps(two_steps, **cfg_kw):
    model = load_train_params(YoloV5("n", 2, trainable=True), two_steps["params"])
    state = init_train_state(model)
    step = make_train_step(model, TrainConfig(img_size=64, batch_size=2, compute_dtype="float32", **cfg_kw), 1)
    losses = []
    for i in range(2):
        m = step(state, {"images": torch.from_numpy(two_steps["images"][i]),
                         "labels": torch.from_numpy(two_steps["labels"]),
                         "label_mask": torch.from_numpy(two_steps["mask"])})
        losses.append(float(m["total"]))
    return state, losses


def test_remat_matches_the_plain_step(two_steps):
    """remat changes how the gradient is computed, not what: two steps agree
    with the plain ones (loss rtol 1e-6, leaves within 1e-4 of their
    magnitude); the running statistics move exactly once per step, so they
    equal the plain run's."""
    plain = two_steps["state"]
    state, losses = _port_steps(two_steps, remat=True)
    assert losses == pytest.approx([m["total"] for m in two_steps["losses"]], rel=1e-6)
    got, want = state_tree(state), state_tree(plain)
    for part in ("params", "ema", "opt_momentum"):
        got_flat = flatten_tree(got[part])
        for k, w in flatten_tree(want[part]).items():
            assert float(np.abs(got_flat[k] - w).max()) <= 1e-4 * float(np.abs(w).max()) + 1e-9, (part, k)
            if part == "params" and k.endswith(("/bn/mean", "/bn/var")):
                np.testing.assert_array_equal(got_flat[k], w, err_msg=k)


def test_remat_recomputes_with_stats_frozen(two_steps):
    """The backward pass of a remat step really recomputes the blocks, and
    every recompute runs with the running-statistics update switched off."""
    model = load_train_params(YoloV5("n", 2, trainable=True), two_steps["params"])
    state = init_train_state(model)
    step = make_train_step(model, TrainConfig(img_size=64, batch_size=2, compute_dtype="float32",
                                              remat=True), 1)
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append(model.train_options.update_stats))
             for m in model.modules() if isinstance(m, type(model.b1.bn))]
    step(state, {"images": torch.from_numpy(two_steps["images"][0]),
                 "labels": torch.from_numpy(two_steps["labels"]),
                 "label_mask": torch.from_numpy(two_steps["mask"])})
    for h in hooks:
        h.remove()
    assert calls.count(True) == len(hooks) == 57 and calls.count(False) == 57
    assert model.train_options.update_stats


# ---------------------------------------------------------------------------
# bf16, the default compute dtype
# ---------------------------------------------------------------------------

def _beyond_one_bf16_spacing(got: np.ndarray, want: np.ndarray) -> float:
    """The share of elements farther from the JAX value than one bf16
    spacing at its magnitude (|want| * 2**-7 bounds it)."""
    return float((np.abs(got - want) > np.abs(want) * 2.0**-7).mean())


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 2, 16, 32), (1, 1, 32, 32), (6, 2, 3, 16)])
def test_bf16_block_matches_jax(k, stride, cin, cout):
    """One Conv+BN+SiLU block in train mode on the same bf16 input, with
    random BN parameters and statistics: the weight cast to bf16 at use, the
    conv, the batch statistics of the bf16 conv output (rounded to bf16, as
    jnp.var returns them), the normalization in bf16 and the f32 running
    update, as the JAX package's conv_block. Readings over three seeds per
    shape: 0.9-2.6% of the outputs beyond one bf16 spacing of JAX's; the
    running variance more than 1e-6 off on 0-6.2% of the channels (a batch
    variance on the other side of a bf16 rounding boundary: one channel),
    at most 3.1e-4 of the leaf's largest; the mean at most 3.3e-5.
    Normalizing in f32, or convolving in f32 and casting after, puts
    14.7-19.6% of the outputs beyond one spacing; batch statistics kept in
    f32 move the variance on 97-100% of the channels. Bounds: 5% of the
    outputs, 15% of the channels, 1e-3 and 1e-4."""
    rng = np.random.default_rng(k * 100 + cin)
    x = rng.standard_normal((4, 32, 32, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * np.sqrt(2 / (k * k * cin))).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, cout), "bias": rng.uniform(-0.5, 0.5, cout),
          "mean": rng.uniform(-0.5, 0.5, cout), "var": rng.uniform(0.5, 1.5, cout)}
    bn = {n: v.astype(np.float32) for n, v in bn.items()}
    pad = ((k // 2 - (k == 6), k // 2 - (k == 6)),) * 2  # the stem's (2, 2)
    y, new = jax.jit(lambda x_, p: jax_layers.conv_block(x_, p, stride, pad, True))(
        jnp.asarray(x).astype(jnp.bfloat16), {"w": jnp.asarray(w), "bn": bn})
    want = np.asarray(y.astype(jnp.float32))
    block = layers.TrainConvBlock(cin, cout, k, layers.TrainOptions()).train()
    with torch.no_grad():
        block.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        for n, v in bn.items():
            getattr(block.bn, n).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    out = block(xt, stride, pad)
    assert out.dtype == torch.bfloat16 and block.bn.var.dtype == torch.float32
    got = out.detach().float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _beyond_one_bf16_spacing(got, want) <= 0.05
    for n, bound in (("var", 1e-3), ("mean", 1e-4)):
        w_stat = np.asarray(new["bn"][n])
        d = np.abs(getattr(block.bn, n).numpy() - w_stat)
        assert float(d.max()) <= bound * float(np.abs(w_stat).max()), (n, d.max())
        if n == "var":
            assert float((d > 1e-6 * np.abs(w_stat)).mean()) <= 0.15, d


def test_bf16_head_matches_jax():
    """The detect head's 1x1 conv and bias in bf16, as the JAX package's
    head: weight and bias cast to bf16, the conv output in bf16. Reading
    over three seeds: bit for bit equal. A head computed in f32 and cast
    after differs on 46-48% of the outputs, a conv in f32 cast before the
    bias on 27-31%. Bound: 5% of the outputs not bit for bit equal."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 64, 21)) * 0.2).astype(np.float32)
    b = rng.uniform(-2, 2, 21).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_layers.conv2d(xb, jnp.asarray(w).astype(jnp.bfloat16)).astype(jnp.bfloat16) + \
        jnp.asarray(b).astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    head = HeadConv(64, 21, trainable=True)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        head.bias.copy_(torch.from_numpy(b))
    out = head(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    got = out.detach().float().permute(0, 2, 3, 1).numpy()
    assert float((got != want).mean()) <= 0.05


@pytest.fixture(scope="module")
def bf16_forward():
    """One bf16 training forward and loss of n at 256 px, batch 4, 2
    classes, through both packages from the same init, images and labels;
    and the JAX package's f32 forward, which sets the scale of bf16's own
    rounding."""
    jmodel, params = jax_yolov5_init("n", 2, seed=0)
    rng = np.random.default_rng(7)
    x = rng.random((4, 256, 256, 3), dtype=np.float32)
    labels, mask = _labels(rng, 4, 8, 256, [5, 3, 6, 2], 2)

    def jax_run(dtype):
        def f(p, x_):
            feats, new = jmodel.features(p, x_.astype(dtype), True)
            _, m = jax_loss.yolo_loss(feats, jnp.asarray(labels), jnp.asarray(mask), jmodel.anchor_table, 2,
                                      strides=jmodel.strides)
            return [f_.astype(jnp.float32) for f_ in feats], new, m
        feats, new, m = jax.jit(f)(params, jnp.asarray(x))
        return [np.asarray(f_) for f_ in feats], _np(new), {k: float(v) for k, v in m.items()}

    model = load_train_params(YoloV5("n", 2, trainable=True), params).train()
    feats = model.features(torch.from_numpy(x).to(torch.bfloat16))
    assert all(f.dtype == torch.bfloat16 for f in feats)
    _, m = loss.yolo_loss(feats, torch.from_numpy(labels), torch.from_numpy(mask), model.anchor_table, 2,
                          strides=model.strides)
    port = ([f.detach().float().numpy() for f in feats], flatten_tree(to_tree(train_state(model))),
            {k: float(v.detach()) for k, v in m.items()})
    return {"port": port, "jax": jax_run(jnp.bfloat16), "jax_f32": jax_run(jnp.float32)}


def _rel_l2(got, want, keys=None):
    keys = range(len(want)) if keys is None else keys
    err = sum(float(((np.asarray(got[k], np.float64) - want[k]) ** 2).sum()) for k in keys)
    return (err / sum(float((np.asarray(want[k], np.float64) ** 2).sum()) for k in keys)) ** 0.5


@pytest.mark.parametrize("part", ["head_maps", "running_stats", "loss"])
def test_bf16_training_forward_matches_jax(bf16_forward, part):
    """n at 256 px, batch 4, bf16, train mode. Over 25 layers bf16's rounding
    compounds: the JAX package's own bf16 head maps lie 3.4%, 5.6% and 7.4%
    (relative L2, by level) from its f32 ones, its running statistics 1.1e-3.
    Readings port vs JAX, both bf16: head maps 3.2%, 5.4% and 7.8%, running
    statistics 9.5e-4, loss components within 4e-3. Bounds: each head map
    and the statistics within 1.5x the JAX package's bf16-vs-f32 distance
    and within 0.12 and 2e-3, each loss component within 1e-2."""
    (g_feats, g_tree, g_loss) = bf16_forward["port"]
    (w_feats, w_tree, w_loss) = bf16_forward["jax"]
    (f_feats, f_tree, _) = bf16_forward["jax_f32"]
    if part == "head_maps":
        for lvl, (g, w, f) in enumerate(zip(g_feats, w_feats, f_feats)):
            assert g.shape == w.shape and np.isfinite(g).all()
            err, noise = _rel_l2([g], [w]), _rel_l2([w], [f])
            assert err <= min(0.12, 1.5 * noise), (lvl, err, noise)
    elif part == "running_stats":
        keys = [k for k in w_tree if k.endswith(("/bn/mean", "/bn/var"))]
        assert len(keys) == 2 * 57 and all(g_tree[k].dtype == np.float32 for k in keys)
        err, noise = _rel_l2(g_tree, w_tree, keys), _rel_l2(w_tree, f_tree, keys)
        assert err <= min(2e-3, 1.5 * noise), (err, noise)
    else:
        for k in ("box", "obj", "cls", "total"):
            assert g_loss[k] == pytest.approx(w_loss[k], rel=1e-2), k


# ---------------------------------------------------------------------------
# the P6 family: n6 at 128 px, f32
# ---------------------------------------------------------------------------

# Bars about ten times the readings of n6 at 128 px, batch 2, f32 (one
# training forward; then two steps): head maps 3.4e-5 of their magnitude,
# running statistics 5.1e-5 of theirs, the box, cls and total losses 4.6e-6
# relative and obj 1.5e-5. On this file's seeds: head maps 1.3e-5 to 4.7e-5,
# statistics 5.6e-5, obj 8.5e-6 and the others 1.8e-6. The worst leaf of
# params, EMA and momentum read 2.9e-4 to 6.2e-4 of its magnitude: held to
# P5's LEAF_RTOL (3e-3), five times the larger.
P6_HEAD_RTOL, P6_STATS_RTOL = 3.4e-4, 5.1e-4
P6_LOSS_RTOL = {"box": 4.6e-5, "cls": 4.6e-5, "total": 4.6e-5, "obj": 1.5e-4}


@pytest.fixture(scope="module")
def p6_steps():
    """One f32 training forward of n6 at 128 px through both packages from
    the same init, then two f32 train steps on the same batches (JAX jitted
    once)."""
    jmodel, params = jax_yolov5_init("n6", 2, seed=0)
    rng = np.random.default_rng(13)
    x = rng.random((2, 128, 128, 3), dtype=np.float32)
    want_feats, want_params = jax.jit(lambda p, x_: jmodel.features(p, x_, True))(params, jnp.asarray(x))
    model = load_train_params(YoloV5("n6", 2, trainable=True), params).train()
    got_feats = [f.detach().numpy() for f in model.features(torch.from_numpy(x))]
    forward = {"want": ([np.asarray(f) for f in want_feats], _np(want_params)),
               "got": (got_feats, flatten_tree(to_tree(train_state(model))))}

    labels, mask = _labels(rng, 2, 6, 128, [3, 4], 2)
    images = rng.random((2, 2, 128, 128, 3), dtype=np.float32)
    jcfg = JaxTrainConfig(img_size=128, batch_size=2, compute_dtype="float32")
    jstate, jstep = jax_init_state(jmodel, params), jax.jit(jax_make_step(jmodel, jcfg, 1))
    model = load_train_params(YoloV5("n6", 2, trainable=True), params)
    state = init_train_state(model)
    step = make_train_step(model, TrainConfig(img_size=128, batch_size=2, compute_dtype="float32"), 1)
    jl, gl = [], []
    for i in range(2):
        jstate, m = jstep(jstate, {"images": jnp.asarray(images[i]), "labels": jnp.asarray(labels),
                                   "label_mask": jnp.asarray(mask)})
        jl.append({k: float(v) for k, v in m.items()})
        m = step(state, {"images": torch.from_numpy(images[i]), "labels": torch.from_numpy(labels),
                         "label_mask": torch.from_numpy(mask)})
        gl.append({k: float(v) for k, v in m.items()})
    return {"forward": forward, "jax_state": jstate, "jax_losses": jl, "state": state, "losses": gl}


def test_p6_training_forward_matches_jax(p6_steps):
    """Four head maps within P6_HEAD_RTOL of their magnitude, and each of
    the 150 running statistics after one forward within P6_STATS_RTOL of
    its largest magnitude."""
    (want_feats, want), (got_feats, got) = p6_steps["forward"]["want"], p6_steps["forward"]["got"]
    assert len(got_feats) == len(want_feats) == 4
    for g, w in zip(got_feats, want_feats):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= P6_HEAD_RTOL * float(np.abs(w).max())
    stats = [k for k in want if k.endswith(("/bn/mean", "/bn/var"))]
    assert len(stats) == 150
    for k in stats:
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= P6_STATS_RTOL * scale, k


def test_p6_two_steps_match_jax(p6_steps):
    for want, got in zip(p6_steps["jax_losses"], p6_steps["losses"]):
        for k, rtol in P6_LOSS_RTOL.items():
            assert got[k] == pytest.approx(want[k], rel=rtol), k
    jstate, got = p6_steps["jax_state"], state_tree(p6_steps["state"])
    assert p6_steps["state"].step == p6_steps["state"].opt_step == 2
    for part, want in (("params", jstate.params), ("ema", jstate.ema), ("opt_momentum", jstate.opt.momentum)):
        _assert_leaves_close(want, got[part])


# ---------------------------------------------------------------------------
# multi-process training: the data axis and the model axis on gloo ranks
# ---------------------------------------------------------------------------

MESH_CFG = dict(img_size=64, batch_size=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def mesh_runs(two_steps, tmp_path_factory):
    """two_steps' init and batches under sharded_train_step in spawned gloo
    worlds, each rank on its rows of the global batch of 2:
    - 2x1: two data ranks of one image each, two steps (written to a
      checkpoint: what a run that crashes after step 2 leaves), then two
      more steps (the uninterrupted 4-step run);
    - resumed: two fresh data ranks restart from that checkpoint and take
      steps 3 and 4;
    - 2x2: two data ranks x two model ranks (channel-sharded blocks), two
      steps."""
    d = tmp_path_factory.mktemp("mesh")
    batches = [{"images": two_steps["images"][i], "labels": two_steps["labels"], "label_mask": two_steps["mask"]}
               for i in range(2)]
    params = jax.tree_util.tree_map(np.asarray, two_steps["params"])

    def run(name, world, n_model, phases, resume=None):
        job, out = str(d / f"{name}.job"), str(d / f"{name}.out")
        workers.dump({"params": params, "batches": batches, "cfg": MESH_CFG, "resume": resume,
                       "phases": phases}, job)
        workers.spawn(workers.train_steps, world, str(d / f"{name}.rdzv"), n_model, job, out)
        return workers.read(out)

    ckpt = str(d / "after_step2")
    runs = {}
    runs["2x1"], runs["uninterrupted"] = run("2x1", 2, 1, [{"steps": [0, 1], "save": ckpt}, {"steps": [0, 1]}])
    (runs["resumed"],) = run("resumed", 2, 1, [{"steps": [0, 1]}], resume=ckpt)
    (runs["2x2"],) = run("2x2", 4, 2, [{"steps": [0, 1]}])
    return runs


@pytest.fixture(scope="module")
def one_rank(two_steps):
    """The same two steps under sharded_train_step on a one-rank 1x1 mesh of
    this process (every collective the identity)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        model = load_train_params(YoloV5("n", 2, trainable=True), two_steps["params"])
        step, state = sharded_train_step(model, TrainConfig(**MESH_CFG), make_mesh(1, 1), 1, init_train_state(model))
        assert model.train_options.data_group is not None
        losses = []
        for i in range(2):
            m = step(state, shard_batch({"images": two_steps["images"][i], "labels": two_steps["labels"],
                                         "label_mask": two_steps["mask"]}, None, "cpu"))
            losses.append({k: float(v) for k, v in m.items()})
        return {"losses": losses, "state": state_tree(state)}
    finally:
        dist.destroy_process_group()


def _mesh_run(mesh_runs, one_rank, run):
    return one_rank if run == "1x1" else mesh_runs[run]


@pytest.mark.parametrize("run", ["2x1", "1x1", "2x2"])
def test_mesh_losses_match_jax(mesh_runs, one_rank, two_steps, run):
    """The global batch's losses on every mesh, rel 1e-5: the metrics are
    all-reduced sums of each rank's share of the global loss."""
    got = _mesh_run(mesh_runs, one_rank, run)["losses"]
    assert len(got) == 2
    for want, g in zip(two_steps["jax_losses"], got):
        for k in ("box", "obj", "cls", "total"):
            assert g[k] == pytest.approx(want[k], rel=1e-5), (run, k)


@pytest.mark.parametrize("run", ["2x1", "1x1", "2x2"])
@pytest.mark.parametrize("part,jax_part", [
    ("params", lambda s: s.params),
    ("ema", lambda s: s.ema),
    ("opt_momentum", lambda s: s.opt.momentum),
])
def test_mesh_state_matches_jax(mesh_runs, one_rank, two_steps, run, part, jax_part):
    """Every leaf after two steps on every mesh, within LEAF_RTOL of the JAX
    step over the global batch. Two data ranks hold one image each, so
    BatchNorm over a rank's own image (or a loss normalized per rank)
    would miss by far; the 2x2 state is the gathered, unsharded tree."""
    got = _mesh_run(mesh_runs, one_rank, run)["state"]
    _assert_leaves_close(jax_part(two_steps["jax_state"]), got[part])
    assert int(got["step"]) == int(got["opt_step"]) == 2


def test_one_rank_mesh_equals_the_plain_step(one_rank, two_steps):
    """A one-rank mesh against the plain port step of two_steps, at the
    bars against the JAX step: losses rel 1e-5, every leaf within
    LEAF_RTOL (the collectives are identities; BatchNorm takes its
    statistics by sums instead of var_mean, a reassociation)."""
    for want, got in zip(two_steps["losses"], one_rank["losses"]):
        for k in ("box", "obj", "cls", "total"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    plain = state_tree(two_steps["state"])
    for part in ("params", "ema", "opt_momentum"):
        _assert_leaves_close(plain[part], one_rank["state"][part])


@pytest.mark.parametrize("part", ["params", "ema", "opt_momentum"])
def test_elastic_resume_equals_the_uninterrupted_run(mesh_runs, part):
    """Two ranks restarted from the step-2 checkpoint end steps 3-4 on the
    uninterrupted run's state (LEAF_RTOL; the same arithmetic on the same
    values) with its losses (rel 1e-5)."""
    full, resumed = mesh_runs["uninterrupted"], mesh_runs["resumed"]
    assert [m["total"] for m in resumed["losses"]] == pytest.approx([m["total"] for m in full["losses"]], rel=1e-5)
    want = flatten_tree(full["state"][part])
    got = flatten_tree(resumed["state"][part])
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert float(np.abs(got[k] - w).max()) <= LEAF_RTOL * scale + 1e-9, k
    assert int(resumed["state"]["step"]) == int(full["state"]["step"]) == 4


@pytest.mark.parametrize("n_model", [2, 4])
def test_param_shardings_follow_the_jax_rule(n_model):
    """The model axis splits a TrainConvBlock's weight and BN vectors on the
    output channels where they divide n_model (the JAX rule on HWIO O and
    1-D vectors); the detect head stays replicated; M = 1 splits nothing."""
    from jax.sharding import PartitionSpec

    from aquaculture_tpu.parallel.mesh import _spec_for_param as jax_spec

    model = YoloV5("n", 2, trainable=True)
    got = param_shardings(model, n_model)
    assert set(got) == set(train_state(model))
    blocks = {n for n, m in model.named_modules() if isinstance(m, layers.TrainConvBlock)}
    for name, t in train_state(model).items():
        block = name.rsplit(".", 2)[0] if name.endswith((".bn.scale", ".bn.bias", ".bn.mean", ".bn.var")) \
            else name.rsplit(".", 1)[0]
        if block not in blocks:
            assert got[name] is None, name
            continue
        shape = tuple(t.shape) if t.dim() == 1 else tuple(t.permute(2, 3, 1, 0).shape)  # HWIO
        want = jax_spec(None, shape, n_model)
        assert (got[name] == 0) == (want != PartitionSpec()), name
    assert sum(v == 0 for v in got.values()) > 0
    assert all(v is None for v in param_shardings(model, 1).values())


def test_batch_sharding_and_mesh_arguments():
    assert batch_sharding(None, 6) == slice(0, 6)
    with pytest.raises(ValueError, match="does not divide"):
        batch_sharding(types.SimpleNamespace(shape=(4, 1), get_local_rank=lambda a: 0), 6)
    fake = types.SimpleNamespace(shape=(3, 2), get_local_rank=lambda axis: {"data": 2, "model": 1}[axis])
    assert batch_sharding(fake, 6) == slice(4, 6)
    from aquaculture_tpu_torch.cli.train import parse_mesh

    assert parse_mesh("8") == (8, 1) and parse_mesh("4x2") == (4, 2)
    for bad in ("0", "2x2x2", "x2"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


@pytest.fixture(scope="module")
def yolo_world(tmp_path_factory):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    from end_to_end_demo import render_world

    out = tmp_path_factory.mktemp("yolo_world")
    img_dir, _ = render_world(str(out), n_images=4, seed=1)
    return img_dir


def test_dataset_builds_a_ranks_slots(yolo_world):
    """A data rank's rows of each global batch are the rows a single process
    builds there (per-slot seeding)."""
    from aquaculture_tpu_torch.train.dataset import DetectionDataset

    ds = DetectionDataset(yolo_world, None, TrainConfig(img_size=64, batch_size=4, feed_threads=1), seed=3)
    full = next(iter(ds.epoch(1)))
    part = next(iter(ds.epoch(1, slots=[2, 3])))
    for k in ("images", "labels", "label_mask"):
        assert part[k].shape[0] == 2
        np.testing.assert_array_equal(part[k], full[k][2:4], err_msg=k)


def test_cli_train_mesh_2_equals_one_process(yolo_world, tmp_path, monkeypatch):
    """cli.train --mesh 2 on two spawned gloo ranks (f32, as
    tests/test_torch_train_cli.py compares the CLIs) for two epochs of one
    step (global batch 4, two images per rank), dying when epoch 2 starts
    and rerun with --resume, against one process training the two epochs:
    the same state/ and last/ within LEAF_RTOL, the same epoch-2 total loss
    (rel 1e-5) and components (rel 1e-4: the objectness term, 7e-4 of 0.17,
    read 1.6e-5 relative after the step, BatchNorm over 2x2 maps of 4
    images amplifying the data ranks' reassociated statistics)."""
    from aquaculture_tpu_torch.cli import train as cli_train

    args = ["--images", yolo_world, "--variant", "n", "--num-classes", "2", "--img", "64", "--batch", "4",
            "--epochs", "2", "--no-augment", "--seed", "0", "--device", "cpu"]
    mesh = str(tmp_path / "mesh")
    runs = [{"argv": args + ["--out", mesh, "--mesh", "2"], "crash_at_epoch": 1},
            {"argv": args + ["--out", mesh, "--mesh", "2", "--resume"]}]
    workers.spawn(workers.cli_train, 2, str(tmp_path / "rdzv"), runs, str(tmp_path / "out.pkl"), True)
    crashed, resumed = workers.read(str(tmp_path / "out.pkl"))
    assert crashed is None and resumed["mesh"] == [2, 1] and resumed["step"] == 2
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    base = cli_train.TrainConfig
    monkeypatch.setattr(cli_train, "TrainConfig",
                        lambda **kw: dataclasses.replace(base(**kw), compute_dtype="float32"))
    single = cli_train.main(args + ["--out", str(tmp_path / "one")])
    assert single["mesh"] is None and single["step"] == 2
    got, want = resumed["epochs"][0], single["epochs"][1]
    assert got["total"] == pytest.approx(want["total"], rel=1e-5)
    for k in ("box", "obj", "cls"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for sub in ("state", "last"):
        _assert_leaves_close(checkpoint.load_params(str(tmp_path / "one" / sub)),
                             checkpoint.load_params(os.path.join(mesh, sub)))
    assert checkpoint.load_metadata(os.path.join(mesh, "state"))["epoch"] == 2
