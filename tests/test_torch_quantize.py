"""The port's int8 PTQ path against the JAX package's on the same numpy-seeded
inputs: the exact int8 convolution (both routes), calibration, the
quantized tree, the JAX package's quantized tree served by the port, the
skip lists and the serving dtypes.

Tolerances, stated per test:
- the int8 convolution: tolerance 0 (int32);
- calibration statistics: 1.5e-5 relative, about ten times the readings
  (1.1e-6 on n at 64 px, 1.3e-6 on n6 at 128 px: float32 convolutions
  summed in another order);
- ``quantize`` on the same statistics: the tree exactly, int8 codes and
  scales (one numpy expression in both packages); the port's own
  calibration carried through: ``wq`` and ``wscale`` exact, the activation
  scales at the statistics' bar;
- the JAX package's quantized tree served by the port in f32 (the head and
  a dequantized input still run in bf16, as in the JAX package), against
  JAX ``features``: full and mixed splits read 0 differing codes and equal
  head maps; the bars allow a code in 10^4 off by one and head maps within
  two bf16 spacings. The safe split, whose float C3 blocks sum in another
  order than XLA's, read 0.5% (n) and 0.8% (n6) of the codes off by at
  most 2 and head maps within 2.3e-5 of their magnitude: bars 8%, 4 and
  3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.models import layers as jax_layers
from aquaculture_tpu.models import quantize as jax_quantize
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_yolov5_init
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.models import layers, quantize
from aquaculture_tpu_torch.models.weights import flatten_tree, load_jax_params
from aquaculture_tpu_torch.models.yolov5 import YoloV5
from aquaculture_tpu_torch.ops import int8_conv
from aquaculture_tpu_torch.pipeline import make_infer_fn

STATS_RTOL = 1.5e-5

# (B, Cin, H, W, Cout, k, stride, padding): the conv kinds of the int8
# models (1x1, k3/s1, k3/s2, the k2 space-to-depth downsample with (1, 0)
# padding, the k3 stem over 12 channels: K = 108, padded to 112), a product
# of M <= 16 rows, and Cout not a multiple of 8
CONV_CASES = {
    "1x1": (2, 16, 8, 8, 24, 1, 1, None),
    "k3s1": (2, 16, 9, 9, 32, 3, 1, None),
    "k3s2": (2, 16, 10, 10, 32, 3, 2, None),
    "k2_s2d": (2, 64, 5, 5, 32, 2, 1, ((1, 0), (1, 0))),
    "stem12": (2, 12, 8, 8, 16, 3, 1, ((1, 1), (1, 1))),
    "m_le_16": (1, 8, 4, 4, 8, 1, 1, None),
    "k108_m9_n20": (1, 12, 3, 3, 20, 3, 1, None),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_routes_equal_jax(case):
    b, cin, h, w, cout, k, s, pad = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    p = pad or ((k // 2, k // 2), (k // 2, k // 2))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt), (s, s), p, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view of NHWC storage: channels_last
    wq = torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()
    mm = int8_conv.int8_conv2d_mm(xt, wq, s, pad)
    plain = int8_conv.int8_conv2d_plain(xt, wq, s, pad)
    assert mm.dtype == plain.dtype == torch.int32
    np.testing.assert_array_equal(mm.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(plain.permute(0, 2, 3, 1).numpy(), want)


def test_int8_conv_route_follows_the_device(monkeypatch):
    """A CPU tensor takes the plain route; a CUDA tensor _int_mm (here a
    CPU stand-in that claims to be a CUDA tensor); the im2col chunks whole
    images when IM2COL_BYTES binds, with the same result."""
    x = torch.randint(-127, 128, (3, 8, 6, 6), dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    w = torch.randint(-127, 128, (16, 8, 3, 3), dtype=torch.int8)
    int8_conv.mm_calls = int8_conv.plain_calls = 0
    plain = int8_conv.int8_conv2d(x, w)
    assert (int8_conv.mm_calls, int8_conv.plain_calls) == (0, 1)

    class _Cuda(torch.Tensor):
        is_cuda = True

    got = int8_conv.int8_conv2d(x.as_subclass(_Cuda), w.as_subclass(_Cuda))
    assert (int8_conv.mm_calls, int8_conv.plain_calls) == (1, 1)
    assert torch.equal(torch.Tensor(got), plain)
    monkeypatch.setattr(int8_conv, "IM2COL_BYTES", 6 * 6 * 72)  # one image per chunk
    assert torch.equal(int8_conv.int8_conv2d_mm(x, w), plain)
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv2d(x.float(), w)


def _jax_paths(tree, path=""):
    """id(conv weight) -> the port's module name, over a JAX fused tree."""
    out = {}
    if isinstance(tree, dict):
        if "w" in tree and "b" in tree:
            return {id(tree["w"]): path}
        for k, v in tree.items():
            out.update(_jax_paths(v, f"{path}.{k}" if path else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_jax_paths(v, f"{path}.{i}"))
    return out


@pytest.fixture(scope="module", params=[("n", 64), ("n6", 128)], ids=["n64", "n6_128"])
def calibrated(request):
    """One model per variant, calibrated on two seeded f32 images by both
    packages; the JAX statistics re-keyed by the port's module names."""
    variant, size = request.param
    jmodel, params = jax_yolov5_init(variant, num_classes=2, seed=0)
    fused = jmodel.fuse(params)
    imgs = np.random.default_rng(0).random((2, size, size, 3), dtype=np.float32)
    jstats = jax_quantize.calibrate(jmodel, fused, jnp.asarray(imgs))
    ids = _jax_paths(fused)
    jstats_named = {(k[0], ids[k[1]]) if isinstance(k, tuple) else ids[k]: v for k, v in jstats.items()}
    model = load_jax_params(YoloV5(variant, 2), jax.tree_util.tree_map(np.asarray, fused)).eval()
    return {"variant": variant, "jmodel": jmodel, "fused": fused, "imgs": imgs, "jstats": jstats,
            "jstats_named": jstats_named, "model": model, "stats": quantize.calibrate(model, torch.from_numpy(imgs))}


def test_calibration_stats_match_jax(calibrated):
    got, want = calibrated["stats"], calibrated["jstats_named"]
    assert set(got) == set(want)
    kinds = {k[0] if isinstance(k, tuple) else "in" for k in got}
    assert kinds == {"in", "out", "sum"} and all(v > 0 for v in got.values())
    for k in want:
        assert abs(got[k] - want[k]) <= STATS_RTOL * want[k], (k, got[k], want[k])


SPLITS = {"full": lambda v: (), "mixed": lambda v: jax_quantize.SERVING_INT8_SKIP,
          "safe": jax_quantize.serving_int8_safe_skip}


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_quantized_tree_matches_jax(calibrated, split):
    skip = SPLITS[split](calibrated["variant"])
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jax_quantize.quantize(calibrated["fused"], calibrated["jstats"], skip=skip)))
    tree = quantize.fused_tree(calibrated["model"])
    # the same statistics: the same tree, bit for bit
    same = flatten_tree(quantize.quantize(tree, calibrated["jstats_named"], skip=skip))
    assert set(same) == set(want)
    for k in want:
        assert same[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(same[k], want[k], err_msg=k)
    # the port's own calibration: int8 codes equal but at rounding ties
    got = flatten_tree(quantize.quantize(tree, calibrated["stats"], skip=skip))
    assert set(got) == set(want)
    for k in want:
        if k.endswith("/wq"):
            w = flatten_tree(tree)[k[:-3] + "/w"] / want[k[:-3] + "/wscale"]
            off = got[k] != want[k]
            assert np.all(np.abs(np.abs(w[off] - np.trunc(w[off])) - 0.5) < 1e-4), k
        elif k.endswith("/wscale"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k.endswith("scale"):
            assert abs(float(got[k]) - float(want[k])) <= STATS_RTOL * float(want[k]), k


def _capture_jax(jmodel, qtree, imgs):
    """JAX features on the quantized tree, jitted, with the codes of every
    requant returned beside the head maps."""
    codes = []
    orig = jax_layers.requant

    def record(act, yscale):
        q = orig(act, yscale)
        codes.append(q.q)
        return q

    def fwd(p, x):
        codes.clear()
        feats, _ = jmodel.features(p, x)
        return feats, list(codes)

    jax_layers.requant = record
    try:
        feats, got = jax.jit(fwd)(qtree, jnp.asarray(imgs))
    finally:
        jax_layers.requant = orig
    return [np.asarray(f) for f in feats], [np.asarray(c) for c in got]


def _capture_port(model, imgs):
    codes = []
    orig = layers.requant

    def record(act, yscale):
        q = orig(act, yscale)
        codes.append(q.q.permute(0, 2, 3, 1).numpy())
        return q

    layers.requant = record
    try:
        with torch.inference_mode():
            feats = model.features(torch.from_numpy(imgs))
    finally:
        layers.requant = orig
    return feats, codes


# (share of codes that may differ, the largest difference, head-map error
# as a share of its magnitude) per split
CARRY_BARS = {"full": (1e-4, 1, 8e-3), "mixed": (1e-4, 1, 8e-3), "safe": (8e-2, 4, 3e-4)}


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_jax_quantized_tree_served_by_the_port(calibrated, split):
    skip = SPLITS[split](calibrated["variant"])
    qtree = jax_quantize.quantize(calibrated["fused"], calibrated["jstats"], skip=skip)
    model = load_jax_params(YoloV5(calibrated["variant"], 2), jax.tree_util.tree_map(np.asarray, qtree)).eval()
    want_f, want_c = _capture_jax(calibrated["jmodel"], qtree, calibrated["imgs"])
    got_f, got_c = _capture_port(model, calibrated["imgs"])
    assert len(got_c) == len(want_c) > 20
    share, worst, head = CARRY_BARS[split]
    n = sum(c.size for c in want_c)
    differ = sum(int((g != w).sum()) for g, w in zip(got_c, want_c))
    assert differ <= share * n, (differ, n)
    assert max(int(np.abs(g.astype(int) - w).max()) for g, w in zip(got_c, want_c)) <= worst
    for g, w in zip(got_f, want_f):
        # a level whose neck output is a QTensor reaches the head
        # dequantized, in bf16 even in f32 serving, as in the JAX package
        assert g.shape == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        w = w.astype(np.float32)
        assert np.abs(g.float().numpy() - w).max() <= head * np.abs(w).max()
    assert {str(f.dtype) for f in want_f} == ({"bfloat16"} if split != "safe" else {"float32", "bfloat16"})


def test_load_jax_params_keeps_the_int8_tree(calibrated):
    """wq int8 (HWIO -> OIHW), scales and biases f32, QConvBlocks at the
    quantized convs and sum_yscale on the shortcut bottlenecks only."""
    qtree = jax.tree_util.tree_map(
        np.asarray, jax_quantize.quantize(calibrated["fused"], calibrated["jstats"]))
    model = load_jax_params(YoloV5(calibrated["variant"], 2), qtree)
    np.testing.assert_array_equal(model.b5.wq.numpy(), qtree["b5"]["wq"].transpose(3, 2, 0, 1))
    assert model.b5.wq.dtype == torch.int8 and model.b5.yscale.dtype == torch.float32
    assert isinstance(model.b2.m[0].cv2, layers.QConvBlock) and model.b2.m[0].cv2.yscale is None
    neck_c3 = model.n15 if model.is_p6 else model.n13
    assert model.b2.m[0].sum_yscale is not None and neck_c3.m[0].sum_yscale is None
    assert float(model.b2.m[0].sum_yscale) == float(qtree["b2"]["m"][0]["sum_yscale"])


def test_skip_lists_and_float_head_match_jax(calibrated):
    for name in ("_SHORTCUT_C3", "SERVING_INT8_SKIP", "SERVING_INT8_SAFE_SKIP", "SERVING_INT8_SAFE_SKIP_P6"):
        assert getattr(quantize, name) == getattr(jax_quantize, name), name
    for v in ("n", "m", "mt", "n6", "m6"):
        assert quantize.serving_int8_safe_skip(v) == jax_quantize.serving_int8_safe_skip(v)
    # n20 is a C3 of P5 and a 1x1 conv of P6; b10 a shortcut C3 of P6 only
    variant = calibrated["variant"]
    imgs = torch.from_numpy(calibrated["imgs"])
    mixed = quantize.quantize_model(calibrated["model"], imgs, skip=quantize.SERVING_INT8_SKIP)
    for name in quantize.SERVING_INT8_SKIP:
        assert not any(isinstance(m, layers.QConvBlock) for m in getattr(mixed, name).modules()), name
    assert isinstance(mixed.b5, layers.QConvBlock)
    assert all(type(h).__name__ == "HeadConv" and h.weight.dtype == torch.float32 for h in mixed.head)
    if variant == "n6":
        assert isinstance(mixed.n20, layers.QConvBlock) and mixed.b10.m[0].sum_yscale is not None
    else:
        assert isinstance(mixed.n20.cv3, layers.QConvBlock)


def test_make_infer_fn_keeps_int8_scales_f32(calibrated):
    """bf16 serving of an int8 model: float blocks and the head in bf16;
    int8 weights stay int8 and every scale and bias of the int8 path
    stays float32."""
    model = quantize.quantize_model(calibrated["model"], torch.from_numpy(calibrated["imgs"]))
    size = calibrated["imgs"].shape[1]
    infer = make_infer_fn(model, DetectConfig(img_size=size, conf_threshold=1e-5), tile=size, device="cpu")
    images = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, size, size, 3), dtype=np.uint8))
    det, valid = infer(images)
    assert valid.any() and torch.isfinite(det).all()
    qblocks = [m for m in model.modules() if isinstance(m, layers.QConvBlock)]
    assert qblocks
    for m in qblocks:
        assert m.wq.dtype == torch.int8
        assert {t.dtype for t in (m.wscale, m.xscale, m.bias)} == {torch.float32}
        assert m.yscale is None or m.yscale.dtype == torch.float32
    sums = [m.sum_yscale for m in model.modules() if isinstance(m, layers.Bottleneck) and m.sum_yscale is not None]
    assert sums and all(t.dtype == torch.float32 for t in sums)
    assert all(h.weight.dtype == torch.bfloat16 for h in model.head)
