"""Post-training int8 quantization of the detector's conv stack.

A copy of aquaculture_tpu/models/quantize.py for the port: weights quantize
per output channel, activations per tensor at scales calibrated on sample
images, and every quantized Conv+SiLU block runs int8 x int8 -> int32
(ops/int8_conv.py) with the dequantization, SiLU and requantization in a
float32 epilogue (``layers.QConvBlock``). The detect head stays floating
point: it feeds the box decode.

    stats = calibrate(model, sample_images)      # float model, one forward
    qtree = quantize(fused_tree(model), stats)   # the JAX package's int8 tree
    qmodel = load_jax_params(YoloV5(...), qtree) # QConvBlocks where quantized

or ``quantize_model(model, sample_images, skip)`` in one call. Calibration
keys each conv's statistics by its module's name in the model (``b2.m.0.cv1``;
the JAX package keys them by the identity of the conv's weight array), so
``quantize`` walks the numpy tree by the same paths.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from aquaculture_tpu_torch.models import layers as L
from aquaculture_tpu_torch.models.weights import load_jax_params, to_tree
from aquaculture_tpu_torch.models.yolov5 import YoloV5


def calibrate(model: YoloV5, sample_images: torch.Tensor) -> Dict:
    """One forward of the float serving ``model`` over ``sample_images``
    ((N, H, W, 3) in [0, 1], in the dtype to calibrate in, on the model's
    device), recording per conv block its input's absolute maximum (key:
    the block's name), its output's after SiLU (``("out", name)``) and per
    shortcut bottleneck its sum's (``("sum", name of its cv2)``)."""
    names = {m: n for n, m in model.named_modules()}
    L._CALIB_STATS = {}
    try:
        with torch.inference_mode():
            model.features(sample_images)
        raw = L._CALIB_STATS
    finally:
        L._CALIB_STATS = None
    return {(k[0], names[k[1]]) if isinstance(k, tuple) else names[k]: v for k, v in raw.items()}


# Backbone C3 blocks run their bottlenecks with shortcut adds; the neck C3s
# don't (models/yolov5.py features()). Needed to place sum_yscale correctly.
_SHORTCUT_C3 = ("b2", "b4", "b6", "b8", "b10")  # b10 exists only on P6

# The mixed split: the early large-spatial, small-channel layers (P1-P3
# backbone) stay float and int8 starts at the stride-16 backbone. The JAX
# package chose it by TPU measurements; the port keeps it as the option's
# meaning (its speed on the H100: PERF.md).
SERVING_INT8_SKIP = ("b0", "b1", "b2", "b3", "b4")

# The serving default, the localization-safe split: the mixed split plus
# the neck C3 blocks that feed the detect head (P3/P4/P5 outputs). int8
# noise on the features the box regression reads is where quantization's
# mAP@.5:.95 cost concentrates (tests/test_accuracy.py bounds it).
SERVING_INT8_SAFE_SKIP = SERVING_INT8_SKIP + ("n17", "n20", "n23")

# The P6 family's 4-level neck names its head-feeding C3s differently
# (models/yolov5.py features(): o3..o6 = n23/n26/n29/n32).
SERVING_INT8_SAFE_SKIP_P6 = SERVING_INT8_SKIP + ("n23", "n26", "n29", "n32")


def serving_int8_safe_skip(variant: str = "m"):
    """The localization-safe skip list for a detector variant."""
    return SERVING_INT8_SAFE_SKIP_P6 if variant.endswith("6") else SERVING_INT8_SAFE_SKIP


def fused_tree(model: YoloV5) -> dict:
    """The float serving model's weights as the JAX package's fused numpy
    tree (HWIO float32 ``w``, ``b``)."""
    return to_tree(dict(model.named_parameters()))


def quantize(fused_params: dict, calib: Dict, default_xscale: float = 1.0, skip=()) -> dict:
    """Fused {w, b} conv dicts -> int8 dicts {wq, wscale, xscale, b[,
    yscale]}, the JAX package's ``quantize`` on the same numpy arithmetic:
    weights per output channel (a channel of zeros keeps scale 1), the
    input scale for a float input, and the calibrated output scale, so that
    the block hands the next one int8 codes. A shortcut bottleneck's cv2
    emits float and the bottleneck requantizes the sum at its own scale
    (``sum_yscale``). Convs without statistics, the top-level layers named
    in ``skip`` and the detect head stay floating point."""

    def qconv(node, path, with_yscale: bool = True):
        if path not in calib:
            return node  # uncalibrated: keep fp
        w = np.asarray(node["w"], np.float32)
        wmax = np.abs(w).max(axis=(0, 1, 2))
        wscale = np.where(wmax > 0, wmax / 127.0, 1.0)
        wq = np.clip(np.round(w / wscale), -127, 127).astype(np.int8)
        amax = calib[path]
        out = {
            "wq": wq,
            "wscale": wscale.astype(np.float32),
            "xscale": np.float32(amax / 127.0 if amax > 0 else default_xscale),
            "b": node["b"],
        }
        omax = calib.get(("out", path), 0.0)
        if with_yscale and omax > 0:
            out["yscale"] = np.float32(omax / 127.0)
        return out

    def walk(node, path: str, shortcut_c3: bool = False):
        join = lambda k: f"{path}.{k}" if path else str(k)
        if isinstance(node, dict):
            if "w" in node and "b" in node and "bn" not in node:
                return qconv(node, path)
            if shortcut_c3 and set(node) >= {"cv1", "cv2"} and "cv3" not in node:
                out = {"cv1": walk(node["cv1"], join("cv1")), "cv2": qconv(node["cv2"], join("cv2"), with_yscale=False)}
                smax = calib.get(("sum", join("cv2")), 0.0)
                if smax > 0 and "wq" in out["cv2"]:
                    out["sum_yscale"] = np.float32(smax / 127.0)
                return out
            return {k: walk(v, join(k), shortcut_c3 or k in _SHORTCUT_C3) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, join(i), shortcut_c3) for i, v in enumerate(node))
        return node

    if skip and isinstance(fused_params, dict):
        out = {k: (v if k in skip else walk(v, k, k in _SHORTCUT_C3)) for k, v in fused_params.items()}
    else:
        out = walk(fused_params, "")
    # The detect head feeds the box decode: always keep it floating point.
    if isinstance(out, dict) and "head" in out:
        out["head"] = fused_params["head"]
    return out


def quantize_model(model: YoloV5, sample_images: torch.Tensor, skip=()) -> YoloV5:
    """calibrate + quantize in one call: a new YoloV5 of ``model``'s variant,
    classes and anchors (float32, on the CPU) whose quantized positions
    hold ``layers.QConvBlock``s."""
    qtree = quantize(fused_tree(model), calibrate(model, sample_images), skip=skip)
    return load_jax_params(YoloV5(model.variant, model.num_classes, anchors=model.anchor_table), qtree)
