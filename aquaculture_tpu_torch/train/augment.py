"""Training augmentation: mosaic, random affine, HSV jitter, flips.

A copy of aquaculture_tpu/train/augment.py (the ultralytics v5 pipeline
with its public hyp defaults: hsv 0.015/0.7/0.4, fliplr 0.5, mosaic 1.0,
translate 0.1, scale 0.5): 4-image mosaic on a 2S x 2S canvas around a
random centre, random scale + translate back to S x S, HSV gain jitter,
horizontal/vertical flips. Host-side numpy and OpenCV on uint8 images,
producing (S, S, 3) images and (N, 5) [cls, cx, cy, w, h] pixel boxes. The
numpy ``Generator`` draws happen in the JAX package's order and the OpenCV
calls are its calls, so one seed gives the same pixels and boxes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def hsv_augment(img: np.ndarray, rng: np.random.Generator, h: float = 0.015, s: float = 0.7, v: float = 0.4) -> np.ndarray:
    """Random HSV gain jitter (uint8 RGB in and out; OpenCV's HSV, H in [0, 180))."""
    import cv2

    gains = rng.uniform(-1, 1, 3) * np.asarray([h, s, v]) + 1.0
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    dtype = img.dtype
    x = np.arange(0, 256, dtype=gains.dtype)
    lut_h = ((x * gains[0]) % 180).astype(dtype)
    lut_s = np.clip(x * gains[1], 0, 255).astype(dtype)
    lut_v = np.clip(x * gains[2], 0, 255).astype(dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s), cv2.LUT(val, lut_v)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def flip_augment(
    img: np.ndarray, boxes: np.ndarray, rng: np.random.Generator,
    fliplr: float = 0.5, flipud: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random horizontal/vertical flips; boxes are (N, 5) [cls, cx, cy, w, h]
    in pixels of img."""
    h, w = img.shape[:2]
    boxes = boxes.copy()
    if rng.random() < fliplr:
        img = img[:, ::-1]
        boxes[:, 1] = w - boxes[:, 1]
    if rng.random() < flipud:
        img = img[::-1]
        boxes[:, 2] = h - boxes[:, 2]
    return np.ascontiguousarray(img), boxes


def mosaic4(
    imgs: Sequence[np.ndarray],
    boxes: Sequence[np.ndarray],
    size: int,
    rng: np.random.Generator,
    pad_value: int = 114,
) -> Tuple[np.ndarray, np.ndarray]:
    """Combine 4 images into a 2S x 2S mosaic around a random centre.

    boxes are per-image (N_i, 5) [cls, cx, cy, w, h] pixel arrays.
    Returns (canvas (2S, 2S, 3), merged boxes in canvas pixels).
    """
    s = size
    canvas = np.full((2 * s, 2 * s, 3), pad_value, np.uint8)
    cx = int(rng.uniform(s // 2, 3 * s // 2))
    cy = int(rng.uniform(s // 2, 3 * s // 2))
    merged: List[np.ndarray] = []
    for i, (img, b) in enumerate(zip(imgs, boxes)):
        h, w = img.shape[:2]
        if i == 0:  # top-left of centre
            x1a, y1a, x2a, y2a = max(cx - w, 0), max(cy - h, 0), cx, cy
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = cx, max(cy - h, 0), min(cx + w, 2 * s), cy
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = x2a - x1a, h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(cx - w, 0), cy, cx, min(cy + h, 2 * s)
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, y2a - y1a
        else:  # bottom-right
            x1a, y1a, x2a, y2a = cx, cy, min(cx + w, 2 * s), min(cy + h, 2 * s)
            x1b, y1b = 0, 0
            x2b, y2b = x2a - x1a, y2a - y1a
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        if len(b):
            nb = b.copy().astype(np.float64)
            nb[:, 1] += x1a - x1b
            nb[:, 2] += y1a - y1b
            merged.append(nb)
    out = np.concatenate(merged) if merged else np.zeros((0, 5))
    return canvas, out


def random_affine(
    img: np.ndarray,
    boxes: np.ndarray,
    size: int,
    rng: np.random.Generator,
    scale: float = 0.5,
    translate: float = 0.1,
    pad_value: int = 114,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random scale + translate from a (H, W) canvas to (size, size) with a
    constant pad_value border, clipping boxes and dropping degenerate ones
    (w or h < 2 px, or less than a quarter still visible)."""
    import cv2

    h, w = img.shape[:2]
    sc = rng.uniform(1 - scale, 1 + scale)
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * size - sc * w / 2
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * size - sc * h / 2
    m = np.asarray([[sc, 0, tx], [0, sc, ty]], np.float64)
    out = cv2.warpAffine(img, m, (size, size), borderValue=(pad_value,) * 3)

    if len(boxes) == 0:
        return out, boxes
    b = boxes.copy().astype(np.float64)
    b[:, 1] = b[:, 1] * sc + tx
    b[:, 2] = b[:, 2] * sc + ty
    b[:, 3] *= sc
    b[:, 4] *= sc
    # clip to the image, recompute w/h from the clipped corners
    pre_area = b[:, 3] * b[:, 4]  # post-scale, pre-clip
    x0 = np.clip(b[:, 1] - b[:, 3] / 2, 0, size)
    x1 = np.clip(b[:, 1] + b[:, 3] / 2, 0, size)
    y0 = np.clip(b[:, 2] - b[:, 4] / 2, 0, size)
    y1 = np.clip(b[:, 2] + b[:, 4] / 2, 0, size)
    b[:, 1], b[:, 2] = (x0 + x1) / 2, (y0 + y1) / 2
    b[:, 3], b[:, 4] = x1 - x0, y1 - y0
    # candidate filter (ultralytics box_candidates): a mostly clipped-away
    # box is a poisoned target
    visible = (b[:, 3] * b[:, 4]) / np.maximum(pre_area, 1e-9)
    keep = (b[:, 3] >= 2) & (b[:, 4] >= 2) & (visible > 0.25)
    return out, b[keep]


def augment_sample(
    pick_fn,
    size: int,
    rng: np.random.Generator,
    mosaic_p: float = 1.0,
    scale: float = 0.5,
    translate: float = 0.1,
    hsv: Tuple[float, float, float] = (0.015, 0.7, 0.4),
    fliplr: float = 0.5,
    flipud: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One augmented training sample. pick_fn() -> (uint8 HWC image, (N, 5)
    pixel boxes) draws a random base sample; mosaic draws three more."""
    if rng.random() < mosaic_p:
        pairs = [pick_fn() for _ in range(4)]
        canvas, boxes = mosaic4([p[0] for p in pairs], [p[1] for p in pairs], size, rng)
        img, boxes = random_affine(canvas, boxes, size, rng, scale, translate)
    else:
        img, boxes = pick_fn()
        img, boxes = random_affine(img, boxes, size, rng, scale, translate)
    img = hsv_augment(img, rng, *hsv)
    img, boxes = flip_augment(img, boxes, rng, fliplr, flipud)
    return img, boxes
