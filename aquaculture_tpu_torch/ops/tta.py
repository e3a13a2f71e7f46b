"""Test-time augmentation (the ultralytics ``detect.py --augment`` path).

Counterpart of aquaculture_tpu/ops/tta.py: multi-scale + horizontal-flip
forward passes merged into one candidate pool before NMS, the public yolov5
augmented-inference transform (models/yolo.py _forward_augment /
_descale_pred). Scales (1, 0.83, 0.67) with a left-right flip on the middle
scale; each pass is resized to int(side * ratio), padded bottom/right to a
multiple of the model's largest stride with 0.447, and its decoded boxes are
de-scaled back to input pixels (xywh / ratio, a flipped centre mirrored
about the input width) before the passes are concatenated.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

TTA_SCALES: Tuple[float, ...] = (1.0, 0.83, 0.67)
TTA_FLIPS: Tuple[Optional[str], ...] = (None, "lr", None)
_PAD_VAL = 0.447  # ultralytics scale_img pad value (ImageNet mean gray)


def _scale_pad(x: torch.Tensor, ratio: float, gs: int) -> torch.Tensor:
    """NHWC ``x``: resize by ``ratio`` (antialiased bilinear, in float32 as
    pipeline.preprocess) and pad bottom/right to a multiple of ``gs``
    (ultralytics utils.torch_utils.scale_img semantics)."""
    if ratio == 1.0:
        return x
    b, h, w, c = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    xr = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                       antialias=True, align_corners=False).to(x.dtype)
    ph = math.ceil(nh / gs) * gs - nh
    pw = math.ceil(nw / gs) * gs - nw
    return F.pad(xr, (0, pw, 0, ph), value=_PAD_VAL).permute(0, 2, 3, 1).contiguous()


def tta_predict(
    model,
    x: torch.Tensor,
    scales: Sequence[float] = TTA_SCALES,
    flips: Sequence[Optional[str]] = TTA_FLIPS,
) -> torch.Tensor:
    """Augmented forward: (B, H, W, 3) NHWC in [0, 1] -> (B, sum N_l, 5+nc)
    decoded float32 rows in INPUT-pixel coordinates, ready for NMS."""
    if len(scales) != len(flips):
        raise ValueError(
            f"scales ({len(scales)}) and flips ({len(flips)}) must have the "
            "same length: zip would drop passes")
    gs = int(max(model.strides))
    w0 = torch.full((), float(x.shape[2]), device=x.device)
    outs = []
    for ratio, flip in zip(scales, flips):
        xi = torch.flip(x, dims=(2,)) if flip == "lr" else x
        p = model(_scale_pad(xi, ratio, gs))
        r = torch.full((), ratio, dtype=p.dtype, device=p.device)  # a device divisor, as in preprocess
        xy, wh = p[..., 0:2] / r, p[..., 2:4] / r
        if flip == "lr":
            xy = torch.cat([w0 - xy[..., 0:1], xy[..., 1:2]], dim=-1)
        outs.append(torch.cat([xy, wh, p[..., 4:]], dim=-1))
    return torch.cat(outs, dim=1)
