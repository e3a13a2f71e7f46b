"""Letterbox preprocessing: aspect-preserving resize + pad, on the device.

Counterpart of aquaculture_tpu/ops/letterbox.py, the ultralytics letterbox
of the reference's ``detect.py --img 640`` (reference README.md:77): scale
the image to fit the target square, pad the remainder with gray (114) split
evenly, and normalize to [0, 1]. Images are NHWC as in the JAX package.

The resize is antialiased bilinear in float32 (the JAX package's
``jax.image.resize(..., "bilinear")``), and the divisor is a 0-dim device
tensor: CUDA divides by a Python scalar as a multiply by its reciprocal.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _letterbox_nchw(x: torch.Tensor, new_size: int, pad_value: float, dtype: torch.dtype):
    """(B, C, H, W) float32 -> (B, new_size, new_size, C) in ``dtype``."""
    h, w = x.shape[-2:]
    gain = min(new_size / h, new_size / w)
    nh, nw = int(round(h * gain)), int(round(w * gain))
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True, align_corners=False)
    pad_y, pad_x = new_size - nh, new_size - nw
    top, left = pad_y // 2, pad_x // 2
    x = F.pad(x, (left, pad_x - left, top, pad_y - top), value=pad_value)
    x = x / torch.full((), 255.0, device=x.device)
    return x.to(dtype).permute(0, 2, 3, 1).contiguous(), gain, (left, top)


def letterbox(
    img: torch.Tensor,
    new_size: int = 640,
    pad_value: float = 114.0,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """A (H, W, 3) uint8/float image -> ((new_size, new_size, 3) in [0, 1],
    scale gain, (pad_x, pad_y)); the inverse map back to source pixels is
    ``src = (dst - pad) / gain``."""
    x = img.permute(2, 0, 1)[None].float()
    out, gain, pad = _letterbox_nchw(x, new_size, pad_value, dtype)
    return out[0], gain, pad


def letterbox_batch(imgs: torch.Tensor, new_size: int = 640, dtype: torch.dtype = torch.bfloat16):
    """Letterbox over a (B, H, W, 3) batch of same-size images -> (batch,
    gain, (pad_x, pad_y))."""
    return _letterbox_nchw(imgs.permute(0, 3, 1, 2).float(), new_size, 114.0, dtype)


def unletterbox_boxes(boxes: torch.Tensor, gain: float, pad: Tuple[int, int]) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coordinates back to source pixels."""
    px, py = pad
    shift = torch.tensor([px, py, px, py], dtype=boxes.dtype, device=boxes.device)
    return (boxes - shift) / torch.full((), gain, dtype=boxes.dtype, device=boxes.device)
