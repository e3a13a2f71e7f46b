"""Building blocks of the detector family as PyTorch modules.

Counterpart of aquaculture_tpu/models/layers.py: Conv+SiLU with BN folded
(``ConvBlock``, the fused ``{w, b}`` serving path) or with trainable
BatchNorm (``TrainConvBlock``, the ``{w, bn}`` training path), Bottleneck,
C3 and SPPF over either, the space-to-depth stem and nearest 2x upsample.
Modules take and return NCHW tensors; callers keep them in
``torch.channels_last`` memory format, which is the NHWC layout of the JAX
package and what cuDNN runs fastest.

The numpy helpers at the bottom (BN folding and the exact space-to-depth
weight reparametrizations) work on the JAX package's HWIO parameter trees,
so a tree saved by either package loads through models/weights.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

# BatchNorm2d with ultralytics' defaults, as layers.batch_norm
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def _same(k: int) -> Padding:
    p = k // 2
    return ((p, p), (p, p))


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: Padding | None = None):
    """NCHW conv with explicit (top, bottom), (left, right) padding; output
    in the input dtype (the layers.conv2d contract)."""
    (pt, pb), (pl, pr) = padding if padding is not None else _same(w.shape[-1])
    if pt == pb and pl == pr:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w.to(x.dtype), stride=stride)


class ConvBlock(nn.Module):
    """Conv2d with BN folded into weight + bias, then SiLU ("Conv" in
    YOLOv5; layers.conv_block's fused path). ``weight`` is OIHW."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x, stride: int = 1, padding: Padding | None = None):
        y = conv2d(x, self.weight, stride, padding)
        return F.silu(y + self.bias.to(x.dtype)[:, None, None])


@dataclasses.dataclass
class TrainOptions:
    """Switches of one training model, shared by its blocks:
    rematerialization per top-level block, and whether a train-mode forward
    writes the BN running statistics (off while a rematerialized block is
    recomputed in the backward pass, so they move once per step)."""

    remat: bool = False
    update_stats: bool = True

    @contextlib.contextmanager
    def stats_frozen(self):
        prev, self.update_stats = self.update_stats, False
        try:
            yield
        finally:
            self.update_stats = prev


class BatchNorm(nn.Module):
    """BatchNorm with the JAX package's arithmetic (layers.batch_norm), not
    ``nn.BatchNorm2d``'s: in train mode the batch mean and the BIASED batch
    variance normalize, and the f32 running statistics move as
    ``(1 - 0.03) * old + 0.03 * batch``; ``inv = rsqrt(var + 1e-3) * scale``
    in f32, then ``(x - mean) * inv + bias`` in the activation dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            if update_stats:
                with torch.no_grad():
                    self.mean.copy_((1 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean.float())
                    self.var.copy_((1 - BN_MOMENTUM) * self.var + BN_MOMENTUM * var.float())
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var.float() + BN_EPS) * self.scale
        dt = x.dtype
        return (x - mean.to(dt)[:, None, None]) * inv.to(dt)[:, None, None] + self.bias.to(dt)[:, None, None]


class TrainConvBlock(nn.Module):
    """Conv2d + BatchNorm + SiLU with trainable OIHW ``weight`` and BN
    ``scale``/``bias``, f32 ``mean``/``var`` buffers (layers.conv_block's
    ``{w, bn}`` path). The f32 weight is cast to the activation dtype at
    use."""

    def __init__(self, cin: int, cout: int, k: int, options: TrainOptions):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bn = BatchNorm(cout)
        self.options = options

    def forward(self, x, stride: int = 1, padding: Padding | None = None):
        y = conv2d(x, self.weight, stride, padding)
        return F.silu(self.bn(y, self.options.update_stats))


Block = Callable[[int, int, int], nn.Module]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, block: Block = ConvBlock):
        super().__init__()
        self.cv1 = block(cin, cout, 1)
        self.cv2 = block(cout, cout, 3)

    def forward(self, x, shortcut: bool):
        y = self.cv2(self.cv1(x))
        if shortcut and x.shape[1] == y.shape[1]:
            y = x + y
        return y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv3(cat([m(cv1(x)), cv2(x)]))."""

    def __init__(self, cin: int, cout: int, n: int, block: Block = ConvBlock):
        super().__init__()
        ch = cout // 2
        self.cv1 = block(cin, ch, 1)
        self.cv2 = block(cin, ch, 1)
        self.cv3 = block(2 * ch, cout, 1)
        self.m = nn.ModuleList(Bottleneck(ch, ch, block) for _ in range(n))

    def forward(self, x, shortcut: bool = True):
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1, shortcut)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


def max_pool(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k stride-1 max pool with same padding; the padding is -inf."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, block: Block = ConvBlock):
        super().__init__()
        ch = cin // 2
        self.cv1 = block(cin, ch, 1)
        self.cv2 = block(ch * 4, cout, 1)

    def forward(self, x, k: int = 5):
        y = self.cv1(x)
        y1 = max_pool(y, k)
        y2 = max_pool(y1, k)
        y3 = max_pool(y2, k)
        return self.cv2(torch.cat([y, y1, y2, y3], dim=1))


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2): 2x2 spatial blocks to channels,
    channel order (row offset, col offset, c) as in the JAX package's
    space_to_depth2 (matching stem_weights_to_s2d). Keeps channels_last."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (an exact repeat)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


# ---------------------------------------------------------------------------
# numpy parameter-tree transforms (HWIO weights, as the JAX package stores)
# ---------------------------------------------------------------------------

def fuse_conv_bn(p: dict) -> dict:
    """Fold BN statistics into conv weight + bias, in the leaves' own dtype
    (a float16 checkpoint folds in float16, as the JAX package does)."""
    if "bn" not in p:
        return p
    bn = p["bn"]
    inv = bn["scale"] / np.sqrt(bn["var"] + 1e-3)
    w = p["w"] * inv[None, None, None, :]
    b = bn["bias"] - bn["mean"] * inv
    return {"w": w, "b": b}


def stem_weights_to_s2d(w: np.ndarray) -> np.ndarray:
    """Exact reparametrization of a k6/s2/p2 conv over C channels into a
    k3/s1/p1 conv over 4C space-to-depth channels (HWIO, float32).

    For output pixel i: 2i + u - 2 = 2(i + du) + a with u = 2 du + a + 2,
    du in {-1,0,1}, a in {0,1}: every original tap lands on exactly one
    (s2d neighbour, sub-pixel channel) slot."""
    k, _, cin, cout = w.shape
    if k != 6:
        raise ValueError(f"stem kernel must be 6x6, got {k}")
    w = np.asarray(w, np.float32)
    out = np.zeros((3, 3, 4 * cin, cout), np.float32)
    for u in range(6):
        du, a = divmod(u - 2, 2)
        for v in range(6):
            dv, b = divmod(v - 2, 2)
            out[du + 1, dv + 1, (a * 2 + b) * cin : (a * 2 + b + 1) * cin, :] = w[u, v]
    return out


def down_weights_to_s2d(w: np.ndarray) -> np.ndarray:
    """Exact reparametrization of a k3/s2/p1 conv over C channels into a
    k2/s1 conv with (1, 0) padding over 4C space-to-depth channels (HWIO,
    float32); (du, a) = divmod(u - 1, 2) per tap."""
    k, _, cin, cout = w.shape
    if k != 3:
        raise ValueError(f"downsample kernel must be 3x3, got {k}")
    w = np.asarray(w, np.float32)
    out = np.zeros((2, 2, 4 * cin, cout), np.float32)
    for u in range(3):
        du, a = divmod(u - 1, 2)
        for v in range(3):
            dv, b = divmod(v - 1, 2)
            out[du + 1, dv + 1, (a * 2 + b) * cin : (a * 2 + b + 1) * cin, :] = w[u, v]
    return out


def tree_map_fuse(params):
    """Recursively fuse all conv+bn blocks in a parameter tree."""
    if isinstance(params, dict):
        if "w" in params and "bn" in params:
            return fuse_conv_bn(params)
        return {k: tree_map_fuse(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_map_fuse(v) for v in params)
    return params


def he_init(rng: np.random.Generator, shape: Sequence[int], fan_in: int) -> np.ndarray:
    # the JAX package's _he_init expression, rounded to float32 as
    # jnp.asarray rounds it
    return (rng.standard_normal(shape).astype(np.float32) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def conv_init(rng: np.random.Generator, cin: int, cout: int, k: int) -> dict:
    return {
        "w": he_init(rng, (k, k, cin, cout), k * k * cin),
        "bn": {
            "scale": np.ones((cout,), np.float32),
            "bias": np.zeros((cout,), np.float32),
            "mean": np.zeros((cout,), np.float32),
            "var": np.ones((cout,), np.float32),
        },
    }


def bottleneck_init(rng: np.random.Generator, cin: int, cout: int) -> dict:
    return {"cv1": conv_init(rng, cin, cout, 1), "cv2": conv_init(rng, cout, cout, 3)}


def c3_init(rng: np.random.Generator, cin: int, cout: int, n: int) -> dict:
    ch = cout // 2
    return {
        "cv1": conv_init(rng, cin, ch, 1),
        "cv2": conv_init(rng, cin, ch, 1),
        "cv3": conv_init(rng, 2 * ch, cout, 1),
        "m": [bottleneck_init(rng, ch, ch) for _ in range(n)],
    }


def sppf_init(rng: np.random.Generator, cin: int, cout: int) -> dict:
    ch = cin // 2
    return {"cv1": conv_init(rng, cin, ch, 1), "cv2": conv_init(rng, ch * 4, cout, 1)}
