"""Building blocks of the detector family as PyTorch modules.

Counterpart of aquaculture_tpu/models/layers.py: Conv+SiLU with BN folded
(``ConvBlock``, the fused ``{w, b}`` serving path), with trainable
BatchNorm (``TrainConvBlock``, the ``{w, bn}`` training path) or quantized
to int8 (``QConvBlock``, the ``{wq, wscale, xscale, b[, yscale]}`` serving
path that models/quantize.py builds), Bottleneck, C3 and SPPF over any of
them, the space-to-depth stem and nearest 2x upsample. Between quantized
blocks activations travel as ``QTensor`` (int8 codes and a per-tensor
scale); ``qcat``, ``qup2`` and ``qs2d`` pass them through concatenation,
upsampling and space-to-depth, and ``deq`` turns them back into floats.
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
import functools
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aquaculture_tpu_torch.ops.int8_conv import int8_conv2d

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

# BatchNorm2d with ultralytics' defaults, as layers.batch_norm
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def _same(k: int) -> Padding:
    p = k // 2
    return ((p, p), (p, p))


class QTensor(NamedTuple):
    """int8 activations and their per-tensor scale (value ~ q * scale), as
    the int8 serving path hands them from one quantized block to the next
    (layers.QTensor). ``q`` is NCHW int8 in channels_last memory, ``scale``
    a 0-dim float32 tensor on the same device."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


def deq(x, dtype: torch.dtype = torch.bfloat16):
    """QTensor -> float activations in ``dtype`` (bf16 by default, as the
    JAX package's deq); identity on plain tensors."""
    if isinstance(x, QTensor):
        return (x.q.float() * x.scale).to(dtype)
    return x


def requant(act: torch.Tensor, yscale: torch.Tensor) -> QTensor:
    """float activations -> int8 at the calibrated output scale (round half
    to even, clipped to +-127); the divisor is the 0-dim scale tensor."""
    q = torch.clamp(torch.round(act.float() / yscale), -127, 127)
    return QTensor(q.to(torch.int8), yscale)


def qcat(parts):
    """Concatenate along channels: QTensors rescaled to their largest scale
    and rounded (the ratio is at most 1, so nothing clips), plain tensors
    as they are; a mix is dequantized to floats, in the promoted dtype."""
    if all(isinstance(p, QTensor) for p in parts):
        s = parts[0].scale
        for p in parts[1:]:
            s = torch.maximum(s, p.scale)
        qs = [torch.round(p.q.float() * (p.scale / s)).to(torch.int8) for p in parts]
        return QTensor(torch.cat(qs, dim=1), s)
    if any(isinstance(p, QTensor) for p in parts):
        parts = [deq(p) for p in parts]
        dtype = functools.reduce(torch.promote_types, (p.dtype for p in parts))
        parts = [p.to(dtype) for p in parts]
    return torch.cat(parts, dim=1)


def qup2(x):
    """2x nearest upsample, QTensor-aware (int8 codes are repeated, the
    scale kept)."""
    if isinstance(x, QTensor):
        b, c, h, w = x.q.shape
        nhwc = x.q.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
        return QTensor(nhwc.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2), x.scale)
    return upsample2x(x)


def qs2d(x):
    """space_to_depth2, QTensor-aware (pure data movement, scale kept)."""
    if isinstance(x, QTensor):
        return QTensor(space_to_depth2(x.q), x.scale)
    return space_to_depth2(x)


# Calibration (models/quantize.calibrate): while this is a dict, every float
# ConvBlock records its input's and its output's absolute maximum, and every
# shortcut Bottleneck the sum's, keyed by module (("out", block) and ("sum",
# its cv2) for the latter two), as layers.conv_block does by weight identity.
_CALIB_STATS: dict | None = None


def _record(key, t: torch.Tensor) -> None:
    _CALIB_STATS[key] = max(_CALIB_STATS.get(key, 0.0), float(t.abs().max()))


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
        # a float block downstream of a quantized one (the mixed splits)
        # takes the dequantized activations
        x = deq(x)
        if _CALIB_STATS is not None:
            _record(self, x)
        y = conv2d(x, self.weight, stride, padding)
        out = F.silu(y + self.bias.to(x.dtype)[:, None, None])
        if _CALIB_STATS is not None:
            _record(("out", self), out)
        return out


class QConvBlock(nn.Module):
    """Conv2d + SiLU on int8 (layers.conv_block's ``{wq, wscale, xscale,
    b[, yscale]}`` branch): OIHW int8 ``wq`` with per-output-channel float32
    ``wscale``, a float32 input scale ``xscale`` for a float input, the
    float32 ``bias``, and with ``yscale`` a requantized QTensor output.

    A float input quantizes at ``xscale`` and a float output keeps the
    input's dtype; a QTensor input brings its own scale, and a float output
    is then bfloat16 whatever the serving dtype, as in the JAX package. The
    convolution is exact int32 (ops/int8_conv.py); the epilogue
    ``y32 * (xscale * wscale) + b`` and the SiLU run in float32."""

    def __init__(self, cin: int, cout: int, k: int, requantize: bool):
        super().__init__()
        self.wq = nn.Parameter(torch.zeros(cout, cin, k, k, dtype=torch.int8), requires_grad=False)
        self.wscale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.xscale = nn.Parameter(torch.ones(()), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.yscale = nn.Parameter(torch.ones(()), requires_grad=False) if requantize else None

    def forward(self, x, stride: int = 1, padding: Padding | None = None):
        if isinstance(x, QTensor):
            xq, xscale, float_dtype = x.q, x.scale, torch.bfloat16
        else:
            xscale, float_dtype = self.xscale, x.dtype
            xq = torch.clamp(torch.round(x.float() / xscale), -127, 127).to(torch.int8)
        y32 = int8_conv2d(xq, self.wq, stride, padding)
        y = y32.float() * (xscale * self.wscale)[:, None, None] + self.bias[:, None, None]
        act = F.silu(y)
        if self.yscale is not None:
            return requant(act, self.yscale)
        return act.to(float_dtype)


def kernel_of(block: nn.Module) -> torch.Tensor:
    """A conv block's stored kernel: int8 ``wq`` or float ``weight``."""
    return block.wq if isinstance(block, QConvBlock) else block.weight


def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model``'s float parameters to ``dtype`` in place, except the
    int8 path's: a QConvBlock keeps its int8 weight and float32 scales and
    bias, a shortcut Bottleneck its float32 ``sum_yscale`` (the JAX package
    keeps them in f32 whatever the serving dtype)."""
    for m in model.modules():
        if isinstance(m, QConvBlock):
            continue
        for name, p in m.named_parameters(recurse=False):
            if p.is_floating_point() and name != "sum_yscale":
                p.data = p.data.to(dtype)
    return model


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
    """cv2(cv1(x)), plus x on a shortcut. In an int8 model whose cv2 emits
    float (a shortcut bottleneck of the backbone), the sum requantizes at
    its own calibrated scale ``sum_yscale`` (None until models/weights.py
    loads one); a partly quantized one without it adds in float32."""

    def __init__(self, cin: int, cout: int, block: Block = ConvBlock):
        super().__init__()
        self.cv1 = block(cin, cout, 1)
        self.cv2 = block(cout, cout, 3)
        self.register_parameter("sum_yscale", None)

    def forward(self, x, shortcut: bool):
        y = self.cv2(self.cv1(x))
        if shortcut and x.shape[1] == y.shape[1]:
            if self.sum_yscale is not None:
                y = requant(y.float() + deq(x, torch.float32), self.sum_yscale)
            elif isinstance(x, QTensor) or isinstance(y, QTensor):
                y = deq(x, torch.float32) + deq(y, torch.float32)
            else:
                y = x + y
                if _CALIB_STATS is not None:
                    _record(("sum", self.cv2), y)
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
        return self.cv3(qcat([y1, self.cv2(x)]))


def max_pool(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k stride-1 max pool with same padding; the padding is -inf.
    int8 codes (the quantized SPPF) pool as float32, exact for |q| <= 127:
    every window holds its centre, so the padding never wins."""
    if x.dtype == torch.int8:
        return F.max_pool2d(x.float(), k, stride=1, padding=k // 2).to(torch.int8)
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, block: Block = ConvBlock):
        super().__init__()
        ch = cin // 2
        self.cv1 = block(cin, ch, 1)
        self.cv2 = block(ch * 4, cout, 1)

    def forward(self, x, k: int = 5):
        y = self.cv1(x)
        if isinstance(y, QTensor):
            # max pool is order-preserving: it runs on the codes, scale kept
            y1 = QTensor(max_pool(y.q, k), y.scale)
            y2 = QTensor(max_pool(y1.q, k), y.scale)
            y3 = QTensor(max_pool(y2.q, k), y.scale)
        else:
            y1 = max_pool(y, k)
            y2 = max_pool(y1, k)
            y3 = max_pool(y2, k)
        return self.cv2(qcat([y, y1, y2, y3]))


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
