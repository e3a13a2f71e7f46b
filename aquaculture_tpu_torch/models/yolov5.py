"""YOLOv5 detector family (P5: n/s/m/l/x and the lane-aligned mt; P6:
n6..x6) as a PyTorch module.

Counterpart of aquaculture_tpu/models/yolov5.py: CSPDarknet backbone (6x6/s2
stem, C3 blocks, SPPF), PANet neck and the anchor-based detect head at
strides 8/16/32 or, for the *6 variants, an extra 768 -> 1024 backbone
stage, a 4-level PANet and a stride-64 detect level (public yolov5-p6
yaml). The serving model holds BN-folded weights; the training model
(``trainable=True``) holds the unfused layout the JAX package trains: the
k6/s2 stem on 3 channels, k3/s2 downsamples and Conv+BatchNorm+SiLU blocks
with trainable parameters. Either loads from a JAX-package parameter tree
through models/weights.py. ``init`` builds the same random tree as the JAX
package's ``yolov5_init`` from a seed, with numpy.

Public layouts are the JAX package's: ``features`` takes NHWC images
(B, H, W, 3) in [0, 1] and returns NHWC head maps; ``decode`` returns
(B, N, 5+nc) rows with N ordered (level, y, x, anchor). Inside, tensors are
NCHW in channels_last memory format.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aquaculture_tpu_torch.models import layers as L

# depth_multiple, width_multiple per variant (public YOLOv5 scaling table).
# The "*6" names are the P6 family: their base letter's scaling pair, the
# P6 topology.
VARIANTS: Dict[str, Tuple[float, float]] = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
    "n6": (0.33, 0.25),
    "s6": (0.33, 0.50),
    "m6": (0.67, 0.75),
    "l6": (1.00, 1.00),
    "x6": (1.33, 1.25),
    # mt: m's depths, channel map from CHANNEL_OVERRIDES (width multiple unused)
    "mt": (0.67, 0.75),
}

# Explicit channel maps; a listed variant takes its c1..c5 from here.
CHANNEL_OVERRIDES: Dict[str, Dict[str, int]] = {
    "mt": {"c1": 32, "c2": 64, "c3": 256, "c4": 256, "c5": 1024},
}

# Default COCO anchors per stride level (w, h) in pixels.
DEFAULT_ANCHORS = (
    ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),      # P3/8
    ((30.0, 61.0), (62.0, 45.0), (59.0, 119.0)),     # P4/16
    ((116.0, 90.0), (156.0, 198.0), (373.0, 326.0)),  # P5/32
)
STRIDES = (8, 16, 32)

# P6 family (public yolov5-p6 anchor table, pixels at 1280 px)
DEFAULT_ANCHORS_P6 = (
    ((19.0, 27.0), (44.0, 40.0), (38.0, 94.0)),          # P3/8
    ((96.0, 68.0), (86.0, 152.0), (180.0, 137.0)),       # P4/16
    ((140.0, 301.0), (303.0, 264.0), (238.0, 542.0)),    # P5/32
    ((436.0, 615.0), (739.0, 380.0), (925.0, 792.0)),    # P6/64
)
STRIDES_P6 = (8, 16, 32, 64)

# stride-2 downsample convs of each topology (features' `down`)
DOWN_LAYERS = ("b1", "b3", "b5", "b7", "n18", "n21")
DOWN_LAYERS_P6 = ("b1", "b3", "b5", "b7", "b9", "n24", "n27", "n30")


def _make_divisible(c: float, divisor: int = 8) -> int:
    return max(int(np.ceil(c / divisor) * divisor), divisor)


def _width(c: int, wm: float) -> int:
    return _make_divisible(c * wm) if c != 3 else 3


def _depth(n: int, dm: float) -> int:
    return max(int(round(n * dm)), 1)


class HeadConv(nn.Module):
    """The detect head's 1x1 conv with bias and no activation, in the
    activation dtype."""

    def __init__(self, cin: int, cout: int, trainable: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1, 1), requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=trainable)

    def forward(self, x):
        return L.conv2d(x, self.weight) + self.bias.to(x.dtype)[:, None, None]


class YoloV5(nn.Module):
    """YOLOv5 model, P5 or P6 by variant. Parameter names follow the JAX
    package's tree (``b2.m.0.cv1.weight`` <-> ``b2/m/0/cv1/w``,
    ``b2.m.0.cv1.bn.mean`` <-> ``b2/m/0/cv1/bn/mean``); ``n20`` is a C3 in
    P5 and a 1x1 conv in P6, as there.

    Serving (``trainable=False``): BN-folded blocks; the stem starts in the
    fused space-to-depth layout (k3 over 12 channels) and every downsample
    as k3/s2; models/weights.py may load the other layouts the JAX package
    stores, and ``features`` dispatches on the stored kernel shape as the
    JAX package does.

    Training (``trainable=True``): Conv+BatchNorm+SiLU blocks
    (``layers.TrainConvBlock``), the k6/s2 stem on 3 channels, trainable
    f32 parameters and f32 BN running statistics; ``train_options`` holds
    the model's remat switch."""

    def __init__(self, variant: str = "m", num_classes: int = 5, anchors: Sequence | None = None,
                 trainable: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown or unported variant {variant!r}; have {sorted(VARIANTS)}")
        self.variant = variant
        self.num_classes = num_classes
        self.is_p6 = variant.endswith("6")
        family_anchors = DEFAULT_ANCHORS_P6 if self.is_p6 else DEFAULT_ANCHORS
        self.anchor_table = anchors if anchors is not None else family_anchors
        self.strides = STRIDES_P6 if self.is_p6 else STRIDES
        self.down_layers = DOWN_LAYERS_P6 if self.is_p6 else DOWN_LAYERS
        self.trainable = trainable
        ch, dp = self.channels(), self.depths()
        c1, c2, c3, c4, c5 = (ch[f"c{i}"] for i in range(1, 6))
        n3, n6, n9 = dp["n3"], dp["n6"], dp["n9"]
        if trainable:
            self.train_options = L.TrainOptions()
            conv = functools.partial(L.TrainConvBlock, options=self.train_options)
            self.b0 = conv(3, c1, 6)
        else:
            self.train_options = None
            conv = L.ConvBlock
            self.b0 = conv(4 * 3, c1, 3)
        c3_ = functools.partial(L.C3, block=conv)
        self.b1 = conv(c1, c2, 3)
        self.b2 = c3_(c2, c2, n3)
        self.b3 = conv(c2, c3, 3)
        self.b4 = c3_(c3, c3, n6)
        self.b5 = conv(c3, c4, 3)
        self.b6 = c3_(c4, c4, n9)
        self.b7 = conv(c4, c5, 3)
        self.b8 = c3_(c5, c5, n3)
        if self.is_p6:
            c6 = ch["c6"]
            self.b9 = conv(c5, c6, 3)
            self.b10 = c3_(c6, c6, n3)
            self.b11 = L.SPPF(c6, c6, conv)
            self.n12 = conv(c6, c5, 1)
            self.n15 = c3_(2 * c5, c5, n3)
            self.n16 = conv(c5, c4, 1)
            self.n19 = c3_(2 * c4, c4, n3)
            self.n20 = conv(c4, c3, 1)
            self.n23 = c3_(2 * c3, c3, n3)
            self.n24 = conv(c3, c3, 3)
            self.n26 = c3_(2 * c3, c4, n3)
            self.n27 = conv(c4, c4, 3)
            self.n29 = c3_(2 * c4, c5, n3)
            self.n30 = conv(c5, c5, 3)
            self.n32 = c3_(2 * c5, c6, n3)
            head_in = (c3, c4, c5, c6)
        else:
            self.b9 = L.SPPF(c5, c5, conv)
            self.n10 = conv(c5, c4, 1)
            self.n13 = c3_(2 * c4, c4, n3)
            self.n14 = conv(c4, c3, 1)
            self.n17 = c3_(2 * c3, c3, n3)
            self.n18 = conv(c3, c3, 3)
            self.n20 = c3_(2 * c3, c4, n3)
            self.n21 = conv(c4, c4, 3)
            self.n23 = c3_(2 * c4, c5, n3)
            head_in = (c3, c4, c5)
        self.head = nn.ModuleList(HeadConv(c, self.na * self.no, trainable) for c in head_in)

    @property
    def na(self) -> int:
        return len(self.anchor_table[0])

    @property
    def no(self) -> int:
        return self.num_classes + 5

    def channels(self) -> Dict[str, int]:
        w = VARIANTS[self.variant][1]
        ch = {f"c{i}": _width(c, w) for i, c in enumerate((64, 128, 256, 512, 1024), 1)}
        if self.is_p6:
            # P6 backbone: ... 512 -> 768 -> 1024 (public yolov5-p6 yaml)
            ch["c5"] = _width(768, w)
            ch["c6"] = _width(1024, w)
        ch.update(CHANNEL_OVERRIDES.get(self.variant, {}))
        return ch

    def depths(self) -> Dict[str, int]:
        d = VARIANTS[self.variant][0]
        return {"n3": _depth(3, d), "n6": _depth(6, d), "n9": _depth(9, d)}

    # ------------------------------------------------------------------
    # numpy parameter trees (the JAX package's format)
    # ------------------------------------------------------------------

    @staticmethod
    def _init_backbone_prefix(rng, ch, dp) -> dict:
        """b0..b8, the CSPDarknet prefix both families share (the P6
        family's c5 is 768-wide; the expressions are the same)."""
        return {
            "b0": L.conv_init(rng, 3, ch["c1"], 6),
            "b1": L.conv_init(rng, ch["c1"], ch["c2"], 3),
            "b2": L.c3_init(rng, ch["c2"], ch["c2"], dp["n3"]),
            "b3": L.conv_init(rng, ch["c2"], ch["c3"], 3),
            "b4": L.c3_init(rng, ch["c3"], ch["c3"], dp["n6"]),
            "b5": L.conv_init(rng, ch["c3"], ch["c4"], 3),
            "b6": L.c3_init(rng, ch["c4"], ch["c4"], dp["n9"]),
            "b7": L.conv_init(rng, ch["c4"], ch["c5"], 3),
            "b8": L.c3_init(rng, ch["c5"], ch["c5"], dp["n3"]),
        }

    def _head_init(self, rng, channels) -> list:
        return [
            {"w": L.he_init(rng, (1, 1, c, self.na * self.no), c),
             "b": np.zeros((self.na * self.no,), np.float32)}
            for c in channels
        ]

    def init(self, seed: int = 0) -> dict:
        """Unfused random tree, draw for draw the JAX package's
        ``YoloV5.init(seed)``."""
        if self.is_p6:
            return self._init_p6(seed)
        ch, dp = self.channels(), self.depths()
        rng = np.random.default_rng(seed)
        return {
            **self._init_backbone_prefix(rng, ch, dp),
            "b9": L.sppf_init(rng, ch["c5"], ch["c5"]),
            "n10": L.conv_init(rng, ch["c5"], ch["c4"], 1),
            "n13": L.c3_init(rng, 2 * ch["c4"], ch["c4"], dp["n3"]),
            "n14": L.conv_init(rng, ch["c4"], ch["c3"], 1),
            "n17": L.c3_init(rng, 2 * ch["c3"], ch["c3"], dp["n3"]),
            "n18": L.conv_init(rng, ch["c3"], ch["c3"], 3),
            "n20": L.c3_init(rng, 2 * ch["c3"], ch["c4"], dp["n3"]),
            "n21": L.conv_init(rng, ch["c4"], ch["c4"], 3),
            "n23": L.c3_init(rng, 2 * ch["c4"], ch["c5"], dp["n3"]),
            "head": self._head_init(rng, (ch["c3"], ch["c4"], ch["c5"])),
        }

    def _init_p6(self, seed: int) -> dict:
        """P6 topology, draw for draw the JAX package's ``_init_p6``: one
        more backbone stage (768 -> 1024) and a 4-level PANet."""
        ch, dp = self.channels(), self.depths()
        rng = np.random.default_rng(seed)
        return {
            **self._init_backbone_prefix(rng, ch, dp),
            "b9": L.conv_init(rng, ch["c5"], ch["c6"], 3),
            "b10": L.c3_init(rng, ch["c6"], ch["c6"], dp["n3"]),
            "b11": L.sppf_init(rng, ch["c6"], ch["c6"]),
            "n12": L.conv_init(rng, ch["c6"], ch["c5"], 1),
            "n15": L.c3_init(rng, 2 * ch["c5"], ch["c5"], dp["n3"]),
            "n16": L.conv_init(rng, ch["c5"], ch["c4"], 1),
            "n19": L.c3_init(rng, 2 * ch["c4"], ch["c4"], dp["n3"]),
            "n20": L.conv_init(rng, ch["c4"], ch["c3"], 1),
            "n23": L.c3_init(rng, 2 * ch["c3"], ch["c3"], dp["n3"]),
            "n24": L.conv_init(rng, ch["c3"], ch["c3"], 3),
            "n26": L.c3_init(rng, 2 * ch["c3"], ch["c4"], dp["n3"]),
            "n27": L.conv_init(rng, ch["c4"], ch["c4"], 3),
            "n29": L.c3_init(rng, 2 * ch["c4"], ch["c5"], dp["n3"]),
            "n30": L.conv_init(rng, ch["c5"], ch["c5"], 3),
            "n32": L.c3_init(rng, 2 * ch["c5"], ch["c6"], dp["n3"]),
            "head": self._head_init(rng, (ch["c3"], ch["c4"], ch["c5"], ch["c6"])),
        }

    def fuse(self, params: dict, stem_s2d: bool = True, down_s2d: Sequence[str] = ()) -> dict:
        """Fold every BN into its conv (numpy, in the leaves' dtype) and
        apply the exact space-to-depth reparametrizations, as the JAX
        package's ``YoloV5.fuse`` does."""
        fused = {name: (p if name == "head" else L.tree_map_fuse(p)) for name, p in params.items()}
        if stem_s2d and fused["b0"]["w"].shape[0] == 6:
            fused["b0"] = {**fused["b0"], "w": L.stem_weights_to_s2d(fused["b0"]["w"])}
        for name in down_s2d:
            if name not in self.down_layers:
                raise ValueError(
                    f"down_s2d: {name!r} is not a stride-2 downsample conv of this "
                    f"{'P6' if self.is_p6 else 'P5'} model; eligible: {sorted(self.down_layers)}"
                )
            p = fused[name]
            if p["w"].shape[0] != 3:
                raise ValueError(f"down_s2d: layer {name!r} has no k3 kernel")
            fused[name] = {**p, "w": L.down_weights_to_s2d(p["w"])}
        return fused

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def _run(self, m: nn.Module, *args, **kwargs) -> torch.Tensor:
        """Call one top-level block; under ``train_options.remat`` (train
        mode, autograd on) through torch.utils.checkpoint, with the BN
        running statistics frozen while the backward pass recomputes it."""
        opts = self.train_options
        if opts is not None and opts.remat and self.training and torch.is_grad_enabled():
            return checkpoint(m, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), opts.stats_frozen()), **kwargs)
        return m(*args, **kwargs)

    def _down(self, name: str, t):
        # k2 kernel = fuse(down_s2d=...): space-to-depth + k2/s1, (1, 0) pad
        m = getattr(self, name)
        if L.kernel_of(m).shape[-1] == 2:
            return self._run(m, L.qs2d(t), 1, ((1, 0), (1, 0)))
        return self._run(m, t, 2)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) NHWC images in [0, 1] -> per-level raw head maps,
        each (B, H/s, W/s, na*no) NHWC in the input's dtype: three levels for
        P5, four for P6. In train mode (``self.train()``) every BatchNorm
        normalizes with batch statistics and moves its running statistics
        once per call.

        An int8 model (models/quantize.py) hands QTensors between its
        quantized blocks: concatenation, upsampling and space-to-depth pass
        them through (layers.qcat, qup2, qs2d), and the detect head takes
        them dequantized (bf16), as the JAX package's ``features`` does."""
        run = self._run
        x = x.permute(0, 3, 1, 2)  # NCHW view; channels_last when x is NHWC-contiguous
        w0 = L.kernel_of(self.b0)
        if w0.shape[-1] == 3 and w0.shape[1] == 4 * x.shape[1]:
            y = run(self.b0, L.space_to_depth2(x), 1, ((1, 1), (1, 1)))
        else:
            y = run(self.b0, x, 2, ((2, 2), (2, 2)))
        y = self._down("b1", y)
        y = run(self.b2, y)
        y = self._down("b3", y)
        p3 = run(self.b4, y)                              # stride 8
        y = self._down("b5", p3)
        p4 = run(self.b6, y)                              # stride 16
        y = self._down("b7", p4)
        if self.is_p6:
            p5 = run(self.b8, y)                          # stride 32
            y = self._down("b9", p5)
            y = run(self.b11, run(self.b10, y))           # stride 64
            t12 = run(self.n12, y)
            y = run(self.n15, L.qcat([L.qup2(t12), p5]), shortcut=False)
            t16 = run(self.n16, y)
            y = run(self.n19, L.qcat([L.qup2(t16), p4]), shortcut=False)
            t20 = run(self.n20, y)
            o3 = run(self.n23, L.qcat([L.qup2(t20), p3]), shortcut=False)
            y = self._down("n24", o3)
            o4 = run(self.n26, L.qcat([y, t20]), shortcut=False)
            y = self._down("n27", o4)
            o5 = run(self.n29, L.qcat([y, t16]), shortcut=False)
            y = self._down("n30", o5)
            o6 = run(self.n32, L.qcat([y, t12]), shortcut=False)
            outs = (o3, o4, o5, o6)
        else:
            y = run(self.b8, y)
            y = run(self.b9, y)                           # stride 32
            t10 = run(self.n10, y)
            y = run(self.n13, L.qcat([L.qup2(t10), p4]), shortcut=False)
            t14 = run(self.n14, y)
            o3 = run(self.n17, L.qcat([L.qup2(t14), p3]), shortcut=False)
            y = self._down("n18", o3)
            o4 = run(self.n20, L.qcat([y, t14]), shortcut=False)
            y = self._down("n21", o4)
            o5 = run(self.n23, L.qcat([y, t10]), shortcut=False)
            outs = (o3, o4, o5)
        # the head stays floating point (it feeds the box decode)
        return [h(L.deq(o)).permute(0, 2, 3, 1) for h, o in zip(self.head, outs)]

    def decode(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """Raw NHWC head maps -> (B, N, 5+nc) f32 rows [cx, cy, w, h, obj,
        cls...] in input pixels (public YOLOv5 transform):
            xy = (2*sigmoid(t_xy) - 0.5 + grid) * stride
            wh = (2*sigmoid(t_wh))**2 * anchor
        Rows run (y, x, anchor) within each level, as in the JAX package."""
        outs = []
        for f, anchors, stride in zip(feats, self.anchor_table, self.strides):
            b, h, w, _ = f.shape
            p = torch.sigmoid(f.reshape(b, h, w, self.na, self.no).float())
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=f.device),
                torch.arange(w, dtype=torch.float32, device=f.device),
                indexing="ij",
            )
            grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]     # (1,h,w,1,2)
            anc = torch.tensor(anchors, dtype=torch.float32, device=f.device)[None, None, None]
            xy = (p[..., 0:2] * 2.0 - 0.5 + grid) * float(stride)
            wh = torch.square(p[..., 2:4] * 2.0) * anc
            out = torch.cat([xy, wh, p[..., 4:]], dim=-1)
            outs.append(out.reshape(b, h * w * self.na, self.no))
        return torch.cat(outs, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.features(x))


def init_detect_biases(model: YoloV5, params: dict, img_size: int = 640, cls_prior: float = 0.01) -> dict:
    """Ultralytics-style detect bias initialization (the JAX package's
    expression): obj bias += log(8 / (640/stride)^2), cls bias +=
    log(prior / (nc - 1))."""
    new_head = []
    for hp, stride in zip(params["head"], model.strides):
        b = np.array(hp["b"]).reshape(model.na, model.no)
        b[:, 4] += np.log(8.0 / (img_size / stride) ** 2)
        b[:, 5:] += np.log(cls_prior / max(model.num_classes - 1, 1))
        new_head.append({"w": hp["w"], "b": np.asarray(b.reshape(-1), np.float32)})
    return {**params, "head": new_head}


def yolov5_init(variant: str = "m", num_classes: int = 5, seed: int = 0):
    """-> (model, unfused numpy params): the JAX package's ``yolov5_init``
    tree. Load it with models.weights.load_jax_params."""
    model = YoloV5(variant=variant, num_classes=num_classes)
    return model, init_detect_biases(model, model.init(seed))
