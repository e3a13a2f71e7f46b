"""Detection pipeline of the PyTorch port: image files -> detections.

Counterpart of ``make_infer_fn`` and ``detect_files`` in
aquaculture_tpu/pipeline.py, on the Python file loader. Tiles stream through
the prefetched loader; normalize + resize + forward + NMS run as one
function per fixed-shape batch on the device; batch N+1 is dispatched
before batch N is harvested, so the device-to-host copy and the host's
post-processing overlap device work. The geocode/areas/land-filter epilogue
of ``run_pipeline`` comes in a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from aquaculture_tpu_torch.config import IM_WIDTH, DetectConfig, resolve_device
from aquaculture_tpu_torch.data.filenames import TileSpec
from aquaculture_tpu_torch.data.loader import tile_batches
from aquaculture_tpu_torch.models.yolov5 import YoloV5
from aquaculture_tpu_torch.ops.nms import batched_nms

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class PipelineStats:
    tiles: int = 0
    batches: int = 0
    detections: int = 0
    infer_seconds: float = 0.0

    @property
    def tiles_per_second(self) -> float:
        return self.tiles / self.infer_seconds if self.infer_seconds else 0.0


def preprocess(images_u8: torch.Tensor, img_size: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, img_size, img_size, 3) NHWC in ``dtype``,
    values in [0, 1], on the input's device.

    The resize is antialiased bilinear, in float32 and then cast:
    PyTorch's antialiased bilinear has no bfloat16 CPU kernel, and one
    operator on both devices keeps the CPU tests on the card's path. The
    divisor is a 0-dim device tensor: CUDA divides by a Python scalar as a
    multiply by its reciprocal, which is not IEEE division."""
    x = images_u8.permute(0, 3, 1, 2).float() / torch.full((), 255.0, device=images_u8.device)
    if x.shape[2] != img_size or x.shape[3] != img_size:
        x = F.interpolate(x, size=(img_size, img_size), mode="bilinear",
                          antialias=True, align_corners=False)
    return x.to(dtype).permute(0, 2, 3, 1).contiguous()  # NHWC = channels_last NCHW


def make_infer_fn(model: YoloV5, cfg: DetectConfig, tile: int = IM_WIDTH, device="cuda"):
    """Build the (uint8 NHWC tile batch) -> (dets, valid) function.

    Moves ``model`` (in place) to ``device``, the compute dtype and
    channels_last. The returned function takes a (B, tile, tile, 3) uint8
    tensor on the host (pinned for an asynchronous copy) or on the device
    and returns (B, max_det, 6) rows [x0, y0, x1, y1, conf, cls] in tile
    pixels plus the (B, max_det) validity mask, both on the device."""
    dev = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    gain = torch.full((), cfg.img_size / tile, device=dev)  # a device divisor, as in preprocess
    model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        preds = model(preprocess(images_u8.to(dev, non_blocking=True), cfg.img_size, dtype))
        det, valid = batched_nms(
            preds,
            conf_thresh=cfg.conf_threshold,
            iou_thresh=cfg.iou_threshold,
            max_det=cfg.max_detections,
            pre_topk=cfg.pre_nms_topk,
            class_agnostic=cfg.class_agnostic,
            backend=cfg.nms_backend,
        )
        # 640-space -> tile pixel space (square tiles: pure gain)
        return torch.cat([det[..., :4] / gain, det[..., 4:]], dim=-1), valid

    return infer


def detect_files(
    paths: Sequence[str],
    model: YoloV5,
    cfg: DetectConfig = DetectConfig(),
    batch_size: int = 32,
    tile: int = IM_WIDTH,
    infer_fn=None,
    device="cuda",
):
    """Run inference over image files on ``device`` (CUDA unless the CPU is
    asked for). infer_fn: a prebuilt make_infer_fn result for repeated
    calls. Returns (boxes_px (N,4) int64, conf (N,), cls (N,), specs,
    stats)."""
    dev = resolve_device(device)
    infer = infer_fn or make_infer_fn(model, cfg, tile, device=dev)
    stats = PipelineStats()

    all_boxes: List[np.ndarray] = []
    all_conf: List[np.ndarray] = []
    all_cls: List[np.ndarray] = []
    all_specs: List[TileSpec] = []

    def harvest(det_dev, valid_dev, specs_batch, n_valid):
        det = det_dev.cpu().numpy()
        valid = valid_dev.cpu().numpy()
        stats.batches += 1
        stats.tiles += n_valid
        for i, spec in enumerate(specs_batch):
            if spec is None:
                continue
            v = valid[i]
            if not v.any():
                continue
            d = det[i][v]
            boxes = np.trunc(d[:, :4]).astype(np.int64)  # reference int() semantics
            all_boxes.append(boxes)
            all_conf.append(d[:, 4].astype(np.float64))
            all_cls.append(d[:, 5].astype(np.int64))
            all_specs.extend([spec] * len(d))

    t0 = time.perf_counter()
    batches = tile_batches(paths, batch_size, tile, pin_memory=dev.type == "cuda")
    # Double-buffered: dispatch batch N+1 before harvesting batch N (CUDA
    # work is asynchronous; the .cpu() copies in harvest are the sync point).
    pending = None
    for batch in batches:
        det_dev, valid_dev = infer(batch.images)
        if pending is not None:
            harvest(*pending)
        pending = (det_dev, valid_dev, batch.specs, int(batch.valid.sum()))
    if pending is not None:
        harvest(*pending)
    stats.infer_seconds = time.perf_counter() - t0

    if all_boxes:
        boxes = np.concatenate(all_boxes)
        conf = np.concatenate(all_conf)
        cls = np.concatenate(all_cls)
    else:
        boxes = np.zeros((0, 4), np.int64)
        conf = np.zeros(0)
        cls = np.zeros(0, np.int64)
    stats.detections = len(boxes)
    return boxes, conf, cls, all_specs, stats
