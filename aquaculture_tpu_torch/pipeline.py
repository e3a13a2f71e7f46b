"""Detection pipeline of the PyTorch port: image files -> geocoded detections.

Counterpart of ``make_infer_fn``, ``overlap_stride``, ``detect_files`` and
``run_pipeline`` in aquaculture_tpu/pipeline.py, on the Python file loader
(the port has no native loader: its H100 hosts lack the libjpeg and
libtiff development headers; ROADMAP.md). Tiles stream through the
prefetched loader; normalize + resize + forward (or the test-time-augmented
forward) + NMS run as one function per fixed-shape batch on the device;
batch N+1 is dispatched before batch N is harvested, so the device-to-host copy and the
host's post-processing overlap device work. ``run_pipeline`` adds the host
epilogue: geocode, download-box dedup, cross-tile NMS for overlap serving,
cage areas and the land filter.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import DTYPES, IM_WIDTH, DetectConfig, resolve_device
from aquaculture_tpu_torch.data.filenames import TileSpec
from aquaculture_tpu_torch.data.loader import tile_batches
from aquaculture_tpu_torch.models.layers import to_compute_dtype
from aquaculture_tpu_torch.models.yolov5 import YoloV5
from aquaculture_tpu_torch.ops.nms import batched_nms
from aquaculture_tpu_torch.ops.tta import tta_predict
from aquaculture_tpu_torch.post.areas import cage_areas
from aquaculture_tpu_torch.post.dedup import (
    deduplicate_download_boxes, deduplicate_gdf_with_bboxes, nms_cross_tile)
from aquaculture_tpu_torch.post.geocode import geocode_detections, remove_land_detections
from aquaculture_tpu_torch.post.landmask import remove_land_detections_hybrid

# From this many detections on, the land filter rasterizes the land once
# (remove_land_detections_hybrid, row-for-row the exact result); below it
# the exact sjoin is cheaper than building the mask.
HYBRID_LAND_FILTER_ROWS = 2000


@dataclasses.dataclass
class PipelineStats:
    tiles: int = 0
    batches: int = 0
    detections: int = 0
    infer_seconds: float = 0.0
    # run_pipeline: host seconds and rows after each stage that ran
    # (detect, geocode, dedup, cross_tile, areas, land_filter), and the land
    # filter's branch ("exact" or "hybrid")
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    stage_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    land_filter: str = ""
    # the tile loader that ran: the port has the Python one only, where the
    # JAX package may run its native loader ("native")
    loader: str = "python"

    @property
    def tiles_per_second(self) -> float:
        return self.tiles / self.infer_seconds if self.infer_seconds else 0.0


def preprocess(images_u8: torch.Tensor, img_size: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, img_size, img_size, 3) NHWC in ``dtype``,
    values in [0, 1], on the input's device. The resize is skipped when the
    tiles arrive at img_size (decode-at-scale); it downscales (1024 -> 640)
    or upscales (1024 -> 1280 for the P6 family).

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
    channels_last; an int8 model (models/quantize.py) keeps its int8
    weights and its float32 scales and biases. The returned function takes a (B, tile, tile, 3) uint8
    tensor on the host (pinned for an asynchronous copy) or on the device
    and returns (B, max_det, 6) rows [x0, y0, x1, y1, conf, cls] in tile
    pixels plus the (B, max_det) validity mask, both on the device."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gain = torch.full((), cfg.img_size / tile, device=dev)  # a device divisor, as in preprocess
    to_compute_dtype(model.to(device=dev, memory_format=torch.channels_last), dtype).eval()

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        x = preprocess(images_u8.to(dev, non_blocking=True), cfg.img_size, dtype)
        if cfg.augment:
            preds = tta_predict(model, x, scales=cfg.tta_scales, flips=cfg.tta_flips)
        else:
            preds = model(x)
        det, valid = batched_nms(
            preds,
            conf_thresh=cfg.conf_threshold,
            iou_thresh=cfg.iou_threshold,
            max_det=cfg.max_detections,
            pre_topk=cfg.pre_nms_topk,
            class_agnostic=cfg.class_agnostic,
            backend=cfg.nms_backend,
            multi_label=cfg.multi_label,
        )
        # 640-space -> tile pixel space (square tiles: pure gain)
        return torch.cat([det[..., :4] / gain, det[..., 4:]], dim=-1), valid

    return infer


def overlap_stride(overlap: int, tile_px: int = IM_WIDTH) -> int:
    """Tiling stride for overlap serving; 0 means the hard grid. overlap >=
    tile would step the grid by <= 0 px, so it raises."""
    if overlap and not 0 < overlap < tile_px:
        raise ValueError(f"overlap must be in (0, {tile_px}); got {overlap}")
    return tile_px - overlap if overlap else 0


def detect_files(
    paths: Sequence[str],
    model: YoloV5,
    cfg: DetectConfig = DetectConfig(),
    batch_size: int = 32,
    tile: int = IM_WIDTH,
    infer_fn=None,
    device="cuda",
    stride: int = 0,
    decode_threads: int = 0,
    decode_scale: bool = False,
):
    """Run inference over image files on ``device`` (CUDA unless the CPU is
    asked for). infer_fn: a prebuilt make_infer_fn result for repeated
    calls.

    stride: 0 = the reference's hard grid; 0 < stride < tile overlaps the
    tiles of large rasters (overlap serving; run_pipeline dedups the
    copies with post.dedup.nms_cross_tile). decode_threads: the loader's
    decode pool, 0 = auto (cores capped at 8), 1 = sequential.
    decode_scale: decode rasters at img_size/tile scale on the host and
    ship img_size tiles to the device, skipping its resize (8*img_size must
    divide by tile); offsets stay in source pixels. Incompatible with
    stride. Returns (boxes_px (N,4) int64, conf (N,), cls (N,), specs,
    stats)."""
    dev = resolve_device(device)
    out_tile = 0
    if decode_scale:
        if stride:
            raise ValueError("decode_scale is incompatible with overlap serving")
        if cfg.img_size >= tile or (8 * cfg.img_size) % tile != 0:
            raise ValueError(
                f"decode_scale needs img_size a proper N/8 fraction of the "
                f"tile; got {cfg.img_size}/{tile}"
            )
        out_tile = cfg.img_size
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
    batches = tile_batches(paths, batch_size, tile, pin_memory=dev.type == "cuda", stride=stride,
                           decode_threads=decode_threads, out_tile=out_tile)
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


def run_pipeline(
    paths: Sequence[str],
    model: YoloV5,
    download_bboxes: "gf.GeoFrame",
    cfg: DetectConfig = DetectConfig(),
    batch_size: int = 32,
    land: Optional["gf.GeoFrame"] = None,
    dedup: bool = True,
    device="cuda",
    overlap: int = 0,
    overlap_iou: float = 0.5,
    decode_threads: int = 0,
    decode_scale: bool = False,
):
    """Files -> geocoded, area-annotated ocean detections, on ``device``
    (CUDA unless the CPU is asked for).

    Mirrors geocode_results.py __main__ + calc_net_areas.py __main__
    (reference: src/process_yolo/) in one call, in the JAX package's order:
    detect, geocode, region dedup against the download boxes, cross-tile
    NMS (overlap > 0: tiles of large rasters step by tile - overlap px, and
    the copies of a boundary object collapse by meter-space IoU), cage
    areas, then the land filter (the hybrid mask from
    HYBRID_LAND_FILTER_ROWS detections on, else the exact sjoin).
    decode_threads and decode_scale as in ``detect_files``. Returns
    (detections GeoFrame in EPSG:4326, PipelineStats with each stage's host
    seconds and rows).
    """
    clock = time.perf_counter
    t = clock()
    boxes, conf, cls, specs, stats = detect_files(
        paths, model, cfg, batch_size, device=device, stride=overlap_stride(overlap),
        decode_threads=decode_threads, decode_scale=decode_scale,
    )

    def lap(stage: str, rows: int) -> None:
        nonlocal t
        now = clock()
        stats.stage_seconds[stage] = now - t
        stats.stage_rows[stage] = rows
        t = now

    lap("detect", len(boxes))
    det = geocode_detections(boxes, conf, cls, specs, download_bboxes)
    if len(det):
        # assigned before cross-tile NMS: specs align with geocode's rows
        det["bbox_ind"] = [s.bbox_ind for s in specs]
    lap("geocode", len(det))
    # geocode_detections returns CRS 4326 and every step below preserves it
    # (deduplicate_gdf_with_bboxes round-trips through to_crs(src_crs);
    # nms_cross_tile copies det.crs; drop/cage_areas copy the frame)
    if len(det) and dedup:
        dd = deduplicate_download_boxes(download_bboxes)
        det = deduplicate_gdf_with_bboxes(dd, det)
        lap("dedup", len(det))
    # Cross-tile NMS after region dedup, as in the JAX package: a border
    # cage of two download boxes must first lose the copy that dedup drops,
    # or NMS could keep that one and lose both.
    if len(det) and overlap:
        det = nms_cross_tile(det, iou_thresh=overlap_iou)
        lap("cross_tile", len(det))
    if len(det) and "bbox_ind" in det.columns:
        det = det.drop(columns=["bbox_ind"])
    if len(det):
        det = cage_areas(det)
    lap("areas", len(det))
    if land is not None and len(det):
        if len(det) >= HYBRID_LAND_FILTER_ROWS:
            stats.land_filter = "hybrid"
            det = remove_land_detections_hybrid(det, land)
        else:
            stats.land_filter = "exact"
            det = remove_land_detections(det, land)
        lap("land_filter", len(det))
    return det, stats
