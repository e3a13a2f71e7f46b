"""Detection pipeline of the PyTorch port: image files -> geocoded detections.

Counterpart of ``make_infer_fn``, ``overlap_stride``, ``detect_files`` and
``run_pipeline`` in aquaculture_tpu/pipeline.py. Local files go through the
device loader (data/native_loader.py: the JPEG entropy decode on host
threads, the rest of the decode in kernels on the card, the JAX package's
native-loader choice) or the Python loader (data/loader.py, PIL); with
``store=``, blobs stream from an object store (data/store.py). Tiles stream
through the prefetched loader; normalize + resize + forward (or the test-time-augmented
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
from aquaculture_tpu_torch.data import native_loader
from aquaculture_tpu_torch.data.loader import prefetch, tile_batches, tile_batches_from_store
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

# formats the device loader reads (its entropy decoder, or PIL for TIFF)
_NATIVE_EXTS = (".jpg", ".jpeg", ".tif", ".tiff")


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
    # the tile loader that ran: "python" (data/loader.py) or "device"
    # (data/native_loader.py, the JAX package's native loader); and, for
    # the device loader, the files of each route ("device", "pil",
    # "pil_resize", "skipped")
    loader: str = "python"
    files: Dict[str, int] = dataclasses.field(default_factory=dict)

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


def place_model(model: YoloV5, dtype: str, device) -> torch.device:
    """Move ``model`` (in place) to ``device``, channels_last and the
    compute dtype named ``dtype`` (``DetectConfig.dtype``), in eval mode;
    an int8 model (models/quantize.py) keeps its int8 weights and its
    float32 scales and biases. The one placement of the live path and of
    the AOT artifact (models/aot.py). Returns the device."""
    dev = resolve_device(device)
    to_compute_dtype(model.to(device=dev, memory_format=torch.channels_last), DTYPES[dtype]).eval()
    return dev


class ServingProgram(torch.nn.Module):
    """The serving program: (B, tile, tile, 3) uint8 tiles on the model's
    device -> (B, max_det, 6) rows [x0, y0, x1, y1, conf, cls] in tile
    pixels and the (B, max_det) validity mask. Preprocess, the forward or
    the test-time-augmented forward, batched NMS, then the tile-pixel gain.

    The live path (``make_infer_fn``) calls it with the model's own
    weights; models/aot.py traces it with ``torch.export``, the weights
    given as inputs through ``torch.func.functional_call``. Place the model
    first (``place_model``)."""

    def __init__(self, model: YoloV5, cfg: DetectConfig, tile: int = IM_WIDTH):
        super().__init__()
        self.model, self.cfg, self.tile = model, cfg, tile

    def forward(self, images_u8: torch.Tensor):
        cfg = self.cfg
        x = preprocess(images_u8, cfg.img_size, DTYPES[cfg.dtype])
        if cfg.augment:
            preds = tta_predict(self.model, x, scales=cfg.tta_scales, flips=cfg.tta_flips)
        else:
            preds = self.model(x)
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
        # 640-space -> tile pixel space (square tiles: pure gain, divided by
        # a device tensor as in preprocess)
        gain = torch.full((), cfg.img_size / self.tile, device=images_u8.device)
        return torch.cat([det[..., :4] / gain, det[..., 4:]], dim=-1), valid


def make_infer_fn(model: YoloV5, cfg: DetectConfig, tile: int = IM_WIDTH, device="cuda"):
    """Build the (uint8 NHWC tile batch) -> (dets, valid) function.

    Places ``model`` (in place: ``place_model``) and serves it through
    ``ServingProgram``. The returned function takes a (B, tile, tile, 3)
    uint8 tensor on the host (pinned for an asynchronous copy) or on the
    device and returns (B, max_det, 6) rows [x0, y0, x1, y1, conf, cls] in
    tile pixels plus the (B, max_det) validity mask, both on the device."""
    dev = place_model(model, cfg.dtype, device)
    program = ServingProgram(model, cfg, tile)

    @torch.inference_mode()
    def infer(images_u8: torch.Tensor):
        return program(images_u8.to(dev, non_blocking=True))

    return infer


def overlap_stride(overlap: int, tile_px: int = IM_WIDTH) -> int:
    """Tiling stride for overlap serving; 0 means the hard grid. overlap >=
    tile would step the grid by <= 0 px, so it raises."""
    if overlap and not 0 < overlap < tile_px:
        raise ValueError(f"overlap must be in (0, {tile_px}); got {overlap}")
    return tile_px - overlap if overlap else 0


def _exceeds_tile(path: str, tile: int) -> bool:
    """A raster larger than a tile (PIL reads the header only); an
    unreadable header counts as larger, so the Python loader decides."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            return im.size[0] > tile or im.size[1] > tile
    except Exception:
        return True


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
    store=None,
    use_native: Optional[bool] = None,
):
    """Run inference over image files, or object-store blobs, on ``device``
    (CUDA unless the CPU is asked for). infer_fn: a prebuilt make_infer_fn
    result for repeated calls (the pod runner's checkpoint chunks).

    store: a data.store.BlobStore; when given, ``paths`` are blob KEYS
    streamed through a threaded fetch window, and no local image file is
    read. decode_threads applies to files only.

    stride: 0 = the reference's hard grid; 0 < stride < tile overlaps the
    tiles of large rasters (overlap serving; run_pipeline dedups the
    copies with post.dedup.nms_cross_tile). decode_threads: the loader's
    decode pool, 0 = auto (cores capped at 8), 1 = sequential.
    decode_scale: decode rasters at img_size/tile scale on the host and
    ship img_size tiles to the device, skipping its resize (8*img_size must
    divide by tile); offsets stay in source pixels. Incompatible with
    stride.

    use_native: the device loader (data/native_loader.py) or the Python
    one, chosen as the JAX package chooses: None takes the device loader
    for local files at a scale it decodes (8/8, 5/8); None or True then
    keep it only when every path is .jpg/.jpeg/.tif/.tiff and, with
    overlap serving, no raster is larger than a tile; False forces the
    Python loader.
    ``stats.loader`` names the loader that ran. Returns (boxes_px (N,4)
    int64, conf (N,), cls (N,), specs, stats)."""
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
    if use_native is None:
        use_native = (store is None and native_loader.available()
                      and native_loader.supports_scale(out_tile, tile))
    if use_native and not all(p.lower().endswith(_NATIVE_EXTS) for p in paths):
        # the device loader skips what it cannot read: a PNG corpus would
        # vanish, so it goes to the Python loader
        use_native = False
    if use_native and stride and stride < tile and any(_exceeds_tile(p, tile) for p in paths):
        use_native = False  # overlapped slicing lives in the Python loader
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
    pin = dev.type == "cuda"
    if store is not None:
        batches = tile_batches_from_store(store, paths, batch_size, tile, pin_memory=pin, stride=stride,
                                          out_tile=out_tile)
    elif use_native:
        stats.loader = "device"
        batches = prefetch(native_loader.native_tile_batches(
            paths, batch_size, tile, n_threads=decode_threads, out_tile=out_tile, device=dev,
            counts=stats.files))
    else:
        batches = tile_batches(paths, batch_size, tile, pin_memory=pin, stride=stride,
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
    store=None,
    use_native: Optional[bool] = None,
):
    """Files -> geocoded, area-annotated ocean detections, on ``device``
    (CUDA unless the CPU is asked for). With ``store`` set, ``paths`` are
    object-store keys streamed through the BlobStore protocol.

    Mirrors geocode_results.py __main__ + calc_net_areas.py __main__
    (reference: src/process_yolo/) in one call, in the JAX package's order:
    detect, geocode, region dedup against the download boxes, cross-tile
    NMS (overlap > 0: tiles of large rasters step by tile - overlap px, and
    the copies of a boundary object collapse by meter-space IoU), cage
    areas, then the land filter (the hybrid mask from
    HYBRID_LAND_FILTER_ROWS detections on, else the exact sjoin).
    decode_threads, decode_scale and use_native as in ``detect_files``. Returns
    (detections GeoFrame in EPSG:4326, PipelineStats with each stage's host
    seconds and rows).
    """
    clock = time.perf_counter
    t = clock()
    boxes, conf, cls, specs, stats = detect_files(
        paths, model, cfg, batch_size, device=device, stride=overlap_stride(overlap),
        decode_threads=decode_threads, decode_scale=decode_scale, store=store, use_native=use_native,
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
