"""Constants and the detection configuration of the PyTorch port.

A copy of what the port needs from aquaculture_tpu/config.py: the imagery
geometry and CRS registry (reference src/utils.py:17-20), the class
mappings, the clustering operating point, ``DetectConfig`` with its serving
options (multi-label candidates, test-time augmentation) and
``TrainConfig``, field for field.
"""

from __future__ import annotations

import dataclasses

import torch

LARGE_TIF_SIZE = 1024 * 6  # px of one downloaded GeoTIFF
IM_WIDTH = 1024            # px of one analysis tile
IM_HEIGHT = 1024
DOWNLOAD_BOX_M = 1200.0    # meters covered by one download box (EPSG:3857)

CRS_MAPPING = 3857  # Web Mercator: storage / mapping CRS
CRS_AREA = 3035     # ETRS89-extended LAEA Europe: area measurement CRS
CRS_LATLON = 4326   # WGS84 lat/lon: output CRS

CLASS_NAMES = (
    "circle_farm",
    "square_farm",
    "triangle_farm",
    "other_farm",
    "rectangle_farm",
)
REVERSE_CLASS_MAPPING = {i: n for i, n in enumerate(CLASS_NAMES)}
CLASS_MAPPING = {n: i for i, n in enumerate(CLASS_NAMES)}

# Operating point found by the reference's grid search
# (reference: src/get_kfold_cluster_performance.py:538-540)
OPTIMAL_CONF_THRESHOLD = 0.785
OPTIMAL_DISTANCE_THRESHOLD = 50.0   # DBSCAN eps in meters (EPSG:3035)
OPTIMAL_MIN_CLUSTER_SIZE = 5


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Inference configuration for the detector: ``detect.py --img 640``
    with ultralytics' default NMS settings."""

    img_size: int = 640
    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_detections: int = 300       # post-NMS cap (fixed shape)
    # Pre-NMS candidate cap: the suppression scan is K serial steps.
    pre_nms_topk: int = 1024
    # one candidate per (box, class) above conf (ultralytics val.py
    # semantics); False = argmax class, the reference's detect.py default
    multi_label: bool = False
    # test-time augmentation (ultralytics detect.py --augment): one forward
    # pass per (scale, flip), merged before NMS (ops/tta.py)
    augment: bool = False
    tta_scales: tuple = (1.0, 0.83, 0.67)
    tta_flips: tuple = (None, "lr", None)
    class_agnostic: bool = False
    dtype: str = "bfloat16"
    # ops.nms.batched_nms backend. 'auto' is the only value: suppression
    # follows the tensors' device (CUDA -> the hand-written kernel, which
    # launches or raises; CPU -> the plain PyTorch version).
    nms_backend: str = "auto"

    def __post_init__(self):
        # zip(scales, flips) would drop passes on a length mismatch
        if len(self.tta_scales) != len(self.tta_flips):
            raise ValueError(
                f"tta_scales ({len(self.tta_scales)}) and tta_flips "
                f"({len(self.tta_flips)}) must have the same length: one "
                "flip entry (None or 'lr') per scale pass")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration: the reference's ``train.py --img 640
    --batch 16 --epochs 50`` with ultralytics' default hyperparameters."""

    img_size: int = 640
    batch_size: int = 16
    epochs: int = 50
    lr0: float = 0.01
    lrf: float = 0.01               # final OneCycle lr fraction
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    box_gain: float = 0.05
    cls_gain: float = 0.5
    obj_gain: float = 1.0
    anchor_t: float = 4.0           # anchor-match wh ratio threshold
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0
    mosaic: float = 1.0
    translate: float = 0.1
    scale: float = 0.5
    ema_decay: float = 0.9999
    max_boxes_per_image: int = 120  # fixed-shape label padding
    # Host feed threads per batch (decode, mosaic, affine and HSV are numpy
    # and OpenCV, mostly releasing the GIL). 0 = auto (cores capped at 8),
    # 1 = sequential. Batches are identical for any thread count
    # (per-sample seeding).
    feed_threads: int = 0
    # Decoded-image cache budget (GiB), shared by the full-resolution and
    # resized caches; past it samples are decoded per use. <= 0 disables.
    cache_gb: float = 4.0
    # Recompute each top-level block's activations in the backward pass
    # (torch.utils.checkpoint): less activation memory for more compute.
    remat: bool = False
    # Activations and weight use in this dtype; master parameters, BN
    # statistics, head maps in the loss and the loss in float32.
    # "float32" trains in full precision.
    compute_dtype: str = "bfloat16"


# compute dtypes by their config names (DetectConfig.dtype,
# TrainConfig.compute_dtype)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; the CPU is
    used only when asked for. A CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
