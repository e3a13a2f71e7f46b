"""PyTorch/CUDA port of aquaculture_tpu: the aq-detect and aq-pipeline slices
(tiles -> YOLOv5 -> class-aware NMS with a hand-written CUDA suppression
kernel -> labels, or -> geocode, download-box dedup, cage areas and the land
filter -> GeoJSON), the aq-train slice (YOLO-format data -> augmentation
-> YOLOv5 training with grouped SGD and EMA -> checkpoints), and their
multi-process forms over torch.distributed (aq-pod: corpus shards, chunk
manifests and one gathered GeoJSON, from files or an object store;
cli.train --mesh: data- and model-parallel training), and the tonnage
path (aq-facilities -> aq-tonnage: the polygon overlay engine, facilities
per imagery pass, and the Monte-Carlo tonnage bootstrap on the GPU),
among others.

Imports torch, numpy, pandas, PIL and (in the augmentation) OpenCV only;
nothing of JAX or of aquaculture_tpu.
"""

from aquaculture_tpu_torch._exports import lazy_exports

__version__ = "0.1.0"

lazy_exports(globals(), {
    "config": ("CRS_AREA", "CRS_LATLON", "CRS_MAPPING", "IM_HEIGHT", "IM_WIDTH", "LARGE_TIF_SIZE"),
})
