"""PyTorch/CUDA port of aquaculture_tpu: the aq-detect and aq-pipeline slices
(tiles -> YOLOv5 -> class-aware NMS with a hand-written CUDA suppression
kernel -> labels, or -> geocode, download-box dedup, cage areas and the land
filter -> GeoJSON) and the aq-train slice (YOLO-format data -> augmentation
-> YOLOv5 training with grouped SGD and EMA -> checkpoints).

Imports torch, numpy, pandas, PIL and (in the augmentation) OpenCV only;
nothing of JAX or of aquaculture_tpu.
"""
