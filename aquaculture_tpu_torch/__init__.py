"""PyTorch/CUDA port of aquaculture_tpu: the aq-detect and aq-pipeline slices
(tiles -> YOLOv5 -> class-aware NMS with a hand-written CUDA suppression
kernel -> labels, or -> geocode, download-box dedup, cage areas and the land
filter -> GeoJSON).

Imports torch, numpy, pandas and PIL only; nothing of JAX or of
aquaculture_tpu.
"""
