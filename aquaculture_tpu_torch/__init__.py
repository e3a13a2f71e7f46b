"""PyTorch/CUDA port of aquaculture_tpu: the aq-detect slice (tiles -> YOLOv5 ->
class-aware NMS with a hand-written CUDA suppression kernel -> labels).

Imports torch, numpy and PIL only; nothing of JAX or of aquaculture_tpu.
"""
