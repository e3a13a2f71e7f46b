"""Serving ops of the PyTorch port: letterbox, class-aware NMS (the CUDA
suppression kernel behind ``nms_cuda``), TTA and the int8 convolution.
Names are imported at first use (``_exports``). ``ops.nms`` and
``ops.letterbox`` are the submodules (their functions are ``ops.nms.nms``
and ``ops.letterbox.letterbox``), where the JAX package's eager import
leaves the functions under those names."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "letterbox": ("letterbox",),
    "nms": ("batched_nms", "batched_nms_feats", "nms"),
})
