"""Hand-written CUDA JPEG reconstruction kernels, bound with ctypes.

``csrc/jpeg_decode.cu`` holds two kernels for ``sm_90a``:
``jpeg_idct_kernel`` (dequantisation + libjpeg-turbo's integer IDCT at the
component's scaled size, into per-component planes) and
``jpeg_color_kernel`` (fancy chroma upsampling, YCbCr->RGB, the crop and
the tile grid, into the (B, T, T, 3) uint8 batch). They are not ports of a
TPU kernel: the JAX package decodes JPEG on host threads with libjpeg-turbo
(its tileloader.cc). The host keeps the entropy decode
(csrc/jpeg_entropy.cc, data/native_loader.py).

Each wrapper takes the descriptors of ``data.jpeg_plain.describe_batch``.
On CUDA tensors it launches its kernel on the current stream or raises; on
CPU tensors it runs the plain version (``idct_batch_plain``,
``color_batch_plain``), which the CPU tests use and ``chip_smoke.py`` holds
the kernels against. The library builds at first use with ``nvcc`` into
``csrc/build/``, named by a hash of the source and flags, as
``ops/nms_cuda.py`` builds its own; a failed build raises with nvcc's
output.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from aquaculture_tpu_torch.data.jpeg_plain import (
    COMP_INTS, IMAGE_INTS, TILE_INTS, color_batch_plain, idct_batch_plain)
from aquaculture_tpu_torch.ops import nms_cuda

SOURCE = os.path.join(nms_cuda._CSRC, "jpeg_decode.cu")

# Kernel launches since the last reset; chip_smoke.py zeroes them around
# the main path to show that it went through the kernels.
idct_launches = 0
color_launches = 0
# jpeg_idct_kernel's grid has one y row per component; CUDA caps gridDim.y
MAX_GRID_Y = 65535

_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            so = nms_cuda.compile_library(SOURCE, "libaq_jpeg_decode")
            lib = ctypes.CDLL(so)
            lib.aq_jpeg_idct.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
            lib.aq_jpeg_idct.restype = ctypes.c_int
            lib.aq_jpeg_color.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
            lib.aq_jpeg_color.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, the batch on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def jpeg_idct(coef: torch.Tensor, qt: torch.Tensor, comps: torch.Tensor, plane_bytes: int,
              max_blocks: int) -> torch.Tensor:
    """Dequantise and inverse-DCT every component of a batch: coef int16
    coefficients, qt int32 (64 per component), comps int32 (n, 8) ->
    planes, a uint8 buffer of plane_bytes on coef's device."""
    global idct_launches
    dev = coef.device
    _check("coef", coef, torch.int16, dev)
    _check("qt", qt, torch.int32, dev)
    _check("comps", comps, torch.int32, dev)
    if comps.dim() != 2 or comps.shape[1] != COMP_INTS:
        raise ValueError(f"comps must be (n, {COMP_INTS}); got {tuple(comps.shape)}")
    if dev.type == "cpu":
        return idct_batch_plain(coef, qt, comps, plane_bytes)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_idct runs on CUDA or the CPU; got {dev}")
    planes = torch.empty(plane_bytes, dtype=torch.uint8, device=dev)
    n = comps.shape[0]
    if n == 0:
        return planes
    lib = build()
    if n > MAX_GRID_Y:
        raise ValueError(f"{n} components in one batch; the kernel's grid takes {MAX_GRID_Y}")
    with torch.cuda.device(dev):
        err = lib.aq_jpeg_idct(coef.data_ptr(), qt.data_ptr(), comps.data_ptr(), n, max_blocks,
                               planes.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"aq_jpeg_idct launch failed: cudaError {err}")
    idct_launches += 1
    return planes


def jpeg_color(planes: torch.Tensor, comps: torch.Tensor, images: torch.Tensor, tiles: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """Upsample, colour-convert and slice a batch's planes into ``out``
    (n_slots, TH, TW, 3) uint8, in place: each decoded slot gets its tile,
    zero slots zeros, caller slots (TILE_CALLER) are left untouched."""
    global color_launches
    dev = out.device
    _check("planes", planes, torch.uint8, dev)
    for name, t, width in (("comps", comps, COMP_INTS), ("images", images, IMAGE_INTS),
                           ("tiles", tiles, TILE_INTS)):
        _check(name, t, torch.int32, dev)
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name} must be (n, {width}); got {tuple(t.shape)}")
    _check("out", out, torch.uint8, dev)
    if out.dim() != 4 or out.shape[3] != 3 or out.shape[0] != tiles.shape[0]:
        raise ValueError(f"out must be ({tiles.shape[0]}, TH, TW, 3); got {tuple(out.shape)}")
    if dev.type == "cpu":
        return color_batch_plain(planes, comps, images, tiles, out)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_color runs on CUDA or the CPU; got {dev}")
    n, th, tw = out.shape[:3]
    if n * th * tw == 0:
        return out
    lib = build()
    with torch.cuda.device(dev):
        err = lib.aq_jpeg_color(planes.data_ptr(), comps.data_ptr(), images.data_ptr(), tiles.data_ptr(),
                                n, th, tw, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"aq_jpeg_color launch failed: cudaError {err}")
    color_launches += 1
    return out
