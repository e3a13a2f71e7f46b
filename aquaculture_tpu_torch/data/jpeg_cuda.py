"""The hand-written CUDA JPEG reconstruction kernel, bound with ctypes.

``csrc/jpeg_decode.cu`` holds one kernel for ``sm_90a``,
``jpeg_decode_kernel``: dequantisation + libjpeg-turbo's integer IDCT at
each component's scaled size, chroma upsampling (fancy, or a box of 1 to 4
a side), the conversion to RGB (YCbCr, grey, or RGB-coded components
copied), the crop and the tile grid, fused, into the (B, TH, TW, 3) uint8 batch, with the
component planes kept in shared memory (never in device memory); one
instantiation per scale N/8 (N = 1..8) holds that scale's IDCTs. It is not
a port of a TPU kernel: the JAX package decodes JPEG on host threads with
libjpeg-turbo (its tileloader.cc). The host keeps the entropy decode
(csrc/jpeg_entropy.cc, data/native_loader.py).

``jpeg_decode`` takes the descriptors and the layout of
``data.jpeg_plain.describe_batch``.
On CUDA tensors it launches the kernel on the current stream or raises; on
CPU tensors it runs the plain version (``decode_batch_plain``), which the
CPU tests use and ``chip_smoke.py`` holds the kernel against. The library
builds at first use with ``nvcc`` into ``csrc/build/``, named by a hash of
the source and flags, as ``ops/nms_cuda.py`` builds its own; a failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from aquaculture_tpu_torch.data.jpeg_plain import (
    COMP_INTS, IMAGE_INTS, RING_PITCH, RING_ROWS, RING_SLACK, STRIPE_W, TILE_INTS, BatchLayout,
    decode_batch_plain, decode_grid)
from aquaculture_tpu_torch.ops import nms_cuda

SOURCE = os.path.join(nms_cuda._CSRC, "jpeg_decode.cu")

# Kernel launches since the last reset; chip_smoke.py zeroes it around the
# main path to show that it went through the kernel.
decode_launches = 0
# the grid's y axis is the batch's slots; CUDA caps gridDim.y
MAX_GRID_Y = 65535
ATTRIBUTES = ("registers", "shared_bytes", "local_bytes", "threads", "ctas_per_sm")

_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library; its
    geometry must be ``jpeg_plain``'s."""
    global _lib
    with _lock:
        if _lib is None:
            so = nms_cuda.compile_library(SOURCE, "libaq_jpeg_decode")
            lib = ctypes.CDLL(so)
            lib.aq_jpeg_decode.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
            lib.aq_jpeg_decode.restype = ctypes.c_int
            lib.aq_jpeg_geometry.argtypes = [ctypes.c_void_p]
            lib.aq_jpeg_geometry.restype = None
            lib.aq_jpeg_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.aq_jpeg_attributes.restype = ctypes.c_int
            geo, want = (ctypes.c_int * 4)(), (STRIPE_W, RING_ROWS, RING_PITCH, RING_SLACK)
            lib.aq_jpeg_geometry(geo)
            if tuple(geo) != want:
                raise RuntimeError(f"{so}: kernel geometry {tuple(geo)} != jpeg_plain's {want}")
            _lib = lib
        return _lib


def attributes(scale: int = 8) -> dict:
    """The scale/8 kernel's registers per thread, static shared memory per
    CTA, local (spill) bytes per thread, threads per CTA and resident CTAs
    per SM on the current card (cudaFuncGetAttributes)."""
    vals = (ctypes.c_int * len(ATTRIBUTES))()
    err = build().aq_jpeg_attributes(scale, vals)
    if err != 0:
        raise RuntimeError(f"aq_jpeg_attributes failed: cudaError {err}")
    return dict(zip(ATTRIBUTES, vals))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, the batch on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def jpeg_decode(coef: torch.Tensor, qt: torch.Tensor, comps: torch.Tensor, images: torch.Tensor,
                tiles: torch.Tensor, out: torch.Tensor, lay: Optional[BatchLayout] = None) -> torch.Tensor:
    """Decode a batch into ``out`` (n_slots, TH, TW, 3) uint8, in place:
    coef int16 coefficients, qt int32 (64 per component), comps, images and
    tiles int32 descriptors. Each decoded slot gets its tile, zero slots
    zeros; caller slots (TILE_CALLER) are left untouched. ``lay``, the
    batch's ``BatchLayout``, picks the kernel of its scale and the grid's
    band unit; CUDA tensors need it, the plain version does not."""
    global decode_launches
    dev = out.device
    _check("coef", coef, torch.int16, dev)
    _check("qt", qt, torch.int32, dev)
    for name, t, width in (("comps", comps, COMP_INTS), ("images", images, IMAGE_INTS),
                           ("tiles", tiles, TILE_INTS)):
        _check(name, t, torch.int32, dev)
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name} must be (n, {width}); got {tuple(t.shape)}")
    _check("out", out, torch.uint8, dev)
    if out.dim() != 4 or out.shape[3] != 3 or out.shape[0] != tiles.shape[0]:
        raise ValueError(f"out must be ({tiles.shape[0]}, TH, TW, 3); got {tuple(out.shape)}")
    if dev.type == "cpu":
        return decode_batch_plain(coef, qt, comps, images, tiles, out)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_decode runs on CUDA or the CPU; got {dev}")
    n, th, tw = out.shape[:3]
    if n * th * tw == 0:
        return out
    if n > MAX_GRID_Y:
        raise ValueError(f"{n} slots in one batch; the kernel's grid takes {MAX_GRID_Y}")
    if lay is None:
        raise ValueError("jpeg_decode on CUDA tensors needs the batch's BatchLayout (describe_batch)")
    _, band_rows = decode_grid(n, th, tw, lay)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.aq_jpeg_decode(coef.data_ptr(), qt.data_ptr(), comps.data_ptr(), images.data_ptr(),
                                 tiles.data_ptr(), n, th, tw, band_rows, lay.scale, out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"aq_jpeg_decode launch failed: cudaError {err}")
    decode_launches += 1
    return out
