"""Hand-written CUDA greedy NMS suppression, bound with ctypes.

Replaces the Pallas TPU kernel ``_suppress_kernel``
(aquaculture_tpu/ops/nms_pallas.py:33). The kernel (csrc/nms_suppress.cu)
runs one CTA per image and resolves the serial chain 32 candidates at a
time: in-block decisions as bit words, later candidates cleared by the
whole CTA, one barrier per 32-candidate word that has a live candidate, and
the ``iou > thr`` decision taken exactly without a division (the source's
header says more). Any K up to ``MAX_K``.
Its plain PyTorch counterpart is ``ops.nms.greedy_suppress_plain``; the
CPU tests use that one, and ``chip_smoke.py`` holds this kernel against it
on the card.

The library builds at first use with ``nvcc`` for ``sm_90a`` into
``csrc/build/`` (listed in .gitignore), named by a hash of the source and
flags so an edited source rebuilds. A failed build raises with nvcc's
stderr; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCE = os.path.join(_CSRC, "nms_suppress.cu")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
# Shared-memory budget of one CTA: the in-block row words and the alive and
# kept bitsets, 4.25 B per candidate (csrc kMaxK). Covers the whole P5 pool
# at 640 px (25,200 rows), not the whole P6 pool at 1280 px (102,000 rows):
# only --pre-topk > MAX_K reaches the limit, and there the plain version's
# (and the JAX package's off-TPU) K x K IoU matrix needs 41.6 GB per image.
MAX_K = 49152

# Kernel launches since the last reset; chip_smoke.py zeroes it around the
# main path to prove the path went through the kernel.
launches = 0

_lib = None
_lock = threading.Lock()


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str = _SOURCE) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libaq_nms_suppress_{digest}.so")


def compile_library(source: str = _SOURCE) -> str:
    """nvcc ``source`` into the build directory once per source hash;
    returns the shared library's path."""
    so = library_path(source)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, so)
    return so


def load_library(so: str) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(so)
    lib.aq_nms_suppress.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.aq_nms_suppress.restype = ctypes.c_int
    lib.aq_nms_max_k.argtypes = []
    lib.aq_nms_max_k.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = compile_library()
        lib = load_library(so)
        lib.aq_nms_max_staged_k.argtypes = []
        lib.aq_nms_max_staged_k.restype = ctypes.c_int
        if lib.aq_nms_max_k() != MAX_K:
            raise RuntimeError(
                f"{so}: kernel MAX_K {lib.aq_nms_max_k()} != wrapper MAX_K {MAX_K}"
            )
        _lib = lib
        return lib


def greedy_suppress_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float = 0.45
) -> torch.Tensor:
    """Batched greedy suppression on the card: boxes (B, K, 4) score-sorted
    xyxy float32, valid (B, K) bool, both contiguous CUDA tensors on one
    device -> keep (B, K) bool. Any K in [1, MAX_K]. Raises on anything
    else, CPU tensors included."""
    global launches
    if not (boxes.is_cuda and valid.is_cuda):
        raise ValueError(
            "greedy_suppress_cuda takes CUDA tensors; use "
            "ops.nms.greedy_suppress_plain for CPU tensors"
        )
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid; got {boxes.dtype}, {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"need boxes (B, K, 4) and valid (B, K); got {tuple(boxes.shape)}, {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    b, k = valid.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"K={k} outside [1, {MAX_K}] (the kernel's shared-memory budget): a pre-NMS "
            f"top-k above {MAX_K} (e.g. the whole 102,000-row P6 pool at 1280 px) is a limit "
            "of the port; there the plain version's K x K IoU matrix would take 41.6 GB per image"
        )
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    lib = build()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.aq_nms_suppress(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            b, k, float(iou_thresh), stream,
        )
    if err != 0:
        raise RuntimeError(f"aq_nms_suppress launch failed: cudaError {err}")
    launches += 1
    return keep
