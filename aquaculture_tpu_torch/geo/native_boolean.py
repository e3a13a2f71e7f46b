"""ctypes bindings for the C++ boolean-overlay sweep (csrc/booleanop.cc).

``csrc/booleanop.cc`` is the port's own copy of the JAX package's C++ port
of the lattice-snapped Martinez-Rueda sweep in :mod:`geo.boolean` (the
GEOS-equivalent component: the reference's overlay and unary_union run
inside GEOS; reference src/utils.py:241-273,
src/load_data/create_land_filter.py:129-137, src/utils_tonnage.py:617,1165).
Both engines take the same integer-lattice rings and give the same
contours (tests/test_torch_native_boolean.py).

The library is built at first use from that one source with ``g++ -O3
-fPIC -std=c++17 -Wall -shared`` (no image libraries: the source needs
none) into ``csrc/build/`` (listed in .gitignore), named by a hash of the
source and flags, written to a temporary file and moved into place, so
that concurrent processes never load a half-written library. A failed
build or load raises with the compiler's or loader's message; nothing
falls back to the Python sweep. ``geo.boolean`` chooses the engine
(``set_sweep_engine``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "booleanop.cc")
BUILD_DIR = os.path.join(_CSRC, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

# Sweeps run by the library since the last reset; chip_smoke.py zeroes it
# around cli.facilities to show which engine the overlay ran on.
sweeps = 0

_lib = None
_lock = threading.Lock()

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the C++ sweep cannot be built "
                           "(geo.boolean.set_sweep_engine('python') selects the Python sweep)")
    return cxx


def library_path(source: str = SOURCE, name: str = "libaq_booleanop", flags=CXX_FLAGS) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def compile_library(source: str = SOURCE, name: str = "libaq_booleanop", flags=CXX_FLAGS) -> str:
    """g++ ``source`` with ``flags`` into the build directory once per
    source hash (the library named ``name``); returns its path."""
    so = library_path(source, name, flags)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([find_cxx(), *flags, "-o", tmp, source], capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed to build {source} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def load_library(so: str) -> ctypes.CDLL:
    """Load a built library and declare its five C entry points."""
    lib = ctypes.CDLL(so)
    lib.aq_bool_op.restype = ctypes.c_void_p
    lib.aq_bool_op.argtypes = [
        _c_double_p, _c_int32_p, ctypes.c_int32,
        _c_double_p, _c_int32_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,
    ]
    lib.aq_bool_ncontours.restype = ctypes.c_int32
    lib.aq_bool_ncontours.argtypes = [ctypes.c_void_p]
    lib.aq_bool_contour.restype = ctypes.c_int32
    lib.aq_bool_contour.argtypes = [ctypes.c_void_p, ctypes.c_int32, _c_int32_p, _c_int32_p]
    lib.aq_bool_points.restype = ctypes.c_int32
    lib.aq_bool_points.argtypes = [ctypes.c_void_p, ctypes.c_int32, _c_double_p]
    lib.aq_bool_free.restype = None
    lib.aq_bool_free.argtypes = [ctypes.c_void_p]
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the sweep library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load_library(compile_library())
        return _lib


def _pack_rings(rings: Sequence[np.ndarray]):
    sizes = np.array([len(r) for r in rings], np.int32)
    if len(rings):
        xy = np.ascontiguousarray(np.concatenate([np.asarray(r, np.float64) for r in rings]))
    else:
        xy = np.zeros((0, 2), np.float64)
    return xy, sizes


def sweep_native(
    subject_rings: Sequence[np.ndarray],
    clipping_rings: Sequence[np.ndarray],
    operation: int,
    s_maxx: float,
    minmaxx: float,
) -> List[Tuple[np.ndarray, int]]:
    """Run the C++ sweep on lattice-snapped rings.

    Returns a list of (points (N,2) float64, hole_of) per output contour in
    creation order (hole_of = parent contour index, -1 for shells)."""
    global sweeps
    lib = build()
    sxy, ssz = _pack_rings(subject_rings)
    cxy, csz = _pack_rings(clipping_rings)
    handle = lib.aq_bool_op(
        sxy.ctypes.data_as(_c_double_p), ssz.ctypes.data_as(_c_int32_p), len(ssz),
        cxy.ctypes.data_as(_c_double_p), csz.ctypes.data_as(_c_int32_p), len(csz),
        operation, float(s_maxx), float(minmaxx),
    )
    sweeps += 1
    try:
        out: List[Tuple[np.ndarray, int]] = []
        npts = ctypes.c_int32()
        hole_of = ctypes.c_int32()
        for i in range(lib.aq_bool_ncontours(handle)):
            lib.aq_bool_contour(handle, i, ctypes.byref(npts), ctypes.byref(hole_of))
            pts = np.empty((npts.value, 2), np.float64)
            if npts.value:
                lib.aq_bool_points(handle, i, pts.ctypes.data_as(_c_double_p))
            out.append((pts, int(hole_of.value)))
        return out
    finally:
        lib.aq_bool_free(handle)
