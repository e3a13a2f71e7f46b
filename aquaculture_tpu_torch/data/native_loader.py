"""The device tile loader: JPEG entropy decode and TIFF reading on host
threads, the rest of the JPEG decode in a hand-written kernel on the card.

Counterpart of aquaculture_tpu/data/native_loader.py with
the C++ tileloader.cc beside it, split another way. The JAX package decodes whole
JPEGs on a C++ thread pool with libjpeg-turbo; the port's hosts have no
libjpeg, and on a card the parallel half belongs on the card:
- ``csrc/jpeg_entropy.cc`` (g++, ctypes) parses the markers and
  entropy-decodes each JPEG (sequential in one scan or several, and
  progressive, Huffman or arithmetic) on a thread pool into de-zigzagged,
  still-quantised int16 coefficients (at scale only the coefficients each
  block's scaled IDCT reads), ahead of the consumer and handed out in path
  order;
- the coefficients go into a pinned staging slot, are copied to the card
  ``non_blocking``, and ``data/jpeg_cuda.py``'s fused kernel dequantises,
  inverse-transforms, upsamples, colour-converts and slices the tile grid
  straight into the (B, T, T, 3) uint8 batch on the card, once per batch. Two slots, each guarded by a CUDA
  event: a slot is refilled only after its copy has finished;
- on ``device="cpu"`` the same coefficients go through the plain version
  (``data/jpeg_plain.py``);
- ``csrc/tiff_decode.cc`` (built into the same library) reads TIFFs on the
  same threads, without libtiff, giving the pixels of libtiff's RGBA
  interface (``TIFFReadRGBAImageOriented`` at ORIENTATION_TOPLEFT, the JAX
  package's tileloader.cc): classic and BigTIFF, strips and tiles, none,
  LZW, Deflate, PackBits, WebP (``csrc/webp_decode.cc``: lossy VP8,
  lossless VP8L and ALPH alpha, libwebp's pixels), NeXT, ThunderScan,
  PixarLog and SGILog (``csrc/tiff_legacy.cc``) and JBIG
  (``csrc/jbig_decode.cc``: jbigkit's decoder) decoded there into RGB,
  which goes to the card in one copy from a pinned buffer and is cut into
  tiles there; JPEG strips
  or tiles (compression 7) as entropy-decoded segments, decoded on the card
  by the same kernel into the raster that the tiles are cut from (a
  segment that fails, or whose stream is smaller than it, shows libtiff's
  segment buffer as the segments before left it).
The pixels are libjpeg-turbo's, byte for byte, at every N/8 from 1/8 to
8/8 (the decode-at-scale of ``detect_files(decode_scale=True)``: the
DCT-domain scaled IDCT, not a resize), as the JAX package's native loader
gives them.

Files are routed by content, from their markers and tags, never by
catching an error: every JPEG that libjpeg-turbo 2.1.5 decodes (baseline,
extended, progressive and multi-scan sequential, Huffman or arithmetic,
grey, YCbCr or RGB-coded, sampling factors 1..4) goes to the card; a TIFF
at full size goes through the reader ("tiff"), its JPEG segments through
the kernel ("tiff_jpeg"), and a TIFF in a compression the reader does not
decode (CCITT, old JPEG, LZMA, ZSTD, LERC, and JBIG of several resolution
layers or planes) or a JPEG layout the kernel does not take through PIL on
a host pool with libtiff's RGBA semantics
(``data/geotiff.read_tiff_rgba``, "pil"); at scale every TIFF takes the
Python loader's PIL resize ("pil_resize"), as the JAX module routes
non-JPEG files; a JPEG that libjpeg refuses (12-bit, CMYK, lossless,
hierarchical, fractional sampling), a TIFF that libtiff's RGBA interface
refuses (32-bit or float samples, ...), a file that is neither JPEG nor
TIFF, or one whose markers do not parse is skipped, as the JAX package's
loader skips it. ``counts`` says how many files took each route
(``ROUTES``).

Tile order is deterministic: files in path order, each raster's tiles
x-major (the JAX native loader's order varies from run to run). The grid is
tileloader.cc's: a side no longer than a tile gives one zero-padded tile.

Scales: every N/8, N = 1..8 (``SCALES``), as libjpeg's scale_num / 8.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aquaculture_tpu_torch.config import IM_WIDTH, resolve_device
from aquaculture_tpu_torch.data import jpeg_cuda
from aquaculture_tpu_torch.data.filenames import TileSpec, decode_tile_name
from aquaculture_tpu_torch.data.geotiff import read_image, read_tiff_rgba
from aquaculture_tpu_torch.data.jpeg_plain import (
    KIND_BASELINE, KIND_REFUSED, KIND_TIFF, KIND_UNREADABLE, M_COEFS, M_HEIGHT, M_KIND,  # noqa: F401 (kinds re-exported)
    M_OUT_H, M_OUT_W, M_SOURCE, M_WIDTH, META_INTS, T_ACROSS, T_FLIP, T_ROUTE, T_SEG_H, T_SEG_W, T_SEGMENTS,
    T_TILED, TIFF_JPEG, TIFF_PIL, TIFF_RASTER, TILE_CALLER, TILE_DECODED, TILE_ZERO,
    EntropyImage, describe_batch, kept, reconstruct_plain, tile_grid, unpack_batch)
from aquaculture_tpu_torch.data.loader import TileBatch, _emit_tiles
from aquaculture_tpu_torch.geo import native_boolean

SOURCE = os.path.join(native_boolean._CSRC, "jpeg_entropy.cc")
TIFF_SOURCES = tuple(os.path.join(native_boolean._CSRC, f)
                     for f in ("tiff_decode.cc", "tiff_decode.h", "webp_decode.cc", "webp_decode.h", "tiff_legacy.cc",
                               "tiff_legacy.h", "jbig_decode.cc", "jbig_decode.h", "zstd_decode.cc", "zstd_decode.h",
                               "lerc_decode.cc", "lerc_decode.h"))
# no FMA contraction: the TIFF reader's colour conversions are libtiff's
# float arithmetic, operation by operation
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread", "-ffp-contract=off")
SCALES = tuple(range(1, 9))  # the N of the N/8 scales the kernel decodes at
ROUTES = ("device", "tiff", "tiff_jpeg", "pil", "pil_resize", "skipped")
RASTER_SLOT_BYTES = 6144 * 6144 * 3  # a pinned raster slot holds one 6144 px RGB download

_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the entropy decoder. A
    failed build raises with g++'s output."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native_boolean.compile_library((SOURCE, *TIFF_SOURCES), "libaq_jpeg_entropy",
                                                             CXX_FLAGS))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.aq_jpeg_meta_ints.argtypes, lib.aq_jpeg_meta_ints.restype = [], i32
            lib.aq_jpeg_probe.argtypes, lib.aq_jpeg_probe.restype = [ctypes.c_char_p, i32, vp], i32
            lib.aq_jpeg_decode.argtypes = [ctypes.c_char_p, i32, vp, vp, ctypes.c_long]
            lib.aq_jpeg_decode.restype = i32
            lib.aq_jpeg_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32, i32, i32, i32]
            lib.aq_jpeg_loader_create.restype = vp
            lib.aq_jpeg_loader_peek.argtypes, lib.aq_jpeg_loader_peek.restype = [vp, vp, vp], i32
            lib.aq_jpeg_loader_pop.argtypes = [vp, vp, ctypes.c_long]
            lib.aq_jpeg_loader_pop.restype = i32
            lib.aq_jpeg_loader_pop_pixels.argtypes = [vp, vp, ctypes.c_long]
            lib.aq_jpeg_loader_pop_pixels.restype = i32
            lib.aq_jpeg_loader_segments.argtypes, lib.aq_jpeg_loader_segments.restype = [vp, vp, i32], i32
            lib.aq_jpeg_loader_meta.argtypes, lib.aq_jpeg_loader_meta.restype = [vp, i32, vp], i32
            lib.aq_tiff_codec.argtypes = [i32, vp, ctypes.c_long, vp, ctypes.c_long]
            lib.aq_tiff_codec.restype = i32
            lib.aq_jpeg_loader_destroy.argtypes, lib.aq_jpeg_loader_destroy.restype = [vp], None
            if lib.aq_jpeg_meta_ints() != META_INTS:
                raise RuntimeError(f"{SOURCE}: {lib.aq_jpeg_meta_ints()} metadata ints, the wrapper {META_INTS}")
            _lib = lib
        return _lib


def available() -> bool:
    """True once the entropy decoder is built (building it if needed); a
    failed build raises, it never answers False."""
    return build() is not None


def supports_scaled() -> bool:
    """Decode-at-scale is built in (at the scales of ``SCALES``)."""
    return available()


def check_scale(out_tile: int, tile: int = IM_WIDTH) -> int:
    """The N of an N/8 decode that gives ``out_tile`` px tiles from
    ``tile`` px ones (8 for out_tile 0); raises ValueError unless out_tile
    is a proper N/8 fraction of tile."""
    if not out_tile:
        return 8
    if out_tile >= tile or (8 * out_tile) % tile != 0:
        raise ValueError(f"out_tile must be a proper N/8 fraction of tile; got {out_tile}/{tile}")
    return 8 * out_tile // tile


def probe(path: str, scale_n: int = 8) -> np.ndarray:
    """A file's metadata at scale_n/8 (``jpeg_plain``'s layout; M_KIND says
    how it is routed, and a TIFF's T_ROUTE how it is read), read from its
    header (a TIFF's from its tags and its JPEG segments' headers)."""
    meta = np.zeros(META_INTS, np.int32)
    build().aq_jpeg_probe(os.fsencode(path), scale_n, meta.ctypes.data)
    return meta


def entropy_decode(path: str, scale_n: int = 8) -> Optional[EntropyImage]:
    """The host half alone: the coefficients and metadata of a JPEG the
    entropy decoder takes (M_KIND KIND_BASELINE) at scale_n/8, None for
    any other file (and for a one-scan JPEG whose markers after its scan
    libjpeg refuses, which only the decode reads)."""
    lib = build()
    meta = probe(path, scale_n)
    if meta[M_KIND] != KIND_BASELINE:
        return None
    coef = np.empty(max(int(meta[M_COEFS]), 1), np.int16)
    kind = lib.aq_jpeg_decode(os.fsencode(path), scale_n, meta.ctypes.data, coef.ctypes.data, coef.size)
    if kind != KIND_BASELINE:
        return None
    return EntropyImage(meta, torch.from_numpy(coef[:int(meta[M_COEFS])]))


def _reconstruct(image: EntropyImage, dev: torch.device) -> torch.Tensor:
    """A whole image's (H, W, 3) uint8 pixels on ``dev``: the kernel on
    CUDA, its plain version on the CPU."""
    if dev.type == "cpu":
        return reconstruct_plain(image)
    h, w = image.out_height, image.out_width
    packed, lay = describe_batch([image.meta], [0], [(TILE_DECODED, 0, 0, 0)])
    qt, comps, images, tiles = unpack_batch(torch.from_numpy(packed).to(dev), lay)
    out = torch.empty((1, h, w, 3), dtype=torch.uint8, device=dev)
    return jpeg_cuda.jpeg_decode(image.coef.to(dev), qt, comps, images, tiles, out, lay)[0]


class _Staging:
    """Pinned host buffers that TIFF rasters and JPEG segments' coefficients
    pass through on their way to the card, one copy each: two, used in
    turn, each refilled only after the event of its last copy; at least
    ``floor`` bytes each, so that a corpus of equal rasters pins once. On
    the CPU each file gets a buffer of its own."""

    def __init__(self, dev: torch.device, floor: int = 0):
        self.dev, self.floor = dev, floor
        self.bufs: list = [None, None]
        self.events: list = [None, None]
        self.k = 0

    def stage(self, nbytes: int, fill) -> torch.Tensor:
        """``fill(ptr)`` writes nbytes at ptr (0 on success); the bytes as a
        uint8 tensor on the device."""
        if self.dev.type != "cuda":
            buf = torch.empty(nbytes, dtype=torch.uint8)
            if fill(buf.data_ptr()) != 0:
                raise RuntimeError("the loader refused to hand out a decoded TIFF")
            return buf
        k, self.k = self.k, self.k ^ 1
        if self.events[k] is not None:
            self.events[k].synchronize()
        if self.bufs[k] is None or self.bufs[k].numel() < nbytes:
            self.bufs[k] = None
            self.bufs[k] = torch.empty(max(nbytes, self.floor), dtype=torch.uint8, pin_memory=True)
        if fill(self.bufs[k].data_ptr()) != 0:
            raise RuntimeError("the loader refused to hand out a decoded TIFF")
        with torch.cuda.device(self.dev):
            out = self.bufs[k][:nbytes].to(self.dev, non_blocking=True)
            self.events[k] = torch.cuda.Event()
            self.events[k].record()
        return out


def segment_slots(metas: np.ndarray) -> Tuple[List[int], List[int], List[Tuple[int, int, int, int]]]:
    """How a JPEG-compressed TIFF's segments go through the kernel: (the
    segments that decoded, where the coefficients of each start, one slot
    per segment: the decode of its M_SOURCE)."""
    src = metas[:, M_SOURCE]
    starts = np.concatenate([[0], np.cumsum(metas[:, M_COEFS].astype(np.int64))[:-1]])
    decoded = np.flatnonzero(src == np.arange(len(metas))).tolist()
    image = {s: i for i, s in enumerate(decoded)}
    tiles = [(TILE_DECODED, image[s], 0, 0) for s in src.tolist()]
    return decoded, [int(starts[s]) for s in decoded], tiles


def _segments_raster(coef: torch.Tensor, metas: np.ndarray, meta: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A JPEG-compressed TIFF's (H, W, 3) pixels from its segments'
    coefficients: every strip or tile one slot of one kernel launch (its
    plain version on the CPU), of the segment's size, holding libtiff's
    segment buffer after it: the decode of its M_SOURCE, and where a stream
    is smaller than its slot, the slot before it (zeros before the first)
    past the stream; the slots laid side by side and cropped to the
    image."""
    n, sh, sw = int(meta[T_SEGMENTS]), int(meta[T_SEG_H]), int(meta[T_SEG_W])
    decoded, offs, tiles = segment_slots(metas)
    packed, lay = describe_batch([metas[s] for s in decoded], offs, tiles)
    qt, comps, images, tiles = unpack_batch(torch.from_numpy(packed).to(dev), lay)
    out = torch.empty((n, sh, sw, 3), dtype=torch.uint8, device=dev)
    jpeg_cuda.jpeg_decode(coef, qt, comps, images, tiles, out, lay)
    partial = set()  # the slots that differ from their source's decode
    for s, src in enumerate(metas[:, M_SOURCE].tolist()):
        if src != s:
            if src in partial:
                out[s] = out[src]
                partial.add(s)
            continue
        w, h = int(metas[s, M_WIDTH]), int(metas[s, M_HEIGHT])
        if w < sw or h < sh:
            below = out[s - 1] if s else torch.zeros_like(out[0])
            out[s, h:] = below[h:]
            out[s, :h, w:] = below[:h, w:]
            partial.add(s)
    if meta[T_TILED]:
        across = int(meta[T_ACROSS])
        out = out.view(n // across, across, sh, sw, 3).permute(0, 2, 1, 3, 4).reshape(n // across * sh,
                                                                                    across * sw, 3)
    else:
        out = out.view(n * sh, sw, 3)
    return out[:int(meta[M_HEIGHT]), :int(meta[M_WIDTH])]


def _segment_metas(lib, handle, meta: np.ndarray) -> np.ndarray:
    segs = int(meta[T_SEGMENTS])
    metas = np.empty((segs, META_INTS), np.int32)
    if lib.aq_jpeg_loader_segments(handle, metas.ctypes.data, segs) != segs:
        raise RuntimeError("aq_jpeg_loader_segments refused a peeked TIFF")
    return metas


def _tiff_raster(lib, handle, meta: np.ndarray, stage: _Staging) -> torch.Tensor:
    """Pop the peeked TIFF (T_ROUTE TIFF_RASTER or TIFF_JPEG) as its (H,
    W, 3) uint8 pixels on the staging device, the orientation's flips
    applied."""
    h, w = int(meta[M_HEIGHT]), int(meta[M_WIDTH])
    if meta[T_ROUTE] == TIFF_RASTER:
        raster = stage.stage(h * w * 3, lambda ptr: lib.aq_jpeg_loader_pop_pixels(handle, ptr, h * w * 3))
        raster = raster.view(h, w, 3)
    else:
        metas = _segment_metas(lib, handle, meta)
        n = int(meta[M_COEFS])
        coef = stage.stage(2 * n, lambda ptr: lib.aq_jpeg_loader_pop(handle, ptr, n)).view(torch.int16)
        raster = _segments_raster(coef, metas, meta, stage.dev)
    flips = [d for bit, d in ((2, 0), (1, 1)) if meta[T_FLIP] & bit]
    return raster.flip(flips) if flips else raster


@contextlib.contextmanager
def _one_file(path: str):
    """A loader over one file at 8/8 on one thread: (lib, handle, the
    peeked file's metadata)."""
    lib = build()
    handle = lib.aq_jpeg_loader_create((ctypes.c_char_p * 1)(os.fsencode(path)), 1, 8, 1, 1)
    try:
        meta = np.zeros(META_INTS, np.int32)
        idx = ctypes.c_int32()
        if lib.aq_jpeg_loader_peek(handle, meta.ctypes.data, ctypes.byref(idx)) != 1:
            raise RuntimeError(f"the loader handed out nothing for {path}")
        yield lib, handle, meta
    finally:
        lib.aq_jpeg_loader_destroy(handle)


def read_tiff(path: str, device="cuda") -> Optional[torch.Tensor]:
    """A TIFF's (H, W, 3) uint8 pixels on ``device`` as libtiff's RGBA
    interface gives them: through the reader (JPEG segments through the
    kernel, or its plain version on the CPU), through PIL for a
    compression the reader does not decode; None for a TIFF that libtiff
    refuses or a file that is not a TIFF."""
    dev = resolve_device(device)
    with _one_file(path) as (lib, handle, meta):
        if meta[M_KIND] != KIND_TIFF:
            return None
        if meta[T_ROUTE] in (TIFF_RASTER, TIFF_JPEG):
            return _tiff_raster(lib, handle, meta, _Staging(dev)).contiguous()
    return torch.from_numpy(read_tiff_rgba(path)).to(dev) if meta[T_ROUTE] == TIFF_PIL else None


def tiff_segments(path: str) -> Optional[Tuple[np.ndarray, np.ndarray, torch.Tensor]]:
    """A JPEG-compressed TIFF's segments as the loader hands them to the
    kernel: (the file's metadata, each segment's (n, META_INTS), their
    int16 coefficients back to back on the CPU); None for a file that does
    not take that route."""
    with _one_file(path) as (lib, handle, meta):
        if meta[M_KIND] != KIND_TIFF or meta[T_ROUTE] != TIFF_JPEG:
            return None
        metas = _segment_metas(lib, handle, meta)
        coef = torch.empty(int(meta[M_COEFS]), dtype=torch.int16)
        if lib.aq_jpeg_loader_pop(handle, coef.data_ptr(), coef.numel()) != 0:
            raise RuntimeError("aq_jpeg_loader_pop refused a peeked TIFF")
        return meta, metas, coef


def decode_image(path: str, device="cuda") -> Optional[torch.Tensor]:
    """Decode one JPEG or TIFF at full size -> (H, W, 3) uint8 on
    ``device`` (a TIFF as libtiff's RGBA interface gives it, ``read_tiff``);
    None for a file the loader skips."""
    dev = resolve_device(device)
    image = entropy_decode(path, 8)
    if image is not None:
        return _reconstruct(image, dev)
    return read_tiff(path, dev)


def scale_for(width: int, height: int, target: int) -> int:
    """tileloader.cc's rule: the largest N/8 whose longer side stays >=
    target (8 when target <= 0 or the image is no larger)."""
    full = max(width, height)
    if target <= 0 or full <= target:
        return 8
    return max(1, min(8, (8 * target + full - 1) // full))


def decode_image_scaled(path: str, target: int, device="cuda") -> Optional[torch.Tensor]:
    """Decode with a DCT-domain downscale: a JPEG at the largest N/8 scale
    whose longer side stays >= target (``scale_for``), on the card (or
    its plain version on the CPU); a TIFF at full size, as in the JAX
    package. None for a file the loader skips."""
    dev = resolve_device(device)
    meta = probe(path)
    kind = meta[M_KIND]
    if kind == KIND_TIFF:
        return read_tiff(path, dev)
    if kind != KIND_BASELINE:
        return None
    image = entropy_decode(path, scale_for(int(meta[M_WIDTH]), int(meta[M_HEIGHT]), target))
    return None if image is None else _reconstruct(image, dev)


# ---------------------------------------------------------------- batches

def coefs_per_tile(tile: int, scale_n: int) -> int:
    """int16 coefficients of one 4:2:0 tile at scale_n/8 (luma IDCTs of
    scale_n, chroma of 2 * scale_n up to 8, each keeping ``kept`` a
    side): the staging slots' first size (they grow for other samplings)."""
    k_luma, k_chroma = kept(scale_n), kept(min(2 * scale_n, 8) if scale_n < 8 else 8)
    return (tile // 8) ** 2 * k_luma ** 2 + 2 * (tile // 16) ** 2 * k_chroma ** 2


class _Slot:
    """One staging slot: the coefficients of a batch's images and the
    packed descriptors, pinned on a CUDA loader, and the event recorded
    after their copy to the card."""

    def __init__(self, cap: int, pinned: bool):
        self.pinned = pinned
        self.coef = torch.empty(cap, dtype=torch.int16, pin_memory=pinned)
        self.desc = torch.empty(4096, dtype=torch.int32, pin_memory=pinned)
        self.event = None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def grow(self, used: int, need: int) -> None:
        """Room for ``need`` more coefficients after ``used`` (only while
        the slot is being filled, after ``wait``)."""
        if used + need > self.coef.numel():
            new = torch.empty(max(2 * self.coef.numel(), used + need), dtype=torch.int16,
                              pin_memory=self.pinned)
            new[:used] = self.coef[:used]
            self.coef = new


class _Staged:
    """Where one decoded image's coefficients sit: slot, offset, batch."""

    __slots__ = ("meta", "slot", "off", "n", "batch")

    def __init__(self, meta, slot, off, n, batch):
        self.meta, self.slot, self.off, self.n, self.batch = meta, slot, off, n, batch


class _RasterTile:
    """One tile of a raster already on the batch's device (a TIFF through
    the reader): its origin in the raster."""

    __slots__ = ("raster", "x", "y")

    def __init__(self, raster: torch.Tensor, x: int, y: int):
        self.raster, self.x, self.y = raster, x, y


class _Batcher:
    """Fills staging slots image by image and emits fixed-shape batches:
    the coefficients of every image with a tile in the batch (an image
    whose tiles straddle two batches is staged in both), the tile slots,
    the pixels of routed files and the tiles of rasters on the device."""

    def __init__(self, dev: torch.device, batch_size: int, eff: int, cap: int):
        self.dev, self.b, self.eff = dev, batch_size, eff
        cuda = dev.type == "cuda"
        self.slots = [_Slot(cap, cuda) for _ in range(2 if cuda else 1)]
        self.k = 0
        self.slot = self.slots[0]
        self.used = 0
        self.group: List[_Staged] = []
        self.entries: list = []

    def stage(self, meta: np.ndarray, pop) -> _Staged:
        """Copy one image's coefficients into the slot (``pop(ptr, cap)``
        writes them)."""
        n = int(meta[M_COEFS])
        self.slot.grow(self.used, n)
        ptr = self.slot.coef.data_ptr() + 2 * self.used
        if pop(ptr, n) != 0:
            raise RuntimeError("aq_jpeg_loader_pop refused a staged image")
        return self._place(_Staged(meta, None, 0, n, 0))

    def _place(self, st: _Staged) -> _Staged:
        st.slot, st.off, st.batch = self.slot, self.used, self.k
        self.used += st.n
        self.group.append(st)
        return st

    def _restage(self, st: _Staged) -> None:
        src = st.slot.coef[st.off:st.off + st.n].clone()  # one CPU slot: the source is overwritten
        self.slot.grow(self.used, st.n)
        self.slot.coef[self.used:self.used + st.n] = src
        self._place(st)

    def add(self, entry, spec: TileSpec) -> Iterator[TileBatch]:
        """Add one tile: (staged image, x, y), a routed file's pixels or a
        ``_RasterTile``."""
        if isinstance(entry, tuple) and entry[0].batch != self.k:
            self._restage(entry[0])
        self.entries.append((entry, spec))
        if len(self.entries) == self.b:
            yield self._emit()

    def flush(self) -> Iterator[TileBatch]:
        if self.entries:
            yield self._emit()

    def _emit(self) -> TileBatch:
        index = {id(st): j for j, st in enumerate(self.group)}
        tiles, specs, caller = [], [], []
        for s, (e, spec) in enumerate(self.entries):
            if isinstance(e, tuple):
                tiles.append((TILE_DECODED, index[id(e[0])], e[1], e[2]))
            else:
                tiles.append((TILE_CALLER, 0, 0, 0))
                caller.append((s, e))
            specs.append(spec)
        n = len(self.entries)
        tiles += [(TILE_ZERO, 0, 0, 0)] * (self.b - n)
        specs += [None] * (self.b - n)
        packed, lay = describe_batch([st.meta for st in self.group], [st.off for st in self.group], tiles)
        slot = self.slot
        if slot.desc.numel() < packed.size:
            slot.desc = torch.empty(2 * packed.size, dtype=torch.int32, pin_memory=slot.pinned)
        slot.desc[:packed.size] = torch.from_numpy(packed)
        out = torch.empty((self.b, self.eff, self.eff, 3), dtype=torch.uint8, device=self.dev)
        if self.dev.type == "cuda":
            with torch.cuda.device(self.dev):
                coef = slot.coef[:self.used].to(self.dev, non_blocking=True)
                desc = slot.desc[:packed.size].to(self.dev, non_blocking=True)
                slot.event = torch.cuda.Event()
                slot.event.record()
                self._decode(coef, desc, lay, out, caller)
        else:
            self._decode(slot.coef[:self.used], slot.desc[:packed.size], lay, out, caller)
        valid = np.zeros(self.b, bool)
        valid[:n] = True
        # the next batch fills the next slot once its copy is done
        self.k += 1
        self.slot = self.slots[self.k % len(self.slots)]
        self.slot.wait()
        self.used = 0
        self.group, self.entries = [], []
        return TileBatch(out, specs, valid)

    def _decode(self, coef, desc, lay, out, caller) -> None:
        if self.group:
            qt, comps, images, tiles = unpack_batch(desc, lay)
            jpeg_cuda.jpeg_decode(coef, qt, comps, images, tiles, out, lay)
        else:  # no JPEG in the batch: no kernel, the empty slots zeroed here
            out[len(self.entries):].zero_()
        arrays = [(s, a) for s, a in caller if isinstance(a, np.ndarray)]
        if arrays:
            px = torch.from_numpy(np.stack([a for _, a in arrays]))
            if self.dev.type == "cuda":
                px = px.pin_memory().to(self.dev, non_blocking=True)
            for j, (s, _) in enumerate(arrays):
                out[s].copy_(px[j])
        for s, t in caller:
            if isinstance(t, _RasterTile):
                px = t.raster[t.y:t.y + self.eff, t.x:t.x + self.eff]
                if px.shape[0] < self.eff or px.shape[1] < self.eff:
                    out[s].zero_()
                out[s, :px.shape[0], :px.shape[1]].copy_(px)


def _routed_tiles(path: str, base: TileSpec, tile: int, out_tile: int) -> list:
    """(pixels, spec) of each tile of a TIFF, through PIL, each zero-padded
    to the batch's slot: at full size libtiff's RGBA pixels on the device
    loader's grid (a compression the reader does not decode), at scale the
    Python loader's PIL-resize twin (its ``_emit_tiles``, which leaves a
    raster no larger than a slot whole)."""
    eff = out_tile or tile
    if out_tile:
        tiles = _emit_tiles(read_image(path), base, tile, 0, out_tile)
    else:
        arr = read_tiff_rgba(path)
        tiles = ((arr[y:y + tile, x:x + tile], _tile_spec(base, x, y, tile, tile))
                 for x, y in tile_grid(arr.shape[1], arr.shape[0], tile))
    out = []
    for px, spec in tiles:
        t = np.zeros((eff, eff, 3), np.uint8)
        t[:px.shape[0], :px.shape[1]] = px[..., :3]
        out.append((t, spec))
    return out


def _tile_spec(base: TileSpec, x: int, y: int, tile: int, eff: int) -> TileSpec:
    return TileSpec(year=base.year, bbox_ind=base.bbox_ind, x_offset=base.x_offset + x * tile // eff,
                    y_offset=base.y_offset + y * tile // eff, layer=base.layer)


def native_tile_batches(
    paths: Sequence[str],
    batch_size: int = 32,
    tile: int = IM_WIDTH,
    n_threads: int = 0,
    queue_depth: int = 64,
    out_tile: int = 0,
    device="cuda",
    counts: Optional[Dict[str, int]] = None,
) -> Iterator[TileBatch]:
    """Files -> fixed-shape TileBatches under the contract of
    ``data.loader.tile_batches``, with ``images`` already on ``device``.

    n_threads: the entropy decoder's and TIFF reader's threads (0 = cores
    capped at 8), and as many PIL threads for the TIFFs left to PIL;
    queue_depth: files decoded ahead of the consumer (fewer when their
    decoded bytes pass 1 GiB). out_tile > 0 decodes at out_tile/tile (5/8: 640 px
    tiles from 1024 px ones) with offsets in source pixels; an out_tile
    that is not a proper N/8 fraction of tile raises ValueError here,
    before any file is read. ``counts`` (a dict,
    filled in place) gets the files of each route in ``ROUTES``."""
    scale_n = check_scale(out_tile, tile)
    dev = resolve_device(device)
    lib = build()
    counts = {} if counts is None else counts
    for r in ROUTES:
        counts.setdefault(r, 0)
    return _batches(lib, list(paths), batch_size, tile, out_tile, scale_n, n_threads, queue_depth, dev, counts)


def _batches(lib, paths, batch_size, tile, out_tile, scale_n, n_threads, depth, dev, counts):
    eff = out_tile or tile
    n_threads = n_threads or min(os.cpu_count() or 1, 8)
    base_specs = [decode_tile_name(p) for p in paths]
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    handle = lib.aq_jpeg_loader_create(arr, len(paths), scale_n, n_threads, depth)
    if not handle:
        raise RuntimeError("aq_jpeg_loader_create rejected its arguments")
    pool = ThreadPoolExecutor(max_workers=n_threads)
    routed: dict = {}
    scanned = 0
    meta, ahead = np.zeros(META_INTS, np.int32), np.zeros(META_INTS, np.int32)
    pidx = ctypes.c_int32()
    batcher = _Batcher(dev, batch_size, eff, batch_size * coefs_per_tile(tile, scale_n))
    stage = _Staging(dev, RASTER_SLOT_BYTES)

    def to_pil(m: np.ndarray) -> bool:
        return m[M_KIND] == KIND_TIFF and (out_tile > 0 or m[T_ROUTE] == TIFF_PIL)

    try:
        while lib.aq_jpeg_loader_peek(handle, meta.ctypes.data, ctypes.byref(pidx)) == 1:
            i = pidx.value
            # start PIL on the TIFFs left to it that the workers have read ahead
            scanned = max(scanned, i)
            while scanned < min(i + depth, len(paths)):
                if not lib.aq_jpeg_loader_meta(handle, scanned, ahead.ctypes.data):
                    break
                if to_pil(ahead):
                    routed[scanned] = pool.submit(_routed_tiles, paths[scanned], base_specs[scanned],
                                                  tile, out_tile)
                scanned += 1
            kind = int(meta[M_KIND])
            if kind == KIND_BASELINE:
                m = meta.copy()
                st = batcher.stage(m, lambda ptr, cap: lib.aq_jpeg_loader_pop(handle, ptr, cap))
                counts["device"] += 1
                for x, y in tile_grid(int(m[M_OUT_W]), int(m[M_OUT_H]), eff):
                    yield from batcher.add((st, x, y), _tile_spec(base_specs[i], x, y, tile, eff))
                continue
            if kind == KIND_TIFF and not out_tile and meta[T_ROUTE] in (TIFF_RASTER, TIFF_JPEG):
                raster = _tiff_raster(lib, handle, meta, stage)
                counts["tiff" if meta[T_ROUTE] == TIFF_RASTER else "tiff_jpeg"] += 1
                for x, y in tile_grid(raster.shape[1], raster.shape[0], eff):
                    yield from batcher.add(_RasterTile(raster, x, y), _tile_spec(base_specs[i], x, y, tile, eff))
                continue
            lib.aq_jpeg_loader_pop(handle, None, 0)
            if not to_pil(meta):  # refused JPEGs and TIFFs, unreadable files
                counts["skipped"] += 1
                continue
            fut = routed.pop(i, None) or pool.submit(_routed_tiles, paths[i], base_specs[i], tile, out_tile)
            counts["pil_resize" if out_tile else "pil"] += 1
            for px, spec in fut.result():
                yield from batcher.add(px, spec)
        yield from batcher.flush()
    finally:
        lib.aq_jpeg_loader_destroy(handle)
        pool.shutdown(wait=False, cancel_futures=True)

