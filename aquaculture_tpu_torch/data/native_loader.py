"""The device tile loader: JPEG entropy decode on host threads, the rest
of the decode in hand-written kernels on the card.

Counterpart of aquaculture_tpu/data/native_loader.py with
the C++ tileloader.cc beside it, split another way. The JAX package decodes whole
JPEGs on a C++ thread pool with libjpeg-turbo; the port's hosts have no
libjpeg, and on a card the parallel half belongs on the card:
- ``csrc/jpeg_entropy.cc`` (g++, ctypes) parses the markers and
  Huffman-decodes each baseline JPEG on a thread pool into de-zigzagged,
  still-quantised int16 coefficients (at 5/8 only each block's kept
  coefficients), ahead of the consumer and handed out in path order;
- the coefficients go into a pinned staging slot, are copied to the card
  ``non_blocking``, and ``data/jpeg_cuda.py``'s two kernels dequantise,
  IDCT, upsample, colour-convert and slice the tile grid straight into the
  (B, T, T, 3) uint8 batch on the card. Two slots, each guarded by a CUDA
  event: a slot is refilled only after its copy has finished;
- on ``device="cpu"`` the same coefficients go through the plain versions
  (``data/jpeg_plain.py``).
The pixels are libjpeg-turbo's, byte for byte, at 8/8 and at 5/8 (the
decode-at-scale of ``detect_files(decode_scale=True)``: the DCT-domain
scaled IDCT, not a resize).

Files are routed by content, from their header, never by catching an
error: baseline JPEG goes to the card; TIFF and the JPEG processes the
entropy decoder does not speak (progressive, lossless, arithmetic, 12-bit,
CMYK, multi-scan, RGB-coded) decode on a host thread pool through PIL
(``data/geotiff.read_image``; at scale through the Python loader's PIL
resize, as the JAX module routes non-JPEG files); a file that is neither,
or whose header does not parse, is skipped. ``counts`` says how many files
took each route: "device", "pil", "pil_resize", "skipped".

Tile order is deterministic: files in path order, each raster's tiles
x-major (the JAX native loader's order varies from run to run). The grid is
tileloader.cc's: a side no longer than a tile gives one zero-padded tile.

Scales: 8/8 and 5/8. Other N/8 scales raise a ValueError (ROADMAP.md);
``pipeline.detect_files`` then takes the Python loader.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from aquaculture_tpu_torch.config import IM_WIDTH, resolve_device
from aquaculture_tpu_torch.data import jpeg_cuda
from aquaculture_tpu_torch.data.filenames import TileSpec, decode_tile_name
from aquaculture_tpu_torch.data.geotiff import read_image
from aquaculture_tpu_torch.data.jpeg_plain import (
    KIND_BASELINE, KIND_OTHER_JPEG, KIND_TIFF, KIND_UNREADABLE, M_COEFS, M_HEIGHT, M_KIND,
    M_OUT_H, M_OUT_W, M_WIDTH, META_INTS, TILE_CALLER, TILE_DECODED, TILE_ZERO,
    EntropyImage, describe_batch, reconstruct_plain, tile_grid, unpack_batch)
from aquaculture_tpu_torch.data.loader import TileBatch, _emit_tiles, resize_to_scale
from aquaculture_tpu_torch.geo import native_boolean

SOURCE = os.path.join(native_boolean._CSRC, "jpeg_entropy.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
SCALES = (8, 5)  # the N/8 scales the kernels decode at
ROUTES = ("device", "pil", "pil_resize", "skipped")

_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the entropy decoder. A
    failed build raises with g++'s output."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native_boolean.compile_library(SOURCE, "libaq_jpeg_entropy", CXX_FLAGS))
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
            lib.aq_jpeg_loader_kind.argtypes, lib.aq_jpeg_loader_kind.restype = [vp, i32], i32
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
    ``tile`` px ones (8 for out_tile 0); raises ValueError for anything but
    8/8 and 5/8."""
    if not out_tile:
        return 8
    if out_tile >= tile or (8 * out_tile) % tile != 0:
        raise ValueError(f"out_tile must be a proper N/8 fraction of tile; got {out_tile}/{tile}")
    n = 8 * out_tile // tile
    if n not in SCALES:
        raise ValueError(f"the device loader decodes at 8/8 and 5/8; {n}/8 is still to port "
                         "(ROADMAP.md, section 1)")
    return n


def supports_scale(out_tile: int, tile: int = IM_WIDTH) -> bool:
    try:
        check_scale(out_tile, tile)
    except ValueError:
        return False
    return True


def probe(path: str, scale_n: int = 8) -> np.ndarray:
    """A file's metadata at scale_n/8 (``jpeg_plain``'s layout; M_KIND says
    how it is routed), read from its header."""
    meta = np.zeros(META_INTS, np.int32)
    build().aq_jpeg_probe(os.fsencode(path), scale_n, meta.ctypes.data)
    return meta


def entropy_decode(path: str, scale_n: int = 8) -> Optional[EntropyImage]:
    """The host half alone: a baseline JPEG's coefficients and metadata
    at scale_n/8, None for any other file."""
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
    """A whole image's (H, W, 3) uint8 pixels on ``dev``: the kernels on
    CUDA, the plain versions on the CPU."""
    if dev.type == "cpu":
        return reconstruct_plain(image)
    h, w = image.out_height, image.out_width
    packed, lay = describe_batch([image.meta], [0], [(TILE_DECODED, 0, 0, 0)])
    qt, comps, images, tiles = unpack_batch(torch.from_numpy(packed).to(dev), lay)
    planes = jpeg_cuda.jpeg_idct(image.coef.to(dev), qt, comps, lay.plane_bytes, lay.max_blocks)
    out = torch.empty((1, h, w, 3), dtype=torch.uint8, device=dev)
    return jpeg_cuda.jpeg_color(planes, comps, images, tiles, out)[0]


def decode_image(path: str, device="cuda") -> Optional[torch.Tensor]:
    """Decode one JPEG or TIFF at full size -> (H, W, 3) uint8 on
    ``device``; None if the file is neither or does not parse."""
    dev = resolve_device(device)
    image = entropy_decode(path, 8)
    if image is not None:
        return _reconstruct(image, dev)
    if probe(path)[M_KIND] == KIND_UNREADABLE:
        return None
    return torch.from_numpy(np.array(read_image(path))).to(dev)


def scale_for(width: int, height: int, target: int) -> int:
    """tileloader.cc's rule: the largest N/8 whose longer side stays >=
    target (8 when target <= 0 or the image is no larger)."""
    full = max(width, height)
    if target <= 0 or full <= target:
        return 8
    return max(1, min(8, (8 * target + full - 1) // full))


def decode_image_scaled(path: str, target: int, device="cuda") -> Optional[torch.Tensor]:
    """Decode with a DCT-domain downscale: a JPEG at the largest N/8 scale
    whose longer side stays >= target (``scale_for``); only 8/8 and 5/8
    are ported, other scales raise ValueError. A non-baseline JPEG goes to
    the PIL resize to libjpeg's ceil(d * N / 8); TIFF decodes at full size,
    as in the JAX package. None if the file does not parse."""
    dev = resolve_device(device)
    meta = probe(path)
    kind = meta[M_KIND]
    if kind == KIND_UNREADABLE:
        return None
    if kind == KIND_TIFF:
        return decode_image(path, dev)
    n = scale_for(int(meta[M_WIDTH]), int(meta[M_HEIGHT]), target)
    if n not in SCALES:
        raise ValueError(f"the device loader decodes at 8/8 and 5/8; {n}/8 is still to port "
                         "(ROADMAP.md, section 1)")
    if kind == KIND_OTHER_JPEG:
        return torch.from_numpy(np.array(resize_to_scale(read_image(path), n))).to(dev)
    return _reconstruct(entropy_decode(path, n), dev)


# ---------------------------------------------------------------- batches

def coefs_per_tile(tile: int, scale_n: int) -> int:
    """int16 coefficients of one 4:2:0 tile at scale_n/8: the staging
    slots' first size (they grow for other samplings)."""
    k_luma = min(scale_n, 8)
    return (tile // 8) ** 2 * k_luma ** 2 + 2 * (tile // 16) ** 2 * 64


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


class _Batcher:
    """Fills staging slots image by image and emits fixed-shape batches:
    the coefficients of every image with a tile in the batch (an image
    whose tiles straddle two batches is staged in both), the tile slots,
    the pixels of routed files."""

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
        """Add one tile: (staged image, x, y) or a routed file's pixels."""
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
        qt, comps, images, tiles = unpack_batch(desc, lay)
        planes = jpeg_cuda.jpeg_idct(coef, qt, comps, lay.plane_bytes, lay.max_blocks)
        jpeg_cuda.jpeg_color(planes, comps, images, tiles, out)
        if caller:
            px = torch.from_numpy(np.stack([a for _, a in caller]))
            if self.dev.type == "cuda":
                px = px.pin_memory().to(self.dev, non_blocking=True)
            for j, (s, _) in enumerate(caller):
                out[s].copy_(px[j])


def _routed_tiles(path: str, base: TileSpec, tile: int, out_tile: int) -> list:
    """(pixels, spec) of each tile of a file the entropy decoder does not
    take, through PIL, each zero-padded to the batch's slot: at full size on
    the device loader's grid, at scale the Python loader's PIL-resize twin
    (its ``_emit_tiles``, which leaves a raster no larger than a slot whole)."""
    arr = read_image(path)
    eff = out_tile or tile
    if out_tile:
        tiles = _emit_tiles(arr, base, tile, 0, out_tile)
    else:
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

    n_threads: the entropy decoder's threads (0 = cores capped at 8), and
    as many PIL threads for routed files; queue_depth: files decoded ahead
    of the consumer. out_tile > 0 decodes at out_tile/tile (5/8: 640 px
    tiles from 1024 px ones) with offsets in source pixels; other scales
    raise ValueError here, before any file is read. ``counts`` (a dict,
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
    meta = np.zeros(META_INTS, np.int32)
    pidx = ctypes.c_int32()
    batcher = _Batcher(dev, batch_size, eff, batch_size * coefs_per_tile(tile, scale_n))
    try:
        while lib.aq_jpeg_loader_peek(handle, meta.ctypes.data, ctypes.byref(pidx)) == 1:
            i = pidx.value
            # start PIL on the routed files the workers have read ahead
            scanned = max(scanned, i)
            while scanned < min(i + depth, len(paths)):
                kind = lib.aq_jpeg_loader_kind(handle, scanned)
                if kind < 0:
                    break
                if kind in (KIND_OTHER_JPEG, KIND_TIFF):
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
            lib.aq_jpeg_loader_pop(handle, None, 0)
            if kind == KIND_UNREADABLE:
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

