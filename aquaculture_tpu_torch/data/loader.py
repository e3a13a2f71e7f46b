"""Batched, prefetching tile loader feeding the detector (file path).

Counterpart of the file path of aquaculture_tpu/data/loader.py: image files
-> decode (PIL; an ordered thread pool decodes ahead) -> tile grid (the
hard grid, or overlapping tiles for overlap serving) -> fixed-size uint8
batches, the tail batch zero-padded with a validity mask -> a bounded
background prefetch thread. Decode-at-scale (``out_tile``) resizes each
raster once before slicing, with offsets kept in source pixels. Batches
are torch tensors; with ``pin_memory`` they sit in pinned host memory, so
the host-to-device copy can be ``non_blocking``. The object-store path
(``iter_tiles_from_store``, ``tile_batches_from_store``) fetches blobs in an
ordered thread window and then tiles and batches them as the file path
does, so the two give the same batches.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aquaculture_tpu_torch.config import IM_WIDTH
from aquaculture_tpu_torch.data.filenames import TileSpec, decode_tile_name
from aquaculture_tpu_torch.data.geotiff import read_image, read_image_bytes
from aquaculture_tpu_torch.data.tiling import split_image


class TileBatch:
    """One fixed-shape batch: images (B, tile, tile, 3) uint8 + per-tile
    specs (None for padding) + validity mask."""

    __slots__ = ("images", "specs", "valid")

    def __init__(self, images: torch.Tensor, specs: List[Optional[TileSpec]], valid: np.ndarray):
        self.images = images
        self.specs = specs
        self.valid = valid


def iter_tiles_from_files(
    paths: Sequence[str], tile: int = IM_WIDTH, decode_threads: int = 0,
    stride: int = 0, out_tile: int = 0,
) -> Iterator[Tuple[np.ndarray, TileSpec]]:
    """Yield (tile_array, spec) over pre-tiled images or large rasters.

    decode_threads > 1 decodes ahead in an ordered pool (PIL's decoders
    release the GIL); 0 = auto (cpu_count capped at 8), 1 = sequential
    (host RAM bounded to one raster). stride and out_tile as in
    ``_emit_tiles``."""
    if decode_threads == 0:
        decode_threads = min(os.cpu_count() or 1, 8)
    if decode_threads > 1 and len(paths) > 1:
        images = _window_map(read_image, paths, decode_threads)
    else:
        images = ((read_image(p), p) for p in paths)
    for arr, path in images:
        yield from _emit_tiles(arr, decode_tile_name(path), tile, stride, out_tile)


def _window_map(fn, items: Sequence, workers: int):
    """Ordered threaded map with a bounded in-flight window (2x workers):
    yields (fn(item), item) in input order."""
    from concurrent.futures import ThreadPoolExecutor

    items = list(items)
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        window = max(1, 2 * workers)
        futures = {}
        next_submit = 0

        def top_up():
            nonlocal next_submit
            while next_submit < len(items) and len(futures) < window:
                futures[next_submit] = pool.submit(fn, items[next_submit])
                next_submit += 1

        top_up()
        for i, item in enumerate(items):
            res = futures.pop(i).result()
            top_up()
            yield res, item


def resize_to_scale(arr: np.ndarray, n: int) -> np.ndarray:
    """A raster at n/8 scale through PIL's bilinear, to libjpeg's
    ceil(d*n/8) dims: the Python loader's decode-at-scale."""
    from PIL import Image

    sh, sw = (arr.shape[0] * n + 7) // 8, (arr.shape[1] * n + 7) // 8
    if (sh, sw) == arr.shape[:2]:
        return arr
    return np.asarray(Image.fromarray(arr).resize((sw, sh), Image.BILINEAR))


def _emit_tiles(
    arr: np.ndarray, base: TileSpec, tile: int, stride: int = 0, out_tile: int = 0
) -> Iterator[Tuple[np.ndarray, TileSpec]]:
    """Split one decoded raster into (tile, spec) pairs: a <=tile-px image
    is one tile (offsets from its name); larger rasters split into the
    offset grid with offsets ADDED to the name's base. 0 < stride < tile
    overlaps the tiles (overlap serving, data/tiling.split_image).

    out_tile > 0 (decode-at-scale): the raster resizes ONCE to
    out_tile/tile with PIL's bilinear, to libjpeg's ceil(d*N/8) dims,
    before slicing in scaled space; offsets stay in SOURCE pixels.
    Incompatible with stride (overlap serving slices in source space)."""
    if out_tile:
        if stride and stride != tile:
            raise ValueError("decode-at-scale does not support overlap serving")
        if out_tile >= tile or (8 * out_tile) % tile != 0:
            raise ValueError(f"out_tile must be a proper N/8 fraction of tile; got {out_tile}/{tile}")
        arr = resize_to_scale(arr, 8 * out_tile // tile)
        emit, stride = out_tile, 0
        if arr.shape[0] <= out_tile and arr.shape[1] <= out_tile:
            yield arr, base
            return
    else:
        emit = tile
        if arr.shape[0] <= tile and arr.shape[1] <= tile:
            yield arr, base
            return
    tiles, offs = split_image(arr, emit, stride=stride)
    for t, (dx, dy) in zip(tiles, offs):
        yield t, TileSpec(
            year=base.year,
            bbox_ind=base.bbox_ind,
            x_offset=base.x_offset + dx * tile // emit,
            y_offset=base.y_offset + dy * tile // emit,
            layer=base.layer,
        )


def batch_tiles(
    tiles: Iterable[Tuple[np.ndarray, TileSpec]],
    batch_size: int,
    tile: int = IM_WIDTH,
    pin_memory: bool = False,
) -> Iterator[TileBatch]:
    """Group tiles into fixed (B, tile, tile, 3) uint8 batches, padding the
    tail batch with zeros + validity mask."""
    buf_imgs: List[np.ndarray] = []
    buf_specs: List[Optional[TileSpec]] = []

    def flush() -> TileBatch:
        n = len(buf_imgs)
        images = torch.empty((batch_size, tile, tile, 3), dtype=torch.uint8, pin_memory=pin_memory)
        out = images.numpy()
        out[n:] = 0
        for i, im in enumerate(buf_imgs):
            h, w = im.shape[:2]
            if (h, w) != (tile, tile):
                out[i] = 0
            out[i, :h, :w] = im[..., :3]
        valid = np.zeros((batch_size,), bool)
        valid[:n] = True
        specs = buf_specs + [None] * (batch_size - n)
        return TileBatch(images, specs, valid)

    for arr, spec in tiles:
        buf_imgs.append(arr)
        buf_specs.append(spec)
        if len(buf_imgs) == batch_size:
            yield flush()
            buf_imgs, buf_specs = [], []
    if buf_imgs:
        yield flush()


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread with a bounded queue (double
    buffering): host decode overlaps device compute."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item


def tile_batches(
    paths: Sequence[str], batch_size: int = 32, tile: int = IM_WIDTH, pin_memory: bool = False,
    stride: int = 0, decode_threads: int = 0, out_tile: int = 0,
) -> Iterator[TileBatch]:
    """paths -> prefetched fixed-shape TileBatches (the full input
    pipeline). pin_memory=True (needs CUDA) puts each batch in pinned host
    memory for a non_blocking copy to the card. stride < tile overlaps the
    tiles of large rasters; decode_threads: 0 = auto, 1 = sequential;
    out_tile > 0 = decode-at-scale, batches (B, out_tile, out_tile, 3)."""
    tiles = iter_tiles_from_files(paths, tile, decode_threads=decode_threads, stride=stride,
                                  out_tile=out_tile)
    return prefetch(batch_tiles(tiles, batch_size, out_tile or tile, pin_memory))


# ---------------------------------------------------------------------------
# Object-store streaming (the reference's corpus transport: GCS blobs,
# src/utils.py:192-238 listing + geocode_results.py:34-66 download)
# ---------------------------------------------------------------------------

def iter_tiles_from_store(
    store, keys: Sequence[str], tile: int = IM_WIDTH, fetch_threads: int = 4,
    stride: int = 0, out_tile: int = 0,
) -> Iterator[Tuple[np.ndarray, TileSpec]]:
    """Yield (tile_array, spec) streaming blob bytes from a BlobStore
    (data/store.py). A thread pool keeps a bounded window of ``store.get``
    calls ahead of the decoder, so fetch latency overlaps decode and device
    work; decode and tiling are the file path's, so a store corpus and a
    file corpus give the same tiles. A failed fetch raises here."""
    keys = list(keys)
    if not keys:
        return
    for data, key in _window_map(store.get, keys, fetch_threads):
        yield from _emit_tiles(read_image_bytes(data), decode_tile_name(key), tile, stride, out_tile)


def tile_batches_from_store(
    store, keys: Sequence[str], batch_size: int = 32, tile: int = IM_WIDTH, pin_memory: bool = False,
    fetch_threads: int = 4, stride: int = 0, out_tile: int = 0,
) -> Iterator[TileBatch]:
    """(store, keys) -> prefetched fixed-shape TileBatches: the streaming
    twin of ``tile_batches``."""
    tiles = iter_tiles_from_store(store, keys, tile, fetch_threads, stride=stride, out_tile=out_tile)
    return prefetch(batch_tiles(tiles, batch_size, out_tile or tile, pin_memory))
