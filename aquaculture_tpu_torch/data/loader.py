"""Batched, prefetching tile loader feeding the detector (file path).

Counterpart of the file path of aquaculture_tpu/data/loader.py: image files
-> decode (PIL; an ordered thread pool decodes ahead) -> hard tile grid ->
fixed-size uint8 batches, the tail batch zero-padded with a validity mask
-> a bounded background prefetch thread. Batches are torch tensors; with
``pin_memory`` they sit in pinned host memory, so the host-to-device copy
can be ``non_blocking``. The object-store and native-loader paths come in
a later slice of the port.
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
from aquaculture_tpu_torch.data.geotiff import read_image
from aquaculture_tpu_torch.data.tiling import split_image


class TileBatch:
    """One fixed-shape batch: images (B, tile, tile, 3) uint8 + per-tile
    specs (None for padding) + validity mask."""

    __slots__ = ("images", "specs", "valid")

    def __init__(self, images: torch.Tensor, specs: List[Optional[TileSpec]], valid: np.ndarray):
        self.images = images
        self.specs = specs
        self.valid = valid


def iter_tiles_from_files(paths: Sequence[str], tile: int = IM_WIDTH) -> Iterator[Tuple[np.ndarray, TileSpec]]:
    """Yield (tile_array, spec) over pre-tiled images or large rasters,
    decoding ahead in an ordered pool of up to 8 threads (PIL's decoders
    release the GIL)."""
    decode_threads = min(os.cpu_count() or 1, 8)
    if decode_threads > 1 and len(paths) > 1:
        images = _window_map(read_image, paths, decode_threads)
    else:
        images = ((read_image(p), p) for p in paths)
    for arr, path in images:
        yield from _emit_tiles(arr, decode_tile_name(path), tile)


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


def _emit_tiles(arr: np.ndarray, base: TileSpec, tile: int) -> Iterator[Tuple[np.ndarray, TileSpec]]:
    """Split one decoded raster into (tile, spec) pairs on the hard grid: a
    <=tile-px image is one tile (offsets from its name); larger rasters
    split into the offset grid with offsets ADDED to the name's base."""
    if arr.shape[0] <= tile and arr.shape[1] <= tile:
        yield arr, base
        return
    tiles, offs = split_image(arr, tile)
    for t, (dx, dy) in zip(tiles, offs):
        yield t, TileSpec(
            year=base.year,
            bbox_ind=base.bbox_ind,
            x_offset=base.x_offset + dx,
            y_offset=base.y_offset + dy,
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
) -> Iterator[TileBatch]:
    """paths -> prefetched fixed-shape TileBatches (the full input
    pipeline). pin_memory=True (needs CUDA) puts each batch in pinned host
    memory for a non_blocking copy to the card."""
    return prefetch(batch_tiles(iter_tiles_from_files(paths, tile), batch_size, tile, pin_memory))
