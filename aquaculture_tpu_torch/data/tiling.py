"""Array-level tile slicing of large downloaded images.

A copy of aquaculture_tpu/data/tiling.py (reference
src/load_data/tile_tifs.py:33-47: a 6144 px image yields a 6x6 grid of
1024 px tiles named by pixel offset).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from aquaculture_tpu_torch.config import IM_WIDTH, LARGE_TIF_SIZE
from aquaculture_tpu_torch.data.filenames import TileSpec


def tile_offsets(large: int = LARGE_TIF_SIZE, tile: int = IM_WIDTH) -> List[Tuple[int, int]]:
    """(x_offset, y_offset) grid in the reference's iteration order
    (x-major then y; tile_tifs.py:33-37 loops i in x, j in y)."""
    steps = large // tile
    return [(i * tile, j * tile) for i in range(steps) for j in range(steps)]


def split_image(
    img: np.ndarray, tile: int = IM_WIDTH, stride: int = 0
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Split a (H, W, C) image into a tile grid.

    stride == 0 (default) is the reference's non-overlapping grid
    (reshape-transpose): ragged edges are ignored. stride < tile produces
    overlapping tiles, offsets stepping by ``stride`` per axis with a final
    offset flush to the image edge, x-major order.

    Returns (tiles (N, tile, tile, C), offsets [(x, y), ...]).
    """
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    if stride and stride < tile:
        def starts(extent):
            if extent <= tile:
                return [0]
            ss = list(range(0, extent - tile, stride))
            ss.append(extent - tile)  # flush to the edge
            return ss

        offsets = [(x, y) for x in starts(w) for y in starts(h)]
        crops = []
        for x, y in offsets:
            crop = img[y : y + tile, x : x + tile]
            if crop.shape[0] < tile or crop.shape[1] < tile:
                pad = np.zeros((tile, tile) + img.shape[2:], img.dtype)
                pad[: crop.shape[0], : crop.shape[1]] = crop
                crop = pad
            crops.append(crop)
        tiles = np.stack(crops)
        return tiles.reshape(len(offsets), tile, tile, c), offsets
    ny, nx = h // tile, w // tile
    view = img[: ny * tile, : nx * tile].reshape(ny, tile, nx, tile, c)
    # -> (nx, ny, tile, tile, c) to match x-major offset order
    tiles = np.ascontiguousarray(view.transpose(2, 0, 1, 3, 4)).reshape(nx * ny, tile, tile, c)
    offsets = [(i * tile, j * tile) for i in range(nx) for j in range(ny)]
    return tiles, offsets


def tile_specs_for_image(
    year: int, bbox_ind: int, large: int = LARGE_TIF_SIZE, tile: int = IM_WIDTH
) -> List[TileSpec]:
    """The TileSpec of each tile of one downloaded image, in tile_offsets'
    order."""
    return [
        TileSpec(year=year, bbox_ind=bbox_ind, x_offset=x, y_offset=y)
        for x, y in tile_offsets(large, tile)
    ]
