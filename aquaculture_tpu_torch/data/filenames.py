"""Tile filename codec.

The pipeline's geospatial metadata travels in file names:
``ORTHOIMAGERY.ORTHOPHOTOS{year}_{bbox_ind}_{x_offset}_{y_offset}.{ext}``
(2021 uses the ``ORTHOIMAGERY.ORTHOPHOTOS.ORTHO-EXPRESS.{...}`` layer name).
A copy of aquaculture_tpu/data/filenames.py (reference src/utils.py:372-389),
so both packages name tiles and label files identically.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Identity of one analysis tile within a downloaded GeoTIFF."""

    year: int
    bbox_ind: int
    x_offset: int
    y_offset: int
    layer: str = ""  # full WMS layer name prefix (before the year suffix)

    @property
    def name(self) -> str:
        if self.bbox_ind < 0:  # generic (non-pipeline) image: layer IS the stem
            return self.layer
        return f"{self.layer or _layer_for_year(self.year)}{self.year}"


def _layer_for_year(year: int) -> str:
    # reference utils.py:383-385: 2021 switched to the ORTHO-EXPRESS layer
    if int(year) == 2021:
        return "ORTHOIMAGERY.ORTHOPHOTOS.ORTHO-EXPRESS."
    return "ORTHOIMAGERY.ORTHOPHOTOS"


def encode_tile_name(spec: TileSpec, extension: str = "jpeg") -> str:
    if spec.bbox_ind < 0:
        return f"{spec.name}.{extension}"
    return f"{spec.name}_{spec.bbox_ind}_{spec.x_offset}_{spec.y_offset}.{extension}"


def decode_tile_name(path: str) -> TileSpec:
    """Parse a tile/label file name into its TileSpec.

    Accepts .jpeg/.jpg/.txt/.tif/.png names (the label files emitted by
    detection reuse the image stem; reference geocode_results.py:89).
    """
    base = os.path.basename(path)
    for ext in (".jpeg", ".jpg", ".txt", ".tif", ".tiff", ".png"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    try:
        name, bbox_ind, x_offset, y_offset = base.split("_")
        return TileSpec(
            year=int(name[-4:]),
            bbox_ind=int(bbox_ind),
            x_offset=int(x_offset),
            y_offset=int(y_offset),
            layer=name[:-4],
        )
    except ValueError:
        # Not a pipeline tile name: generic image, no geospatial identity.
        return TileSpec(year=0, bbox_ind=-1, x_offset=0, y_offset=0, layer=base)
