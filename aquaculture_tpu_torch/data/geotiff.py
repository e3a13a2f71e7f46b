"""Image decode: ``read_image`` and ``read_image_bytes`` of
aquaculture_tpu/data/geotiff.py; the georeferenced GeoTIFF reader comes
with the geocoding slice."""

from __future__ import annotations

import io

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Plain image decode (JPEG/PNG/TIFF) to a (H, W, C) uint8 array."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_image_bytes(data: bytes) -> np.ndarray:
    """Decode an in-memory image blob (the store streaming path) to (H, W, C)
    uint8 with the decoder of ``read_image``, so a store corpus and a file
    corpus give the same pixels."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))
