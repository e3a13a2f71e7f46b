"""Image decode. Only ``read_image`` of aquaculture_tpu/data/geotiff.py so
far; the georeferenced GeoTIFF reader comes with the geocoding slice."""

from __future__ import annotations

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Plain image decode (JPEG/PNG/TIFF) to a (H, W, C) uint8 array."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
