"""Human-label (CloudFactory) artifact loaders (a copy of
aquaculture_tpu/data/labels.py; host).

Reference: src/utils.py:46-94 — humanlabels.geojson (4,142 annotated cage
boxes), cf_images.csv (the 35,199 sampled images), and the buffered-land
"only land" image flag used for stratification. The land flag needs the
overlay engine (a land dissolve and ``sjoin(predicate="within")``), which
comes with a later slice of the port: ``mark_land_images`` raises until then.
"""

from __future__ import annotations

import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_MAPPING


def load_cf_labels(path: str) -> "gf.GeoFrame":
    """CloudFactory labels in EPSG:3857 (reference utils.py:72-83)."""
    labels = gf.read_file(path)
    return labels.to_crs(CRS_MAPPING)


def load_cf_images(path: str) -> pd.DataFrame:
    """The sampled-image list (reference utils.py:86-93)."""
    return pd.read_csv(path)


def mark_land_images(
    images: "gf.GeoFrame",
    land: "gf.GeoFrame",
    land_indent: float = 0.0,
    projected_crs: int = 3035,
) -> pd.Series:
    """True for images entirely within the landmass (reference
    utils.py:46-69). Not in this slice of the port: it raises."""
    raise ValueError("mark_land_images: only images without a land flag are in this slice of the port "
                     "(the land dissolve and sjoin(predicate='within') need the boolean engine)")
