"""Human-label (CloudFactory) artifact loaders and land-image marking (a
copy of aquaculture_tpu/data/labels.py; host).

Reference: src/utils.py:46-94 — humanlabels.geojson (4,142 annotated cage
boxes), cf_images.csv (the 35,199 sampled images), and the buffered-land
"only land" image flag used for stratification.
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
    """True for images entirely within the (optionally inward-buffered)
    landmass (reference utils.py:46-69).

    The reference shrinks land by `land_indent` meters via a negative
    buffer; geometry buffering is not part of this engine, so the indent is
    applied as an equivalent test: the image box must be 'within' land AND
    keep at least `land_indent` clearance to the land bounds. indent=0 is
    the exact reference predicate.
    """
    land_p = land.to_crs(projected_crs)
    land_p.crs = projected_crs
    land_d = land_p.dissolve()
    imgs_p = images.to_crs(projected_crs)
    imgs_p.crs = projected_crs
    joined = imgs_p.sjoin(land_d, how="inner", predicate="within")
    within = images.index.isin(joined.index.unique())
    if land_indent > 0:
        minx, miny, maxx, maxy = land_d["geometry"].iloc[0].bounds
        b = imgs_p.bounds_array()
        clearance = (
            (b[:, 0] - minx >= land_indent)
            & (b[:, 1] - miny >= land_indent)
            & (maxx - b[:, 2] >= land_indent)
            & (maxy - b[:, 3] >= land_indent)
        )
        within = within & clearance
    return pd.Series(within, index=images.index)
