"""Year -> imagery-pass (period) mapping and external ground-truth loaders.
A copy of aquaculture_tpu/tonnage/periods.py in the PyTorch port.

Reference: src/utils.py:96-130 — the 6 imagery passes covering 2000-2021,
and the Trujillo et al. (2012) deduplicated facility locations used as the
external comparison set.
"""

from __future__ import annotations

import pandas as pd

from aquaculture_tpu_torch import frame as gf

PASSES = (
    (2000, 2004, "2000-2004"),
    (2005, 2009, "2005-2009"),
    (2010, 2012, "2010-2012"),
    (2013, 2015, "2013-2015"),
    (2016, 2018, "2016-2018"),
    (2019, 2021, "2019-2021"),
)


def map_year_to_image_pass(year: int) -> str:
    """reference utils.py:116-130 (map_year_to_image_pass_opt2)."""
    for lo, hi, name in PASSES:
        if lo <= int(year) <= hi:
            return name
    return "No group"


def load_trujillo_locations(path: str) -> "gf.GeoFrame":
    """Trujillo et al. deduped facility points -> EPSG:3857 GeoFrame
    (reference utils.py:96-113)."""
    df = pd.read_csv(path)
    out = gf.from_xy(df, x="lon", y="lat", crs=4326)
    return out.to_crs(3857)
