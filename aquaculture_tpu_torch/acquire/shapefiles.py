"""Shapefile bootstrap: fetch + extract the coastline / EEZ / country
shapes the pipeline starts from.
A copy of aquaculture_tpu/acquire/shapefiles.py in the PyTorch port.

Port of the reference's load_shapefiles.py + create_land_filter.load_data
(reference: src/load_data/load_shapefiles.py:14-39,
src/load_data/create_land_filter.py:19-44): the EEA European coastline and
France reference-grid zips download automatically; the marineregions EEZ
shapefile requires a manual browser download (their WFS gates it), exactly
as the reference documents. Fetching goes through an injectable ``fetch``
callable so the orchestration is testable offline.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Callable, Dict, Optional

from aquaculture_tpu_torch.utils.logging import log_info, log_warning

# reference load_shapefiles.py / create_land_filter.py URLs
SOURCES: Dict[str, str] = {
    "europe_coastline": (
        "https://www.eea.europa.eu/data-and-maps/data/eea-coastline-for-analysis-1/"
        "gis-data/europe-coastline-shapefile/at_download/file"
    ),
    "france_grid": (
        "https://www.eea.europa.eu/data-and-maps/data/eea-reference-grids-2/"
        "gis-files/france-shapefile/at_download/file"
    ),
}
EEZ_MANUAL_URL = "https://www.marineregions.org/gazetteer.php?p=details&id=5677"


def _default_fetch(url: str) -> bytes:  # pragma: no cover - network
    import urllib.request

    with urllib.request.urlopen(url, timeout=300) as r:
        return r.read()


def load_shapefiles(
    out_dir: str,
    fetch: Optional[Callable[[str], bytes]] = None,
    sources: Dict[str, str] = SOURCES,
) -> Dict[str, str]:
    """Download + extract each zip under <out_dir>/raw/<name>/.

    Returns {name: extraction dir}. Skips names whose directory already
    contains files (resumable, like every reference stage)."""
    fetch = fetch or _default_fetch
    raw = os.path.join(out_dir, "raw")
    out: Dict[str, str] = {}
    for name, url in sources.items():
        dest = os.path.join(raw, name)
        if os.path.isdir(dest) and os.listdir(dest):
            log_info("%s already present, skipping", name)
            out[name] = dest
            continue
        os.makedirs(dest, exist_ok=True)
        data = fetch(url)
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            z.extractall(dest)
        log_info("extracted %s -> %s", name, dest)
        out[name] = dest
    eez = os.path.join(raw, "eez", "eez.shp")
    if not os.path.exists(eez):
        log_warning(
            "EEZ shapefile must be downloaded manually from %s and saved as %s",
            EEZ_MANUAL_URL,
            eez,
        )
    return out
