"""WMS orthoimagery acquisition.
A copy of aquaculture_tpu/acquire/wms.py in the PyTorch port.

Port of the reference's downloader (reference:
src/load_data/download_french_data.py): tile the buffered coast into
1200 m boxes (200 m x 6; :174), probe each box per year layer with a cheap
1024px request, skip blanks, fetch the 6144px GeoTIFF, store resumably.

Transport/store are protocols: HttpWmsTransport speaks WMS GetMap over
urllib; LocalBlobStore / any object store handles persistence. The download
loop keeps the reference's fault tolerance (skip-if-exists resumability,
continue-on-connection-error; :45-47,185-189).
"""

from __future__ import annotations

import io
from typing import Iterable, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import LARGE_TIF_SIZE
from aquaculture_tpu_torch.data.blank import is_blank
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.utils.logging import log_info, log_warning

# The reference's WMS endpoint + layer naming (download_french_data.py:24,209)
IGN_WMS_URL = "https://wxs.ign.fr/orthohisto/geoportail/r/wms"
PROBE_SIZE = 1024
FULL_SIZE = LARGE_TIF_SIZE  # 6144


def layer_name(year: int) -> str:
    if int(year) == 2021:
        return "ORTHOIMAGERY.ORTHOPHOTOS.ORTHO-EXPRESS.2021"
    return f"ORTHOIMAGERY.ORTHOPHOTOS{year}"


class WmsTransport(Protocol):
    def getmap(self, layer: str, bbox: Tuple[float, float, float, float], size: int) -> bytes: ...


class HttpWmsTransport:
    """WMS 1.1.1 GetMap over urllib (image/tiff, EPSG:3857)."""

    def __init__(self, url: str = IGN_WMS_URL, timeout: float = 120.0):
        self.url = url
        self.timeout = timeout

    def getmap(self, layer, bbox, size):  # pragma: no cover - network
        import urllib.parse
        import urllib.request

        params = {
            "SERVICE": "WMS",
            "VERSION": "1.1.1",
            "REQUEST": "GetMap",
            "LAYERS": layer,
            "STYLES": "normal",
            "SRS": "EPSG:3857",
            "BBOX": ",".join(f"{v:.6f}" for v in bbox),
            "WIDTH": str(size),
            "HEIGHT": str(size),
            "FORMAT": "image/tiff",
            "TRANSPARENT": "TRUE",
            # the WMS 1.1.1 spec default, sent explicitly so the query's
            # param set is identical to owslib's
            "EXCEPTIONS": "application/vnd.ogc.se_xml",
        }
        q = urllib.parse.urlencode(params)
        with urllib.request.urlopen(f"{self.url}?{q}", timeout=self.timeout) as r:
            return r.read()


# The store lives in data/store.py (the serving pipeline consumes it too,
# not just acquisition); re-exported here, as the JAX package does.
from aquaculture_tpu_torch.data.store import BlobStore, LocalBlobStore  # noqa: F401


def tile_shapefile(geometries: Iterable[_poly.Geometry], size: float = 1200.0) -> List[_poly.Polygon]:
    """Tile geometries into size x size boxes that intersect them
    (reference tile_shapefile, download_french_data.py:109-139; the
    production call uses size=200*6=1200 m, :174)."""
    out = []
    for geom in geometries:
        if geom is None or geom.is_empty or geom.area == 0:
            continue
        minx, miny, maxx, maxy = geom.bounds
        for x in np.arange(minx, maxx + size, size):
            for y in np.arange(miny, maxy + size, size):
                b = _poly.box(x, y, x + size, y + size)
                if _poly.intersects(geom, b):
                    out.append(b)
    return out


def _decode_image(data: bytes) -> Optional[np.ndarray]:
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def download_images_within_shape(
    coast: Iterable[_poly.Geometry],
    years: Sequence[int],
    transport: WmsTransport,
    store: BlobStore,
    out_prefix: str = "coastal_french_data/tifs",
    box_size: float = 1200.0,
    wanted_bboxes: Optional[List[_poly.Polygon]] = None,
    max_retries: int = 3,
) -> "gf.GeoFrame":
    """Full acquisition loop (download_french_data.py:142-191): tile the
    coast, then per (year layer, box): cheap blank probe, full download,
    resumable store. Returns the wanted-bbox GeoFrame (wanted_bboxes.csv
    equivalent)."""
    boxes = wanted_bboxes if wanted_bboxes is not None else tile_shapefile(coast, box_size)
    frame = gf.GeoFrame({"bbox_ind": range(len(boxes))}, geometry=boxes, crs=3857)

    for year in years:
        layer = layer_name(year)
        n_dl, n_blank, n_skip = 0, 0, 0
        for ind, b in enumerate(boxes):
            out_path = f"{out_prefix}/{layer}_{ind}.tif"
            if store.exists(out_path):
                n_skip += 1
                continue
            bbox = b.bounds
            for attempt in range(max_retries):
                try:
                    probe = transport.getmap(layer, bbox, PROBE_SIZE)
                    img = _decode_image(probe)
                    if img is None or is_blank(img):
                        n_blank += 1
                        break
                    full = transport.getmap(layer, bbox, FULL_SIZE)
                    store.put(out_path, full)
                    n_dl += 1
                    break
                except ConnectionError as e:  # keep going, resumable
                    log_warning("connection error on %s (%d/%d): %s", out_path, attempt + 1, max_retries, e)
        log_info("%s: %d downloaded, %d blank, %d already present", layer, n_dl, n_blank, n_skip)
    return frame
