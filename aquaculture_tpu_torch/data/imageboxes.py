"""Image-box construction: per-tile geocoded boxes, blank-status screening,
whitespace geometry correction.
A copy of aquaculture_tpu/data/imageboxes.py in the PyTorch port.

Port of the reference's image-box pipeline (reference: src/utils.py:156-563):
each analysis tile gets a geocoded EPSG:3857 box derived from its parent
download box and pixel offsets; blank tiles are dropped; partly-blank tiles
get their geometry shrunk to the largest non-blank region. Imagery access is
dependency-injected through an ImageStore (local directory or GCS), so the
pipeline is testable offline and streams from object storage in production.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Protocol

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import IM_HEIGHT, IM_WIDTH, LARGE_TIF_SIZE
from aquaculture_tpu_torch.data.blank import is_blank, is_partly_blank
from aquaculture_tpu_torch.data.filenames import TileSpec, decode_tile_name, encode_tile_name
from aquaculture_tpu_torch.data.geotiff import read_image
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.geo.rasterize import largest_region_polygon
from aquaculture_tpu_torch.post.dedup import deduplicate_download_boxes, deduplicate_gdf_with_bboxes
from aquaculture_tpu_torch.utils.logging import log_info


class ImageStore(Protocol):
    def get(self, image_file: str) -> Optional[np.ndarray]: ...

    def list_images(self) -> List[str]: ...


class LocalImageStore:
    """Images in a local directory (the offline/test store)."""

    def __init__(self, root: str):
        self.root = root

    def get(self, image_file: str) -> Optional[np.ndarray]:
        path = os.path.join(self.root, image_file)
        if not os.path.exists(path):
            return None
        return read_image(path)

    def list_images(self) -> List[str]:
        return sorted(
            f for f in os.listdir(self.root) if f.endswith((".jpeg", ".jpg", ".png"))
        )


class GcsImageStore:
    """Images in a GCS bucket (requires google-cloud-storage at runtime)."""

    def __init__(self, bucket_name: str, prefix: str = "", user_project: Optional[str] = None):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise ImportError(
                "google-cloud-storage is required for GcsImageStore; use "
                "LocalImageStore for local imagery"
            ) from e
        client = storage.Client()
        self.bucket = storage.Bucket(client, bucket_name, user_project=user_project)
        self.client = client
        self.prefix = prefix

    def get(self, image_file: str):  # pragma: no cover - network
        import io

        from PIL import Image

        blob = self.bucket.blob(os.path.join(self.prefix, image_file))
        try:
            data = blob.download_as_bytes()
        except Exception:
            return None
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))

    def list_images(self):  # pragma: no cover - network
        return [
            os.path.relpath(b.name, self.prefix)
            for b in self.client.list_blobs(self.bucket, prefix=self.prefix)
        ]


def image_box_for_spec(spec: TileSpec, tif_bounds) -> _poly.Polygon:
    """EPSG:3857 box of one tile inside its parent download box
    (reference get_french_image_data, utils.py:156-189)."""
    xmin_m, ymin_m, xmax_m, ymax_m = tif_bounds
    sx = (xmax_m - xmin_m) / LARGE_TIF_SIZE
    sy = (ymax_m - ymin_m) / LARGE_TIF_SIZE
    x0 = xmin_m + spec.x_offset * sx
    y1 = ymax_m - spec.y_offset * sy
    x1 = xmin_m + (spec.x_offset + IM_WIDTH) * sx
    y0 = ymax_m - (spec.y_offset + IM_HEIGHT) * sy
    return _poly.box(x0, y0, x1, y1)


def build_image_boxes(
    image_files: Iterable[str], download_bboxes: "gf.GeoFrame"
) -> "gf.GeoFrame":
    """Geocoded box per tile file (reference get_french_image_boxes,
    utils.py:192-238; the GCS listing is supplied by the caller)."""
    bounds_by_ind = {
        int(i): g.bounds for i, g in zip(download_bboxes.index, download_bboxes["geometry"])
    }
    recs = {"year": [], "bbox_ind": [], "x_offset": [], "y_offset": [], "image_file": []}
    geoms = []
    for f in image_files:
        if "(" in f:  # reference skips GCS duplicate-suffix files (:221)
            continue
        spec = decode_tile_name(f)
        if spec.bbox_ind < 0 or spec.bbox_ind not in bounds_by_ind:
            continue
        geoms.append(image_box_for_spec(spec, bounds_by_ind[spec.bbox_ind]))
        recs["year"].append(spec.year)
        recs["bbox_ind"].append(spec.bbox_ind)
        recs["x_offset"].append(spec.x_offset)
        recs["y_offset"].append(spec.y_offset)
        recs["image_file"].append(os.path.basename(f))
    out = gf.GeoFrame(pd.DataFrame(recs), geometry=geoms, crs=3857)
    return out


def classify_blank_status(img: Optional[np.ndarray]) -> str:
    if img is None:
        return "blank"
    if is_blank(img):
        return "blank"
    if is_partly_blank(img):
        return "partly blank"
    return "complete"


def correct_partly_blank_geom(img: np.ndarray, complete_geom: _poly.Geometry) -> _poly.Geometry:
    """Shrink an image box to its largest non-blank region
    (reference utils.py:482-530): mask = max-channel < 250, largest
    8-connected region -> polygon, pixel->CRS affine, simplify(0.5)."""
    non_blank = np.max(np.asarray(img)[:, :, :3], axis=2) < 250.0
    poly_px = largest_region_polygon(non_blank)
    if poly_px is None or poly_px.is_empty:
        return _poly.Empty()
    minx, miny, maxx, maxy = complete_geom.bounds
    h, w = non_blank.shape
    a = (maxx - minx) / w
    e = -(maxy - miny) / h

    def fwd(xs, ys):
        return minx + np.asarray(xs) * a, maxy + np.asarray(ys) * e

    return poly_px.transform(fwd).simplify(0.5)


def remove_white_image_boxes(
    img_boxes: "gf.GeoFrame",
    store: ImageStore,
    blank_key: Optional[pd.DataFrame] = None,
) -> "gf.GeoFrame":
    """Drop blank tiles, shrink partly-blank tiles
    (reference utils.py:392-479). blank_key (image_file, image_status) can
    be supplied to skip re-screening (the reference's cached CSV)."""
    boxes = img_boxes.copy()
    boxes.crs = img_boxes.crs
    if "image_file" not in boxes.columns:
        boxes["image_file"] = [
            encode_tile_name(
                TileSpec(year=int(y), bbox_ind=int(b), x_offset=int(x), y_offset=int(yo))
            )
            for y, b, x, yo in zip(
                boxes["year"], boxes["bbox_ind"], boxes["x_offset"], boxes["y_offset"]
            )
        ]

    if blank_key is None:
        status = [classify_blank_status(store.get(f)) for f in boxes["image_file"]]
        boxes["image_status"] = status
    else:
        key = dict(zip(blank_key["image_file"], blank_key["image_status"]))
        boxes["image_status"] = [key.get(f, "blank") for f in boxes["image_file"]]

    keep_complete = boxes[boxes["image_status"] == "complete"].copy()
    partly = boxes[boxes["image_status"] == "partly blank"].copy()

    new_geoms = []
    keep_rows = []
    for i, (_, row) in enumerate(partly.iterrows()):
        img = store.get(row["image_file"])
        if img is None:
            continue
        g = correct_partly_blank_geom(img, row["geometry"])
        if g.is_empty:
            continue
        keep_rows.append(i)
        new_geoms.append(g)
    partly = partly.iloc[keep_rows].copy()
    partly["geometry"] = new_geoms

    out = pd.concat([partly, keep_complete])
    out = gf.GeoFrame(out)
    out.crs = img_boxes.crs
    log_info("%d image boxes after blank screening", len(out))
    return out


def load_final_image_boxes(
    download_bboxes: "gf.GeoFrame",
    store: ImageStore,
    cache_dir: Optional[str] = None,
) -> "gf.GeoFrame":
    """Full pipeline: list imagery -> geocode boxes -> dedup vs download
    boxes -> blank screening (reference load_final_image_boxes,
    utils.py:533-563), with artifact-file caching when cache_dir is set."""
    cache = os.path.join(cache_dir, "image_boxes_rmblank.geojson") if cache_dir else None
    if cache and os.path.exists(cache):
        log_info("loading image boxes from %s", cache)
        return gf.read_file(cache)

    boxes = build_image_boxes(store.list_images(), download_bboxes)
    dedup = deduplicate_download_boxes(download_bboxes)
    boxes = deduplicate_gdf_with_bboxes(dedup, boxes)
    boxes = remove_white_image_boxes(boxes, store)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        boxes.to_file(cache)
    return boxes
