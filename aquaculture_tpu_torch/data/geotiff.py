"""GeoTIFF read/write without GDAL, and plain image decode: a copy of
aquaculture_tpu/data/geotiff.py.

Georeferencing is parsed directly from the TIFF tags (ModelPixelScale
33550, ModelTiepoint 33922, GeoKeyDirectory 34735) with PIL doing the
raster decode (the reference shells into GDAL, src/load_data/
tile_tifs.py:29-47). Only the pipeline's cases are covered: north-up
rasters (no rotation terms), single image per file, EPSG-coded CRS. The
tonnage path reads bathymetry through ``read_geotiff``.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional, Tuple

import numpy as np

TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_GEO_KEY_DIRECTORY = 34735
KEY_PROJECTED_CRS = 3072
KEY_GEOGRAPHIC_CRS = 2048


@dataclasses.dataclass
class GeoTiff:
    """A decoded north-up GeoTIFF: pixel array + affine georeference."""

    array: np.ndarray          # (H, W, C) or (H, W)
    origin_x: float            # CRS x of the outer corner of pixel (0, 0)
    origin_y: float            # CRS y of the outer corner of pixel (0, 0)
    pixel_w: float             # CRS units per pixel in x (> 0)
    pixel_h: float             # CRS units per pixel in y (> 0; rows go south)
    epsg: Optional[int] = None

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        h, w = self.array.shape[:2]
        return (
            self.origin_x,
            self.origin_y - h * self.pixel_h,
            self.origin_x + w * self.pixel_w,
            self.origin_y,
        )

    def pixel_box_to_crs(self, x0: float, y0: float, x1: float, y1: float):
        """Pixel-space box (x right, y down) -> CRS (minx, miny, maxx, maxy)."""
        return (
            self.origin_x + x0 * self.pixel_w,
            self.origin_y - y1 * self.pixel_h,
            self.origin_x + x1 * self.pixel_w,
            self.origin_y - y0 * self.pixel_h,
        )


def _parse_epsg(geokeys: Tuple[int, ...]) -> Optional[int]:
    if len(geokeys) < 4:
        return None
    n = geokeys[3]
    epsg = None
    for i in range(n):
        kid, loc, _cnt, val = geokeys[4 + 4 * i : 8 + 4 * i]
        if loc == 0 and kid in (KEY_PROJECTED_CRS, KEY_GEOGRAPHIC_CRS):
            if kid == KEY_PROJECTED_CRS:
                return int(val)  # projected key wins
            epsg = int(val)
    return epsg


def read_geotiff(path: str) -> GeoTiff:
    from PIL import Image

    with Image.open(path) as im:
        tags = dict(im.tag_v2) if hasattr(im, "tag_v2") else {}
        arr = np.asarray(im)

    scale = tags.get(TAG_MODEL_PIXEL_SCALE)
    tie = tags.get(TAG_MODEL_TIEPOINT)
    if scale is None or tie is None:
        raise ValueError(f"{path}: missing GeoTIFF georeference tags")
    sx, sy = float(scale[0]), float(scale[1])
    # tiepoint: (i, j, k, x, y, z) — raster point (i,j) maps to CRS (x,y)
    i, j, _, x, y, _ = (float(v) for v in tie[:6])
    origin_x = x - i * sx
    origin_y = y + j * sy
    epsg = _parse_epsg(tuple(int(v) for v in tags.get(TAG_GEO_KEY_DIRECTORY, ())))
    return GeoTiff(array=arr, origin_x=origin_x, origin_y=origin_y, pixel_w=sx, pixel_h=sy, epsg=epsg)


def write_geotiff(
    path: str,
    arr: np.ndarray,
    bounds: Tuple[float, float, float, float],
    epsg: int = 3857,
) -> None:
    """Write a north-up GeoTIFF (uncompressed) with georeference tags."""
    from PIL import Image
    from PIL.TiffImagePlugin import ImageFileDirectory_v2

    h, w = arr.shape[:2]
    minx, miny, maxx, maxy = bounds
    sx, sy = (maxx - minx) / w, (maxy - miny) / h

    ifd = ImageFileDirectory_v2()
    ifd[TAG_MODEL_PIXEL_SCALE] = (sx, sy, 0.0)
    ifd.tagtype[TAG_MODEL_PIXEL_SCALE] = 12  # DOUBLE
    ifd[TAG_MODEL_TIEPOINT] = (0.0, 0.0, 0.0, minx, maxy, 0.0)
    ifd.tagtype[TAG_MODEL_TIEPOINT] = 12
    is_projected = epsg not in (4326, 4258)
    key_id = KEY_PROJECTED_CRS if is_projected else KEY_GEOGRAPHIC_CRS
    ifd[TAG_GEO_KEY_DIRECTORY] = (1, 1, 0, 2, 1024, 0, 1, 1 if is_projected else 2, key_id, 0, 1, epsg)
    ifd.tagtype[TAG_GEO_KEY_DIRECTORY] = 3  # SHORT

    Image.fromarray(arr).save(path, format="TIFF", tiffinfo=ifd)


def read_image(path: str) -> np.ndarray:
    """Plain image decode (JPEG/PNG/TIFF) to a (H, W, C) uint8 array."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


TAG_ORIENTATION = 274
TAG_EXTRA_SAMPLES = 338
EXTRASAMPLE_UNASSALPHA = 2
# PIL's orientation fix-up (its EXIF transpose at load) undone: 2 mirror,
# 3 turn half round, 4 upside down, 5 transpose, 6 rotate 270, 7
# transverse, 8 rotate 90
_UNDO_PIL_ORIENTATION = {
    2: lambda a: a[:, ::-1],
    3: lambda a: a[::-1, ::-1],
    4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2),
    6: lambda a: np.rot90(a, 1),
    7: lambda a: np.rot90(a, 2).transpose(1, 0, 2),
    8: lambda a: np.rot90(a, -1),
}
# libtiff's TIFFReadRGBAImageOriented(..., ORIENTATION_TOPLEFT) on the
# stored rows: tif_getimage.c's setorientation flips and never transposes,
# so 5-8 read as 1-4
_LIBTIFF_ORIENTATION = {**{o: _UNDO_PIL_ORIENTATION[o] for o in (2, 3, 4)}, 5: lambda a: a,
                        **{o: _UNDO_PIL_ORIENTATION[o - 4] for o in (6, 7, 8)}}


def read_tiff_rgba(path: str) -> np.ndarray:
    """A TIFF's (H, W, 3) uint8 pixels as libtiff's RGBA interface gives
    them (``TIFFReadRGBAImageOriented(..., ORIENTATION_TOPLEFT)``, the JAX
    package's tileloader.cc), from PIL's decode and the file's tags:
    - unassociated alpha (ExtraSamples 2) premultiplied, (c * a + 127) // 255
      (tif_getimage.c's UaToAa table); associated alpha (ExtraSamples 1)
      decoded without PIL's un-premultiplying rawmode, so that the colour
      samples come out as stored (putRGBAAcontig8bittile);
    - CMYK (Photometric 5) from PIL's raw samples by
      putRGBcontig8bitCMYKtile's (255 - K) * (255 - C) // 255;
    - 16-bit grey reduced to its high byte (put16bitbwtile);
    - orientations 5-8 as libtiff lays them out: the stored rows flipped as
      for 1-4 (5 as stored, 6 mirrored, 7 turned half round, 8 upside
      down), where PIL transposes them.
    Anything else as ``read_image`` gives it."""
    from PIL import Image

    with Image.open(path) as im:
        orientation = im.tag_v2.get(TAG_ORIENTATION, 1)
        unassociated = tuple(im.tag_v2.get(TAG_EXTRA_SAMPLES, ()))[:1] == (EXTRASAMPLE_UNASSALPHA,)
        # PIL's "RGBa" rawmode divides by the alpha as it unpacks; "RGBA" keeps the samples
        im.tile = [t._replace(args=("RGBA" + t.args[0][4:],) + tuple(t.args[1:]))
                   if t.args and str(t.args[0]).startswith("RGBa") else t for t in im.tile]
        im.load()
        applied = TAG_ORIENTATION not in im.tag_v2  # PIL drops the tag once it has applied it
        if im.mode == "RGBA" and unassociated:
            rgba = np.asarray(im).astype(np.uint32)
            arr = ((rgba[..., :3] * rgba[..., 3:] + 127) // 255).astype(np.uint8)
        elif im.mode == "CMYK":
            cmyk = np.asarray(im).astype(np.uint32)
            arr = ((255 - cmyk[..., 3:]) * (255 - cmyk[..., :3]) // 255).astype(np.uint8)
        elif im.mode.startswith("I;16"):
            arr = np.repeat((np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8)[..., None], 3, -1)
        else:
            arr = np.asarray(im.convert("RGB"))
    if orientation in _LIBTIFF_ORIENTATION:
        if applied:
            arr = _UNDO_PIL_ORIENTATION[orientation](arr)
        arr = _LIBTIFF_ORIENTATION[orientation](arr)
    return np.array(arr, order="C")  # a writable copy, as read_image's callers get


def read_image_bytes(data: bytes) -> np.ndarray:
    """Decode an in-memory image blob (the store streaming path) to (H, W, C)
    uint8 with the decoder of ``read_image``, so a store corpus and a file
    corpus give the same pixels."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))
