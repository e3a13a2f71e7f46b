"""Bathymetry acquisition: EMODnet .asc grids -> one merged GeoTIFF.
A copy of aquaculture_tpu/acquire/bathymetry.py in the PyTorch port.

Port of the reference's bathymetry step (reference:
src/load_data/bathymetry_data.py): download EMODnet tiles (F4/F5/E5 .asc),
merge into data/bathymetry/EMOD_2022.tif. The ESRI ASCII-grid reader and
mosaic replace rasterio.merge; download is behind a fetch callable.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

from aquaculture_tpu_torch.data.geotiff import GeoTiff, write_geotiff
from aquaculture_tpu_torch.utils.logging import log_info

EMOD_TILES = ("F4", "F5", "E5")  # reference bathymetry_data.py tile set
EMOD_URL = "https://downloads.emodnet-bathymetry.eu/v11/{tile}_2022.asc.zip"


def read_asc(path_or_text) -> GeoTiff:
    """Parse an ESRI ASCII grid into a GeoTiff (nodata -> NaN)."""
    if isinstance(path_or_text, str) and os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    lines = text.splitlines()
    hdr = {}
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if len(parts) == 2 and parts[0].lower() in (
            "ncols", "nrows", "xllcorner", "yllcorner", "xllcenter", "yllcenter",
            "cellsize", "nodata_value",
        ):
            hdr[parts[0].lower()] = float(parts[1])
            i += 1
        else:
            break
    ncols, nrows = int(hdr["ncols"]), int(hdr["nrows"])
    cell = hdr["cellsize"]
    if "xllcorner" in hdr:
        x0, y0 = hdr["xllcorner"], hdr["yllcorner"]
    else:  # center registration
        x0, y0 = hdr["xllcenter"] - cell / 2, hdr["yllcenter"] - cell / 2
    data = np.loadtxt(lines[i:]).reshape(nrows, ncols)
    nodata = hdr.get("nodata_value")
    if nodata is not None:
        data = np.where(data == nodata, np.nan, data)
    return GeoTiff(
        array=data.astype(np.float32),
        origin_x=x0,
        origin_y=y0 + nrows * cell,
        pixel_w=cell,
        pixel_h=cell,
        epsg=4326,
    )


def merge_asc_grids(grids: Sequence[GeoTiff]) -> GeoTiff:
    """Mosaic same-resolution grids into one raster (first wins on overlap,
    matching rasterio.merge defaults)."""
    assert grids
    cell = grids[0].pixel_w
    for g in grids:
        assert abs(g.pixel_w - cell) < 1e-12 and abs(g.pixel_h - cell) < 1e-12, "resolution mismatch"
    minx = min(g.bounds[0] for g in grids)
    miny = min(g.bounds[1] for g in grids)
    maxx = max(g.bounds[2] for g in grids)
    maxy = max(g.bounds[3] for g in grids)
    w = int(round((maxx - minx) / cell))
    h = int(round((maxy - miny) / cell))
    out = np.full((h, w), np.nan, np.float32)
    for g in grids:
        gh, gw = g.array.shape[:2]
        col = int(round((g.bounds[0] - minx) / cell))
        row = int(round((maxy - g.bounds[3]) / cell))
        target = out[row : row + gh, col : col + gw]
        src = np.asarray(g.array, np.float32)
        fill = np.isnan(target)
        target[fill] = src[fill]
    return GeoTiff(array=out, origin_x=minx, origin_y=maxy, pixel_w=cell, pixel_h=cell, epsg=4326)


def build_bathymetry(
    out_path: str,
    tiles: Sequence[str] = EMOD_TILES,
    fetch: Optional[Callable[[str], str]] = None,
) -> GeoTiff:
    """Fetch + merge + write the bathymetry raster.

    fetch(tile) -> .asc text; defaults to downloading from EMODnet
    (network)."""
    if fetch is None:  # pragma: no cover - network
        import io
        import urllib.request
        import zipfile

        def fetch(tile: str) -> str:
            with urllib.request.urlopen(EMOD_URL.format(tile=tile)) as r:
                z = zipfile.ZipFile(io.BytesIO(r.read()))
            name = next(n for n in z.namelist() if n.endswith(".asc"))
            return z.read(name).decode()

    grids = [read_asc(fetch(t)) for t in tiles]
    merged = merge_asc_grids(grids)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_geotiff(out_path, merged.array, merged.bounds, epsg=4326)
    log_info("wrote merged bathymetry (%dx%d) -> %s", *merged.array.shape[:2], out_path)
    return merged
