"""Data-acquisition command surface: the reference's four L1 scripts as
one CLI (reference: src/load_data/load_shapefiles.py:14-39,
download_french_data.py:193-197, bathymetry_data.py:14,
create_land_filter.py:70-137). The port's counterpart of
aquaculture_tpu/cli/acquire.py, with the same subcommands, flags and
defaults. Host only: no device is used.

    python -m aquaculture_tpu_torch.cli.acquire shapefiles --out data/
    python -m aquaculture_tpu_torch.cli.acquire wms --coast coast.geojson \
        --years 2000 2004 --store data/
    python -m aquaculture_tpu_torch.cli.acquire bathymetry --out data/bathymetry/EMOD_2022.tif
    python -m aquaculture_tpu_torch.cli.acquire landfilter --coastline coast.shp \
        --country fr.geojson --eez eez.geojson --out land.geojson

Each subcommand is a thin file-IO shell over the injectable-transport
APIs in :mod:`aquaculture_tpu_torch.acquire`; everything network-shaped stays
resumable (skip-if-exists), exactly like the reference's loops.
"""

from __future__ import annotations

import argparse
import os


def _read_geo(path: str):
    """Read a GeoJSON or ESRI shapefile into a GeoFrame."""
    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.geo.shapefile import read_shapefile

    # accept any sibling of the shapefile set, like read_shapefile itself
    if path.lower().endswith((".shp", ".dbf", ".shx", ".prj")) or (
        not os.path.splitext(path)[1] and os.path.exists(path + ".shp")
    ):
        return read_shapefile(path)
    return gf.read_file(path)


def _cmd_shapefiles(args) -> None:
    from aquaculture_tpu_torch.acquire.shapefiles import load_shapefiles

    load_shapefiles(args.out)


def _cmd_wms(args) -> None:
    from aquaculture_tpu_torch.acquire.wms import (
        HttpWmsTransport,
        download_images_within_shape,
    )
    from aquaculture_tpu_torch.data.store import LocalBlobStore
    from aquaculture_tpu_torch.geo.io import to_wkt
    from aquaculture_tpu_torch.utils.logging import log_info

    coast = _read_geo(args.coast).to_crs(3857)
    transport = HttpWmsTransport(url=args.url) if args.url else HttpWmsTransport()
    store = LocalBlobStore(args.store)
    frame = download_images_within_shape(
        list(coast["geometry"]),
        args.years,
        transport,
        store,
        out_prefix=args.prefix,
        box_size=args.box_size,
    )
    if args.bboxes_out:
        # the reference's wanted_bboxes.csv format (utils.py:25-43): WKT
        # geometry column in EPSG:3857 — cli.geocode reads it back directly
        import pandas as pd

        pd.DataFrame(
            {
                "bbox_ind": list(frame["bbox_ind"]),
                "geometry": [to_wkt(g) for g in frame["geometry"]],
            }
        ).to_csv(args.bboxes_out, index=False)
        log_info("wrote %d download boxes -> %s", len(frame), args.bboxes_out)


def _cmd_bathymetry(args) -> None:
    from aquaculture_tpu_torch.acquire.bathymetry import build_bathymetry

    fetch = None
    if args.asc:
        # offline mode: mosaic local .asc grids instead of downloading
        paths = {os.path.splitext(os.path.basename(p))[0]: p for p in args.asc}

        def fetch(tile: str) -> str:
            for name, p in paths.items():
                if name.upper().startswith(tile.upper()):
                    with open(p) as f:
                        return f.read()
            raise FileNotFoundError(f"no local .asc matches tile {tile}: {args.asc}")

        tiles = list(paths)
        build_bathymetry(args.out, tiles=tiles, fetch=fetch)
        return
    build_bathymetry(args.out, tiles=args.tiles)


def _cmd_landfilter(args) -> None:
    from aquaculture_tpu_torch.geo import polygon as _poly
    from aquaculture_tpu_torch.utils.logging import log_info

    from aquaculture_tpu_torch.acquire.landfilter import build_land_filter

    coast = _read_geo(args.coastline)
    lines = []
    for g in coast["geometry"]:
        if isinstance(g, _poly.MultiLineString):
            lines.extend(g.geoms)
        elif isinstance(g, _poly.LineString):
            lines.append(g)
        elif isinstance(g, (_poly.Polygon, _poly.MultiPolygon)):
            lines.extend(g.boundary)
    if not lines:
        raise SystemExit(f"no linework found in {args.coastline}")
    country = list(_read_geo(args.country)["geometry"])[0]
    eez = list(_read_geo(args.eez)["geometry"])[0] if args.eez else None
    out = build_land_filter(
        lines, country, eez, keep_faces=tuple(args.keep_faces), crs=args.crs
    )
    out.to_file(args.out)
    log_info("wrote %d land polygons -> %s", len(out), args.out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sh = sub.add_parser("shapefiles", help="fetch + extract the bootstrap "
                        "shapefiles (EEA coastline, France grid; EEZ stays "
                        "a manual download, as the reference documents)")
    sh.add_argument("--out", required=True, help="data dir (zips extract under <out>/raw/)")
    sh.set_defaults(fn=_cmd_shapefiles)

    wm = sub.add_parser("wms", help="tile the coast into 1200 m boxes and "
                        "download WMS orthoimagery per year (probe -> blank "
                        "skip -> full fetch; resumable)")
    wm.add_argument("--coast", required=True, help="coast shape (GeoJSON or .shp)")
    wm.add_argument("--years", type=int, nargs="+", required=True)
    wm.add_argument("--store", required=True, help="local blob-store root for the .tifs")
    wm.add_argument("--prefix", default="coastal_french_data/tifs")
    wm.add_argument("--box-size", type=float, default=1200.0)
    wm.add_argument("--url", default=None, help="WMS endpoint override")
    wm.add_argument("--bboxes-out", default=None,
                    help="write the download boxes as wanted_bboxes.csv "
                         "(WKT, EPSG:3857) for cli.geocode/pipeline")
    wm.set_defaults(fn=_cmd_wms)

    ba = sub.add_parser("bathymetry", help="EMODnet .asc tiles -> one merged GeoTIFF")
    ba.add_argument("--out", required=True, help="output GeoTIFF path")
    ba.add_argument("--tiles", nargs="+", default=["F4", "F5", "E5"])
    ba.add_argument("--asc", nargs="+", default=None,
                    help="local .asc grid files (offline; skips the download)")
    ba.set_defaults(fn=_cmd_bathymetry)

    lf = sub.add_parser("landfilter", help="polygonize coastline linework "
                        "into the land filter (country minus EEZ, ranked faces)")
    lf.add_argument("--coastline", required=True, help="coastline linework (GeoJSON or .shp)")
    lf.add_argument("--country", required=True, help="country footprint polygon file")
    lf.add_argument("--eez", default=None, help="EEZ polygon file to subtract")
    lf.add_argument("--keep-faces", type=int, nargs="+", default=[0],
                    help="indices (by descending equal-area size) of faces "
                         "to keep as primary landmass (reference keeps 1st "
                         "and 5th; create_land_filter.py:104)")
    lf.add_argument("--crs", type=int, default=4326)
    lf.add_argument("--out", required=True, help="output land GeoJSON")
    lf.set_defaults(fn=_cmd_landfilter)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
