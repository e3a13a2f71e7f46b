"""Geocoding CLI of the PyTorch port: YOLO label .txt files -> detections.geojson.

Equivalent of the reference's geocode_results.py __main__
(reference: src/process_yolo/geocode_results.py:221-271) and of
``aquaculture_tpu.cli.geocode``: parse label files, geocode to
EPSG:3857/3035/4326, dedup against overlapping download boxes, optionally
drop land detections. Host only (numpy).

Output CRS — intentional difference: the reference saves its GeoJSONs in
the CRS left over from dedup, EPSG:3857 (geocode_results.py:260-271);
this CLI writes EPSG:4326, which is what RFC 7946 GeoJSON requires.

    python -m aquaculture_tpu_torch.cli.geocode --labels LABELS/ \\
        --download-bboxes wanted_bboxes.csv --out detections.geojson \\
        [--land LAND.geojson --ocean-out ocean_detections.geojson]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.data.filenames import decode_tile_name
from aquaculture_tpu_torch.post.dedup import deduplicate_download_boxes, deduplicate_gdf_with_bboxes
from aquaculture_tpu_torch.post.geocode import (
    geocode_detections,
    remove_land_detections,
    yolo_norm_to_pixels,
)


def load_download_bboxes(path: str) -> "gf.GeoFrame":
    """Load wanted_bboxes.csv (WKT geometry column; reference utils.py:25-43)."""
    df = pd.read_csv(path)
    col = "geometry" if "geometry" in df.columns else df.columns[-1]
    return gf.from_wkt_column(df, column=col, crs=3857)


def read_labels(label_dir: str):
    """Parse all YOLO label files -> (boxes_px, conf, cls, specs)."""
    boxes, confs, clss, specs = [], [], [], []
    for path in sorted(glob.glob(os.path.join(label_dir, "*.txt"))):
        spec = decode_tile_name(path)
        rows = np.loadtxt(path, ndmin=2)
        if rows.size == 0:
            continue
        boxes.append(yolo_norm_to_pixels(rows[:, 1:5]))
        confs.append(rows[:, 5] if rows.shape[1] > 5 else np.ones(len(rows)))
        clss.append(rows[:, 0].astype(np.int64))
        specs.extend([spec] * len(rows))
    if boxes:
        return np.concatenate(boxes), np.concatenate(confs), np.concatenate(clss), specs
    return np.zeros((0, 4), np.int64), np.zeros(0), np.zeros(0, np.int64), []


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--labels", required=True, help="directory of YOLO .txt label files")
    ap.add_argument("--download-bboxes", required=True, help="wanted_bboxes.csv path")
    ap.add_argument("--out", required=True, help="detections.geojson output path")
    ap.add_argument("--ocean-out", default=None, help="ocean_detections.geojson output path")
    ap.add_argument("--land", default=None, help="land polygons GeoJSON for the ocean filter")
    ap.add_argument("--no-dedup", action="store_true")
    args = ap.parse_args(argv)

    boxes, conf, cls, specs = read_labels(args.labels)
    print(f"[INFO] parsed {len(boxes)} detections from {args.labels}")
    dl = load_download_bboxes(args.download_bboxes)
    det = geocode_detections(boxes, conf, cls, specs, dl)

    if not args.no_dedup and len(det):
        dd = deduplicate_download_boxes(dl)
        det["bbox_ind"] = [s.bbox_ind for s in specs]
        det = deduplicate_gdf_with_bboxes(dd, det)
        det = det.drop(columns=["bbox_ind"])
        det.crs = 4326

    det.to_file(args.out)
    print(f"[INFO] wrote {len(det)} detections -> {args.out}")

    if args.land and args.ocean_out:
        land = gf.read_file(args.land)
        ocean = remove_land_detections(det, land)
        ocean.to_file(args.ocean_out, index=True)
        print(f"[INFO] wrote {len(ocean)} ocean detections -> {args.ocean_out}")


if __name__ == "__main__":
    main()
