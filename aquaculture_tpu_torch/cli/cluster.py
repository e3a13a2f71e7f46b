"""Clustering CLI of the PyTorch port: detections.geojson -> facilities.geojson.

Equivalent of the reference's predictions_cluster entry
(reference: src/cluster_facilities.py:181-208, wired by
src/Results/generate_facilities.py with the tuned operating point
conf=0.785, eps=50 m, min size=5; README.md:113) and of
``aquaculture_tpu.cli.cluster``. The DBSCAN labels are computed on the GPU
(``--device cuda``, the default; raises without one) or on the CPU
(``--device cpu``); the facility aggregation runs on the host.

    python -m aquaculture_tpu_torch.cli.cluster --detections detections.geojson \\
        --out facilities.geojson [--conf 0.785] [--distance 50] [--min-size 5]
"""

from __future__ import annotations

import argparse
import time

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import (
    OPTIMAL_CONF_THRESHOLD,
    OPTIMAL_DISTANCE_THRESHOLD,
    OPTIMAL_MIN_CLUSTER_SIZE,
    resolve_device,
)
from aquaculture_tpu_torch.geo import io as _geoio
from aquaculture_tpu_torch.post.cluster import predictions_cluster


def main(argv=None) -> "gf.GeoFrame":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--detections", required=True)
    ap.add_argument("--out", required=True, help="facilities.geojson output path")
    ap.add_argument("--conf", type=float, default=OPTIMAL_CONF_THRESHOLD)
    ap.add_argument("--distance", type=float, default=OPTIMAL_DISTANCE_THRESHOLD)
    ap.add_argument("--min-size", type=int, default=OPTIMAL_MIN_CLUSTER_SIZE)
    ap.add_argument("--cluster-variable", default="year")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    det = gf.read_file(args.detections)
    if "index" not in det.columns:
        det["index"] = range(len(det))
    has_area = "area" in det.columns
    det = det.to_crs(3035)
    fac = predictions_cluster(
        det,
        cluster_variable=args.cluster_variable,
        conf_thresh=args.conf,
        distance_threshold=args.distance,
        min_cluster_size=args.min_size,
        include_area=has_area,
        device=device,
    )
    # Cast farm-geometry columns to WKT for GeoJSON storage
    # (reference cluster_facilities.py:160-165)
    for col in [c for c in fac.columns if c.endswith("_farm_geoms")]:
        fac[col] = [_geoio.to_wkt(g) for g in fac[col]]
    fac.to_file(args.out)
    print(f"[INFO] {len(det)} detections -> {len(fac)} facilities on {device} in "
          f"{time.perf_counter() - t0:.3f} s -> {args.out}")
    return fac


if __name__ == "__main__":
    main()
