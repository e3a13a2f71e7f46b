"""Facility-generation CLI: build + pickle AquaFacility objects.
A copy of aquaculture_tpu/cli/facilities.py in the PyTorch port.

Equivalent of the reference's generate_facilities.py (reference:
src/Results/generate_facilities.py): construct the prediction facility at
the tuned operating point (conf 0.785, eps 50 m, min size 5; README.md:113),
attach min/max cage selections and bathymetry depth, pickle. The DBSCAN labels run on the GPU (``--device cuda``, the default;
raises without one) or on the CPU (``--device cpu``).

    python -m aquaculture_tpu_torch.cli.facilities --detections det.geojson \\
        --image-boxes boxes.geojson --out facility.pkl [--bathymetry bathy.tif]
"""

from __future__ import annotations

import argparse
import os

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import (
    OPTIMAL_CONF_THRESHOLD,
    OPTIMAL_DISTANCE_THRESHOLD,
    OPTIMAL_MIN_CLUSTER_SIZE,
    resolve_device,
)
from aquaculture_tpu_torch.tonnage.facility import AquaFacility
from aquaculture_tpu_torch.tonnage.periods import map_year_to_image_pass
from aquaculture_tpu_torch.utils.logging import log_info


def main(argv=None) -> AquaFacility:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--detections", required=True, help="ocean_detections.geojson path")
    ap.add_argument("--image-boxes", required=True, help="image boxes GeoJSON (blank-screened)")
    ap.add_argument("--out", required=True, help="output pickle path")
    ap.add_argument("--bathymetry", default=None, help="merged bathymetry GeoTIFF")
    ap.add_argument("--conf", type=float, default=OPTIMAL_CONF_THRESHOLD)
    ap.add_argument("--distance", type=float, default=OPTIMAL_DISTANCE_THRESHOLD)
    ap.add_argument("--min-size", type=int, default=OPTIMAL_MIN_CLUSTER_SIZE)
    ap.add_argument("--image-selection", default="random", choices=["random", "min", "max"])
    ap.add_argument("--min-cage-threshold", type=float, default=5.0)
    ap.add_argument("--default-cage-depth", type=float, default=10.0)
    ap.add_argument("--no-min-max", action="store_true", help="skip min/max selection bounds")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    preds = gf.read_file(args.detections)
    boxes = gf.read_file(args.image_boxes)
    fac = AquaFacility(
        preds=preds,
        image_boxes=boxes,
        selected_map=map_year_to_image_pass,
        image_selection=args.image_selection,
        confidence_threshold=args.conf,
        distance_threshold=args.distance,
        min_cluster_size=args.min_size,
        time_group="pass",
        device=device,
    )
    if not args.no_min_max:
        fac.compute_min_max_cages()
    if args.bathymetry:
        fac.add_depth(
            min_cage_threshold=args.min_cage_threshold,
            default_cage_depth=args.default_cage_depth,
            bathymetry_path=args.bathymetry,
        )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fac.save(args.out)
    log_info("saved AquaFacility (%d facilities) -> %s", len(fac.final_facilities), args.out)
    return fac


if __name__ == "__main__":
    main()
