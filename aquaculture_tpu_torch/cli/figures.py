"""Figures CLI: precision/recall curves and facility maps.
A copy of aquaculture_tpu/cli/figures.py in the PyTorch port.

Equivalent of the reference's figure scripts (reference:
src/Results/ModelPerformance.py main, FacilitiesMaps.py): threshold-sweep
P/R curves across pipeline stages (raw / ocean / clustered) and per-period
facility maps with Trujillo classification. The clustered stage's DBSCAN
labels run on the GPU (``--device cuda``, the default; raises without one)
or on the CPU (``--device cpu``); the classifications and plots are host
code, and the plots need matplotlib. ``--facility-pickle`` is read by the
restricted unpickler of tonnage/facility.py (either package's pickle).

    python -m aquaculture_tpu_torch.cli.figures --detections det.geojson \
        --labels labels.geojson --out-dir figures/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import (
    OPTIMAL_CONF_THRESHOLD,
    OPTIMAL_DISTANCE_THRESHOLD,
    OPTIMAL_MIN_CLUSTER_SIZE,
    resolve_device,
)
from aquaculture_tpu_torch.eval.kfold import clustered_detections
from aquaculture_tpu_torch.results.maps import (
    classify_facilities,
    classify_our_facilities,
    plot_combined_map,
    plot_facility_map,
    true_positive_facilities,
    trujillo_1km_boxes,
)
from aquaculture_tpu_torch.results.performance import plot_precision_recall_curves, stats_at_thresholds
from aquaculture_tpu_torch.tonnage.periods import load_trujillo_locations
from aquaculture_tpu_torch.utils.logging import log_info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--detections", required=True, help="all detections GeoJSON")
    ap.add_argument("--labels", required=True, help="human labels GeoJSON (farm-typed)")
    ap.add_argument("--ocean-detections", default=None, help="land-filtered detections GeoJSON")
    ap.add_argument("--facilities", default=None, help="facilities GeoJSON for the map")
    ap.add_argument("--facility-pickle", default=None,
                    help="AquaFacility pickle: emits the combined Figure-4 map (facilities.pdf)")
    ap.add_argument("--trujillo", default=None, help="Trujillo locations CSV")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--distance", type=float, default=OPTIMAL_DISTANCE_THRESHOLD)
    ap.add_argument("--min-size", type=int, default=OPTIMAL_MIN_CLUSTER_SIZE)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the clustered stage's DBSCAN (default cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    dets = gf.read_file(args.detections)
    labels = gf.read_file(args.labels).to_crs(dets.crs)
    if "type" in labels.columns:
        labels["type"] = labels["type"].replace(
            {"circle_cage": "circle_farm", "square_cage": "square_farm"}
        )

    thresholds = np.linspace(0, 1, 100)
    all_stats = stats_at_thresholds(labels, dets, thresholds)
    ocean_stats = None
    ocean = None
    if args.ocean_detections:
        ocean = gf.read_file(args.ocean_detections).to_crs(dets.crs)
        ocean.crs = dets.crs
        ocean_stats = stats_at_thresholds(labels, ocean, thresholds)
    # clustered stage at the tuned operating point's cluster params —
    # reuse the already-read-and-reprojected ocean frame (re-reading the
    # file and stamping dets.crs would relabel without transforming)
    base = ocean if ocean is not None else dets
    clustered = clustered_detections(
        base, conf_thresh=0.0, distance_threshold=args.distance, min_cluster_size=args.min_size,
        device=device,
    )
    cluster_stats = stats_at_thresholds(labels, clustered, thresholds)

    fig_path = os.path.join(args.out_dir, "performance_across_confidence.pdf")
    plot_precision_recall_curves(all_stats, ocean_stats, cluster_stats, out_path=fig_path)
    log_info("wrote %s", fig_path)

    if args.facility_pickle and args.trujillo:
        from aquaculture_tpu_torch.tonnage.facility import load_AquaFacility
        from aquaculture_tpu_torch.tonnage.periods import map_year_to_image_pass

        if not os.path.exists(args.facility_pickle):
            raise FileNotFoundError(args.facility_pickle)
        AF = load_AquaFacility(args.facility_pickle)
        tru = load_trujillo_locations(args.trujillo)
        # NOTE: pass the facility frame in its native CRS — GeoFrame.to_crs
        # (like geopandas) transforms only the active geometry column, and
        # true_positive_facilities derives its join boxes from the
        # circle/square cage-geometry columns
        fac_frame = AF.final_facilities
        tp = true_positive_facilities(
            fac_frame, labels.to_crs(fac_frame.crs or 3857), map_year_to_image_pass
        )
        combined = classify_our_facilities(tp, trujillo_1km_boxes(tru, box_crs=3035), tru)
        out = os.path.join(args.out_dir, "facilities.pdf")
        plot_combined_map(combined, out_path=out)
        log_info("wrote %s (%d true-positive facilities)", out, len(tp))

    if args.facilities and args.trujillo:
        fac = gf.read_file(args.facilities)
        tru = load_trujillo_locations(args.trujillo)
        boxes = trujillo_1km_boxes(tru)
        tagged = classify_facilities(fac, boxes)
        group_col = "pass" if "pass" in tagged.columns else ("year" if "year" in tagged.columns else None)
        periods = sorted(tagged[group_col].unique()) if group_col else [None]
        for p in periods:
            out = os.path.join(args.out_dir, f"facility_map_{p or 'all'}.png")
            plot_facility_map(tagged, trujillo=tru, period=p, out_path=out)
            log_info("wrote %s", out)


if __name__ == "__main__":
    main()
