"""Tonnage CLI: AquaFacility pickle -> per-period tonnage estimates + plots.
A copy of aquaculture_tpu/cli/tonnage.py in the PyTorch port.

Equivalent of the reference's tonnage_estimates.py __main__
(reference: src/Results/tonnage_estimates.py:323-410): fit model-error
distributions, build the production-factor table, run the K=10,000
bootstrap with missing-imagery imputation, emit the CSV and Figure-6 plot,
and print the Trujillo comparison. The bootstrap runs on the GPU
(``--device cuda``, the default; raises without one) or on the CPU
(``--device cpu``); a pickle that either package wrote loads.

    python -m aquaculture_tpu_torch.cli.tonnage --facility facility.pkl \\
        --labels labels.geojson --detections det.geojson --download-bboxes boxes.csv \\
        --prod-factors factors.xlsx --fao fao.csv --out tonnage.csv [--K 10000]
"""

from __future__ import annotations

import argparse
import os
import time

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import resolve_device
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.results.tonnage_report import (
    combined_tonnage_plot,
    compute_complete_tonnage_estimates,
    trujillo_comparison,
)
from aquaculture_tpu_torch.tonnage.errors import define_model_error_distributions
from aquaculture_tpu_torch.tonnage.facility import load_AquaFacility
from aquaculture_tpu_torch.tonnage.factors import (
    generate_period_production_factors,
    load_fao_french_mediterranean,
    load_production_factors,
)
from aquaculture_tpu_torch.results.maps import trujillo_1km_boxes
from aquaculture_tpu_torch.tonnage.periods import load_trujillo_locations, map_year_to_image_pass
from aquaculture_tpu_torch.post.dedup import deduplicate_download_boxes
from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
from aquaculture_tpu_torch.utils.logging import log_info


def main(argv=None) -> "pd.DataFrame":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--facility", required=True, help="AquaFacility pickle path")
    ap.add_argument("--labels", required=True, help="humanlabels.geojson path")
    ap.add_argument("--detections", required=True, help="ocean_detections.geojson path")
    ap.add_argument("--download-bboxes", required=True, help="wanted_bboxes.csv path")
    ap.add_argument("--prod-factors", required=True, help="production factors .xlsx")
    ap.add_argument("--fao", required=True, help="FAO French-Med production CSV")
    ap.add_argument("--trujillo", default=None, help="Trujillo locations CSV")
    ap.add_argument("--out", required=True, help="output CSV path")
    ap.add_argument("--plot", default=None, help="optional figure output path")
    ap.add_argument("--conf", type=float, default=0.785)
    ap.add_argument("--min-cage-threshold", type=float, default=5.0)
    ap.add_argument("--depth-mixture", type=float, default=0.85)
    ap.add_argument("--K", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    facility = load_AquaFacility(args.facility)
    facility.device = str(device)
    facility.compute_min_max_cages()

    labels = gf.read_file(args.labels)
    dets = gf.read_file(args.detections)
    dl = load_download_bboxes(args.download_bboxes)
    dedup = deduplicate_download_boxes(dl)
    errs = define_model_error_distributions(
        labels, dets, dedup, map_year_to_image_pass, args.conf
    )
    log_info("error distributions:\n%s", errs.to_string(index=False))

    table = load_production_factors(args.prod_factors)
    fao = load_fao_french_mediterranean(args.fao, map_year_to_image_pass)
    pft = generate_period_production_factors(table, fao, "pass")

    t0 = time.perf_counter()
    est = compute_complete_tonnage_estimates(
        facility, errs, pft, args.min_cage_threshold, args.depth_mixture,
        K=args.K, seed=args.seed,
    )
    log_info("%d periods at K=%d on %s in %.3f s", len(est), args.K, device, time.perf_counter() - t0)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    est.to_csv(args.out)
    log_info("tonnage estimates:\n%s\n-> %s", est.round(1).to_string(), args.out)

    if args.plot:
        fao_by_period = fao.groupby("pass")["production_quantity"].sum()
        combined_tonnage_plot(est, fao_by_period=fao_by_period, out_path=args.plot)
        log_info("wrote figure -> %s", args.plot)

    if args.trujillo:
        tru = load_trujillo_locations(args.trujillo)
        # reference tonnage_estimates.py:279-287: +/-1000 m boxes drawn in
        # EPSG:3035, unioned in EPSG:3857 (trujillo_1km_boxes replicates
        # exactly that, including the box-size convention)
        boxes = _poly.unary_union(
            list(trujillo_1km_boxes(tru, box_crs=3035)["geometry"])
        )
        cmp = trujillo_comparison(
            facility, boxes, errs, pft, args.min_cage_threshold, args.depth_mixture,
            K=args.K, bound_crs=3857,
        )
        log_info("Trujillo comparison:\n%s", cmp.to_string(index=False))
    return est


if __name__ == "__main__":
    main()
