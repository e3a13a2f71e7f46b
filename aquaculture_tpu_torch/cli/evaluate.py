"""Evaluation CLI of the PyTorch port: stratified k-fold grid search +
held-out test metrics.

Equivalent of the reference's get_kfold_cluster_performance.py __main__
(reference: src/get_kfold_cluster_performance.py:482-546) over local
GeoJSON/CSV artifacts, and of ``aquaculture_tpu.cli.evaluate``. The grid
sweep and the clustering run on the GPU (``--device cuda``, the default;
raises without one) or on the CPU (``--device cpu``); the spatial joins on
the host.

    python -m aquaculture_tpu_torch.cli.evaluate --detections D.geojson \\
        --labels L.geojson --images images.csv --out folds.csv
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import (
    OPTIMAL_CONF_THRESHOLD,
    OPTIMAL_DISTANCE_THRESHOLD,
    OPTIMAL_MIN_CLUSTER_SIZE,
    resolve_device,
)
from aquaculture_tpu_torch.eval.kfold import (
    GridConfig,
    kfold_cluster_performance,
    test_set_performance,
)


def main(argv=None) -> tuple:
    """Returns (fold results, held-out table, host seconds per stage)."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--detections", required=True, help="detections GeoJSON")
    ap.add_argument("--labels", required=True, help="human labels GeoJSON")
    ap.add_argument("--images", required=True, help="image metadata CSV (image, bucket columns)")
    ap.add_argument("--out", required=True, help="CSV output path for fold results")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--test-conf", type=float, default=OPTIMAL_CONF_THRESHOLD)
    ap.add_argument("--test-distance", type=float, default=OPTIMAL_DISTANCE_THRESHOLD)
    ap.add_argument("--test-min-size", type=int, default=OPTIMAL_MIN_CLUSTER_SIZE)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    seconds = {}
    t0 = time.perf_counter()
    dets = gf.read_file(args.detections)
    labels = gf.read_file(args.labels)
    images = pd.read_csv(args.images)
    strata = images["bucket"] if "bucket" in images.columns else np.zeros(len(images))
    seconds["read"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    grid = GridConfig(folds=args.folds, seed=args.seed)
    res = kfold_cluster_performance(images, dets, labels, strata, grid, device)
    res.to_csv(args.out, index=False)
    seconds["kfold"] = time.perf_counter() - t0
    print(f"[INFO] wrote {len(res)} fold results -> {args.out}")

    t0 = time.perf_counter()
    test = test_set_performance(
        images, dets, labels, args.test_conf, args.test_distance, args.test_min_size, device
    )
    seconds["held_out"] = time.perf_counter() - t0
    print(f"[INFO] held-out performance at tuned operating point:\n{test.to_string()}")
    print(f"[INFO] on {device}: " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()))
    return res, test, seconds


if __name__ == "__main__":
    main()
