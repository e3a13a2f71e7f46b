"""aq-plan: print the measured serving recommendation for a workload.

The port's counterpart of aquaculture_tpu/cli/plan.py, with the same flags,
refusals and output. The decision rules are the H100 readings of
scripts/plan_sweep.py (models/plan.py, PERF.md section 5); each printed
choice carries its provenance. Host only: no device is used. Example:

    python -m aquaculture_tpu_torch.cli.plan                      # batched throughput serving
    python -m aquaculture_tpu_torch.cli.plan --latency-sensitive  # single-tile p50 path
    python -m aquaculture_tpu_torch.cli.plan --pt-interop --json  # machine-readable
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--img", type=int, default=None,
                    help="serving resolution (default: the chosen variant's "
                         "native size — 1280 for P6, else 640; serving mode "
                         "only). An explicit value is honored verbatim")
    ap.add_argument("--variant", default=None,
                    help="pin a variant; default: recommend one")
    ap.add_argument("--latency-sensitive", action="store_true",
                    help="optimize single-tile p50, not batched throughput")
    ap.add_argument("--pt-interop", action="store_true",
                    help="weights must round-trip with ultralytics .pt")
    ap.add_argument("--boundary-accuracy", action="store_true",
                    help="tile-boundary detections matter most (P6 family; "
                         "overlap serving if a non-P6 variant is pinned)")
    ap.add_argument("--scale-shifted", action="store_true",
                    help="object scales uncertain / beyond the trained range "
                    "(turns on multi-scale TTA)")
    ap.add_argument("--train", action="store_true",
                    help="recommend a TRAINING configuration instead "
                    "(variant/batch/dtype/remat/augment recipe/feed cores)")
    ap.add_argument("--small-targets", action="store_true",
                    help="(--train) objects are small relative to the image: "
                    "moderate the affine scale jitter")
    ap.add_argument("--memory-constrained", action="store_true",
                    help="(--train) per-chip batch doesn't fit HBM: turn on "
                    "remat instead of shrinking the batch")
    ap.add_argument("--json", action="store_true", help="emit one JSON object")
    args = ap.parse_args(argv)

    # each mode ignores the other's knobs — refuse instead of printing a
    # plan that silently dropped a stated constraint
    if args.train:
        bad = [f for f, on in (("--latency-sensitive", args.latency_sensitive),
                               ("--boundary-accuracy", args.boundary_accuracy),
                               ("--scale-shifted", args.scale_shifted),
                               ("--img", args.img is not None)) if on]
        if bad:
            ap.error(f"{' '.join(bad)}: serving-only flag(s) have no effect "
                     "with --train")
    else:
        bad = [f for f, on in (("--small-targets", args.small_targets),
                               ("--memory-constrained", args.memory_constrained))
               if on]
        if bad:
            ap.error(f"{' '.join(bad)}: training-only flag(s) need --train")

    # deferred: keep --help free of the torch import chain
    from aquaculture_tpu_torch.models.plan import recommend_serving, recommend_training

    if args.train:
        plan = recommend_training(
            pt_interop=args.pt_interop,
            small_targets=args.small_targets,
            memory_constrained=args.memory_constrained,
            variant=args.variant,
        )
        if args.json:
            print(json.dumps(dataclasses.asdict(plan)))
            return
        print(f"variant={plan.variant} batch={plan.batch} "
              f"dtype={plan.compute_dtype} remat={plan.remat} "
              f"augment={plan.augment} mosaic={plan.mosaic} "
              f"scale={plan.scale_jitter} budget_x={plan.budget_multiplier} "
              f"feed_cores={plan.feed_cores}")
        for note in plan.notes:
            print(f"  - {note}")
        return

    plan = recommend_serving(
        img=args.img,
        latency_sensitive=args.latency_sensitive,
        pt_interop=args.pt_interop,
        boundary_accuracy=args.boundary_accuracy,
        scale_shifted=args.scale_shifted,
        variant=args.variant,
    )
    if args.json:
        print(json.dumps(dataclasses.asdict(plan)))
        return
    print(f"variant={plan.variant} batch={plan.batch} "
          f"int8={plan.int8} img={plan.img_size} overlap_px={plan.overlap_px} "
          f"tta={plan.tta} decode_scale={plan.decode_scale}")
    for note in plan.notes:
        print(f"  - {note}")


if __name__ == "__main__":
    main()
