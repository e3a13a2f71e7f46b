"""Area CLI of the PyTorch port: append cage surface-area columns to
detections.geojson.

Equivalent of the reference's calc_net_areas.py __main__
(reference: src/process_yolo/calc_net_areas.py:154-175) and of
``aquaculture_tpu.cli.areas``. Host only (numpy).

    python -m aquaculture_tpu_torch.cli.areas --detections detections.geojson [--out OUT]
"""

from __future__ import annotations

import argparse

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.post.areas import cage_areas


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--detections", required=True, help="detections.geojson path (updated in place)")
    ap.add_argument("--out", default=None, help="optional separate output path")
    args = ap.parse_args(argv)

    det = cage_areas(gf.read_file(args.detections))
    det.to_file(args.out or args.detections)
    print(f"[INFO] wrote areas for {len(det)} detections -> {args.out or args.detections}")


if __name__ == "__main__":
    main()
