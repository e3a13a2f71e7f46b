"""Fused pipeline CLI of the PyTorch port: images -> detections.geojson.

What the reference runs as staged scripts with file handoffs
(tile_tifs -> detect -> geocode_results -> calc_net_areas) runs here as one
program, as ``aquaculture_tpu.cli.pipeline`` does: detection on the GPU
(``--device cuda``, the default; raises without one) or on the CPU
(``--device cpu``), then geocode, download-box dedup, cross-tile NMS
(``--overlap``), cage areas and the land filter on the host.

    python -m aquaculture_tpu_torch.cli.pipeline --source DIR \\
        --download-bboxes wanted_bboxes.csv --out detections.geojson \\
        [--weights CKPT_DIR | X.pt] [--land LAND.geojson] \\
        [--overlap PX | --decode-scale] [--decode-threads N] [--int8] \\
        [--profile LOGDIR]

``--int8`` serves the int8 PTQ model; as in the JAX package's CLI, it
calibrates at 640 px whatever ``--img`` says.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.cli.detect import (
    default_img_size, load_model, quantize_for_serving, resolve_model_args)
from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
from aquaculture_tpu_torch.config import DetectConfig, resolve_device
from aquaculture_tpu_torch.models.yolov5 import VARIANTS
from aquaculture_tpu_torch.pipeline import run_pipeline
from aquaculture_tpu_torch.utils.profiler import annotate, maybe_trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", required=True, help="image directory or glob")
    ap.add_argument("--download-bboxes", required=True, help="wanted_bboxes.csv path")
    ap.add_argument("--out", required=True, help="detections.geojson output path")
    ap.add_argument("--weights", default=None,
                    help="ultralytics .pt, or checkpoint directory (params.npz + treedef.json)")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="(default: the checkpoint's saved variant, else m)")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="(default: the checkpoint's saved value, else 5)")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--pre-topk", type=int, default=None,
                    help="candidate pool cap before suppression (default 1024)")
    ap.add_argument("--img", type=int, default=None,
                    help="inference size (default: 640, or 1280 for *6 variants)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--land", default=None, help="land polygons GeoJSON")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--int8", action="store_true", help="int8 PTQ serving path")
    ap.add_argument("--overlap", type=int, default=0,
                    help="overlap serving: tile overlap in px on large rasters "
                         "(boundary objects appear whole in a neighbouring tile; "
                         "duplicates dedup by meter-space IoU). 0 = the reference's hard grid")
    ap.add_argument("--decode-threads", type=int, default=0,
                    help="host decode pool: 0 = auto (cores, capped at 8), 1 = sequential "
                         "(bounds host RAM to one raster in flight)")
    ap.add_argument("--decode-scale", action="store_true",
                    help="decode-at-scale: the host resizes tiles to img px (see cli.detect)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace (Chrome-trace JSON: host spans and, "
                         "on the GPU, its kernels) of the pipeline into LOGDIR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if os.path.isdir(args.source):
        paths = sorted(
            p
            for ext in ("jpeg", "jpg", "png", "tif", "tiff")
            for p in glob.glob(os.path.join(args.source, f"*.{ext}"))
        )
    else:
        paths = sorted(glob.glob(args.source)) or [args.source]

    args.variant, args.num_classes = resolve_model_args(
        args.weights, args.variant, args.num_classes
    )
    model = load_model(args.weights, args.variant, args.num_classes)
    if args.int8:
        # calibrated at the default 640 px, not --img: the JAX package's CLI
        # passes no size here (ROADMAP records it)
        model = quantize_for_serving(model, paths, device=device)
    cfg_kw = dict(img_size=default_img_size(args.img, args.variant), conf_threshold=args.conf)
    if args.pre_topk:
        cfg_kw["pre_nms_topk"] = args.pre_topk
    cfg = DetectConfig(**cfg_kw)
    dl = load_download_bboxes(args.download_bboxes)
    land = gf.read_file(args.land) if args.land else None

    with maybe_trace(args.profile), annotate("run_pipeline"):
        det, stats = run_pipeline(
            paths, model, dl, cfg, args.batch, land=land, dedup=not args.no_dedup, device=device,
            overlap=args.overlap, decode_threads=args.decode_threads, decode_scale=args.decode_scale,
        )
    t0 = time.perf_counter()
    det.to_file(args.out)
    stats.stage_seconds["write"] = time.perf_counter() - t0
    stats.stage_rows["write"] = len(det)
    stages = ", ".join(f"{k} {stats.stage_seconds[k]:.3f} s ({stats.stage_rows[k]} rows)"
                       for k in stats.stage_seconds)
    print(f"[INFO] {stats.tiles} tiles -> {len(det)} detections at "
          f"{stats.tiles_per_second:.1f} tiles/s on {device} ({stats.loader} loader) -> {args.out}; "
          f"{stages}")
    return det, stats


if __name__ == "__main__":
    main()
