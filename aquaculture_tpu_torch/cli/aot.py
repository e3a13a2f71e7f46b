"""Build / inspect / warm AOT serving artifacts (models/aot.py).

Counterpart of ``aquaculture_tpu.cli.aot``. The serving program (resize +
forward + decode + NMS) exports once to a single file with
``torch.export``; serving processes load it and serve any checkpoint of
the same variant and precision. The artifact is traced for one device
type: ``--device cuda`` (the default; raises without a GPU) or ``cpu``.

    python -m aquaculture_tpu_torch.cli.aot export --weights ckpt/last \\
        --variant n --num-classes 2 --batch 128 --out serving.aqt
    python -m aquaculture_tpu_torch.cli.aot describe --program serving.aqt
    python -m aquaculture_tpu_torch.cli.aot warmup --program serving.aqt --weights ckpt/last
    python -m aquaculture_tpu_torch.cli.detect --aot serving.aqt --weights ckpt/last \\
        --source 'tiles/*.jpeg' --out labels/

Detection thresholds and shapes are constants of the artifact: set them at
export time.
"""

from __future__ import annotations

import argparse
import json

from aquaculture_tpu_torch.models.yolov5 import VARIANTS


def _quantized(model, calib: str | None, img: int, device, what: str):
    import glob

    from aquaculture_tpu_torch.cli.detect import quantize_for_serving

    if not calib:
        raise SystemExit(f"--int8 {what} needs --calib (calibration image glob)")
    return quantize_for_serving(model, sorted(glob.glob(calib)), img, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="export the serving program to a file")
    ex.add_argument("--weights", default=None,
                    help=".pt or checkpoint directory (shapes/structure source; random init if omitted)")
    ex.add_argument("--out", required=True, help="output artifact path")
    ex.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="default: the checkpoint's saved metadata, else m")
    ex.add_argument("--num-classes", type=int, default=None,
                    help="default: the checkpoint's saved metadata, else 5")
    ex.add_argument("--batch", type=int, default=32)
    ex.add_argument("--img", type=int, default=None,
                    help="inference size (default: 640, or 1280 for *6 variants)")
    ex.add_argument("--tile", type=int, default=None, help="input tile size (default config.IM_WIDTH)")
    ex.add_argument("--conf", type=float, default=0.25)
    ex.add_argument("--iou", type=float, default=0.45)
    ex.add_argument("--multi-label", action="store_true")
    ex.add_argument("--augment", action="store_true", help="trace TTA into the program")
    ex.add_argument("--int8", action="store_true", help="export the int8 serving program (requires --calib)")
    ex.add_argument("--calib", default=None, help="glob of calibration images for --int8")
    ex.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type the program is traced for (default cuda; raises without a GPU)")

    de = sub.add_parser("describe", help="print an artifact's metadata")
    de.add_argument("--program", required=True)

    wu = sub.add_parser("warmup", help="load the artifact and serve one zero batch on this device "
                        "(builds the suppression kernel, picks cuDNN's algorithms)")
    wu.add_argument("--program", required=True)
    wu.add_argument("--weights", required=True)
    wu.add_argument("--int8", action="store_true",
                    help="quantize the checkpoint first (int8 artifacts expect the int8 "
                         "model's structure; needs --calib)")
    wu.add_argument("--calib", default=None, help="glob of calibration images for --int8")
    wu.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")

    args = ap.parse_args(argv)

    from aquaculture_tpu_torch.models import aot

    if args.cmd == "describe":
        print(json.dumps(aot.read_meta(args.program), indent=2, sort_keys=True))
        return

    from aquaculture_tpu_torch.cli.detect import default_img_size, load_model, resolve_model_args
    from aquaculture_tpu_torch.config import DetectConfig, resolve_device
    from aquaculture_tpu_torch.utils.logging import log_info

    device = resolve_device(args.device)
    if args.cmd == "warmup":
        meta = aot.read_meta(args.program)
        model = load_model(args.weights, meta.get("variant") or "m", meta.get("num_classes") or 5)
        if meta.get("quantized") and not args.int8:
            raise SystemExit(
                f"{args.program} is an int8 artifact: pass --int8 --calib "
                f"'imgs/*.jpeg' so the checkpoint is quantized to the "
                f"structure it expects"
            )
        if args.int8:
            model = _quantized(model, args.calib, meta["img_size"], device, "warmup")
        secs = aot.warmup(args.program, model, device=device)
        log_info("served one batch of %s on %s in %.1fs", args.program, device, secs)
        return secs

    # export: the checkpoint's saved variant/num_classes win over the
    # defaults, and a flag that contradicts them is refused, as cli.detect
    variant, num_classes = resolve_model_args(args.weights, args.variant, args.num_classes)
    if num_classes < 1:
        raise SystemExit(f"--num-classes must be >= 1, got {num_classes}")
    img = default_img_size(args.img, variant)
    model = load_model(args.weights, variant, num_classes)
    if args.int8:
        model = _quantized(model, args.calib, img, device, "export")
    cfg = DetectConfig(img_size=img, conf_threshold=args.conf, iou_threshold=args.iou,
                       multi_label=args.multi_label, augment=args.augment)
    blob, meta = aot.export_serving(model, cfg, batch_size=args.batch, tile=args.tile, device=device)
    aot.save_aot(args.out, blob, meta)
    log_info("exported yolov5%s serving program (batch %d, img %d, device %s): %d bytes -> %s",
             variant, args.batch, img, meta["device"], len(blob), args.out)
    return meta


if __name__ == "__main__":
    main()
