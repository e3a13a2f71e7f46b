"""Detection CLI of the PyTorch port: images -> YOLO-format label files.

Equivalent of the reference's ``yolov5/detect.py --source ... --save-txt
--save-conf`` (reference README.md:77) and of ``aquaculture_tpu.cli.detect``.
Emits one ``<image-stem>.txt`` per image with detections, rows
``class cx cy w h conf`` normalized to the tile. Runs on the GPU
(``--device cuda``, the default) unless ``--device cpu`` is given.

    python -m aquaculture_tpu_torch.cli.detect --source DIR --out LABELS/ \\
        [--weights CKPT_DIR | X.pt] --variant mt \\
        [--augment] [--multi-label] [--decode-scale] [--int8] \\
        [--aot PROGRAM] [--profile LOGDIR]

``--variant m6`` (the P6 family) serves at 1280 px unless --img says
otherwise. ``--int8`` serves the int8 PTQ model, calibrated on the first
source images (``quantize_for_serving``). ``--aot`` serves the exported
program of ``cli.aot export`` (models/aot.py) with the checkpoint's
weights; ``--profile`` writes a trace of the serving loop
(utils/profiler.py).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from aquaculture_tpu_torch.config import IM_WIDTH, DetectConfig, resolve_device
from aquaculture_tpu_torch.data.filenames import encode_tile_name
from aquaculture_tpu_torch.models.weights import load_jax_params, load_pretrained
from aquaculture_tpu_torch.models.yolov5 import VARIANTS, YoloV5, yolov5_init
from aquaculture_tpu_torch.pipeline import detect_files
from aquaculture_tpu_torch.utils.profiler import annotate, maybe_trace


def quantize_for_serving(model: YoloV5, sample_paths, img_size: int = 640, skip=None,
                         device="cuda") -> YoloV5:
    """int8 PTQ of the float serving ``model``, calibrated on ``device`` on
    up to 8 source images through the serving letterbox (bf16, as the JAX
    package's ``quantize_for_serving``), with the variant's
    localization-safe split unless ``skip`` names one. Returns the new
    int8 YoloV5 (models/quantize.quantize_model)."""
    from aquaculture_tpu_torch.data.geotiff import read_image
    from aquaculture_tpu_torch.models.quantize import quantize_model, serving_int8_safe_skip
    from aquaculture_tpu_torch.ops.letterbox import letterbox

    if skip is None:
        skip = serving_int8_safe_skip(model.variant)
    dev = resolve_device(device)
    imgs = [letterbox(torch.from_numpy(read_image(p).copy()).to(dev), img_size)[0] for p in sample_paths[:8]]
    if not imgs:
        raise ValueError("no readable calibration images")
    return quantize_model(model.to(dev), torch.stack(imgs), skip=skip)


def resolve_model_args(
    weights: str | None,
    variant_arg: str | None,
    num_classes_arg: int | None,
    default_variant: str = "m",
    default_num_classes: int = 5,
) -> tuple:
    """Resolve variant/num_classes: explicit flag > checkpoint metadata >
    default; a flag that contradicts the checkpoint's saved metadata is an
    error, not a silent mis-build."""
    meta: dict = {}
    if weights and not weights.endswith(".pt") and os.path.isdir(weights):
        from aquaculture_tpu_torch.utils.checkpoint import load_metadata

        try:
            meta = load_metadata(weights)
        except (FileNotFoundError, NotADirectoryError):
            meta = {}
    variant = variant_arg or meta.get("variant") or default_variant
    if meta.get("variant") and variant_arg and variant_arg != meta["variant"]:
        raise SystemExit(
            f"--variant {variant_arg} contradicts the checkpoint's saved "
            f"variant {meta['variant']!r} ({weights})"
        )
    num_classes = (
        int(num_classes_arg)
        if num_classes_arg is not None
        else int(meta.get("num_classes") or default_num_classes)
    )
    if (
        meta.get("num_classes")
        and num_classes_arg is not None
        and int(num_classes_arg) != int(meta["num_classes"])
    ):
        raise SystemExit(
            f"--num-classes {num_classes_arg} contradicts the checkpoint's "
            f"saved num_classes {meta['num_classes']} ({weights})"
        )
    return variant, num_classes


def default_img_size(img: int | None, variant: str) -> int:
    """--img, else 1280 for the P6 family (*6) and 640 for the rest."""
    if img is not None:
        return img
    return 1280 if variant.endswith("6") else 640


def load_model(weights: str | None, variant: str = "m", num_classes: int = 5) -> YoloV5:
    """An ultralytics ``.pt`` (with the anchors it stores, if any), a
    checkpoint directory of the JAX package's format, or the seed-0 random
    model of ``yolov5_init`` when ``weights`` is None. Weights are
    BN-folded on load."""
    if weights and not os.path.exists(weights):
        raise FileNotFoundError(f"weights not found: {weights}")
    if weights and weights.endswith(".pt"):
        model = YoloV5(variant, num_classes)
        params, anchors = load_pretrained(model, weights)
        if anchors is not None:
            model = YoloV5(variant, num_classes, anchors=anchors)
    elif weights:
        from aquaculture_tpu_torch.utils.checkpoint import load_params

        model, params = YoloV5(variant, num_classes), load_params(weights)
    else:
        model, params = yolov5_init(variant, num_classes)
    return load_jax_params(model, params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", required=True, help="image file, directory, or glob")
    ap.add_argument("--weights", default=None, help="ultralytics .pt, or checkpoint directory (params.npz + treedef.json)")
    ap.add_argument("--out", required=True, help="directory for label .txt files")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="(default: the checkpoint's saved variant, else m)")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="(default: the checkpoint's saved value, else 5)")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--img", type=int, default=None,
                    help="inference size (default: 640, or 1280 for *6 variants)")
    ap.add_argument("--pre-topk", type=int, default=None,
                    help="candidate pool cap before suppression (default 1024)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 PTQ serving path (calibrates on the first source images)")
    ap.add_argument("--augment", action="store_true",
                    help="test-time augmentation (multi-scale + lr-flip, "
                         "ultralytics detect.py --augment)")
    ap.add_argument("--multi-label", action="store_true",
                    help="one detection per (box, class) above conf "
                         "(ultralytics val.py semantics; default argmax class)")
    ap.add_argument("--decode-scale", action="store_true",
                    help="decode-at-scale: the host resizes tiles to img px "
                         "before the copy to the device (requires 8*img %% tile == 0)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace (Chrome-trace JSON: host spans and, "
                         "on the GPU, its kernels) of the serving loop into LOGDIR")
    ap.add_argument("--aot", default=None, metavar="PROGRAM",
                    help="serve from an AOT artifact (cli.aot export); variant, img, conf, "
                         "iou and batch come from the artifact and the matching flags are ignored")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    args.variant, args.num_classes = resolve_model_args(
        args.weights, args.variant, args.num_classes
    )

    if os.path.isdir(args.source):
        paths = sorted(
            p
            for ext in ("jpeg", "jpg", "png", "tif", "tiff")
            for p in glob.glob(os.path.join(args.source, f"*.{ext}"))
        )
    else:
        paths = sorted(glob.glob(args.source)) or [args.source]

    if args.aot:
        # The artifact IS the serving program: its constants (thresholds,
        # shapes, variant) override the matching flags.
        from aquaculture_tpu_torch.models import aot

        if args.decode_scale:
            # the artifact is a fixed-shape program over full (batch, tile,
            # tile, 3) tiles with the resize traced in
            raise SystemExit(
                "--decode-scale cannot be combined with --aot: the AOT "
                "artifact expects full-resolution tiles and resizes on "
                "device. Drop one of the flags."
            )
        if args.pre_topk:
            raise SystemExit(
                "--pre-topk cannot be combined with --aot: the candidate "
                "pool is traced into the artifact. Re-export with the "
                "desired pool, or drop --aot."
            )
        meta = aot.read_meta(args.aot)
        if meta["device"] != device.type:
            raise SystemExit(
                f"{args.aot} was exported for --device {meta['device']}, not {device.type}: "
                f"pass --device {meta['device']} or re-export it with --device {device.type}"
            )
        if meta.get("quantized") and not args.int8:
            raise SystemExit(
                f"{args.aot} is an int8 artifact: pass --int8 so the "
                f"checkpoint is quantized to the structure it expects"
            )
        args.variant = meta.get("variant") or args.variant
        args.num_classes = meta.get("num_classes") or args.num_classes
        args.batch = meta["batch_size"]
        args.img = meta["img_size"]
    args.img = default_img_size(args.img, args.variant)
    model = load_model(args.weights, args.variant, args.num_classes)
    if args.int8:
        model = quantize_for_serving(model, paths, args.img, device=device)
    infer_fn, tile = None, IM_WIDTH
    if args.aot:
        infer_fn, meta = aot.serving_fn(args.aot, model, device=device)
        # thresholds, pool and TTA are traced into the program
        cfg, tile = DetectConfig(img_size=args.img, dtype=meta["dtype"]), meta["tile"]
    else:
        cfg_kw = dict(img_size=args.img, conf_threshold=args.conf, iou_threshold=args.iou,
                      multi_label=args.multi_label, augment=args.augment)
        if args.pre_topk:
            cfg_kw["pre_nms_topk"] = args.pre_topk
        cfg = DetectConfig(**cfg_kw)
    with maybe_trace(args.profile), annotate("detect_files"):
        boxes, conf, cls, specs, stats = detect_files(
            paths, model, cfg, args.batch, tile=tile, infer_fn=infer_fn, device=device,
            decode_scale=args.decode_scale,
        )

    # rows are normalized to the TILE the boxes live in (reference contract:
    # geocode_results.py:89-99)
    os.makedirs(args.out, exist_ok=True)
    per_image: dict = {}
    for b, c, k, s in zip(boxes, conf, cls, specs):
        per_image.setdefault(s, []).append((k, b, c))
    for spec, rows in per_image.items():
        lines = []
        for k, b, c in rows:
            cx = (b[0] + b[2]) / 2 / tile
            cy = (b[1] + b[3]) / 2 / tile
            w = (b[2] - b[0]) / tile
            h = (b[3] - b[1]) / tile
            lines.append(f"{int(k)} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f} {c:.6f}")
        name = encode_tile_name(spec, extension="txt")
        with open(os.path.join(args.out, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    print(
        f"[INFO] {stats.tiles} tiles, {stats.detections} detections, "
        f"{stats.tiles_per_second:.1f} tiles/s on {device} ({stats.loader} loader) -> {args.out}"
    )
    return stats


if __name__ == "__main__":
    main()
