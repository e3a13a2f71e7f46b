"""Export a trained checkpoint as an ultralytics-layout ``.pt`` file.

Counterpart of ``aquaculture_tpu.cli.export``: closes the weights loop with
the reference ecosystem, which trains and serves ``.pt`` weights
(reference README.md:52,60,77). A checkpoint directory of either package
(``cli.train``'s output) becomes a state-dict ``.pt``, or with
``--full-model`` the object pickle ultralytics' ``attempt_load`` rebuilds
(models/export.py; host only, no device).

    python -m aquaculture_tpu_torch.cli.export --ckpt ckpt/last --variant m \\
        --num-classes 5 --out farms.pt
"""

from __future__ import annotations

import argparse

import numpy as np

from aquaculture_tpu_torch.models.yolov5 import VARIANTS


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="checkpoint directory (cli.train output)")
    ap.add_argument("--out", required=True, help=".pt output path")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="default: the checkpoint's saved metadata, else m")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="default: the checkpoint's saved metadata, else 5")
    ap.add_argument("--full-model", action="store_true",
                    help="write an attempt_load-compatible FULL-MODEL pickle "
                         "({'model': DetectionModel}) instead of a state-dict "
                         "file: loadable wherever ultralytics' yolov5 models "
                         "package is importable (reference README.md:77's "
                         "serving command)")
    ap.add_argument("--names", default=None, help="comma-separated class names for --full-model")
    args = ap.parse_args(argv)

    from aquaculture_tpu_torch.models.export import export_full_model_pt, export_ultralytics_pt
    from aquaculture_tpu_torch.models.yolov5 import YoloV5
    from aquaculture_tpu_torch.utils.checkpoint import load_metadata, load_params
    from aquaculture_tpu_torch.utils.logging import log_info

    # cli.train records variant/num_classes in the checkpoint metadata:
    # exporting an n6 checkpoint under the wrong default variant would die
    # on a layer-index mismatch, so the metadata wins over the defaults
    meta = load_metadata(args.ckpt)
    variant = args.variant or meta.get("variant", "m")
    num_classes = args.num_classes or int(meta.get("num_classes", 5))

    model = YoloV5(variant=variant, num_classes=num_classes)
    params = load_params(args.ckpt)
    # .pt stores f32 (half-precision checkpoints upcast losslessly)

    def upcast(node):
        if isinstance(node, dict):
            return {k: upcast(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [upcast(v) for v in node]
        a = np.asarray(node)
        return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a

    params = upcast(params)
    if args.full_model:
        names = None
        if args.names:
            names = [n.strip() for n in args.names.split(",")]
            if len(names) != num_classes:
                # a short names dict crashes the ultralytics consumer at
                # DETECTION time (names[int(cls)] KeyError mid-inference):
                # fail at export instead
                raise SystemExit(
                    f"--names has {len(names)} entries but the model has "
                    f"{num_classes} classes"
                )
        export_full_model_pt(model, params, args.out, names=names)
        log_info("exported full-model pickle (yolov5%s, %d classes) -> %s",
                 variant, num_classes, args.out)
    else:
        sd = export_ultralytics_pt(model, params, args.out)
        log_info("exported %d tensors (yolov5%s, %d classes) -> %s",
                 len(sd), variant, num_classes, args.out)


if __name__ == "__main__":
    main()
