#!/usr/bin/env python3
"""Serving throughput of two checkouts of the port, in turns on one card.

    python3 scripts/serving_ab.py --other DIR [--rounds 2] [--int8]

DIR is the root of another checkout (e.g. an earlier commit unpacked with
``git archive``). Each run is a process of its own that imports
``aquaculture_tpu_torch`` from one root, builds its kernel, and times the
mt serving program (640 px from 1024 px uint8 tiles on the card, batch 128,
bf16, random weights from seed 0) at conf 0.25 and 1e-5 with CUDA events:
the median over 5 windows of 5 batches, after 3 warmups. The runs go
other, this, this, other (``--rounds`` times), so a drift of the card over
the call weighs on both sides alike. ``--int8`` serves the int8 model of
``cli.detect --int8`` on both sides (the localization-safe split,
calibrated on the letterboxed first 8 tiles); both checkouts must have it. One JSON line per run, then a summary
line with each side's mean and the ratio this / other; the card's name and
power limit are in every line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = (0.25, 1e-5)


def child(root: str, int8: bool = False) -> None:
    sys.path.insert(0, root)
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import make_infer_fn

    if not torch.cuda.is_available():
        raise SystemExit("serving_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    nms_cuda.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    tiles = torch.randint(0, 256, (128, 1024, 1024, 3), generator=gen, device=dev, dtype=torch.uint8)
    model = load_model(None, "mt", 5)
    if int8:
        from aquaculture_tpu_torch.models.quantize import quantize_model, serving_int8_safe_skip
        from aquaculture_tpu_torch.ops.letterbox import letterbox

        calib = torch.stack([letterbox(tiles[i], 640)[0] for i in range(8)])
        model = quantize_model(model.to(dev), calib, skip=serving_int8_safe_skip("mt"))
    out = {}
    for conf in CONFS:
        infer = make_infer_fn(model, DetectConfig(conf_threshold=conf), tile=1024, device=dev)
        for _ in range(3):
            infer(tiles)
        torch.cuda.synchronize()
        per = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                infer(tiles)
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / 5)
        out[f"{conf:g}"] = 128 / statistics.median(per) * 1e3
    print(json.dumps({"root": root, "serving": "int8_safe" if int8 else "bfloat16", "tiles_per_s": out}),
          flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--int8", action="store_true", help="serve the int8_safe model on both sides")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.int8)
        return 0
    if not args.other:
        ap.error("--other is required")
    card = card_line()
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    got = {name: [] for name in sides}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", sides[name],
                                   *(["--int8"] if args.int8 else [])],
                                  capture_output=True, text=True, cwd=sides[name], check=True)
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            got[name].append(row["tiles_per_s"])
            print(json.dumps({"side": name, **row, "card": card}), flush=True)
    mean = {name: {c: statistics.mean(r[c] for r in rows) for c in rows[0]} for name, rows in got.items()}
    print(json.dumps({"summary": mean, "this_over_other": {c: mean["this"][c] / mean["other"][c]
                                                           for c in mean["this"]}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
