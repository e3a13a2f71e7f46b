#!/usr/bin/env python3
"""Cold start of the port's serving process, live against the AOT artifact.

    python3 scripts/torch_aot_coldstart.py [--variant m] [--img 640] [--batch 128] \\
        [--repeats 3] [--throughput] [--device cuda]

The card's counterpart of scripts/aot_coldstart.py. A checkpoint of random
weights (seed 0) is written first and the suppression kernel built, so
that no phase pays nvcc. Then each phase runs ``--repeats`` times, each
time in a fresh process, timed from the process's first line:

  live        import -> build the model -> load the checkpoint -> the first
              batch's rows on the host (make_infer_fn)
  aot_export  import -> build -> load -> export + save the artifact (paid
              once per release)
  aot_load    import -> load_aot -> build -> load -> the first batch's rows
              through the artifact (serving_fn_loaded)

The first batch is ``--batch`` seeded uint8 tiles of 1024 px, made on the
host before the clock of that step starts. ``live`` and ``aot_load`` print
a digest of their rows; a last line says whether they agree. ``--throughput`` adds one
process that times the mt serving program (bf16, batch 128, conf 0.25 and
1e-5; CUDA events, the median of 5 windows of 5 batches after 3 warmups)
live and through an artifact, in turns live, aot, aot, live. One JSON line
per run, each with the card's name and power limit; no target is set.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("live", "aot_export", "aot_load")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _tiles(batch: int):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(0).integers(0, 256, (batch, 1024, 1024, 3), dtype=np.uint8))


def _digest(det, valid) -> dict:
    det, valid = det.cpu(), valid.cpu()
    return {"rows": int(valid.sum()), "sha256": hashlib.sha256(det[valid].numpy().tobytes()).hexdigest()[:16]}


def child(phase: str, args) -> dict:
    """One cold start, in this fresh process."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.models import aot
    from aquaculture_tpu_torch.pipeline import make_infer_fn

    laps = {"import": time.perf_counter() - _T0}
    t = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        laps[name] = now - t
        t = now

    out = {"phase": phase}
    cfg = DetectConfig(img_size=args.img, conf_threshold=1e-5)  # random weights: rows to compare
    if phase == "aot_load":
        program, meta = aot.load_aot(args.program)
        lap("load_aot")
    model = load_model(args.ckpt, args.variant, 5)
    lap("build_and_load")
    if phase == "aot_export":
        blob, meta = aot.export_serving(model, cfg, batch_size=args.batch, device=args.device)
        aot.save_aot(args.program, blob, meta)
        lap("export_and_save")
        out["blob_bytes"] = len(blob)
    else:
        infer = (make_infer_fn(model, cfg, device=args.device) if phase == "live"
                 else aot.serving_fn_loaded(program, meta, model, device=args.device))
        lap("place")
        tiles = _tiles(args.batch)
        t = time.perf_counter()  # the input is made before the first batch's clock starts
        out.update(_digest(*infer(tiles)))
        lap("first_batch")
    out["laps_s"] = laps
    out["seconds"] = sum(laps.values())
    return out


def throughput(args) -> list:
    """mt bf16 b128 tiles/s, live and through an artifact, in turns."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.models import aot
    from aquaculture_tpu_torch.pipeline import make_infer_fn

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    tiles = torch.randint(0, 256, (128, 1024, 1024, 3), generator=gen, device=dev, dtype=torch.uint8)
    rows = []
    for conf in (0.25, 1e-5):
        cfg = DetectConfig(conf_threshold=conf)
        model = load_model(None, "mt", 5)
        t0 = time.perf_counter()
        blob, meta = aot.export_serving(model, cfg, batch_size=128, device=dev)
        export_s = time.perf_counter() - t0
        path = os.path.join(args.tmp, f"mt_{conf:g}.aqt")
        aot.save_aot(path, blob, meta)
        t0 = time.perf_counter()
        fns = {"aot": aot.serving_fn(path, model, device=dev)[0]}
        load_s = time.perf_counter() - t0
        fns["live"] = make_infer_fn(model, cfg, tile=1024, device=dev)
        a, b = fns["live"](tiles), fns["aot"](tiles)
        rows_equal = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        per_side = {"live": [], "aot": []}
        for side in ("live", "aot", "aot", "live"):
            fn = fns[side]
            for _ in range(3):
                fn(tiles)
            torch.cuda.synchronize()
            per = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    fn(tiles)
                end.record()
                end.synchronize()
                per.append(start.elapsed_time(end) / 5)
            per_side[side].append(128 / statistics.median(per) * 1e3)
        rows.append({"metric": "serving_live_vs_aot", "variant": "mt", "dtype": "bfloat16", "batch": 128,
                     "img": 640, "conf": conf, "tiles_per_s_live": per_side["live"], "tiles_per_s_aot": per_side["aot"],
                     "aot_over_live": statistics.mean(per_side["aot"]) / statistics.mean(per_side["live"]),
                     "export_s": export_s, "load_s": load_s, "blob_bytes": len(blob),
                     "rows_equal": rows_equal})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", default="m")
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--throughput", action="store_true", help="also time mt b128 live vs artifact")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", default=None, choices=PHASES + ("throughput",), help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--program", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tmp", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    if args.child:
        out = throughput(args) if args.child == "throughput" else [child(args.child, args)]
        for row in out:
            print("RESULT " + json.dumps(row), flush=True)
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_aot_coldstart: no CUDA device (pass --device cpu to rehearse on the CPU)")
    card = card_line() if args.device == "cuda" else "cpu (not a device measurement)"
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init
    from aquaculture_tpu_torch.utils.checkpoint import save_params

    if args.device == "cuda":
        from aquaculture_tpu_torch.ops import nms_cuda

        nms_cuda.build()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, program = os.path.join(tmp, "ckpt"), os.path.join(tmp, "serving.aqt")
        save_params(ckpt, yolov5_init(args.variant, 5, seed=0)[1], {"variant": args.variant, "num_classes": 5})
        common = ["--variant", args.variant, "--img", str(args.img), "--batch", str(args.batch),
                  "--device", args.device, "--ckpt", ckpt, "--program", program, "--tmp", tmp]
        order = ["aot_export"] + [p for _ in range(args.repeats) for p in ("live", "aot_load")]
        order += ["aot_export"] * (args.repeats - 1)
        if args.throughput:
            order.append("throughput")
        digests = set()
        for phase in order:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", phase, *common],
                                  capture_output=True, text=True, cwd=ROOT)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"torch_aot_coldstart: phase {phase} exited {proc.returncode}")
            for line in proc.stdout.splitlines():
                if line.startswith("RESULT "):
                    row = json.loads(line[len("RESULT "):])
                    if "sha256" in row:
                        digests.add((row["rows"], row["sha256"]))
                    for k, v in (("variant", args.variant), ("img", args.img), ("batch", args.batch),
                                 ("device", args.device), ("torch", torch.__version__), ("card", card)):
                        row.setdefault(k, v)
                    print(json.dumps(row), flush=True)
        print(json.dumps({"first_batch_rows_equal_live_vs_aot": len(digests) == 1,
                          "digests": sorted(digests), "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
