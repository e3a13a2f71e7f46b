#!/usr/bin/env python3
"""The serving plan's inputs, read on the card in one call.

    python3 scripts/plan_sweep.py [--only serving,int8,topk,latency,train,feed] \\
        [--device cuda|cpu] [--out FILE]

models/plan.py writes its rules from these readings. The serving rows use
the harness of scripts/serving_ab.py: the serving program of
``pipeline.make_infer_fn`` on seeded uint8 1024 px tiles already on the
card, random weights from seed 0, bf16, conf 1e-5, CUDA events, the median
of 5 windows of 5 batches after 3 warmups. Parts:

  serving  tiles/s of mt and m at 640 (batches 1, 8, 32, 64, 128, 192, 256)
           and m6 at 1280 (batches 8, 32, 64, 128)
  int8     int8_safe against bf16 at b128 for mt and m at 640 and m6 at
           1280, in turns bf16, int8, int8, bf16 (the calibration of
           serving_ab.py --int8: the letterboxed first 8 tiles)
  topk     --pre-topk 512 against 1024 for mt b128, in turns
  latency  single-tile p50 and p90 of mt and m at 640: host wall time per
           synchronized call, 200 calls, on a tile already on the card
  train    the bf16 train step of m and mt at 640 (chip_smoke.time_train_step's
           pieces: seeded batch on the card, CUDA events), batches 16, 32,
           64, 128, remat off and on: ms, img/s, peak memory; a batch that
           does not fit is a row with "fits": false and the bytes it asked for
  feed     the augmented 640 px feed's img/s on 1 and on 8 threads, a cold
           epoch (caches empty) and a warm one, over 32 rendered tiles

One JSON line per row, each with the card's name and power limit as
nvidia-smi gives them, and the spread of its windows. ``--device cpu``
rehearses every part at a tiny size (its numbers are CPU numbers and say
so: "device": "cpu"); on the card it runs on cuda:0 or fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARTS = ("serving", "int8", "topk", "latency", "train", "feed")
CONF = 1e-5
# the card's sizes, and the CPU rehearsal's
SIZES = {
    "cuda": dict(tile=1024, img=640, img6=1280, batches=(1, 8, 32, 64, 128, 192, 256),
                 batches6=(8, 32, 64, 128), ref=128, train_img=640, train_batches=(16, 32, 64, 128),
                 windows=5, iters=5, warmup=3, latency_calls=200, feed_tiles=32, feed_threads=(1, 8)),
    "cpu": dict(tile=64, img=64, img6=128, batches=(1, 2), batches6=(1, 2), ref=2, train_img=64,
                train_batches=(2,), windows=2, iters=1, warmup=1, latency_calls=3, feed_tiles=4,
                feed_threads=(1, 2)),
}


def card_line(dev) -> str:
    if dev.type == "cpu":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class Sweep:
    """The device, its sizes and the output: ``emit`` prints a row."""

    def __init__(self, dev, out=None):
        import torch

        self.dev, self.out = dev, out
        self.size = SIZES[dev.type]
        self.card = card_line(dev)
        self.device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        self.tiles = None
        self.models = {}

    def emit(self, row: dict) -> dict:
        line = json.dumps({**row, "device": self.device_name, "card": self.card})
        print(line, flush=True)
        if self.out:
            with open(self.out, "a") as f:
                f.write(line + "\n")
        return row

    def sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window_ms(self, fn, iters: int) -> float:
        """ms per call over one window of ``iters`` calls: CUDA events on
        the card, the host clock after a synchronize on the CPU."""
        import torch

        if self.dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    def time_ms(self, fn, windows: int = None, iters: int = None) -> dict:
        """serving_ab.py's harness: warmups, then the median of windows."""
        s = self.size
        for _ in range(s["warmup"]):
            fn()
        self.sync()
        per = [self.window_ms(fn, iters or s["iters"]) for _ in range(windows or s["windows"])]
        return {"ms": statistics.median(per), "windows_ms": per}

    def measure(self, fn, windows: int = None, iters: int = None) -> dict:
        """time_ms and the peak memory, or, where the card runs out of
        memory, a measured outcome: {"fits": False} and the bytes asked."""
        import torch

        if self.dev.type == "cpu":
            return {"fits": True, **self.time_ms(fn, windows, iters), "peak_bytes": None}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.dev)
        oom = None
        try:
            t = self.time_ms(fn, windows, iters)
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e)
        peak = torch.cuda.max_memory_allocated(self.dev)
        if oom is None:
            return {"fits": True, **t, "peak_bytes": peak}
        torch.cuda.empty_cache()
        asked = _ASKED.search(oom)
        return {"fits": False, "requested_bytes": int(float(asked[1]) * _UNIT[asked[2]]) if asked else None,
                "peak_bytes_before_failure": peak, "error": oom.splitlines()[0][:300]}

    def batch_tiles(self, b: int):
        """The first ``b`` of the largest batch's seeded uint8 tiles."""
        import torch

        need = max(self.size["batches"] + self.size["batches6"] + (self.size["ref"],))
        if self.tiles is None:
            gen = torch.Generator(device=self.dev).manual_seed(0)
            self.tiles = torch.randint(0, 256, (need, self.size["tile"], self.size["tile"], 3),
                                       generator=gen, device=self.dev, dtype=torch.uint8)
        return self.tiles[:b]

    def model(self, variant: str, int8: bool = False):
        """The seed-0 random model of ``variant`` (cli.detect's), or its
        int8_safe model calibrated as serving_ab.py --int8 does."""
        import torch

        key = (variant, int8)
        if key not in self.models:
            from aquaculture_tpu_torch.cli.detect import load_model

            model = load_model(None, variant, 5)
            if int8:
                from aquaculture_tpu_torch.models.quantize import quantize_model, serving_int8_safe_skip
                from aquaculture_tpu_torch.ops.letterbox import letterbox

                img = self.img(variant)
                calib = [letterbox(t, img)[0] for t in self.batch_tiles(min(8, self.size["ref"]))]
                model = quantize_model(model.to(self.dev), torch.stack(calib), skip=serving_int8_safe_skip(variant))
            self.models[key] = model
        return self.models[key]

    def img(self, variant: str) -> int:
        return self.size["img6"] if variant.endswith("6") else self.size["img"]

    def serving_row(self, variant: str, b: int, int8: bool = False, pre_topk: int = 1024, **extra) -> dict:
        from aquaculture_tpu_torch.config import DetectConfig
        from aquaculture_tpu_torch.pipeline import make_infer_fn

        img = self.img(variant)
        cfg = DetectConfig(img_size=img, conf_threshold=CONF, pre_nms_topk=pre_topk)
        infer = make_infer_fn(self.model(variant, int8), cfg, tile=self.size["tile"], device=self.dev)
        tiles = self.batch_tiles(b)
        t = self.measure(lambda: infer(tiles))
        row = {"part": extra.pop("part", "serving"), "variant": variant, "dtype": "int8_safe" if int8 else "bfloat16",
               "img": img, "tile": self.size["tile"], "batch": b, "conf": CONF, "pre_topk": pre_topk, **extra}
        if not t["fits"]:
            return self.emit({**row, **t})
        rates = [b / ms * 1e3 for ms in t["windows_ms"]]
        return self.emit({**row, "fits": True, "ms_per_batch": t["ms"], "tiles_per_s": b / t["ms"] * 1e3,
                          "tiles_per_s_min": min(rates), "tiles_per_s_max": max(rates),
                          "peak_bytes": t["peak_bytes"]})


def in_turns(sweep: Sweep, a: dict, b: dict, variant: str, part: str, ratio_name: str) -> dict:
    """Rows a, b, b, a of one variant at the reference batch; the ratio of
    the means b / a and each side's spread (its runs' window extremes)."""
    ref = sweep.size["ref"]
    runs = {"a": [], "b": []}
    for side in ("a", "b", "b", "a"):
        kw = a if side == "a" else b
        runs[side].append(sweep.serving_row(variant, ref, part=part, turn=side, **kw))
        if not runs[side][-1]["fits"]:
            return sweep.emit({"part": part, "summary": True, "variant": variant, "batch": ref, "a": a, "b": b,
                               "fits": False})
    mean = {s: statistics.mean(r["tiles_per_s"] for r in rows) for s, rows in runs.items()}
    lo = {s: min(r["tiles_per_s_min"] for r in rows) for s, rows in runs.items()}
    hi = {s: max(r["tiles_per_s_max"] for r in rows) for s, rows in runs.items()}
    # outside the spread: the ranges of the two sides' windows do not meet
    separated = hi["b"] < lo["a"] or hi["a"] < lo["b"]
    return sweep.emit({"part": part, "summary": True, "variant": variant, "batch": ref, "a": a, "b": b,
                       "tiles_per_s_a": mean["a"], "tiles_per_s_b": mean["b"], ratio_name: mean["b"] / mean["a"],
                       "range_a": [lo["a"], hi["a"]], "range_b": [lo["b"], hi["b"]],
                       "outside_spread": separated})


def part_serving(sweep: Sweep) -> None:
    for variant in ("mt", "m"):
        for b in sweep.size["batches"]:
            sweep.serving_row(variant, b)
    for b in sweep.size["batches6"]:
        sweep.serving_row("m6", b)


def part_int8(sweep: Sweep) -> None:
    for variant in ("mt", "m", "m6"):
        in_turns(sweep, {"int8": False}, {"int8": True}, variant, "int8", "int8_over_bf16")
        sweep.models.pop((variant, True))


def part_topk(sweep: Sweep) -> None:
    in_turns(sweep, {"pre_topk": 1024}, {"pre_topk": 512}, "mt", "topk", "topk512_over_1024")


def part_latency(sweep: Sweep) -> None:
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.pipeline import make_infer_fn

    for variant in ("mt", "m"):
        img = sweep.img(variant)
        infer = make_infer_fn(sweep.model(variant), DetectConfig(img_size=img, conf_threshold=CONF),
                              tile=sweep.size["tile"], device=sweep.dev)
        tile = sweep.batch_tiles(1)
        for _ in range(max(10, sweep.size["warmup"])):
            infer(tile)
        sweep.sync()
        ms = []
        for _ in range(sweep.size["latency_calls"]):
            t0 = time.perf_counter()
            infer(tile)
            sweep.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(ms, n=10, method="inclusive")
        sweep.emit({"part": "latency", "variant": variant, "img": img, "batch": 1, "conf": CONF,
                    "calls": len(ms), "p50_ms": statistics.median(ms), "p90_ms": q[8],
                    "min_ms": min(ms), "max_ms": max(ms)})


# (windows, steps per window) of a timed train step: a b128 step takes
# ~0.5 s, so fewer than serving's 5 x 5
TRAIN_WINDOWS = (3, 3)
_ASKED = re.compile(r"Tried to allocate ([0-9.]+) (B|KiB|MiB|GiB|TiB)")
_UNIT = {"B": 1, "KiB": 2 ** 10, "MiB": 2 ** 20, "GiB": 2 ** 30, "TiB": 2 ** 40}


def part_train(sweep: Sweep) -> None:
    import numpy as np
    import torch

    import chip_smoke
    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.models.weights import load_train_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
    from aquaculture_tpu_torch.train.trainer import init_train_state, make_train_step

    img, batches = sweep.size["train_img"], sweep.size["train_batches"]
    host = chip_smoke._train_batch(np.random.default_rng(0), max(batches), img)
    on_card = {k: torch.from_numpy(v).to(sweep.dev) for k, v in host.items()}
    del host
    step = None
    for variant in ("m", "mt"):
        model = load_train_params(YoloV5(variant, 5, trainable=True), yolov5_init(variant, 5)[1])
        model.to(device=sweep.dev, memory_format=torch.channels_last)
        state = init_train_state(model)
        for b in batches:
            batch = {k: v[:b] for k, v in on_card.items()}
            for remat in (False, True):
                row = {"part": "train", "variant": variant, "img": img, "batch": b, "dtype": "bfloat16",
                       "remat": remat}
                step = make_train_step(model, TrainConfig(img_size=img, batch_size=b, remat=remat), 100)
                t = sweep.measure(lambda: step(state, batch), *TRAIN_WINDOWS)
                if not t["fits"]:
                    sweep.emit({**row, **t})
                    continue
                rates = [b / ms * 1e3 for ms in t["windows_ms"]]
                sweep.emit({**row, "fits": True, "ms_per_step": t["ms"], "img_per_s": b / t["ms"] * 1e3,
                            "img_per_s_min": min(rates), "img_per_s_max": max(rates),
                            "peak_bytes": t["peak_bytes"]})
        del model, state
        step = None


def part_feed(sweep: Sweep) -> None:
    from examples.end_to_end_demo import render_world

    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.train.dataset import DetectionDataset

    img = sweep.size["train_img"]
    with tempfile.TemporaryDirectory() as d:
        img_dir, _ = render_world(os.path.join(d, "world"), n_images=sweep.size["feed_tiles"], seed=5)
        for threads in sweep.size["feed_threads"]:
            cfg = TrainConfig(img_size=img, batch_size=min(16, sweep.size["feed_tiles"]), feed_threads=threads)
            ds = DetectionDataset(img_dir, None, cfg, augment=True)
            row = {"part": "feed", "img": img, "threads": threads, "images": len(ds),
                   "host_cores": os.cpu_count()}
            for name in ("cold", "warm"):
                t0 = time.perf_counter()
                n = sum(len(bt["images"]) for bt in ds.epoch(0))
                row[f"{name}_img_per_s"] = n / (time.perf_counter() - t0)
            row["cold_img_per_s_per_thread"] = row["cold_img_per_s"] / threads
            sweep.emit(row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=",".join(PARTS), help="comma-separated parts: " + ", ".join(PARTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    parts = [p for p in args.only.split(",") if p]
    bad = [p for p in parts if p not in PARTS]
    if bad:
        ap.error(f"unknown part(s) {bad}; choose from {PARTS}")

    import torch

    from aquaculture_tpu_torch.config import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        from aquaculture_tpu_torch.ops import nms_cuda

        nms_cuda.build()
    sweep = Sweep(dev, args.out)
    t_start = time.perf_counter()
    for part in PARTS:
        if part in parts:
            t0 = time.perf_counter()
            globals()[f"part_{part}"](sweep)
            sweep.emit({"part": part, "seconds": time.perf_counter() - t0})
    sweep.emit({"parts": parts, "total_s": time.perf_counter() - t_start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
