#!/usr/bin/env python3
"""The TIFF corpus through the device loader of two checkouts of the port,
in turns on one card.

    python3 scripts/tiff_feed_ab.py --other DIR [--rounds 1] [--passes 8] [--wms 16] [--jpeg 1024]
        [--webp 0] [--min-seconds 5]

DIR is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` under the git-ignored ``.archive_check/``).
The corpora are written once, by this checkout's
``chip_smoke.write_tiff_corpus``, and linked under tile-codec names:
- ``mixed``: its files but the BigTIFF, which checkouts before the TIFF
  reader skip, and the WebP files, which checkouts before the WebP codec
  hand to PIL (a 6144 px uncompressed RGB download as aq-acquire wms
  stores it; LZW with Predictor 2 and Deflate at 2048 px; JPEG tiled at
  256 and in strips at 1024 px), ``--passes`` times over (46 tiles of
  1024 px a pass);
- ``webp``: its WebP files (lossy tiled at 512, 2048 px; lossless and
  lossy RGBA in strips, 1024 px), ``--webp`` times over (6 tiles a pass;
  0, the default, leaves it out: both sides must read WebP, so give a
  checkout with the codec as DIR);
- ``wms``: the 6144 px download alone, ``--wms`` times over (36 tiles a
  file), the pipeline's own input;
- ``jpeg``: the control, a route the TIFF reader does not touch:
  ``chip_smoke.write_feed_files``' distinct q90 4:2:0 1024 px JPEG tiles
  linked ``--jpeg`` times in all (0 leaves it out).
Each run is a process of its own that imports ``aquaculture_tpu_torch``
from one root, builds its libraries and, per corpus after a warm run,
times (host clock, the card synchronised) windows of one pass over the
corpus each, as many as ``--min-seconds`` of windows take (at least one):
- ``loader``: ``native_tile_batches`` at full size (1024 px tiles, batch
  128) on the card, each batch synchronised: tiles/s;
- ``detect``: ``detect_files`` (mt, bf16, batch 128, conf 0.25, random
  weights from seed 0) with ``use_native=True``: the run's tiles/s, its
  routes and the decode kernel's launches.
With a ``jpeg`` corpus, each run also times ``chip_smoke.time_host_decode``
on its distinct files (the entropy decoder and PIL's full decode, per
second on one thread and on every core) first, and again after the
corpora: the host decode of a fresh process, and of one that has read the
corpora.
The runs go other, this, this, other, ``--rounds`` times, so a drift of
the card or its host over the call weighs on both sides alike. One JSON
line per run (every window's tiles/s), then a summary line (per corpus
and measure, each side's median over all its windows, their least and
most, the ratio of the medians this / other); the card's name and power
limit are in every line. Exits non-zero if a run fails or the two sides
serve other numbers of tiles.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def windows(run, min_s: float) -> list:
    """Tiles/s of successive calls of run() (which returns its tiles) until
    they have taken min_s seconds."""
    rates, spent = [], 0.0
    while not rates or spent < min_s:
        t0 = time.perf_counter()
        n = run()
        dt = time.perf_counter() - t0
        rates.append(n / dt)
        spent += dt
    return rates


def child(root: str, corpora_json: str, min_s: float) -> None:
    sys.path.insert(0, root)
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.data import jpeg_cuda, native_loader
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import detect_files, make_infer_fn

    if not torch.cuda.is_available():
        raise SystemExit("tiff_feed_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    native_loader.build()
    jpeg_cuda.build()
    nms_cuda.build()
    torch.manual_seed(0)
    model = load_model(None, "mt", 5)
    cfg = DetectConfig(img_size=640, conf_threshold=0.25)
    infer = make_infer_fn(model, cfg, 1024, device=dev)
    with open(corpora_json) as f:
        corpora = json.load(f)
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)  # this checkout's, beside the other root's package
    spec.loader.exec_module(chip_smoke)
    distinct = sorted({os.path.realpath(p) for p in corpora.get("jpeg", [])})
    out = {"host_fresh": chip_smoke.time_host_decode(distinct, "")} if distinct else {}
    for name, paths in corpora.items():
        detect_files(paths[:8], model, cfg, 128, infer_fn=infer, device=dev, use_native=True)  # warm
        seen = {}

        def loader():
            n, counts = 0, {}
            for b in native_loader.native_tile_batches(paths, batch_size=128, device=dev, counts=counts):
                n += int(b.valid.sum())
                torch.cuda.synchronize(dev)
            seen.update(tiles=n, routes=counts)
            return n

        def detect():
            jpeg_cuda.decode_launches = 0
            *_, stats = detect_files(paths, model, cfg, 128, infer_fn=infer, device=dev, use_native=True)
            seen.update(detect_tiles=stats.tiles, jpeg_decode_launches=jpeg_cuda.decode_launches)
            return stats.tiles

        rates = {"loader_tiles_per_s": windows(loader, min_s), "detect_tiles_per_s": windows(detect, min_s)}
        out[name] = {**seen, **rates}
    if distinct:
        out["host_after"] = chip_smoke.time_host_decode(distinct, "")
    print(json.dumps(out), flush=True)


def write_corpora(d: str, passes: int, wms: int, jpeg: int, webp: int) -> str:
    sys.path.insert(0, HERE)
    import chip_smoke

    from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name

    cases = chip_smoke.write_tiff_corpus(d)
    both = [n for n in cases if n != "bigtiff_2048" and not n.startswith("webp")]
    corpora = {"mixed": [cases[n] for _ in range(passes) for n in both], "wms": [cases["wms_6144"]] * wms}
    if webp:
        corpora["webp"] = [cases[n] for _ in range(webp) for n in cases if n.startswith("webp")]
    if jpeg:
        os.makedirs(os.path.join(d, "feed"))
        distinct = chip_smoke.write_feed_files(os.path.join(d, "feed"))[1]
        corpora["jpeg"] = [distinct[i % len(distinct)] for i in range(jpeg)]
    for name, srcs in corpora.items():
        os.makedirs(os.path.join(d, name))
        links = []
        for i, src in enumerate(srcs):
            links.append(os.path.join(d, name, encode_tile_name(TileSpec(year=2014, bbox_ind=i, x_offset=0,
                                                                         y_offset=0), "tif")))
            os.symlink(src, links[-1])
        corpora[name] = links
    path = os.path.join(d, "corpora.json")
    with open(path, "w") as f:
        json.dump(corpora, f)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--wms", type=int, default=16)
    ap.add_argument("--jpeg", type=int, default=1024)
    ap.add_argument("--webp", type=int, default=0)
    ap.add_argument("--min-seconds", type=float, default=5.0)
    ap.add_argument("--child", nargs=3, metavar=("ROOT", "CORPORA", "MIN_S"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child[0], args.child[1], float(args.child[2]))
        return 0
    if not args.other:
        ap.error("--other is required")
    card = card_line()
    d = tempfile.mkdtemp(prefix="tiff_feed_ab_")
    try:
        return run(args, card, write_corpora(d, args.passes, args.wms, args.jpeg, args.webp))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run(args, card: str, corpora: str) -> int:
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    runs = {"other": [], "this": []}
    for r in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", sides[name], corpora,
                                   str(args.min_seconds)],
                                  capture_output=True, text=True, cwd=sides[name])
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[name].append(res)
            print(json.dumps({"round": r, "side": name, "root": sides[name], **res, "process_s":
                              time.perf_counter() - t0, "card": card}), flush=True)
    summary = {}
    for when in ("host_fresh", "host_after"):
        for key in runs["this"][0].get(when, {}):
            if key != "cores":
                every = {s: [run[when][key] for run in runs[s]] for s in runs}
                summary[f"{when}_{key}"] = {**every, "this_over_other": statistics.median(every["this"]) /
                                            statistics.median(every["other"])}
    for corpus in (c for c in runs["this"][0] if not c.startswith("host_")):
        tiles = {runs[s][0][corpus]["tiles"] for s in runs}
        if len(tiles) != 1:
            print(json.dumps({"error": f"{corpus}: the sides serve {sorted(tiles)} tiles"}), flush=True)
            return 1
        for measure in ("loader_tiles_per_s", "detect_tiles_per_s"):
            every = {s: [x for run in runs[s] for x in run[corpus][measure]] for s in runs}
            median = {s: statistics.median(every[s]) for s in runs}
            summary[f"{corpus}_{measure}"] = {
                "median": median, "least": {s: min(every[s]) for s in runs}, "most": {s: max(every[s]) for s in runs},
                "windows": {s: len(every[s]) for s in runs}, "this_over_other": median["this"] / median["other"]}
    print(json.dumps({"summary": summary, "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
