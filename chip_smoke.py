#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (aquaculture_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. card, torch and nvcc versions;
  2. build the CUDA kernel(s) from csrc/ with nvcc for sm_90a;
  3. hold each kernel against its plain PyTorch version on the card, keep
     masks exactly equal (tolerance 0), over several input suites;
  4. drive the port's main path, ``aquaculture_tpu_torch.cli.detect.main``
     on the mt model at 640 px from 1024 px JPEG tiles, with the launch
     counters zeroed just before and read just after; compare batched_nms
     through the kernel with the plain path on one batch; compare the
     card's f32 forward with the CPU's (TF32 off);
  4b. the pipeline phase: drive ``aquaculture_tpu_torch.cli.pipeline.main``
     (detect on the card, then geocode, download-box dedup, cage areas and
     the land filter on the host) at full width (mt at 640, 32 tiles over 4
     download boxes, two of them overlapping, with land; more than 2,000
     rows reach the hybrid land filter), with the counters zeroed around
     it, printing each stage's rows and host seconds; then the committed
     trained fixture over its rendered 12-tile world, once on the card and once on
     the CPU, in bf16 through cli.pipeline (deviation reported) and in f32
     through run_pipeline (held to the golden bar);
  4c. the serving options: the ``p6`` phase drives cli.pipeline on m6 at
     1280 px with 4b's full-width geometry; cli.detect runs once with
     --augment --multi-label and once with --decode-scale (mt at 640), and
     cli.pipeline with --overlap 256 on 2048 px JPEG rasters (rows before
     and after cross-tile NMS), each with the counters zeroed around it;
     batched_nms through the kernel against the plain path on one batch of
     each new path's own candidates (P6 at 1280, multi-label, TTA, TTA with
     multi-label); the card's f32 forward of n6 at 256 against the CPU's;
  5. time the serving program (mt at 640 and m6 at 1280, bf16, batch 128)
     with CUDA events (median of 3 windows after 3 warmups); time the
     suppression kernel on each serving program's own candidates (mt: each
     of TIMED_SHAPES; m6: (128, 1024)), and its bare scan with no valid
     candidate, on a queue of launches held behind a device sleep, so that
     the time is the card's and not the host's enqueue; time the plain
     version beside it;
  6. the train phase: two f32 train steps of n at 160 px (batch 4, TF32
     off) on the card against the CPU, the losses, every leaf of params,
     EMA and momentum, and the change of the params per optimizer group;
     ``aquaculture_tpu_torch.cli.train`` as the reference recipe runs it
     (m at 640, batch 16, 2 epochs, augmentation on, bf16) on 32 rendered
     1024 px tiles with YOLO labels, then its EMA checkpoint served by
     cli.detect over the main path's tiles with the counters zeroed around
     it (launches == batches); the device time of one bf16 train step of m
     at 640, batch 16, plain and with remat (img/s, training TFLOP/s as 3x
     the forward's conv FLOPs, peak memory), the plain step's profile (host
     enqueue, device busy and idle share, kernels by kind), and the
     augmented feed's img/s alone, and the checkpoint's mAP on its own
     world (reported, not gated: four steps learn nothing);
  7. the int8 and accuracy phases, run where their inputs are: after phase
     1 a probe line (the triton version, where CUTLASS's headers are,
     whether matplotlib imports; it gates nothing); after phase 3
     ``int8_conv``, the int8 convolution's card route (torch._int_mm)
     exactly equal to its plain route on every conv call of mt's int8_full
     model at 640 px (batch 2), at M <= 16, M = 200 and the stem's padded
     K = 108; in phases 4 and 4b ``cli.detect --int8`` on the main path's
     tiles and ``cli.pipeline --int8`` at full width with the counters
     zeroed around each (suppression launches == batches, every int8 conv
     through _int_mm, none through the plain route); then one int8 n tree
     at 160 px card vs CPU (the codes at each requant and the head maps) and
     ``accuracy``, ``eval.accuracy.serving_accuracy_table`` for the trained
     fixture on its rendered 12-image world at 160 px on the card and on the
     CPU, every row: the f32 rows agree card vs CPU, and every card row
     holds tests/test_accuracy.py's bounds against the card's bf16 row; in
     phase 5 mt int8_safe b128 serving timed beside bf16, with its stages
     and both forwards' profiles;
  8. after 4b, ``cluster_evaluate`` on an evaluation world at the
     reference's scale written from a numpy seed (8 survey years x 2,000
     cage detections on the French Mediterranean coast, 4,142 labels,
     35,199 images in 5 strata): DBSCAN on the card equal to the plain BFS
     label for label per year at (eps, min size) = (50, 5), (10, 1) and
     (150, 10); ``cli.cluster`` on the card and with --device cpu writing
     equal facility files; on fold 0's train split the card's grid sweep
     equal to the plain per-combination loop on a 12-combination sub-grid
     (NaN in place); ``cli.evaluate`` on the card with the full 6,560-
     combination grid over 5 folds (the sweep's seconds per fold, the
     match matrix's host seconds, the fold rows, the held-out table, which
     must equal test_set_performance with --device cpu). The CPU references
     run in worker processes beside the card's side.
The last lines are the script seconds per group of phases, the total, the
{"kernels": [...]} summary, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core f32
# FLOP/s and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# f32 operations of one IoU + threshold test (ops/nms.py _iou_matrix):
# 4 min/max, 2 sub, 2 clamp, 1 mul, 2 add/sub, 1 max, 1 div, 1 compare
OPS_PER_IOU = 14
# boxes (16 B) + valid (1 B) read once, keep (1 B) written once
BYTES_PER_CANDIDATE = 18

SUITES = ("random", "identical", "boundary", "boundary_straddle", "class_offset",
          "partly_invalid")
# (B, K) of the exactness checks: 32-candidate words full, ragged and
# single; the main path's batch; larger pools up to the whole 25,200-row P5
# pool at 640 px. check_kernels adds K either side of the kernel's
# shared-memory staging limit.
SHAPES = ((1, 1), (3, 128), (2, 300), (4, 33), (128, 1024), (130, 1024), (2, 4096),
          (1, 8192), (1, 25_200))
# (B, K) of the timed suppressions, on the serving program's own candidates
# (mt, conf 1e-5, pre-topk K): the main path's batch, small batches, the
# pre-topk 8192 pool and the whole P5 pool.
TIMED_SHAPES = ((128, 1024), (8, 1024), (1, 1024), (1, 8192), (1, 25_200))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_cuda(fn, iters: int, windows: int = 3, warmup: int = 3, queued: bool = False) -> float:
    """Median over windows of the mean ms per call, CUDA events. queued:
    hold each window's launches behind a device sleep, so that they run
    back to back and the window times the card, not the host's enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(200_000 * iters)  # ~0.1 ms of device clock per launch
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain suites
# ---------------------------------------------------------------------------

def _random_boxes(rng, b, k, size=640.0):
    cx = rng.uniform(50, size - 50, (b, k))
    cy = rng.uniform(50, size - 50, (b, k))
    w = rng.uniform(10, 120, (b, k))
    h = rng.uniform(10, 120, (b, k))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1).astype(np.float32)


def _boundary_boxes(rng, b, k, shift=0):
    """Pairs (base, base shifted right by d) with IoU = (100-d)/(100+d)
    within a few float32 ulps of 0.45; pairs are stacked 300 px apart in y
    only, so x keeps d's full precision. shift=1 starts the pairs at index
    1 after a lone box, so pairs (31, 32), (63, 64), ... straddle the
    kernel's 32-candidate words."""
    d0 = np.float32(100.0 * 0.55 / 1.45)
    out = np.zeros((b, k, 4), np.float32)
    out[:, :shift] = [0, -300, 100, -200]
    for i in range(shift, k):
        q = i - shift
        oy = np.float32(300 * (q // 2))
        if q % 2 == 0:
            out[:, i] = [0, oy, 100, oy + 100]
        else:
            steps = rng.integers(-6, 7, b)
            d = np.array([d0] * b, np.float32)
            for j, s in enumerate(steps):
                for _ in range(abs(int(s))):
                    d[j] = np.nextafter(d[j], np.float32(np.inf if s > 0 else -np.inf))
            out[:, i, 0] = d
            out[:, i, 1] = oy
            out[:, i, 2] = np.float32(100) + d
            out[:, i, 3] = oy + np.float32(100)
    return out


def suite_inputs(kind: str, b: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    valid = np.ones((b, k), bool)
    if kind == "random":
        boxes = _random_boxes(rng, b, k)
        valid = rng.random((b, k)) > 0.1
    elif kind == "identical":
        boxes = np.tile(np.asarray([10.0, 10.0, 50.0, 50.0], np.float32), (b, k, 1))
    elif kind == "boundary":
        boxes = _boundary_boxes(rng, b, k)
    elif kind == "boundary_straddle":
        boxes = _boundary_boxes(rng, b, k, shift=1)
    elif kind == "class_offset":
        cls = rng.integers(0, 5, (b, k)).astype(np.float32)
        boxes = _random_boxes(rng, b, k) + (cls * np.float32(7680.0))[..., None]
    elif kind == "partly_invalid":
        boxes = _random_boxes(rng, b, k)
        valid = rng.random((b, k)) > 0.5
        valid[:, : k // 2] = False
    else:
        raise ValueError(kind)
    return boxes, valid


def check_shapes() -> tuple:
    """SHAPES plus K at and one past the kernel's staging limit."""
    from aquaculture_tpu_torch.ops import nms_cuda

    staged = nms_cuda.build().aq_nms_max_staged_k()
    return SHAPES + ((1, staged), (1, staged + 1))


def check_kernels(dev, shapes) -> list:
    import torch

    from aquaculture_tpu_torch.ops.nms import greedy_suppress_plain
    from aquaculture_tpu_torch.ops.nms_cuda import greedy_suppress_cuda

    passed = []
    for si, kind in enumerate(SUITES):
        for b, k in shapes:
            boxes_np, valid_np = suite_inputs(kind, b, k, seed=1000 * si + k + b)
            boxes = torch.from_numpy(boxes_np).to(dev)
            valid = torch.from_numpy(valid_np).to(dev)
            got = greedy_suppress_cuda(boxes, valid, 0.45)
            want = greedy_suppress_plain(boxes, valid, 0.45)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"nms_suppress != plain on suite {kind} (B={b}, K={k}): {bad} flags differ")
        passed.append(kind)
    return passed


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def write_tiles(d: str, n: int = 16, seed: int = 0, specs=None, px: int = 1024) -> list:
    """n seeded px-square JPEG images (1024 px tiles, or larger rasters)
    named with the tile codec: four per download box along x, or the given
    TileSpecs."""
    from PIL import Image

    from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name

    if specs is None:
        specs = [TileSpec(year=2014, bbox_ind=i // 4, x_offset=1024 * (i % 4), y_offset=0) for i in range(n)]
    rng = np.random.default_rng(seed)
    paths = []
    for spec in specs:
        img = rng.integers(0, 255, (px, px, 3), dtype=np.uint8)
        for _ in range(6):  # bright rectangles for structure
            x, y = rng.integers(0, px - 124, 2)
            w, h = rng.integers(30, 120, 2)
            img[y : y + h, x : x + w] = rng.integers(150, 255, 3, dtype=np.uint8)
        p = os.path.join(d, encode_tile_name(spec, "jpeg"))
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def run_main_path(tile_dir: str, label_dir: str, n_tiles: int, batch: int, options: tuple = (),
                  variant: str = "mt") -> dict:
    """cli.detect on ``variant`` (mt) at 640 over the tiles, with serving
    ``options`` (e.g. --augment --multi-label, or --weights) after the
    defaults."""
    from aquaculture_tpu_torch.cli import detect as cli_detect
    from aquaculture_tpu_torch.ops import int8_conv, nms_cuda

    nms_cuda.launches = int8_conv.mm_calls = int8_conv.plain_calls = 0
    t0 = time.perf_counter()
    stats = cli_detect.main([
        "--source", tile_dir, "--out", label_dir, "--variant", variant,
        "--batch", str(batch), "--conf", "1e-5", *options,
    ])
    seconds = time.perf_counter() - t0
    launches = {"nms_suppress": nms_cuda.launches}
    int8_calls = check_int8_routes(f"cli.detect {list(options)}", "--int8" in options)

    n_batches = -(-n_tiles // batch)
    if launches["nms_suppress"] != n_batches:
        fail(f"nms_suppress launched {launches['nms_suppress']} times on cli.detect {list(options)}, "
             f"expected {n_batches} (one per batch)")
    if stats.loader != "python":
        fail(f"cli.detect {list(options)} ran the {stats.loader!r} loader; the port has the Python one")
    labels = sorted(os.listdir(label_dir))
    if len(labels) != n_tiles:
        fail(f"{len(labels)} label files for {n_tiles} tiles")
    rows = 0
    for name in labels:
        arr = np.loadtxt(os.path.join(label_dir, name), ndmin=2)
        if arr.shape[1] != 6 or not np.isfinite(arr).all():
            fail(f"{name}: malformed rows {arr.shape}")
        if not ((arr[:, 0] >= 0) & (arr[:, 0] < 5)).all() or not (arr[:, 5] > 0).all():
            fail(f"{name}: class or confidence out of range")
        rows += len(arr)
    return {"options": list(options), "launches": launches, "int8_conv_calls": int8_calls, "seconds": seconds,
            "label_files": len(labels), "rows": rows, "tiles": stats.tiles, "batches": stats.batches,
            "loader": stats.loader}


def check_int8_routes(what: str, int8: bool) -> dict:
    """The int8 convolutions of a drive on the card since the counters were
    zeroed: all through torch._int_mm (at least one when ``int8``), none
    through the plain route."""
    from aquaculture_tpu_torch.ops import int8_conv

    calls = {"int_mm": int8_conv.mm_calls, "plain": int8_conv.plain_calls}
    if calls["plain"] or (calls["int_mm"] > 0) != int8:
        fail(f"{what}: int8 convs through _int_mm {calls['int_mm']}, through the plain route {calls['plain']}")
    return calls


# ---------------------------------------------------------------------------
# phase 4b: the aq-pipeline path
# ---------------------------------------------------------------------------

# Download boxes of the full-width drive (EPSG:3857 m): 0 and 1 overlap by
# half, so dedup drops and clips box 1's rows; 2 and 3 share an edge.
PIPELINE_BOXES = ((0.0, 0.0, 1200.0, 1200.0), (600.0, 0.0, 1800.0, 1200.0),
                  (2400.0, 0.0, 3600.0, 1200.0), (3600.0, 0.0, 4800.0, 1200.0))
PIPELINE_TILES = 32   # 8 per box: x offsets 0..3072, y offsets 0 and 1024
PIPELINE_BATCH = 16
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "demo_ckpt_n160")


def write_boxes_csv(path: str, boxes) -> None:
    """wanted_bboxes.csv: one WKT polygon per download box, in bbox_ind order."""
    with open(path, "w") as f:
        f.write("geometry\n")
        for x0, y0, x1, y1 in boxes:
            f.write(f'"POLYGON (({x0} {y0}, {x1} {y0}, {x1} {y1}, {x0} {y1}, {x0} {y0}))"\n')


def write_land(path: str, x0: float, x1: float, y: float, top: float, seed: int) -> None:
    """A jagged coast from x0 to x1 around northing y (EPSG:3857), land up
    to ``top``, written as EPSG:4326 GeoJSON."""
    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.geo import polygon as P

    xs = np.linspace(x0, x1, 33)
    ys = y + np.random.default_rng(seed).uniform(-80, 80, len(xs))
    ring = np.concatenate([np.stack([xs, ys], 1), [[x1, top], [x0, top]]], 0)
    gf.GeoFrame({"name": ["coast"]}, geometry=[P.Polygon(ring)], crs=3857).to_crs(4326).to_file(path)


def clipped_rows(det, boxes_csv: str) -> int:
    """Rows whose geometry dedup clipped: their EPSG:3857 bounds differ from
    the box geocode builds from their pixel columns and tile."""
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.data.filenames import decode_tile_name
    from aquaculture_tpu_torch.post.geocode import pixels_to_mercator

    if not len(det):
        return 0
    specs = [decode_tile_name(n) for n in det["image"]]
    dl = load_download_bboxes(boxes_csv)
    tif = np.asarray([dl["geometry"].iloc[s.bbox_ind].bounds for s in specs])
    xo = np.asarray([s.x_offset for s in specs], np.float64)
    yo = np.asarray([s.y_offset for s in specs], np.float64)
    px = det[["xmin", "ymin", "xmax", "ymax"]].to_numpy(np.float64)
    x0, y1 = pixels_to_mercator(px[:, 0], px[:, 1], xo, yo, tif)
    x1, y0 = pixels_to_mercator(px[:, 2], px[:, 3], xo, yo, tif)
    got = det.to_crs(3857).bounds_array()
    want = np.stack([x0, y0, x1, y1], 1)
    return int((np.abs(got - want) > 1e-3).any(axis=1).sum())


def check_geojson(path: str, det, n_classes: int) -> None:
    """What cli.pipeline wrote: one feature per row, finite lon/lat boxes,
    finite positive areas, confidences in (0, 1], known classes."""
    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.config import CLASS_NAMES

    back = gf.read_file(path)
    if len(back) != len(det) or back.crs != 4326:
        fail(f"{path}: {len(back)} features in EPSG:{back.crs} for {len(det)} rows")
    if not len(back):
        return
    b = back.bounds_array()
    if not (np.isfinite(b).all() and (np.abs(b[:, [0, 2]]) <= 180).all() and (np.abs(b[:, [1, 3]]) <= 90).all()):
        fail(f"{path}: geometry outside lon/lat")
    num = back[["xmin_m", "xmax_m", "ymin_m", "ymax_m", "area", "area_var", "min_area", "max_area",
                "det_conf"]].to_numpy(np.float64)
    if not np.isfinite(num).all() or not (back["area"] > 0).all():
        fail(f"{path}: non-finite values or non-positive areas")
    if not ((back["det_conf"] > 0) & (back["det_conf"] <= 1)).all():
        fail(f"{path}: confidence out of (0, 1]")
    if not set(back["type"]) <= set(CLASS_NAMES[:n_classes]):
        fail(f"{path}: unknown classes {sorted(set(back['type']) - set(CLASS_NAMES[:n_classes]))}")


def _stage_report(stats) -> dict:
    return {"stage_rows": dict(stats.stage_rows), "stage_host_s": dict(stats.stage_seconds),
            "land_filter": stats.land_filter, "tiles": stats.tiles, "batches": stats.batches}


def write_pipeline_inputs(d: str) -> tuple:
    """(tile_dir, boxes_csv, land) of the full-width drive: PIPELINE_TILES
    JPEG tiles over PIPELINE_BOXES, with land over part of boxes 2 and 3."""
    from aquaculture_tpu_torch.data.filenames import TileSpec

    tile_dir = os.path.join(d, "tiles")
    os.makedirs(tile_dir)
    specs = [TileSpec(year=2014, bbox_ind=b, x_offset=1024 * (i % 4), y_offset=1024 * (i // 4))
             for b in range(len(PIPELINE_BOXES)) for i in range(PIPELINE_TILES // len(PIPELINE_BOXES))]
    write_tiles(tile_dir, seed=1, specs=specs)
    boxes_csv, land = os.path.join(d, "wanted_bboxes.csv"), os.path.join(d, "land.geojson")
    write_boxes_csv(boxes_csv, PIPELINE_BOXES)
    write_land(land, 2300.0, 4900.0, 1000.0, 1400.0, seed=2)
    return tile_dir, boxes_csv, land


def drive_pipeline_full_width(d: str, inputs: tuple, variant: str = "mt", options: tuple = ()) -> dict:
    """cli.pipeline on the card: ``variant`` at its default size (mt at
    640, m6 at 1280) over write_pipeline_inputs' tiles, random weights from
    seed 0, conf 1e-5, serving ``options`` (e.g. --int8) after those."""
    from aquaculture_tpu_torch.cli import pipeline as cli_pipeline
    from aquaculture_tpu_torch.cli.detect import default_img_size
    from aquaculture_tpu_torch.ops import int8_conv, nms_cuda

    tile_dir, boxes_csv, land = inputs
    out = os.path.join(d, f"det_{variant}{''.join(options)}.geojson")
    nms_cuda.launches = int8_conv.mm_calls = int8_conv.plain_calls = 0
    t0 = time.perf_counter()
    det, stats = cli_pipeline.main([
        "--source", tile_dir, "--download-bboxes", boxes_csv, "--land", land, "--out", out,
        "--variant", variant, "--batch", str(PIPELINE_BATCH), "--conf", "1e-5", *options,
    ])
    seconds = time.perf_counter() - t0
    launches = nms_cuda.launches
    int8_calls = check_int8_routes(f"pipeline {variant} {list(options)}", "--int8" in options)

    n_batches = -(-PIPELINE_TILES // PIPELINE_BATCH)
    if not launches == stats.batches == n_batches or stats.tiles != PIPELINE_TILES:
        fail(f"pipeline {variant}: nms_suppress launched {launches} times for {stats.batches} batches "
             f"of {stats.tiles} tiles, expected {n_batches} batches of {PIPELINE_TILES}")
    rows = stats.stage_rows
    if not rows["dedup"] < rows["geocode"]:
        fail(f"pipeline {variant}: dedup dropped no row ({rows})")
    clipped = clipped_rows(det, boxes_csv)
    if not clipped:
        fail(f"pipeline {variant}: dedup clipped no row")
    if stats.land_filter != "hybrid" or rows["areas"] <= 2000 or not rows["land_filter"] < rows["areas"]:
        fail(f"pipeline {variant}: land filter {stats.land_filter!r} on {rows['areas']} rows removed "
             f"{rows['areas'] - rows['land_filter']}; expected the hybrid filter on > 2000 rows to remove some")
    check_geojson(out, det, n_classes=5)
    return {"variant": variant, "options": list(options), "img": default_img_size(None, variant),
            "tiles": PIPELINE_TILES, "batch": PIPELINE_BATCH, "download_boxes": len(PIPELINE_BOXES),
            "launches": {"nms_suppress": launches}, "int8_conv_calls": int8_calls, "dedup_clipped_rows": clipped,
            "seconds": seconds, "loader": stats.loader, **_stage_report(stats)}


OVERLAP = 256
OVERLAP_RASTER = 2048  # px; 3 x 3 tiles of 1024 px at stride 768


def drive_pipeline_overlap(d: str, boxes_csv: str) -> dict:
    """cli.pipeline --overlap 256 on the card: mt at 640 over one 2048 px
    raster per download box, conf 1e-5; cross-tile NMS must collapse the
    copies that the overlapping tiles detect twice."""
    from aquaculture_tpu_torch.cli import pipeline as cli_pipeline
    from aquaculture_tpu_torch.data.filenames import TileSpec
    from aquaculture_tpu_torch.ops import nms_cuda

    raster_dir = os.path.join(d, "rasters")
    os.makedirs(raster_dir)
    specs = [TileSpec(year=2014, bbox_ind=b, x_offset=0, y_offset=0) for b in range(len(PIPELINE_BOXES))]
    write_tiles(raster_dir, seed=4, specs=specs, px=OVERLAP_RASTER)
    out = os.path.join(d, "det_overlap.geojson")
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    det, stats = cli_pipeline.main([
        "--source", raster_dir, "--download-bboxes", boxes_csv, "--out", out, "--variant", "mt",
        "--batch", str(PIPELINE_BATCH), "--conf", "1e-5", "--overlap", str(OVERLAP),
    ])
    seconds = time.perf_counter() - t0
    launches = nms_cuda.launches
    n_tiles = 9 * len(PIPELINE_BOXES)
    rows = stats.stage_rows
    if not launches == stats.batches == -(-n_tiles // PIPELINE_BATCH) or stats.tiles != n_tiles:
        fail(f"overlap: {launches} launches, {stats.batches} batches, {stats.tiles} tiles for {n_tiles} tiles")
    if list(rows)[:4] != ["detect", "geocode", "dedup", "cross_tile"] or not rows["cross_tile"] < rows["dedup"]:
        fail(f"overlap: cross-tile NMS collapsed no copy ({rows})")
    check_geojson(out, det, n_classes=5)
    return {"variant": "mt", "img": 640, "overlap": OVERLAP, "rasters": len(PIPELINE_BOXES),
            "raster_px": OVERLAP_RASTER, "launches": {"nms_suppress": launches}, "seconds": seconds,
            "loader": stats.loader, **_stage_report(stats)}


def _match_golden(got, want) -> dict:
    """Each row of ``got`` matched one to one to a row of ``want`` of the
    same image and class at the golden bar of tests/test_golden_pipeline.py
    (pixel-box IoU >= 0.99, confidence within 1e-3); also the spread of
    each row's best IoU against its image and class, matched or not."""
    cols = ["xmin", "ymin", "xmax", "ymax"]

    def iou(a, b):
        iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0)
        ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0)
        inter = iw * ih
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / ua if ua > 0 else 0.0

    free = {}
    for j, (img, typ, conf, box) in enumerate(zip(want["image"], want["type"], want["det_conf"],
                                                  want[cols].to_numpy(np.float64))):
        free.setdefault((img, typ), []).append((j, conf, box))
    worst_iou, worst_dconf, unmatched, best = 1.0, 0.0, 0, []
    for img, typ, conf, box in zip(got["image"], got["type"], got["det_conf"], got[cols].to_numpy(np.float64)):
        cands = free.get((img, typ), [])
        scored = sorted(((iou(box, b), -abs(conf - c), k) for k, (_, c, b) in enumerate(cands)), reverse=True)
        best.append(scored[0][0] if scored else 0.0)
        if not scored or scored[0][0] < 0.99 or -scored[0][1] > 1e-3:
            unmatched += 1
            continue
        best_iou, neg_dconf, k = scored[0]
        worst_iou, worst_dconf = min(worst_iou, best_iou), max(worst_dconf, -neg_dconf)
        cands.pop(k)
    return {"rows": [len(got), len(want)], "unmatched": unmatched, "worst_iou": float(worst_iou),
            "worst_dconf": float(worst_dconf),
            "best_iou_p05_p50": [float(q) for q in np.percentile(best, [5, 50])] if best else None}


def drive_pipeline_trained_card_vs_cpu(d: str, img_dir: str) -> dict:
    """The committed trained fixture (n, 2 classes) at 160 px on its
    rendered 12-tile world (seed 0, in ``d``: the accuracy phase's), with
    land over part of it, once on the
    card and once on the CPU:

    - ``cli.pipeline`` as users run it (bf16): launches, land branch and
      output checked; how far the card's rows are from the CPU's is
      reported, not held to the golden bar, because at 160 px one pixel of
      the model is 6.4 px of the tile and bf16 rounds activations after
      cuDNN's and the CPU's different summation orders;
    - ``run_pipeline`` in f32 with TF32 off: the two GeoJSONs hold the same
      rows at the golden bar."""
    import torch

    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.cli import pipeline as cli_pipeline
    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import run_pipeline

    boxes_csv, land = os.path.join(d, "wanted_bboxes.csv"), os.path.join(d, "land.geojson")
    write_land(land, -100.0, 3700.0, 1100.0, 2500.0, seed=3)
    args = ["--source", img_dir, "--download-bboxes", boxes_csv, "--land", land,
            "--weights", FIXTURE, "--img", "160", "--conf", "0.05"]
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    f32 = DetectConfig(img_size=160, conf_threshold=0.05, dtype="float32")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    runs, frames = {}, {}
    for dtype in ("bfloat16", "float32"):
        for device in ("cuda", "cpu"):
            out = os.path.join(d, f"det_{dtype}_{device}.geojson")
            nms_cuda.launches = 0
            if dtype == "bfloat16":
                det, stats = cli_pipeline.main(args + ["--out", out, "--device", device])
            else:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    det, stats = run_pipeline(paths, load_model(FIXTURE, "n", 2), load_download_bboxes(boxes_csv),
                                              f32, land=gf.read_file(land), device=device)
                finally:
                    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
                det.to_file(out)
            launches = nms_cuda.launches
            if launches != (stats.batches if device == "cuda" else 0):
                fail(f"trained fixture, {dtype} on {device}: {launches} suppression launches "
                     f"for {stats.batches} batches")
            if stats.land_filter != "exact" or not stats.stage_rows["land_filter"] < stats.stage_rows["areas"]:
                fail(f"trained fixture, {dtype} on {device}: land filter {stats.land_filter!r}, "
                     f"rows {stats.stage_rows}")
            check_geojson(out, det, n_classes=2)
            frames[dtype, device] = gf.read_file(out)
            runs[f"{dtype}_{device}"] = {"rows": len(det), "launches": launches, **_stage_report(stats)}
    bf16 = _match_golden(frames["bfloat16", "cuda"], frames["bfloat16", "cpu"])
    match = _match_golden(frames["float32", "cuda"], frames["float32", "cpu"])
    if match["rows"][0] != match["rows"][1] or match["unmatched"] or match["rows"][0] < 50:
        fail(f"trained fixture f32 card vs CPU (TF32 off) misses the golden bar: {match}")
    return {"variant": "n", "img": 160, "tiles": len(paths), "weights": "tests/data/demo_ckpt_n160",
            "f32_card_vs_cpu_golden_bar": match, "bf16_card_vs_cpu": bf16, "runs": runs}


def nms_kernel_vs_plain(preds, multi_label: bool = False, what: str = "mt") -> dict:
    """batched_nms through the kernel vs the plain suppression on the same
    candidates (conf 1e-5, pre-topk 1024): masks and rows exactly equal."""
    import torch

    from aquaculture_tpu_torch.ops import nms as N

    with torch.inference_mode():
        det_k, val_k = N.batched_nms(preds, conf_thresh=1e-5, multi_label=multi_label)
        boxes, nms_boxes, scores, cls, valid = N._prepare_candidates(preds, 1e-5, 1024, False, multi_label)
        keep = N.greedy_suppress_plain(nms_boxes, valid, 0.45)
        det_p, val_p = N._compact(boxes, cls, scores, keep, 300)
    torch.cuda.synchronize()
    if not torch.equal(val_k, val_p):
        fail(f"batched_nms masks differ between kernel and plain suppression ({what})")
    if not torch.equal(det_k, det_p):
        fail(f"batched_nms det rows differ between kernel and plain suppression ({what})")
    if not torch.isfinite(preds).all():
        fail(f"non-finite predictions ({what})")
    return {"pool_rows": preds.shape[1], "B": preds.shape[0], "K": valid.shape[1],
            "valid_candidates": int(valid.sum()), "kept": int(val_k.sum())}


def check_nms_paths(paths: list, dev) -> dict:
    """nms_kernel_vs_plain on one batch of the main path's tiles (bf16)
    for each path's own candidates: mt at 640 (argmax class and
    multi-label), the merged 3-pass TTA pool of mt at 640 (argmax class and
    multi-label), and m6 at 1280 (the 1024 px tiles upscaled)."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.data.loader import tile_batches
    from aquaculture_tpu_torch.ops.tta import tta_predict
    from aquaculture_tpu_torch.pipeline import preprocess

    images = next(iter(tile_batches(paths[:8], batch_size=8))).images.to(dev)
    out = {}
    for variant, img in (("mt", 640), ("m6", 1280)):
        model = load_model(None, variant, 5).to(dev, torch.bfloat16, memory_format=torch.channels_last).eval()
        with torch.inference_mode():
            x = preprocess(images, img, torch.bfloat16)
            preds = model(x)
            if variant == "m6":
                if preds.shape[1] != 3 * sum((img // s) ** 2 for s in (8, 16, 32, 64)):
                    fail(f"m6 at {img}: {preds.shape[1]} rows")
                out["p6_1280"] = nms_kernel_vs_plain(preds, what="m6 at 1280")
                continue
            out["mt_640"] = nms_kernel_vs_plain(preds, what="mt")
            out["multi_label"] = nms_kernel_vs_plain(preds, True, "mt multi-label")
            tta = tta_predict(model, x)
            if tta.shape[1] != 25_200 + 18_207 + 12_348:
                fail(f"TTA pool of mt at 640: {tta.shape[1]} rows")
            out["tta"] = nms_kernel_vs_plain(tta, what="mt TTA")
            out["tta_multi_label"] = nms_kernel_vs_plain(tta, True, "mt TTA multi-label")
    return out


def check_m_builds(dev) -> dict:
    """m (depth 0.67, width 0.75) builds from the same code and runs at 640."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model

    model = load_model(None, "m", 5).to(dev, torch.bfloat16, memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        preds = model(torch.rand((2, 640, 640, 3), device=dev).to(torch.bfloat16))
    if preds.shape != (2, 25_200, 10) or not torch.isfinite(preds).all():
        fail(f"m forward: shape {tuple(preds.shape)} or non-finite values")
    return {"variant": "m", "shape": list(preds.shape)}


def check_f32_vs_cpu(dev, variant: str = "n", img: int = 160) -> dict:
    """f32, TF32 off: the card's forward against the CPU's (n at 160, n6
    at 256)."""
    import torch

    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = load_jax_params(*yolov5_init(variant, 5, seed=7)).eval()
        x = torch.from_numpy(np.random.default_rng(3).random((2, img, img, 3), dtype=np.float32))
        with torch.inference_mode():
            ref = model(x)
            got = model.to(dev).to(memory_format=torch.channels_last)(x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    box_err = float((got[..., :4] - ref[..., :4]).abs().max())
    score_err = float((got[..., 4:] - ref[..., 4:]).abs().max())
    if not (box_err <= 1e-3 and score_err <= 1e-4):
        fail(f"card vs CPU f32 forward of {variant} at {img}: box err {box_err} px, score err {score_err}")
    return {"variant": variant, "img": img, "rows": got.shape[1], "box_max_abs_err_px": box_err,
            "score_max_abs_err": score_err}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def conv_flops_per_image(model, img: int, dev) -> int:
    """Conv FLOPs (2 * MACs) of one forward at img px, from the shapes the
    convs see (forward hooks on one image)."""
    import torch

    from aquaculture_tpu_torch.models.layers import ConvBlock, QConvBlock, kernel_of
    from aquaculture_tpu_torch.models.yolov5 import HeadConv

    total = [0]

    def hook(m, _inp, out):
        o, i, kh, kw = kernel_of(m).shape
        total[0] += 2 * o * i * kh * kw * out.shape[-2] * out.shape[-1]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (ConvBlock, QConvBlock, HeadConv))]
    try:
        with torch.inference_mode():
            model(torch.zeros((1, img, img, 3), device=dev, dtype=model.head[0].weight.dtype))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def suppress_bound_ms(keep, valid) -> tuple:
    """Least time for the suppression of this run's data on the H100: the
    larger of the bytes over HBM bandwidth and the IoUs it needs over the
    f32 rate. A kept candidate must be tested against every kept one
    before it, a suppressed one against at least one."""
    b, k = valid.shape
    kept = keep.sum(dim=1).double()
    suppressed = (valid & ~keep).sum(dim=1).double()
    ious = float((kept * (kept - 1) / 2 + suppressed).sum())
    t_bytes = b * k * BYTES_PER_CANDIDATE / HBM_BYTES_PER_S * 1e3
    t_ops = ious * OPS_PER_IOU / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def all_pairs_bound_ms(b: int, k: int) -> float:
    """The same least time if every pair of candidates needed its IoU."""
    return max(b * k * BYTES_PER_CANDIDATE / HBM_BYTES_PER_S,
               b * k * k / 2 * OPS_PER_IOU / F32_FLOP_PER_S) * 1e3


def serving_tiles(dev, b: int = 128):
    """The timed serving batch: b seeded uint8 1024 px tiles on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(0, 256, (b, 1024, 1024, 3), generator=gen, device=dev, dtype=torch.uint8)


def timed_suppress_inputs(preds, shapes) -> list:
    """(B, K, nms_boxes, valid) of the serving program's own candidates at
    conf 1e-5 and pre-topk K, for each (B, K) of ``shapes``."""
    from aquaculture_tpu_torch.ops import nms as N

    out = []
    for b, k in shapes:
        _, nms_boxes, _, _, valid = N._prepare_candidates(preds[:b], 1e-5, k, False)
        out.append((b, k, nms_boxes.contiguous(), valid.contiguous()))
    return out


def time_suppress(preds, card: str, shapes, variant: str) -> list:
    """The kernel at each (B, K) of ``shapes``, held exactly against the
    plain version on the same inputs, beside its bounds and the plain
    version's time; the first shape (the main path's) also gets the scan
    floor, the kernel with no valid candidate. One JSON line per shape."""
    import torch

    from aquaculture_tpu_torch.ops import nms as N
    from aquaculture_tpu_torch.ops.nms_cuda import greedy_suppress_cuda

    rows = []
    for b, k, boxes, valid in timed_suppress_inputs(preds, shapes):
        main_shape = not rows
        keep = greedy_suppress_cuda(boxes, valid, 0.45)
        plain_keep = N.greedy_suppress_plain(boxes, valid, 0.45)
        torch.cuda.synchronize()
        if not torch.equal(keep, plain_keep):
            fail(f"nms_suppress != plain on the {variant} serving candidates (B={b}, K={k})")
        bound, bound_by = suppress_bound_ms(keep, valid)
        # the plain version at the larger shapes takes 0.4-1.5 s a call:
        # one timed call, no warmup
        reps = 3 if main_shape else 1
        row = {
            "B": b, "K": k, "valid": int(valid.sum()), "kept": int(keep.sum()),
            "ms": time_cuda(lambda: greedy_suppress_cuda(boxes, valid, 0.45), iters=20, queued=True),
            "plain_ms": time_cuda(lambda: N.greedy_suppress_plain(boxes, valid, 0.45), iters=1,
                                  windows=reps, warmup=reps if main_shape else 0),
            "bound_ms": bound, "bound_by": bound_by, "bound_ms_all_pairs": all_pairs_bound_ms(b, k),
            "max_abs_err": float((keep.float() - plain_keep.float()).abs().max()),
        }
        if main_shape:
            no_valid = torch.zeros_like(valid)
            row["scan_floor_ms"] = time_cuda(lambda: greedy_suppress_cuda(boxes, no_valid, 0.45),
                                             iters=20, queued=True)
        print(json.dumps({"metric": "nms_suppress", "variant": variant, **row, "library_ms": None,
                          "library": "none: no PyTorch call computes greedy suppression",
                          "card": card}), flush=True)
        rows.append(row)
    return rows


def time_serving_and_kernel(dev, card: str, tiles, variant: str = "mt", shapes=TIMED_SHAPES,
                            iters: int = 5, int8_paths=None, profile: bool = False) -> dict:
    """The serving program of ``variant`` at its default size (mt at 640,
    m6 at 1280) on the 1024 px ``tiles``, random weights from seed 0:
    tiles/s at conf 0.25 and 1e-5, the stage breakdown at conf 1e-5, the
    forward's conv rate, and the kernel on its candidates at ``shapes``.
    int8_paths: serve the int8_safe model instead (cli.detect --int8's),
    calibrated on these image files. profile: also profile the forward
    (profile_step: device busy, idle share, kernels by kind)."""
    import torch

    from aquaculture_tpu_torch.cli.detect import default_img_size, load_model, quantize_for_serving
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.ops import nms as N
    from aquaculture_tpu_torch.ops.nms_cuda import greedy_suppress_cuda
    from aquaculture_tpu_torch.pipeline import make_infer_fn, preprocess

    model, img, b = load_model(None, variant, 5), default_img_size(None, variant), tiles.shape[0]
    serving = "bfloat16"
    if int8_paths:
        model, serving = quantize_for_serving(model, int8_paths, img, device=dev), "int8_safe"
    out = {"serving": serving}
    for conf in (0.25, 1e-5):
        infer = make_infer_fn(model, DetectConfig(img_size=img, conf_threshold=conf), tile=1024, device=dev)
        ms = time_cuda(lambda: infer(tiles), iters=iters)
        out[f"conf_{conf:g}"] = {"ms_per_batch": ms, "tiles_per_s": b / ms * 1e3}
        print(json.dumps({"metric": "serving", "variant": variant, "dtype": serving, "batch": b,
                          "img": img, "tile": 1024, "conf": conf, "ms_per_batch": ms,
                          "tiles_per_s": b / ms * 1e3, "card": card}), flush=True)

    # stage breakdown of the same program (conf 1e-5: full suppression work)
    with torch.inference_mode():
        x = preprocess(tiles, img, torch.bfloat16)
        preds = model(x)
        kernel_rows = time_suppress(preds, card, shapes, variant)
        boxes, nms_boxes, scores, cls, valid = N._prepare_candidates(preds, 1e-5, 1024, False)
        keep = greedy_suppress_cuda(nms_boxes.contiguous(), valid, 0.45)
        stages = {
            "resize": time_cuda(lambda: preprocess(tiles, img, torch.bfloat16), iters=iters),
            "forward": time_cuda(lambda: model(x), iters=iters),
            "nms_prep": time_cuda(lambda: N._prepare_candidates(preds, 1e-5, 1024, False), iters=5),
            "suppress_kernel": kernel_rows[0]["ms"],
            "compact": time_cuda(lambda: N._compact(boxes, cls, scores, keep, 300), iters=20),
        }
        flops = conv_flops_per_image(model, img, dev)
        fwd_rate = flops * b / (stages["forward"] / 1e3)
        print(json.dumps({"metric": "stages_ms", "variant": variant, "dtype": serving, "img": img, "batch": b,
                          "conf": 1e-5, **stages, "card": card}), flush=True)
        if profile:
            prof = profile_step(lambda: model(x))
            prof["idle_share"] = max(0.0, 1 - prof["device_busy_ms_per_step"] / stages["forward"])
            out["forward_profile"] = prof
            print(json.dumps({"metric": "forward_profile", "variant": variant, "dtype": serving, "img": img,
                              "batch": b, **prof, "card": card}), flush=True)
        print(json.dumps({"metric": "forward_rate", "variant": variant, "dtype": serving, "img": img, "batch": b,
                          "conv_gflop_per_tile": flops / 1e9, "tflop_per_s": fwd_rate / 1e12,
                          "share_of_bf16_dense_peak": fwd_rate / BF16_FLOP_PER_S, "card": card}),
              flush=True)
    out["stages_ms"] = stages
    out["conv_flops_per_tile"] = flops
    out["kernel"] = kernel_rows[0]
    return out


# ---------------------------------------------------------------------------
# phase 6: training (aq-train)
# ---------------------------------------------------------------------------

# Limits of the f32 train steps card vs CPU (n at 160 px, batch 4, two
# steps, TF32 off), each about ten times this comparison's own readings on
# an H100 (PERF.md): per leaf of params, EMA and momentum, the largest
# difference as a share of the leaf's magnitude (read: 8.6e-5); per tree,
# the relative L2 difference (params and EMA 6.7e-8, momentum 4.3e-5); per
# parameter group, the relative L2 difference of the change the two steps
# made, params minus init (BN scales 3.4e-4, weights 2.7e-4, biases
# 4.6e-5, running statistics 2.2e-6). The first step runs at a warmup lr
# of 0 for weights and BN scales, so the params tree barely moves and only
# the change per group shows a skipped or wrong update (relative L2 1).
TRAIN_STEPS_EXACT = 2
TRAIN_LEAF_TOL = 1e-3
TRAIN_TREE_TOL = {"params": 1e-6, "ema": 1e-6, "opt_momentum": 5e-4}
TRAIN_DELTA_TOL = 3e-3
TRAIN_VARIANT, TRAIN_IMG, TRAIN_BATCH, TRAIN_TILES, TRAIN_EPOCHS = "m", 640, 16, 32, 2


# Limits of the int8 phases on an H100 (PERF.md). The int8 n forward card
# vs CPU read 0 of 1,478,400 codes differing and head maps within 5e-9 of
# their magnitude: at most one code in 10^4 may differ, by one, and the
# head maps by one bf16 spacing at their largest magnitude (the head
# convolves dequantized bf16 activations). The f32 rows of the accuracy
# table read equal card vs CPU (mAP): limit 1e-3.
INT8_FLIP_SHARE = 1e-4
INT8_WORST_CODE = 1
INT8_HEAD_TOL = 2.0 ** -8
ACC_F32_TOL = 1e-3

def _train_batch(rng, b: int, img: int, m: int = 8):
    """A fixed-shape batch: b images in [0, 1], up to m pixel boxes each."""
    labels = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        n = 2 + i % (m - 1)
        wh = rng.uniform(img / 40, img / 4, (n, 2))
        cxy = rng.uniform(wh / 2, img - wh / 2)
        labels[i, :n] = np.concatenate([rng.integers(0, 2, (n, 1)), cxy, wh], 1)
        mask[i, :n] = True
    return {"images": rng.random((b, img, img, 3), dtype=np.float32), "labels": labels, "label_mask": mask}


def _rel_l2(got: dict, want: dict, keys) -> float:
    err2 = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum()) for k in keys)
    norm2 = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in keys)
    return (err2 / norm2) ** 0.5 if norm2 else (0.0 if err2 == 0 else float("inf"))


def check_train_step_f32_vs_cpu(dev, variant: str = "n", img: int = 160, b: int = 4) -> dict:
    """TRAIN_STEPS_EXACT f32 train steps (forward, loss, backward, SGD, EMA)
    of ``variant`` at img px from one seeded init and batch, TF32 off, on the
    card and on the CPU: each step's loss and its components (rtol 1e-5),
    every leaf and tree of params, EMA and momentum, and the change of the
    params per optimizer group (TRAIN_LEAF_TOL, TRAIN_TREE_TOL,
    TRAIN_DELTA_TOL)."""
    import torch

    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.models.weights import flatten_tree, load_train_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
    from aquaculture_tpu_torch.train.optimizer import group_of
    from aquaculture_tpu_torch.train.trainer import init_train_state, make_train_step, state_tree

    _, params = yolov5_init(variant, 2, seed=11)
    init = flatten_tree(params)
    rng = np.random.default_rng(12)
    batches = [_train_batch(rng, b, img) for _ in range(TRAIN_STEPS_EXACT)]
    cfg = TrainConfig(img_size=img, batch_size=b, compute_dtype="float32")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for key, device in (("cpu", torch.device("cpu")), ("card", dev)):
            model = load_train_params(YoloV5(variant, 2, trainable=True), params)
            model.to(device=device, memory_format=torch.channels_last)
            state = init_train_state(model)
            step = make_train_step(model, cfg, 1)
            losses = [step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
                      for batch in batches]
            runs[key] = ([{k: float(v) for k, v in m.items()} for m in losses], state_tree(state))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (want_m, want), (got_m, got) = runs["cpu"], runs["card"]
    for i, (w_m, g_m) in enumerate(zip(want_m, got_m)):
        for k in w_m:
            if not abs(g_m[k] - w_m[k]) <= 1e-5 * abs(w_m[k]) + 1e-9:
                fail(f"f32 train step {i + 1} card vs CPU: loss {k} {g_m[k]} vs {w_m[k]}")
    report = {"loss_card": got_m[-1], "loss_cpu": want_m[-1]}
    for part in ("params", "ema", "opt_momentum"):
        w, g = flatten_tree(want[part]), flatten_tree(got[part])
        worst = max((float(np.abs(g[k].astype(np.float64) - w[k]).max()) / (float(np.abs(w[k]).max()) or 1.0), k)
                    for k in w)
        tree = _rel_l2(g, w, w)
        if worst[0] > TRAIN_LEAF_TOL or not tree <= TRAIN_TREE_TOL[part]:
            fail(f"f32 train step card vs CPU: {part} worst leaf {worst}, tree relative L2 {tree}")
        report[part] = {"worst_leaf_share": worst[0], "worst_leaf": worst[1], "tree_rel_l2": tree}
    # the change the steps made, per optimizer group and for the running
    # statistics, which the forward moves
    w, g = flatten_tree(want["params"]), flatten_tree(got["params"])
    w_delta = {k: w[k].astype(np.float64) - init[k] for k in w}
    g_delta = {k: g[k].astype(np.float64) - init[k] for k in w}
    groups = {"bn_scale": 0, "weight": 1, "bias": 2}
    delta = {}
    for name in (*groups, "running_stats"):
        keys = [k for k in w if (k.endswith(("/mean", "/var")) if name == "running_stats"
                                 else not k.endswith(("/mean", "/var")) and group_of(k) == groups[name])]
        err = _rel_l2(g_delta, w_delta, keys)
        norm = sum(float((w_delta[k] ** 2).sum()) for k in keys) ** 0.5
        if not (norm > 0 and err <= TRAIN_DELTA_TOL):
            fail(f"f32 train steps card vs CPU: the {name} change, relative L2 {err} (its norm on the CPU {norm})")
        delta[name] = {"rel_l2": err, "norm_cpu": norm}
    report["change"] = delta
    return {"variant": variant, "img": img, "batch": b, "steps": TRAIN_STEPS_EXACT, "leaf_tol": TRAIN_LEAF_TOL,
            "tree_tol": TRAIN_TREE_TOL, "change_tol": TRAIN_DELTA_TOL, **report}


def drive_train_full_width(d: str, tile_dir: str, n_tiles: int, variant: str = TRAIN_VARIANT,
                           img: int = TRAIN_IMG, batch: int = TRAIN_BATCH, epochs: int = TRAIN_EPOCHS,
                           detect_batch: int = 8) -> dict:
    """cli.train as the reference recipe runs it (augmentation on, bf16) on
    TRAIN_TILES rendered 1024 px JPEG tiles with YOLO labels, then the EMA
    checkpoint it saved served by cli.detect over the main path's tiles with
    the launch counter zeroed around it, and its mAP on its own world
    (bf16, conf 1e-3; reported, not gated)."""
    import torch

    from examples.end_to_end_demo import render_world

    from aquaculture_tpu_torch.cli import train as cli_train
    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.eval.accuracy import world_map
    from aquaculture_tpu_torch.utils.checkpoint import load_metadata, load_params

    img_dir, lab_dir = render_world(os.path.join(d, "world"), n_images=TRAIN_TILES, seed=5)
    out = os.path.join(d, "ckpt")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = cli_train.main(["--images", img_dir, "--out", out, "--variant", variant, "--img", str(img),
                            "--batch", str(batch), "--epochs", str(epochs)])
    seconds = time.perf_counter() - t0
    steps = epochs * (TRAIN_TILES // batch)
    losses = [[e[k] for k in ("total", "box", "obj", "cls")] for e in stats["epochs"]]
    if not np.isfinite(losses).all():
        fail(f"cli.train {variant}: non-finite losses {losses}")
    state = load_params(os.path.join(out, "state"))
    if not int(state["step"]) == int(state["opt_step"]) == stats["step"] == steps:
        fail(f"cli.train {variant}: state/step {int(state['step'])}, expected {steps}")
    meta = load_metadata(os.path.join(out, "last"))
    if meta != {"epoch": epochs, "variant": variant, "num_classes": 5, "img_size": img}:
        fail(f"cli.train {variant}: last/ metadata {meta}")
    load_model(os.path.join(out, "last"), variant, 5)  # the port loads what it saved
    served = run_main_path(tile_dir, os.path.join(d, "labels_trained"), n_tiles, detect_batch,
                           options=("--weights", os.path.join(out, "last")), variant=variant)
    world = world_map(sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)), lab_dir,
                      load_model(os.path.join(out, "last"), variant, 5),
                      DetectConfig(img_size=img, conf_threshold=1e-3), num_classes=5, device="cuda")
    return {"variant": variant, "img": img, "batch": batch, "tiles": TRAIN_TILES, "epochs": stats["epochs"],
            "steps": steps, "seconds": seconds, "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "served": served, "own_world_map": {"map50": world["map50"], "map": world["map"]}}


# kernel kinds of a train step's profile, matched on the kernel's name in
# this order
KERNEL_KINDS = (
    ("int8_gemm", ("i8i8", "s8s8", "imma", "_s8_", "i16832", "int8")),
    ("convolution", ("conv", "cudnn", "sm90_xmma", "implicit_gemm", "dgrad", "wgrad", "fprop", "cutlass", "gemm")),
    ("multi_tensor", ("multi_tensor", "foreach")),
    ("reduction", ("reduce", "welford", "var_mean", "norm")),
    ("copy", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "silu", "sigmoid", "pointwise")),
)


def profile_step(step, n: int = 3) -> dict:
    """Where a step's time goes (a train step, or a serving forward): the
    host's enqueue ms per step (the wall clock of the Python call, no
    profiler attached, median of n), then n steps under torch.profiler:
    device busy ms per step (the sum of kernel times), kernels per step,
    kernel ms by kind and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = getattr(ev, "self_cuda_time_total", 0) if t is None else t
        kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3 / n
        launches += ev.count
    by_kind = {}
    for name, t in kernels.items():
        kind = next((k for k, keys in KERNEL_KINDS if any(x in name.lower() for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"host_enqueue_ms_per_step": statistics.median(host), "device_busy_ms_per_step": sum(kernels.values()),
            "kernels_per_step": launches / n, "by_kind_ms": by_kind,
            "top_kernels_ms": [[name[:80], t] for name, t in top]}


def time_train_step(dev, card: str, batch: dict, variant: str = TRAIN_VARIANT, iters: int = 5,
                    windows: int = 3) -> dict:
    """Device time of one bf16 train step (forward, loss, backward, SGD,
    EMA) of ``variant`` on a batch already on the card, plain and with
    --remat; img/s, training TFLOP/s (3x the forward's conv FLOPs), its
    share of the bf16 dense peak, and peak memory of each; the plain step's
    profile (profile_step) and the card's idle share of it."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.models.weights import load_train_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
    from aquaculture_tpu_torch.train.trainer import init_train_state, make_train_step

    b, img = batch["images"].shape[:2]
    flops_fwd = conv_flops_per_image(load_model(None, variant, 5).to(dev).eval(), img, dev)
    model = load_train_params(YoloV5(variant, 5, trainable=True), yolov5_init(variant, 5)[1])
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    rows = {}
    for name, kw in (("plain", {}), ("remat", {"remat": True})):
        step = make_train_step(model, TrainConfig(img_size=img, batch_size=b, **kw), 100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_cuda(lambda: step(state, on_card), iters=iters, windows=windows)
        rate = 3 * flops_fwd * b / (ms / 1e3)
        rows[name] = {"ms_per_step": ms, "img_per_s": b / ms * 1e3, "train_tflop_per_s": rate / 1e12,
                      "share_of_bf16_dense_peak": rate / BF16_FLOP_PER_S,
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name == "plain":
            prof = profile_step(lambda: step(state, on_card))
            rows[name]["profile"] = {**prof, "idle_share": max(0.0, 1 - prof["device_busy_ms_per_step"] / ms)}
        print(json.dumps({"metric": "train_step", "variant": variant, "img": img, "batch": b,
                          "dtype": "bfloat16", "option": name, **rows[name], "card": card}), flush=True)
    if not np.isfinite([state.ema[n].float().sum().item() for n in list(state.ema)[:8]]).all():
        fail("timed train steps left non-finite EMA weights")
    return {"conv_gflop_per_image_fwd": flops_fwd / 1e9, **rows}


def time_feed(img_dir: str, variant: str = TRAIN_VARIANT, img: int = TRAIN_IMG, batch: int = TRAIN_BATCH) -> dict:
    """The augmented feed alone (DetectionDataset.epoch, the default feed
    threads): img/s of a cold epoch (decode and resize caches empty) and a
    warm one."""
    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.train.dataset import DetectionDataset

    ds = DetectionDataset(img_dir, None, TrainConfig(img_size=img, batch_size=batch), augment=True)
    out = {"threads": min(os.cpu_count() or 1, 8), "images": len(ds)}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        n = sum(len(bt["images"]) for bt in ds.epoch(0))
        out[f"{name}_img_per_s"] = n / (time.perf_counter() - t0)
    return out


def run_train_phase(dev, card: str, tile_dir: str, n_tiles: int) -> dict:
    """The train phase: f32 card vs CPU, the full-width cli.train drive and
    its checkpoint served, then times (step, feed)."""
    import torch

    exact = check_train_step_f32_vs_cpu(dev)
    print(json.dumps({"phase": "train_f32_card_vs_cpu", "tf32": False, **exact}), flush=True)
    with tempfile.TemporaryDirectory() as d:
        drive = drive_train_full_width(d, tile_dir, n_tiles)
        print(json.dumps({"phase": "train", **drive, "card": card}), flush=True)
        feed = time_feed(os.path.join(d, "world", "images"))
        from aquaculture_tpu_torch.config import TrainConfig
        from aquaculture_tpu_torch.train.dataset import DetectionDataset

        cfg = TrainConfig(img_size=TRAIN_IMG, batch_size=TRAIN_BATCH)
        batch = next(iter(DetectionDataset(os.path.join(d, "world", "images"), None, cfg, seed=1).epoch(0)))
    steps = time_train_step(dev, card, batch, iters=3, windows=2)
    # the host sets the pace when cli.train's last epoch runs below 90% of
    # the step alone on a batch already on the card
    e2e = drive["epochs"][-1]["img_per_s"]
    device_img_s = steps["plain"]["img_per_s"]
    pace = "host" if e2e < 0.9 * device_img_s else "device"
    times = {"cli_train_img_per_s_last_epoch": e2e, "device_step_img_per_s": device_img_s,
             "e2e_over_step": e2e / device_img_s, "feed": feed, "paced_by": pace, "steps": steps}
    print(json.dumps({"phase": "train_times", **times, "card": card}), flush=True)
    torch.cuda.empty_cache()
    return {"exact": exact, "drive": drive, "times": times}


# ---------------------------------------------------------------------------
# phase 7: int8 serving and the serving-accuracy harness
# ---------------------------------------------------------------------------

def probe() -> dict:
    """What the card's machine offers later perf work: triton, CUTLASS's
    headers (a fused int8 conv), matplotlib (figures). Gates nothing."""
    out = {}
    try:
        import triton

        out["triton"] = triton.__version__
    except ImportError as e:
        out["triton"] = f"absent: {e}"
    roots = [os.environ.get("CUTLASS_PATH", ""), "/usr/local/cutlass", "/usr/local"]
    heads = [os.path.join(r, "include") for r in roots if r]
    out["cutlass_include"] = next((h for h in heads if os.path.exists(os.path.join(h, "cutlass", "cutlass.h"))), None)
    try:
        import matplotlib

        out["matplotlib"] = matplotlib.__version__
    except ImportError as e:
        out["matplotlib"] = f"absent: {e}"
    return out


def check_int8_conv(dev) -> dict:
    """The int8 convolution's card route (torch._int_mm) against its plain
    route (float64 convolution of the integer values) on the card, exact
    int32, on every conv call of mt's int8_full model at 640 px (batch 2,
    random weights from seed 0, calibrated on random images) and on two
    small products: M = 9 rows (padded to ROW_MULTIPLE) at the stem's K = 108,
    a 1x1 of M = 16, and a 1x1 of M = 200 at K = N = 64 (n's at 160 px,
    which cuBLASLt refused unpadded)."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.models import layers as L
    from aquaculture_tpu_torch.models.quantize import quantize_model
    from aquaculture_tpu_torch.ops import int8_conv

    gen = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.rand((2, 640, 640, 3), generator=gen, device=dev)
    qmodel = quantize_model(load_model(None, "mt", 5).to(dev), imgs.to(torch.bfloat16))
    seen = {}

    def compare(xq, wq, stride=1, padding=None):
        got = int8_conv.int8_conv2d_mm(xq, wq, stride, padding)
        want = int8_conv.int8_conv2d_plain(xq, wq, stride, padding)
        key = (tuple(xq.shape), tuple(wq.shape), stride, padding)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            fail(f"int8 conv _int_mm != plain at input {key[0]}, weight {key[1]}, stride {stride}, "
                 f"padding {padding}: max |diff| {int((got.double() - want.double()).abs().max())}")
        seen[key] = seen.get(key, 0) + 1
        return got

    prev, L.int8_conv2d = L.int8_conv2d, compare
    try:
        with torch.inference_mode():
            qmodel.to(dev, memory_format=torch.channels_last)(imgs)
            small = torch.randint(-127, 128, (1, 12, 3, 3), generator=gen, device=dev, dtype=torch.int8)
            compare(small, torch.randint(-127, 128, (24, 12, 3, 3), generator=gen, device=dev, dtype=torch.int8))
            for shape in ((1, 64, 4, 4), (2, 64, 10, 10)):
                one = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                compare(one.contiguous(memory_format=torch.channels_last),
                        torch.randint(-127, 128, (64, 64, 1, 1), generator=gen, device=dev, dtype=torch.int8))
    finally:
        L.int8_conv2d = prev
    torch.cuda.synchronize()
    kinds = sorted({f"k{w[-1]}/s{st}" + ("/stem" if w[1] == 12 else "") for _, w, st, _ in seen})
    return {"calls": sum(seen.values()), "shapes": len(seen), "kinds": kinds, "max_abs_err": 0}


def check_int8_forward_card_vs_cpu(dev, img: int = 160) -> dict:
    """One int8_full n tree (random weights from seed 7, calibrated on the
    CPU on random images) served in f32 on the CPU and on the card (TF32
    off): the int8 codes at each requant, and the head maps (bf16: the head
    takes the dequantized activations)."""
    import torch

    from aquaculture_tpu_torch.models import layers as L
    from aquaculture_tpu_torch.models.quantize import quantize_model
    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    rng = np.random.default_rng(4)
    qmodel = quantize_model(load_jax_params(*yolov5_init("n", 5, seed=7)).eval(),
                            torch.from_numpy(rng.random((2, img, img, 3), dtype=np.float32)))
    x = torch.from_numpy(rng.random((2, img, img, 3), dtype=np.float32))
    runs = {}
    prev_requant = L.requant
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", dev):
            codes = []

            def record(act, yscale):
                q = prev_requant(act, yscale)
                codes.append(q.q)
                return q

            L.requant = record
            qmodel.to(device, memory_format=torch.channels_last)
            with torch.inference_mode():
                feats = qmodel.features(x.to(device))
            runs[str(device)] = ([c.cpu().int() for c in codes], [f.cpu().float() for f in feats])
    finally:
        L.requant = prev_requant
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (want_c, want_f), (got_c, got_f) = runs["cpu"], runs[str(dev)]
    if len(got_c) != len(want_c) or len(want_c) < 50:
        fail(f"int8 n forward: {len(got_c)} requants on the card, {len(want_c)} on the CPU")
    flips = sum(int((g != w).sum()) for g, w in zip(got_c, want_c))
    codes = sum(w.numel() for w in want_c)
    worst = max(int((g - w).abs().max()) for g, w in zip(got_c, want_c))
    head = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got_f, want_f))
    if flips > INT8_FLIP_SHARE * codes or worst > INT8_WORST_CODE or head > INT8_HEAD_TOL:
        fail(f"int8 n forward card vs CPU: {flips} of {codes} codes differ (worst by {worst}), "
             f"head maps {head} of their magnitude")
    return {"variant": "n", "img": img, "split": "int8_full", "requants": len(want_c), "codes": codes,
            "codes_differing": flips, "worst_code_diff": worst, "head_max_rel_err": head}


def run_accuracy_phase(dev, card: str, img_dir: str, lab_dir: str) -> dict:
    """serving_accuracy_table for the trained fixture on its rendered
    12-image world (seed 0; tests/test_accuracy.py's) at 160 px, every row,
    on the card (TF32 off, so that the f32 row is f32) and on the CPU: the
    f32 rows agree, and every card row holds tests/test_accuracy.py's
    bounds against the card's bf16 row."""
    import torch

    from aquaculture_tpu_torch.eval.accuracy import SERVING_CONFIGS, serving_accuracy_table
    from aquaculture_tpu_torch.ops import int8_conv, nms_cuda

    configs = SERVING_CONFIGS + ("topk512",)
    tables = {}
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for device in ("cpu", "cuda"):
        nms_cuda.launches = int8_conv.mm_calls = int8_conv.plain_calls = 0
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        try:
            rows = serving_accuracy_table(img_dir, lab_dir, FIXTURE, img_size=160, configs=configs,
                                          device=device)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        tables[device] = {"rows": {r.name: {"map50": r.map50, "map": r.map} for r in rows},
                          "seconds": time.perf_counter() - t0, "launches": nms_cuda.launches}
        if device == "cuda":
            tables[device]["int8_conv_calls"] = check_int8_routes("accuracy table", True)
    card, cpu = tables["cuda"]["rows"], tables["cpu"]["rows"]
    # two batches of 8 tiles per row, one launch each, on the card only
    if tables["cuda"]["launches"] != 2 * len(configs) or tables["cpu"]["launches"]:
        fail(f"accuracy table: {tables['cuda']['launches']} launches on the card, "
             f"{tables['cpu']['launches']} on the CPU")
    f32_diff = max(abs(card["f32"][k] - cpu["f32"][k]) for k in ("map50", "map"))
    if f32_diff > ACC_F32_TOL:
        fail(f"accuracy table: f32 card {card['f32']} vs CPU {cpu['f32']}")
    bf16 = card["bf16"]
    d = {name: (r["map50"] - bf16["map50"], r["map"] - bf16["map"]) for name, r in card.items()}
    bounds = {
        "bf16_map50_at_least_0.5": bf16["map50"] >= 0.5,
        "int8_mixed_map50_within_0.05": abs(d["int8_mixed"][0]) <= 0.05,
        "int8_safe_map50_within_0.05": abs(d["int8_safe"][0]) <= 0.05,
        "int8_safe_map_within_0.03": abs(d["int8_safe"][1]) <= 0.03,
        "topk512_within_0.02": max(abs(v) for v in d["topk512"]) <= 0.02,
        "multi_label_map50_above_minus_0.05": d["multi_label"][0] >= -0.05,
    }
    if not all(bounds.values()):
        fail(f"accuracy table on the card misses tests/test_accuracy.py's bounds: "
             f"{[k for k, ok in bounds.items() if not ok]}; rows {card}")
    return {"weights": "tests/data/demo_ckpt_n160", "img": 160, "world_images": 12, "configs": list(configs),
            "on_card": tables["cuda"], "on_cpu": tables["cpu"], "f32_card_vs_cpu_max_diff": f32_diff,
            "f32_tol": ACC_F32_TOL, "bounds": bounds}


# ---------------------------------------------------------------------------
# phase 8: facility clustering (aq-cluster) and k-fold evaluation (aq-evaluate)
# ---------------------------------------------------------------------------

# The evaluation world at the reference's scale: 8 survey years across the
# archive's 2000-2021 span, 2,000 cage detections each on the French
# Mediterranean coast (lon 3.0-7.5 E, lat 42.3-43.6 N), 4,142 labels (the
# size of humanlabels.geojson) and 35,199 images (the size of cf_images.csv)
# in 5 strata.
EVAL_YEARS = (2000, 2003, 2006, 2009, 2012, 2015, 2018, 2021)
EVAL_PER_YEAR, EVAL_SITES, EVAL_LABELS, EVAL_IMAGES = 2000, 300, 4142, 35_199
EVAL_TILE_M = 200.0  # EPSG:3857 meters of one 1024 px tile (6 per 1200 m download box)
# (eps, min size) of the DBSCAN checks: the study's operating point, the
# grid's smallest eps with every kept point a core, its largest eps
DBSCAN_CHECKS = ((50.0, 5), (10.0, 1), (150.0, 10))
# the sub-grid on which the card's sweep is held against the plain loop
EVAL_SUB_GRID = dict(confidence_thresholds=(0.6, 0.785, 1.005), distance_thresholds=(10.0, 50.0),
                     minimum_cluster_sizes=(1, 5))


def write_evaluation_world(d: str, seed: int = 0) -> tuple:
    """(detections.geojson, labels.geojson, images.csv) of the evaluation
    world, from a numpy seed. Per year, ~80% of EVAL_SITES facility sites
    hold 3-12 cages at 8-20 m spacing, and scattered noise fills the year to
    EVAL_PER_YEAR detections; boxes in EPSG:3857 with det_conf from a beta,
    circle/square/rectangle types and the area columns cli.areas writes.
    Labels are jittered copies of facility cages plus unmatched boxes; the
    images are the tiles that hold a detection or a label plus empty tiles,
    bucketed by their largest det_conf (4 bins and "No detection")."""
    import pandas as pd

    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name
    from aquaculture_tpu_torch.eval.buckets import CONF_BINS
    from aquaculture_tpu_torch.geo import crs as C
    from aquaculture_tpu_torch.geo import polygon as P
    from aquaculture_tpu_torch.post.areas import circle_areas, square_areas

    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1) = C.transform(4326, 3857, np.array([3.0, 7.5]), np.array([42.3, 43.6]))
    sites = np.stack([rng.uniform(x0, x1, EVAL_SITES), rng.uniform(y0, y1, EVAL_SITES)], 1)
    n_cages = rng.integers(3, 13, EVAL_SITES)
    xs, ys, years, facility = [], [], [], []
    for year in EVAL_YEARS:
        cx, cy = [], []
        for (sx, sy), n in zip(sites[rng.random(EVAL_SITES) < 0.8], n_cages):
            step, cols = rng.uniform(8, 20), int(rng.integers(2, 5))
            k = np.arange(n)
            cx.append(sx + step * (k % cols) + rng.normal(0, 1, n))
            cy.append(sy + step * (k // cols) + rng.normal(0, 1, n))
        cx, cy = np.concatenate(cx)[:EVAL_PER_YEAR], np.concatenate(cy)[:EVAL_PER_YEAR]
        n_noise = EVAL_PER_YEAR - len(cx)
        xs += [cx, rng.uniform(x0, x1, n_noise)]
        ys += [cy, rng.uniform(y0, y1, n_noise)]
        years.append(np.full(EVAL_PER_YEAR, year))
        facility += [np.ones(len(cx), bool), np.zeros(n_noise, bool)]
    x, y, year, facility = (np.concatenate(a) for a in (xs, ys, years, facility))
    n = len(x)
    size = rng.uniform(8, 25, n)
    types = rng.choice(np.array(["circle_farm", "square_farm", "rectangle_farm"]), n, p=[0.55, 0.4, 0.05])
    conf = np.where(facility, rng.beta(6.0, 1.5, n), rng.beta(2.0, 3.0, n))
    is_circle = types == "circle_farm"
    c_areas, s_areas = circle_areas(size, size, np.zeros(n, bool), np.zeros(n, bool)), square_areas(size, size)
    ix, iy = np.floor((x - x0) / EVAL_TILE_M).astype(np.int64), np.floor((y - y0) / EVAL_TILE_M).astype(np.int64)

    def tile_names(yr, tx, ty):
        width = int((x1 - x0) // (6 * EVAL_TILE_M)) + 1
        return [encode_tile_name(TileSpec(year=int(a), bbox_ind=int(b // 6 + (c // 6) * width),
                                          x_offset=int(b % 6) * 1024, y_offset=int(c % 6) * 1024))
                for a, b, c in zip(yr, tx, ty)]

    image = tile_names(year, ix, iy)
    det = gf.GeoFrame({"image": image, "year": year, "type": types, "det_conf": conf,
                       **{k: np.where(is_circle, a, b) for k, a, b in
                          zip(("area", "area_var", "min_area", "max_area"), c_areas, s_areas)}},
                      geometry=[P.box(a - s / 2, b - s / 2, a + s / 2, b + s / 2) for a, b, s in zip(x, y, size)],
                      crs=3857)

    n_unmatched = EVAL_LABELS // 10
    pick = np.sort(rng.choice(np.nonzero(facility)[0], EVAL_LABELS - n_unmatched, replace=False))
    far = rng.choice(n, n_unmatched)
    jitter = rng.normal(0, 1.5, (len(pick), 4))
    lx, ly = x[far] + rng.uniform(60, 120, n_unmatched), y[far] + rng.uniform(60, 120, n_unmatched)
    lab = gf.GeoFrame(
        {"image": [image[i] for i in pick] + [image[i] for i in far],
         "year": np.concatenate([year[pick], year[far]]),
         "type": np.concatenate([types[pick], np.full(n_unmatched, "circle_farm")])},
        geometry=[P.box(*(np.asarray(det["geometry"].iloc[i].bounds) + j)) for i, j in zip(pick, jitter)]
        + [P.box(a, b, a + 12, b + 12) for a, b in zip(lx, ly)],
        crs=3857)

    held = pd.Series(conf).groupby(np.asarray(image)).max()
    names = list(held.index) + sorted(set(lab["image"]) - set(held.index))
    n_empty = EVAL_IMAGES - len(names)
    empty = tile_names(rng.choice(EVAL_YEARS, n_empty), np.arange(n_empty) % 600, 10_000 + np.arange(n_empty) // 600)
    images = pd.DataFrame({"image": names + empty})
    best = held.reindex(images["image"]).to_numpy()
    images["bucket"] = pd.cut(best, bins=list(CONF_BINS)).astype(str)
    images.loc[np.isnan(best), "bucket"] = "No detection"

    paths = (os.path.join(d, "detections.geojson"), os.path.join(d, "labels.geojson"), os.path.join(d, "images.csv"))
    det.to_file(paths[0])
    lab.to_file(paths[1])
    images.to_csv(paths[2], index=False)
    return paths


def _read_world(paths: tuple) -> tuple:
    import pandas as pd

    from aquaculture_tpu_torch import frame as gf

    return gf.read_file(paths[0]), gf.read_file(paths[1]), pd.read_csv(paths[2])


def _year_centers(det) -> dict:
    """The cages' EPSG:3035 centroids per year, as cluster_facilities
    takes them."""
    from aquaculture_tpu_torch.geo.polygon import centroid_array

    centers = centroid_array(list(det.to_crs(3035)["geometry"]))
    years = det["year"].to_numpy()
    return {int(y): centers[years == y] for y in sorted(set(years))}


def _fold0_train(world: tuple) -> tuple:
    """Detections and labels of fold 0's train split (GridConfig()'s 5
    folds, seed 1, stratified by bucket)."""
    from aquaculture_tpu_torch.eval import kfold

    det, lab, images = world
    train = images.iloc[kfold.stratified_kfold_indices(images["bucket"], 5, 1)[0][0]]
    return kfold._subset(det, train), kfold._subset(lab, train)


# The CPU references of phase 8, each run in a worker process (CPU only)
# while the main process drives the card: host time, not card time, bounds
# the phase. Each returns its result and its seconds.

def _ref_init() -> None:
    import torch

    torch.set_num_threads(2)


def _ref_dbscan_plain(paths: tuple) -> tuple:
    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.post.cluster import dbscan_plain

    centers = _year_centers(gf.read_file(paths[0]))
    t0 = time.perf_counter()
    labels = {(eps, ms, y): dbscan_plain(pts, eps, ms) for eps, ms in DBSCAN_CHECKS for y, pts in centers.items()}
    return labels, time.perf_counter() - t0


def _ref_cli_cluster_cpu(det_path: str, out_path: str) -> tuple:
    from aquaculture_tpu_torch.cli import cluster as cli_cluster

    t0 = time.perf_counter()
    fac = cli_cluster.main(["--detections", det_path, "--out", out_path, "--device", "cpu"])
    return len(fac), time.perf_counter() - t0


def _ref_sub_grid_plain(paths: tuple) -> tuple:
    from aquaculture_tpu_torch.eval import kfold

    det, lab = _fold0_train(_read_world(paths))
    t0 = time.perf_counter()
    return kfold.grid_search_plain(det, lab, kfold.GridConfig(**EVAL_SUB_GRID)), time.perf_counter() - t0


def _ref_held_out_cpu(paths: tuple) -> tuple:
    from aquaculture_tpu_torch.config import (OPTIMAL_CONF_THRESHOLD, OPTIMAL_DISTANCE_THRESHOLD,
                                              OPTIMAL_MIN_CLUSTER_SIZE)
    from aquaculture_tpu_torch.eval import kfold

    det, lab, images = _read_world(paths)
    t0 = time.perf_counter()
    table = kfold.test_set_performance(images, det, lab, OPTIMAL_CONF_THRESHOLD, OPTIMAL_DISTANCE_THRESHOLD,
                                       OPTIMAL_MIN_CLUSTER_SIZE, "cpu")
    return table, time.perf_counter() - t0


def dbscan_card_labels(det, dev) -> tuple:
    """The card's DBSCAN labels per (eps, min size, year) of DBSCAN_CHECKS,
    and their seconds."""
    import torch

    from aquaculture_tpu_torch.post.cluster import dbscan

    labels, seconds = {}, 0.0
    for y, pts in _year_centers(det).items():
        for eps, ms in DBSCAN_CHECKS:
            t0 = time.perf_counter()
            labels[eps, ms, y] = dbscan(pts, eps, ms, dev)
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
    return labels, seconds


def check_dbscan(card: dict, card_s: float, plain) -> dict:
    """Per year, the card's DBSCAN labels equal the plain BFS's (``plain``,
    from _ref_dbscan_plain) elementwise at each DBSCAN_CHECKS (eps, min
    size)."""
    want, plain_s = plain.result()
    for (eps, ms, y), got in card.items():
        if not np.array_equal(got, want[eps, ms, y]):
            fail(f"dbscan on the card != dbscan_plain in year {y} at eps {eps}, min size {ms}: "
                 f"{int((got != want[eps, ms, y]).sum())} of {len(got)} labels differ")
    clusters = {f"{eps:g}_{ms}": sum(int(w.max()) + 1 for (e, m, _), w in want.items() if (e, m) == (eps, ms))
                for eps, ms in DBSCAN_CHECKS}
    return {"checks": [list(c) for c in DBSCAN_CHECKS], "years": len(EVAL_YEARS), "label_arrays": len(card),
            "card_s": card_s, "plain_s": plain_s, "clusters": clusters}


def check_cli_cluster(fac_paths: list, n_card: int, card_s: float, cpu) -> dict:
    """cli.cluster's facility files on the card and with --device cpu
    (``cpu``, from _ref_cli_cluster_cpu) are equal, and not empty."""
    n_cpu, cpu_s = cpu.result()
    files = []
    for p in fac_paths:
        with open(p) as f:
            files.append(json.load(f))
    if files[0] != files[1] or not n_card:
        fail(f"cli.cluster on the card ({n_card} facilities) and with --device cpu ({n_cpu}) wrote "
             f"different facility files, or none")
    return {"cuda_facilities": n_card, "cuda_s": card_s, "cpu_facilities": n_cpu, "cpu_s": cpu_s}


def check_sub_grid(got, card_s: float, train: tuple, plain) -> dict:
    """On fold 0's train split, grid_search on the card (``got``) equals
    grid_search_plain (``plain``, from _ref_sub_grid_plain: every row, NaN
    in the same places) on EVAL_SUB_GRID; the plain loop's seconds per
    combination and their extrapolation to the full grid's 5 folds."""
    want, plain_s = plain.result()
    if not got.equals(want):
        fail(f"grid_search on the card != grid_search_plain on the sub-grid:\n{got}\n{want}")
    combos = len(want)
    return {"train_detections": len(train[0]), "train_labels": len(train[1]), "combinations": combos,
            "nan_precision_rows": int(want["precision"].isna().sum()), "card_s": card_s, "plain_s": plain_s,
            "plain_s_per_combination": plain_s / combos,
            "plain_s_extrapolated_6560x5": plain_s / combos * 6560 * 5}


def drive_evaluate(d: str, paths: tuple) -> tuple:
    """cli.evaluate on the card with the full GridConfig() (6,560
    combinations, 5 folds, seed 1): the fold rows, the held-out table, and
    per fold the sweep's seconds (CUDA-synchronized) and the match matrix's
    host seconds."""
    import torch

    from aquaculture_tpu_torch.cli import evaluate as cli_evaluate
    from aquaculture_tpu_torch.eval import kfold

    sweep_s, match_s = [], []
    real_sweep, real_match = kfold._sweep, kfold._match_matrix

    def timed(fn, into, sync):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return r
        return run

    kfold._sweep, kfold._match_matrix = timed(real_sweep, sweep_s, True), timed(real_match, match_s, False)
    try:
        res, test, seconds = cli_evaluate.main(["--detections", paths[0], "--labels", paths[1], "--images", paths[2],
                                                "--out", os.path.join(d, "folds.csv")])
    finally:
        kfold._sweep, kfold._match_matrix = real_sweep, real_match
    if len(res) != 10 or len(sweep_s) != 5 or len(match_s) != 5:
        fail(f"cli.evaluate: {len(res)} fold rows and {len(sweep_s)} sweeps for 5 folds")
    num = res[[c for c in res.columns if c != "metric"]].to_numpy(np.float64)
    if not np.isfinite(num).all() or test.shape != (2, 2) or not np.isfinite(test.to_numpy()).all():
        fail(f"cli.evaluate: non-finite fold rows or held-out table:\n{res}\n{test}")
    return test, {"grid": "GridConfig() 82 x 8 x 10 = 6,560, 5 folds, seed 1", "sweep_s_per_fold": sweep_s,
                  "match_matrix_host_s_per_fold": match_s, "cli_host_s": seconds,
                  "fold_rows": res.to_dict("records"), "held_out": test.to_dict("index")}


def run_cluster_evaluate_phase(dev, d: str) -> dict:
    """Phase 8 on the evaluation world: the card's side in this process,
    the CPU references in worker processes beside it, compared at the end.
    ``at_s`` gives the script seconds since the phase began at which each
    stage ended."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from aquaculture_tpu_torch.cli import cluster as cli_cluster
    from aquaculture_tpu_torch.eval import kfold

    t_phase, at = time.perf_counter(), {}

    def stamp(name):
        at[name] = time.perf_counter() - t_phase

    paths = write_evaluation_world(d)
    stamp("world")
    fac_paths = [os.path.join(d, f"facilities_{x}.geojson") for x in ("cuda", "cpu")]
    out = {"world": {"years": len(EVAL_YEARS), "detections": EVAL_PER_YEAR * len(EVAL_YEARS),
                     "labels": EVAL_LABELS, "images": EVAL_IMAGES}}
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"), initializer=_ref_init) as pool:
        refs = {"held_out": pool.submit(_ref_held_out_cpu, paths),
                "cluster": pool.submit(_ref_cli_cluster_cpu, paths[0], fac_paths[1]),
                "sub_grid": pool.submit(_ref_sub_grid_plain, paths),
                "dbscan": pool.submit(_ref_dbscan_plain, paths)}
        world = _read_world(paths)
        stamp("read")
        card_labels, dbscan_s = dbscan_card_labels(world[0], dev)
        stamp("dbscan_card")
        t0 = time.perf_counter()
        n_fac = len(cli_cluster.main(["--detections", paths[0], "--out", fac_paths[0]]))
        cluster_s = time.perf_counter() - t0
        stamp("cli_cluster_card")
        train = _fold0_train(world)
        t0 = time.perf_counter()
        sub_grid = kfold.grid_search(*train, kfold.GridConfig(**EVAL_SUB_GRID), dev)
        torch.cuda.synchronize()
        sub_grid_s = time.perf_counter() - t0
        stamp("sub_grid_card")
        test, out["cli_evaluate"] = drive_evaluate(d, paths)
        stamp("cli_evaluate_card")
        out["dbscan_card_vs_plain"] = check_dbscan(card_labels, dbscan_s, refs["dbscan"])
        out["cli_cluster"] = check_cli_cluster(fac_paths, n_fac, cluster_s, refs["cluster"])
        out["sub_grid_card_vs_plain"] = check_sub_grid(sub_grid, sub_grid_s, train, refs["sub_grid"])
        cpu, out["cli_evaluate"]["held_out_cpu_s"] = refs["held_out"].result()
        if not test.equals(cpu):
            fail(f"test_set_performance on the card != --device cpu:\n{test}\n{cpu}")
        stamp("references")
    stamp("workers_joined")
    out["at_s"] = at
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    from aquaculture_tpu_torch.ops import nms_cuda

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # script seconds per group of phases, printed before the summary
    phase_seconds, t_mark = {}, [t_start]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_seconds[name] = round(now - t_mark[0], 2)
        t_mark[0] = now

    # 1. card, torch, nvcc
    card = card_line()
    nvcc_release = next(
        (ln.strip() for ln in subprocess.run([nms_cuda.find_nvcc(), "--version"], capture_output=True,
                                             text=True, check=True).stdout.splitlines()
         if "release" in ln), "unknown")
    print(f"card: {card} | torch {torch.__version__} (CUDA {torch.version.cuda}) | nvcc: {nvcc_release}",
          flush=True)
    print(json.dumps({"probe": probe()}), flush=True)

    # 2. build
    t0 = time.perf_counter()
    nms_cuda.build()
    print(f"build: nms_suppress {time.perf_counter() - t0:.2f} s ({nms_cuda.library_path()})", flush=True)

    # 3. kernels vs plain
    t0 = time.perf_counter()
    shapes = check_shapes()
    suites = check_kernels(dev, shapes)
    print(f"kernels: nms_suppress == plain (exact) on suites {','.join(suites)} x shapes "
          f"{list(shapes)} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"phase": "int8_conv", **check_int8_conv(dev)}), flush=True)

    # 4. the main path; the tiles serve every later phase that needs files
    root = tempfile.TemporaryDirectory()
    d = root.name
    tile_dir, label_dir = os.path.join(d, "tiles"), os.path.join(d, "labels")
    os.makedirs(tile_dir)
    paths = write_tiles(tile_dir, 16)
    mark("kernels_and_tiles")
    main_path = run_main_path(tile_dir, label_dir, n_tiles=16, batch=8)
    print(json.dumps({"phase": "main_path", **main_path}), flush=True)
    # 4c. cli.detect's serving options on the same tiles
    options = {}
    for name, opts in (("tta_multi_label", ("--augment", "--multi-label")),
                       ("decode_scale", ("--decode-scale",))):
        options[name] = run_main_path(tile_dir, os.path.join(d, name), n_tiles=16, batch=8, options=opts)
        print(json.dumps({"phase": f"detect_{name}", **options[name]}), flush=True)
    # 7. int8_serving: cli.detect --int8 on the same tiles
    int8_detect = run_main_path(tile_dir, os.path.join(d, "int8"), n_tiles=16, batch=8, options=("--int8",))
    print(json.dumps({"phase": "int8_detect", **int8_detect}), flush=True)
    print(json.dumps({"phase": "nms_kernel_vs_plain_batch", **check_nms_paths(paths, dev)}), flush=True)
    mark("detect")
    # 4b/4c. aq-pipeline at full width, the trained fixture on its world (the
    # accuracy phase's), P6, overlap, --int8
    from examples.end_to_end_demo import render_world

    d1, dw = os.path.join(d, "pipeline"), os.path.join(d, "world")
    os.makedirs(d1)
    inputs = write_pipeline_inputs(d1)
    world = render_world(dw, n_images=12, seed=0)
    pipeline = {"full_width": drive_pipeline_full_width(d1, inputs),
                "trained_fixture": drive_pipeline_trained_card_vs_cpu(dw, world[0]), "card": card}
    print(json.dumps({"phase": "pipeline", **pipeline}), flush=True)
    p6 = drive_pipeline_full_width(d1, inputs, variant="m6")
    print(json.dumps({"phase": "p6", **p6, "card": card}), flush=True)
    overlap = drive_pipeline_overlap(d1, inputs[1])
    print(json.dumps({"phase": "overlap", **overlap, "card": card}), flush=True)
    int8_pipeline = drive_pipeline_full_width(d1, inputs, options=("--int8",))
    print(json.dumps({"phase": "int8_pipeline", **int8_pipeline, "card": card}), flush=True)
    mark("pipeline")
    # 8. aq-cluster and aq-evaluate on the evaluation world
    d8 = os.path.join(d, "evaluation")
    os.makedirs(d8)
    print(json.dumps({"phase": "cluster_evaluate", **run_cluster_evaluate_phase(dev, d8), "card": card}),
          flush=True)
    mark("cluster_evaluate")
    print(json.dumps({"phase": "f32_card_vs_cpu_n160", "tf32": False, **check_f32_vs_cpu(dev)}), flush=True)
    print(json.dumps({"phase": "f32_card_vs_cpu_n6_256", "tf32": False, **check_f32_vs_cpu(dev, "n6", 256)}),
          flush=True)
    print(json.dumps({"phase": "m_builds", **check_m_builds(dev)}), flush=True)
    print(json.dumps({"phase": "int8_n160_card_vs_cpu", "tf32": False, **check_int8_forward_card_vs_cpu(dev)}),
          flush=True)
    mark("card_vs_cpu")
    accuracy = run_accuracy_phase(dev, card, *world)
    print(json.dumps({"phase": "accuracy", **accuracy, "card": card}), flush=True)
    mark("accuracy")

    # 5. times (the int8 model calibrated on the main path's first 8 tiles)
    tiles = serving_tiles(dev)
    times = time_serving_and_kernel(dev, card, tiles, profile=True)
    times_p6 = time_serving_and_kernel(dev, card, tiles, "m6", shapes=((128, 1024),), iters=1)
    times_int8 = time_serving_and_kernel(dev, card, tiles, shapes=((128, 1024),), iters=2,
                                         int8_paths=paths[:8], profile=True)
    print(json.dumps({"metric": "int8_safe_over_bf16", "variant": "mt", "batch": tiles.shape[0],
                      **{c: times_int8[c]["tiles_per_s"] / times[c]["tiles_per_s"] for c in ("conf_0.25", "conf_1e-05")},
                      "card": card}), flush=True)
    k, k6 = times["kernel"], times_p6["kernel"]
    del tiles
    torch.cuda.empty_cache()
    mark("serving_times")

    # 6. training: f32 card vs CPU, cli.train at full width, its checkpoint
    # served over the main path's tiles, step and feed times
    train = run_train_phase(dev, card, tile_dir, n_tiles=16)
    root.cleanup()
    mark("train")
    summary = {"kernels": [{
        "name": "nms_suppress",
        "route": "cuda",
        "source": "aquaculture_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "aquaculture_tpu/ops/nms_pallas.py:33",
        "launches": main_path["launches"]["nms_suppress"],
        "launches_pipeline": pipeline["full_width"]["launches"]["nms_suppress"],
        "launches_p6": p6["launches"]["nms_suppress"],
        "launches_tta_multi_label": options["tta_multi_label"]["launches"]["nms_suppress"],
        "launches_decode_scale": options["decode_scale"]["launches"]["nms_suppress"],
        "launches_overlap": overlap["launches"]["nms_suppress"],
        "launches_train_detect": train["drive"]["served"]["launches"]["nms_suppress"],
        "launches_int8_detect": int8_detect["launches"]["nms_suppress"],
        "launches_int8_pipeline": int8_pipeline["launches"]["nms_suppress"],
        "launches_accuracy": accuracy["on_card"]["launches"],
        "max_abs_err": max(k["max_abs_err"], k6["max_abs_err"]),
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
        "scan_floor_ms": k["scan_floor_ms"],
        "p6_ms": k6["ms"],
        "p6_plain_ms": k6["plain_ms"],
        "p6_bound_ms": k6["bound_ms"],
        "p6_bound_by": k6["bound_by"],
        "suites_passed": list(suites),
    }]}
    print(json.dumps({"phase_seconds": phase_seconds}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
