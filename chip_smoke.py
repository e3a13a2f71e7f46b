#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (aquaculture_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. card, torch and nvcc versions;
  2. build the CUDA kernels from csrc/ with nvcc for sm_90a (one nvcc per
     source), the C++ overlay sweep (csrc/booleanop.cc) and the JPEG
     entropy decoder (csrc/jpeg_entropy.cc) with g++, all at once;
  3. hold each kernel against its plain PyTorch version on the card, keep
     masks exactly equal (tolerance 0), over several input suites;
  4. drive the port's main path, ``aquaculture_tpu_torch.cli.detect.main``
     on the mt model at 640 px from 1024 px JPEG tiles through the device
     loader (its entropy decode on host threads, ``jpeg_decode`` on the
     card), with the launch counters of both kernels zeroed just before
     and read just after (each == batches); compare batched_nms
     through the kernel with the plain path on one batch; compare the
     card's f32 forward with the CPU's (TF32 off);
  4b. the pipeline phase: drive ``aquaculture_tpu_torch.cli.pipeline.main``
     (detect on the card, then geocode, download-box dedup, cage areas and
     the land filter on the host) at full width (mt at 640, 32 tiles over 4
     download boxes, two of them overlapping, with land; more than 2,000
     rows reach the hybrid land filter), with the counters zeroed around
     it, printing each stage's rows and host seconds; then, after 4c, the
     committed trained fixture over its rendered 12-tile world, once on the
     card and once on the CPU, in bf16 through cli.pipeline (deviation
     reported) and in f32 through run_pipeline (held to the golden bar).
     The CPU runs, the accuracy table's CPU half and phase 10's CPU side
     run in one spawned worker (CPU_REFERENCE_THREADS torch threads),
     started when the world is rendered, beside the card's phases;
  4c. the serving options: the ``p6`` phase drives cli.pipeline on m6 at
     1280 px with 4b's full-width geometry; cli.detect runs once with
     --augment --multi-label and once with --decode-scale (mt at 640), and
     cli.pipeline with --overlap 256 on 2048 px JPEG rasters (rows before
     and after cross-tile NMS), each with the counters zeroed around it;
     batched_nms through the kernel against the plain path on one batch of
     each new path's own candidates (P6 at 1280, multi-label, TTA, TTA with
     multi-label); the card's f32 forward of n6 at 256 against the CPU's;
  4d. the tooling phase, after cli.detect's runs: ``cli.aot export`` of mt at
     640 (batch 8, the main path's seed-0 weights) traced for the card, in a
     process of its own started before phase 2 (its imports and trace
     overlap phases 2-4);
     ``cli.detect --aot`` over the main path's 16 tiles (label files equal
     to the main path's, or within the golden bar with the reason printed;
     suppression launches == batches, inside the exported program);
     ``cli.detect --profile`` (the trace holds one nms_suppress_kernel per
     batch and convolution kernels; its top 10 device ops and device-idle
     share); ``cli.export`` of an f32 m checkpoint, whose ``--weights
     x.pt`` labels equal ``--weights CKPT``'s;
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
     fixture on its rendered 12-image world at 160 px on the card (through
     the device loader) and on the CPU (the Python loader), every row: the
     f32 rows agree card vs CPU, and every card row
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
     combination grid over EVAL_FOLDS = 2 folds (the sweep's seconds per fold, the
     match matrix's host seconds, the fold rows, the held-out table, which
     must equal test_set_performance with --device cpu). The CPU references
     run in worker processes beside the card's side;
  9. after 4b, the ``pod`` phase: ``aquaculture_tpu_torch.cli.pod``'s main
     on two processes sharing cuda:0 (gloo, tcp rendezvous on this
     machine), mt at 640 over the main path's 16 tiles streamed from a
     local store (``store:ROOT::tiles/``), batch 8, so that each rank's
     batch is one of the 1-rank run's: rank 0's GeoJSON equal row for row
     to the in-process 1-rank run_pod_pipeline's, suppression launches per
     rank (each process counts its own) == its batches; rank 1's last chunk
     manifest deleted and the run repeated by two new processes (the same
     output, rank 1 serving exactly that chunk's tiles); one f32 n step at
     160 px under a one-rank NCCL sharded_train_step against the plain card
     step (TF32 off). The processes start before 4b's pipeline runs and
     import while they and the card-vs-CPU checks run (the accuracy table
     follows the pod phase); phase 6 times the m/640/b16 bf16 step under
     the one-rank mesh beside the plain step;
 10. after 8, ``facilities_tonnage``: the tonnage world, a cut of phase 8's
     evaluation world (its detections and labels west of 3.25 E) with an
     image box for each tile and survey year (two years overlap inside the
     2000-2004 and 2005-2009 passes, half the later year's images cut by
     whitespace), a bathymetry GeoTIFF, a factor workbook, FAO production
     and Trujillo points; ``cli.facilities`` on the card and with --device
     cpu (the facility frames equal), ``cli.tonnage`` twice on the card at
     K = 10,000 (identical tables) and once with --device cpu at K = 2,000
     (each pass's mean within 4 standard errors); then ``run_bootstrap`` on
     the card at the paper's scale (K = 10,000 over 16,384 cage pairs, 512
     facilities, 6 passes): its card ms (CUDA events, median of 3 after a
     warm call), the host seconds of ``prepare_bootstrap_inputs``, the peak
     memory, and a degenerate lattice against its closed form
     (``scripts/tonnage_world.py`` profiles that call, and times the CLIs
     on the whole world). The CLIs run on the default overlay sweep engine,
     the C++ one (its sweep counter > 0); one more card cli.facilities on
     the Python engine (no C++ sweep) must give equal facility frames;
 11. after 5, ``plan``: ``cli.plan --json`` in-process for the default,
     --latency-sensitive, --boundary-accuracy and --train, then one batch
     of the default recommendation served through make_infer_fn with the
     counters zeroed around it (one suppression launch), and the kernel's
     mask on that batch's own candidates equal to the plain version's;
 12. after 10, ``acquire_to_map``, from the WMS download to the facility
     map: (a) ``cli.acquire wms`` through the port's HttpWmsTransport
     against a WMS GetMap server on 127.0.0.1 (a thread of this process)
     over a coast polygon that tiles into 3 download boxes of 1200 m (one
     answered all white: 2 downloaded, 1 blank; a second run fetches
     nothing), ``bathymetry`` on two .asc grids (the GeoTIFF equal to
     merge_asc_grids'), ``landfilter`` on .shp linework (>= 1 primary
     face); (b) the reference's tiling step (each stored 6144 px TIFF into
     36 JPEG tiles named by the filename codec), then
     ``load_final_image_boxes`` in a worker process (spawned before phase
     10, so that it has imported by then) while (c) runs: 72 tiles -> 71
     boxes, the banded tile's box shrunk; (c) ``cli.pipeline`` on mt at 640 over those tiles
     (batch 32) with (a)'s download boxes and land, the counters zeroed
     around it: 3 launches, rows inside their download boxes and none on
     land, each launch's keep mask equal to the plain version's on the
     same candidates; (d) cli.figures' computations on phase 10's outputs:
     ``clustered_detections`` on the card equal to the CPU's, the P/R
     sweep over 100 thresholds, Figure 4's classification, the Trujillo
     tags, unique locations, the HTML map with one point per facility (the
     plots only where matplotlib imports).
 13. after 5, ``feed``, the device loader: its fused kernel equal to its
     plain version (torch.equal) on JPEGs at q75, q90 and q95 4:2:0,
     4:4:4, 4:2:2, 4:4:0, 4:1:1, luma 3x1 and 1x4, greyscale, RGB-coded,
     1000 x 750, restart intervals, progressive, arithmetic (sequential
     with restarts, progressive), interrupted progressive files (smoothed)
     and a 2048 px raster, at 8/8 and 5/8, alone and in one batch on the
     tile grid, and the card's 8/8 images equal to PIL's decode on this
     host byte for byte (but PIL_DIFFERS); at 1/8, 2/8, 3/8, 4/8, 6/8 and
     7/8 all but the raster in one batch on the grid; a corpus of good
     tiles, a TIFF and the 12-bit, lossless and CMYK JPEGs that libjpeg
     refuses through native_tile_batches on the card (3 skipped, no
     exception, the TIFF through the TIFF reader, under PIL's resize at
     5/8, tiles equal to the plain path's on the CPU, at 8/8 and 5/8);
     detect_files through both loaders (full-decode rows equal, the kernel
     once per batch), and at --img 512 (4/8) through the device loader by
     default (each kernel once per batch, the card's tiles equal to the CPU
     plain path's); then the times, with the card's name and power limit:
     the host entropy decode and PIL's full decode per second on one thread
     and on every core, the kernel per batch of 128 at every N/8 beside its
     bound (bytes and integer operations; its registers, shared memory and
     spills) and, at 8/8, its plain version's time, and file-fed
     detect_files tiles/s (mt bf16 b128) through both loaders in turns (8
     batches a device-loader run, 3 a Python-loader run, whole-run and
     steady rates) beside phase 5's tiles-on-card rate. Last, the TIFF
     corpus (written by a process of its own since the builds): a 6144 px
     uncompressed download, LZW with predictor, Deflate, BigTIFF and JPEG
     tiled and in strips, each on its route through native_tile_batches,
     the card's tiles equal to the CPU route's, the kernel once per JPEG
     TIFF and equal to its plain version on its segments, timed; and the
     corpus's file-fed tiles/s through the device loader.
The last lines are the script seconds per group of phases, the total, the
{"kernels": [...]} summary, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
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
# IoU-matrix bytes per plain suppression call in check_kernels: the plain
# version's temporaries take about 8 times its IoU matrix, so 5 GB keeps a
# call near 40 GB of the card's 80 (two suites per call at K = 25,200, all
# six below K = 14,400)
PLAIN_IOU_BYTES = 5_200_000_000


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
    kernel's 32-candidate words. Each pair's shift in ulps (-6..6 per
    image) is one ``rng.integers`` draw per pair, in order."""
    d0 = np.float32(100.0 * 0.55 / 1.45)
    ulps = np.empty(13, np.float32)  # d0 moved -6..6 float32 ulps
    ulps[6] = d0
    for n in range(1, 7):
        ulps[6 + n] = np.nextafter(ulps[5 + n], np.float32(np.inf))
        ulps[6 - n] = np.nextafter(ulps[7 - n], np.float32(-np.inf))
    out = np.zeros((b, k, 4), np.float32)
    out[:, :shift] = [0, -300, 100, -200]
    q = np.arange(k - shift)
    oy = (300 * (q // 2)).astype(np.float32)
    base, moved = q[q % 2 == 0], q[q % 2 == 1]
    out[:, shift + base, 1] = oy[base]
    out[:, shift + base, 2] = 100
    out[:, shift + base, 3] = oy[base] + np.float32(100)
    steps = np.asarray([rng.integers(-6, 7, b) for _ in moved], np.int64).reshape(len(moved), b)
    d = ulps[steps + 6].T  # (b, pairs)
    out[:, shift + moved, 0] = d
    out[:, shift + moved, 1] = oy[moved]
    out[:, shift + moved, 2] = np.float32(100) + d
    out[:, shift + moved, 3] = oy[moved] + np.float32(100)
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
    """Each suite at each shape: the kernel against the plain version on
    the same inputs, exactly. The plain version runs K dependent steps of a
    few launches each whatever B is, so the suites' inputs of one shape go
    through it stacked along the batch (rows are independent), as many per
    call as PLAIN_IOU_BYTES of IoU matrix allow; each suite's kernel call
    stays its own."""
    import torch

    from aquaculture_tpu_torch.ops.nms import greedy_suppress_plain
    from aquaculture_tpu_torch.ops.nms_cuda import greedy_suppress_cuda

    for b, k in shapes:
        inputs = [suite_inputs(kind, b, k, seed=1000 * si + k + b) for si, kind in enumerate(SUITES)]
        boxes = [torch.from_numpy(x).to(dev) for x, _ in inputs]
        valid = [torch.from_numpy(v).to(dev) for _, v in inputs]
        got = [greedy_suppress_cuda(x, v, 0.45) for x, v in zip(boxes, valid)]
        group = max(1, min(len(SUITES), PLAIN_IOU_BYTES // (4 * b * k * k)))
        for g0 in range(0, len(SUITES), group):
            sl = slice(g0, g0 + group)
            want = greedy_suppress_plain(torch.cat(boxes[sl]), torch.cat(valid[sl]), 0.45).split(b)
            for kind, g, w in zip(SUITES[sl], got[sl], want):
                if not torch.equal(g, w):
                    fail(f"nms_suppress != plain on suite {kind} (B={b}, K={k}): {int((g != w).sum())} flags differ")
        torch.cuda.synchronize()
    return list(SUITES)


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
    from aquaculture_tpu_torch.data import jpeg_cuda
    from aquaculture_tpu_torch.ops import int8_conv, nms_cuda

    nms_cuda.launches = int8_conv.mm_calls = int8_conv.plain_calls = 0
    jpeg_cuda.decode_launches = 0
    t0 = time.perf_counter()
    stats = cli_detect.main([
        "--source", tile_dir, "--out", label_dir, "--variant", variant,
        "--batch", str(batch), "--conf", "1e-5", *options,
    ])
    seconds = time.perf_counter() - t0
    launches = {"nms_suppress": nms_cuda.launches, "jpeg_decode": jpeg_cuda.decode_launches}
    int8_calls = check_int8_routes(f"cli.detect {list(options)}", "--int8" in options)

    n_batches = -(-n_tiles // batch)
    for name, n in launches.items():
        if n != n_batches:
            fail(f"{name} launched {n} times on cli.detect {list(options)}, expected {n_batches} (one per batch)")
    if stats.loader != "device" or stats.files.get("device") != n_tiles:
        fail(f"cli.detect {list(options)} on JPEG tiles ran the {stats.loader!r} loader ({stats.files}); "
             "the device loader takes JPEG input")
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
            "loader": stats.loader, "files": stats.files}


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
# phase 4d: the serving tooling (cli.aot, cli.detect --aot and --profile,
# cli.export)
# ---------------------------------------------------------------------------

def _label_rows(label_dir: str) -> dict:
    """{file name: (N, 6) rows class cx cy w h conf} of a label directory."""
    return {n: np.loadtxt(os.path.join(label_dir, n), ndmin=2) for n in sorted(os.listdir(label_dir))}


def labels_agree(got_dir: str, want_dir: str, what: str) -> dict:
    """Label files byte-equal, or else every row within the golden bar of
    tests/test_golden_pipeline.py against the row at its place (box IoU
    >= 0.99, confidence within 1e-3, same class), with the reason printed:
    another cuDNN algorithm rounds the bf16 forward otherwise."""
    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names:
        fail(f"{what}: label files {sorted(os.listdir(got_dir))[:3]}... differ from {names[:3]}...")
    equal = all(open(os.path.join(got_dir, n), "rb").read() == open(os.path.join(want_dir, n), "rb").read()
                for n in names)
    if equal:
        return {"files": len(names), "equal": True}
    worst_iou, worst_dconf = 1.0, 0.0
    got_rows = _label_rows(got_dir)
    for n, want in _label_rows(want_dir).items():
        got = got_rows[n]
        if got.shape != want.shape or not (got[:, 0] == want[:, 0]).all():
            fail(f"{what}: {n} has other rows or classes than the live path's")
        boxes = [np.concatenate([r[:, 1:3] - r[:, 3:5] / 2, r[:, 1:3] + r[:, 3:5] / 2], 1) for r in (got, want)]
        lt, rb = np.maximum(boxes[0][:, :2], boxes[1][:, :2]), np.minimum(boxes[0][:, 2:], boxes[1][:, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), 1)
        areas = [np.prod(b[:, 2:] - b[:, :2], 1) for b in boxes]
        iou = inter / np.maximum(areas[0] + areas[1] - inter, 1e-12)
        worst_iou, worst_dconf = min(worst_iou, float(iou.min())), max(worst_dconf, float(np.abs(got[:, 5] - want[:, 5]).max()))
    if worst_iou < 0.99 or worst_dconf > 1e-3:
        fail(f"{what}: rows beyond the golden bar (worst IoU {worst_iou}, conf {worst_dconf})")
    print(f"{what}: label files not byte-equal to the live path's, within the golden bar "
          f"(worst IoU {worst_iou:.6f}, conf {worst_dconf:.2e}): another cuDNN algorithm", flush=True)
    return {"files": len(names), "equal": False, "worst_iou": worst_iou, "worst_dconf": worst_dconf}


def read_trace(logdir: str) -> dict:
    """The device side of a torch.profiler Chrome trace (utils/profiler.py):
    kernels, copies and sets by name with their summed ms, the top 10, and
    the device-idle share of the span from the first device event's start
    to the last one's end (busy = the union of the event intervals)."""
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"--profile wrote {files} into {logdir}, expected one trace")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        fail("the --profile trace holds no device event")
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, cur0, cur1 = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur1:
            busy, cur0 = busy + cur1 - cur0, a
        cur1 = max(cur1, b)
    busy += cur1 - cur0
    window = spans[-1][1] - spans[0][0]
    kernels = [e["name"] for e in dev if e["cat"] == "kernel"]
    kinds = {}
    for name in kernels:
        kind = next((k for k, keys in KERNEL_KINDS if any(x in name.lower() for x in keys)), "other")
        kinds[kind] = kinds.get(kind, 0) + 1
    return {"file": files[0], "device_events": len(dev), "kernels": len(kernels),
            "nms_suppress_kernel_events": sum("nms_suppress_kernel" in n for n in kernels),
            "kernels_by_kind": kinds, "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / window,
            "top10_ms": [[n[:80], t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]}


AOT_EXPORT_CODE = """
import json, sys, time
t0 = time.perf_counter()
from aquaculture_tpu_torch.cli import aot
t1 = time.perf_counter()
meta = aot.main(sys.argv[1:])
print("AOT_EXPORT " + json.dumps({"import_s": t1 - t0, "export_s": time.perf_counter() - t1,
                                  "device": meta["device"], "torch": meta["torch_version"]}), flush=True)
"""


def start_aot_export(d: str, batch: int) -> dict:
    """``cli.aot export`` of mt at 640 (batch ``batch``, conf 1e-5, the main
    path's seed-0 weights) on the card, in a process of its own started now:
    its imports and its trace overlap the kernel and detect phases, which
    time nothing. Killed at exit if still running."""
    prog = os.path.join(d, "serving_mt.aqt")
    log_path = os.path.join(d, "aot_export.log")
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", AOT_EXPORT_CODE, "export", "--variant", "mt", "--batch",
                             str(batch), "--conf", "1e-5", "--out", prog], stdout=log, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    job = {"proc": proc, "log": log, "log_path": log_path, "prog": prog, "t0": time.perf_counter()}
    atexit.register(stop_processes, [(proc, log, log_path)])
    return job


def wait_aot_export(job: dict) -> dict:
    try:
        rc = job["proc"].wait(timeout=300)
    except subprocess.TimeoutExpired:
        fail("cli.aot export did not finish in 300 s")
    job["log"].close()
    text = open(job["log_path"]).read()
    line = next((ln for ln in text.splitlines() if ln.startswith("AOT_EXPORT ")), None)
    if rc != 0 or line is None:
        fail(f"cli.aot export exited {rc}:\n{text[-3000:]}")
    out = json.loads(line[len("AOT_EXPORT "):])
    if out["device"] != "cuda":
        fail(f"cli.aot export traced for {out['device']}, not cuda")
    out.update(bytes=os.path.getsize(job["prog"]), wall_s=time.perf_counter() - job["t0"])
    return out


def run_tooling_phase(d: str, tile_dir: str, main_labels: str, n_tiles: int, batch: int, export: dict) -> dict:
    """The serving tooling on the main path's tiles: the artifact of
    start_aot_export (mt at 640, batch ``batch``, exported on the card);
    cli.detect --aot (labels equal to the main path's, one suppression
    launch per batch inside the exported program); cli.detect --profile
    (a trace with one nms_suppress_kernel per batch and the convolutions;
    its top 10 device ops and idle share); cli.export of an f32 m checkpoint
    (--weights x.pt rows equal to --weights CKPT)."""
    from aquaculture_tpu_torch.cli import export as cli_export
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init
    from aquaculture_tpu_torch.utils.checkpoint import save_params

    out = {"aot_export": export}
    prog = os.path.join(d, "serving_mt.aqt")
    aot_labels = os.path.join(d, "aot_labels")
    out["aot_detect"] = run_main_path(tile_dir, aot_labels, n_tiles, batch, options=("--aot", prog))
    out["aot_detect"]["labels_vs_main_path"] = labels_agree(aot_labels, main_labels, "cli.detect --aot")

    logdir = os.path.join(d, "profile")
    prof_labels = os.path.join(d, "profiled_labels")
    out["profiled_detect"] = run_main_path(tile_dir, prof_labels, n_tiles, batch, options=("--profile", logdir))
    out["profiled_detect"]["labels_vs_main_path"] = labels_agree(prof_labels, main_labels, "cli.detect --profile")
    trace = read_trace(logdir)
    n_batches = -(-n_tiles // batch)
    if trace["nms_suppress_kernel_events"] != n_batches:
        fail(f"the --profile trace holds {trace['nms_suppress_kernel_events']} nms_suppress_kernel events, "
             f"expected {n_batches}")
    if not trace["kernels_by_kind"].get("convolution"):
        fail(f"the --profile trace holds no convolution kernel: {trace['kernels_by_kind']}")
    out["profiled_detect"]["trace"] = trace

    ckpt, pt = os.path.join(d, "m_f32"), os.path.join(d, "m_f32.pt")
    save_params(ckpt, yolov5_init("m", 5, seed=0)[1], {"variant": "m", "num_classes": 5})
    t0 = time.perf_counter()
    cli_export.main(["--ckpt", ckpt, "--out", pt])
    out["export_pt"] = {"seconds": time.perf_counter() - t0, "bytes": os.path.getsize(pt)}
    from_ckpt, from_pt = os.path.join(d, "m_ckpt_labels"), os.path.join(d, "m_pt_labels")
    out["export_pt"]["detect_ckpt"] = run_main_path(tile_dir, from_ckpt, n_tiles, batch, ("--weights", ckpt), "m")
    out["export_pt"]["detect_pt"] = run_main_path(tile_dir, from_pt, n_tiles, batch, ("--weights", pt), "m")
    eq = labels_agree(from_pt, from_ckpt, "cli.detect --weights x.pt vs --weights CKPT")
    if not eq["equal"]:
        fail("--weights x.pt rows differ from --weights CKPT rows on one card (same f32 weights, same program)")
    out["export_pt"]["labels_equal"] = True
    return out


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
    from aquaculture_tpu_torch.data import jpeg_cuda
    from aquaculture_tpu_torch.ops import int8_conv, nms_cuda

    tile_dir, boxes_csv, land = inputs
    out = os.path.join(d, f"det_{variant}{''.join(options)}.geojson")
    nms_cuda.launches = int8_conv.mm_calls = int8_conv.plain_calls = 0
    jpeg_cuda.decode_launches = 0
    t0 = time.perf_counter()
    det, stats = cli_pipeline.main([
        "--source", tile_dir, "--download-bboxes", boxes_csv, "--land", land, "--out", out,
        "--variant", variant, "--batch", str(PIPELINE_BATCH), "--conf", "1e-5", *options,
    ])
    seconds = time.perf_counter() - t0
    launches = {"nms_suppress": nms_cuda.launches, "jpeg_decode": jpeg_cuda.decode_launches}
    int8_calls = check_int8_routes(f"pipeline {variant} {list(options)}", "--int8" in options)

    n_batches = -(-PIPELINE_TILES // PIPELINE_BATCH)
    if set(launches.values()) != {stats.batches} or stats.batches != n_batches or stats.tiles != PIPELINE_TILES:
        fail(f"pipeline {variant}: launches {launches} for {stats.batches} batches "
             f"of {stats.tiles} tiles, expected {n_batches} batches of {PIPELINE_TILES}")
    if stats.loader != "device":
        fail(f"pipeline {variant}: the {stats.loader!r} loader on JPEG tiles")
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
            "launches": launches, "int8_conv_calls": int8_calls, "dedup_clipped_rows": clipped,
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


def trained_fixture_run(d: str, img_dir: str, dtype: str, device: str) -> dict:
    """One run of the committed trained fixture (n, 2 classes) at 160 px on
    its rendered world in ``d`` (land from ``start_cpu_references``): bf16
    through ``cli.pipeline`` as users run it, f32 through ``run_pipeline``
    with TF32 off; launches, land branch and output checked. Returns the
    run's report and its GeoJSON's path."""
    import torch

    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.cli import pipeline as cli_pipeline
    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import run_pipeline

    boxes_csv, land = os.path.join(d, "wanted_bboxes.csv"), os.path.join(d, "land.geojson")
    out = os.path.join(d, f"det_{dtype}_{device}.geojson")
    nms_cuda.launches = 0
    if dtype == "bfloat16":
        det, stats = cli_pipeline.main(["--source", img_dir, "--download-bboxes", boxes_csv, "--land", land,
                                        "--weights", FIXTURE, "--img", "160", "--conf", "0.05", "--out", out,
                                        "--device", device])
    else:
        paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
        f32 = DetectConfig(img_size=160, conf_threshold=0.05, dtype="float32")
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            det, stats = run_pipeline(paths, load_model(FIXTURE, "n", 2), load_download_bboxes(boxes_csv),
                                      f32, land=gf.read_file(land), device=device)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        det.to_file(out)
    launches = nms_cuda.launches
    if launches != (stats.batches if device == "cuda" else 0):
        fail(f"trained fixture, {dtype} on {device}: {launches} suppression launches for {stats.batches} batches")
    if stats.land_filter != "exact" or not stats.stage_rows["land_filter"] < stats.stage_rows["areas"]:
        fail(f"trained fixture, {dtype} on {device}: land filter {stats.land_filter!r}, rows {stats.stage_rows}")
    check_geojson(out, det, n_classes=2)
    return {"out": out, "report": {"rows": len(det), "launches": launches, **_stage_report(stats)},
            "tiles": stats.tiles}


def drive_pipeline_trained_card_vs_cpu(d: str, img_dir: str, cpu_runs) -> dict:
    """The committed trained fixture (n, 2 classes) at 160 px on its
    rendered 12-tile world (seed 0, in ``d``: the accuracy phase's), with
    land over part of it, once on the card (here) and once on the CPU
    (``cpu_runs``: each dtype's ``trained_fixture_run`` future, from the
    CPU reference worker):

    - ``cli.pipeline`` as users run it (bf16): launches, land branch and
      output checked; how far the card's rows are from the CPU's is
      reported, not held to the golden bar, because at 160 px one pixel of
      the model is 6.4 px of the tile and bf16 rounds activations after
      cuDNN's and the CPU's different summation orders;
    - ``run_pipeline`` in f32 with TF32 off: the two GeoJSONs hold the same
      rows at the golden bar."""
    from aquaculture_tpu_torch import frame as gf

    runs, frames = {}, {}
    for dtype in ("bfloat16", "float32"):
        for device in ("cuda", "cpu"):
            run = trained_fixture_run(d, img_dir, dtype, "cuda") if device == "cuda" else cpu_runs[dtype].result()
            frames[dtype, device] = gf.read_file(run["out"])
            runs[f"{dtype}_{device}"] = run["report"]
    bf16 = _match_golden(frames["bfloat16", "cuda"], frames["bfloat16", "cpu"])
    match = _match_golden(frames["float32", "cuda"], frames["float32", "cpu"])
    if match["rows"][0] != match["rows"][1] or match["unmatched"] or match["rows"][0] < 50:
        fail(f"trained fixture f32 card vs CPU (TF32 off) misses the golden bar: {match}")
    return {"variant": "n", "img": 160, "tiles": run["tiles"], "weights": "tests/data/demo_ckpt_n160",
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain_keep = N.greedy_suppress_plain(boxes, valid, 0.45)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(keep, plain_keep):
            fail(f"nms_suppress != plain on the {variant} serving candidates (B={b}, K={k})")
        bound, bound_by = suppress_bound_ms(keep, valid)
        # the plain version at the larger shapes takes 0.4-1.9 s a call:
        # there its time is that of the checking call above, no warmup
        row = {
            "B": b, "K": k, "valid": int(valid.sum()), "kept": int(keep.sum()),
            "ms": time_cuda(lambda: greedy_suppress_cuda(boxes, valid, 0.45), iters=20, queued=True),
            "plain_ms": (time_cuda(lambda: N.greedy_suppress_plain(boxes, valid, 0.45), iters=1, windows=3)
                         if main_shape else start.elapsed_time(end)),
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
            prof = profile_step(lambda: model(x), n=1)
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
# phase 11: the serving plan (cli.plan)
# ---------------------------------------------------------------------------

PLAN_CASES = (("default", ()), ("latency_sensitive", ("--latency-sensitive",)),
              ("boundary_accuracy", ("--boundary-accuracy",)), ("train", ("--train",)))


def run_plan_phase(dev, card: str, tiles) -> dict:
    """cli.plan --json in-process for PLAN_CASES, then one batch of the
    default recommendation served on the card through make_infer_fn with the
    launch counter zeroed around it (one launch), and the suppression on
    that batch's own candidates held exactly against the plain version.
    ``tiles`` (phase 5's serving batch) is reused when the recommended batch
    has its size."""
    import io

    import torch

    from aquaculture_tpu_torch.cli import plan as cli_plan
    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import make_infer_fn, preprocess

    plans = {}
    for name, argv in PLAN_CASES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_plan.main([*argv, "--json"])
        plans[name] = json.loads(buf.getvalue())
        print(json.dumps({"phase": "plan", "case": name, **{k: v for k, v in plans[name].items() if k != "notes"},
                          "notes": len(plans[name]["notes"])}), flush=True)
    rec = plans["default"]
    if rec["int8"] or rec["tta"] or rec["overlap_px"]:
        fail(f"the default plan {rec} asks for a serving path this phase does not drive")
    b, img = rec["batch"], rec["img_size"]
    reused = tiles.shape[0] == b
    if not reused:
        tiles = serving_tiles(dev, b)
    model = load_model(None, rec["variant"], 5)
    infer = make_infer_fn(model, DetectConfig(img_size=img, conf_threshold=1e-5), tile=1024, device=dev)
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    det, valid = infer(tiles)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = nms_cuda.launches
    if launches != 1:
        fail(f"one batch of the plan's recommendation launched nms_suppress {launches} times, expected 1")
    if tuple(det.shape) != (b, 300, 6) or not torch.isfinite(det).all() or not valid.any():
        fail(f"the plan's batch: rows {tuple(det.shape)}, finite {bool(torch.isfinite(det).all())}")
    with torch.inference_mode():
        preds = model(preprocess(tiles, img, torch.bfloat16))
    check = nms_kernel_vs_plain(preds, what=f"the plan's {rec['variant']} b{b}")
    return {"plans": {k: {f: v for f, v in p.items() if f != "notes"} for k, p in plans.items()},
            "served": {"variant": rec["variant"], "batch": b, "img": img, "dtype": "bfloat16",
                       "reused_serving_tiles": bool(reused), "first_batch_s": seconds, "launches": launches,
                       "rows": int(valid.sum()), **check}}


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
    profile (profile_step) and the card's idle share of it; and the step
    under a one-rank NCCL mesh (cli.train --mesh 1 on one card), with its
    overhead over the plain step."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.models.weights import load_train_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
    from aquaculture_tpu_torch.parallel.sharded import sharded_train_step
    from aquaculture_tpu_torch.train.trainer import init_train_state, make_train_step

    b, img = batch["images"].shape[:2]
    flops_fwd = conv_flops_per_image(load_model(None, variant, 5).to(dev).eval(), img, dev)
    model = load_train_params(YoloV5(variant, 5, trainable=True), yolov5_init(variant, 5)[1])
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    rows = {}
    for name, kw in (("plain", {}), ("remat", {"remat": True}), ("mesh_1x1", {})):
        cfg = TrainConfig(img_size=img, batch_size=b, **kw)
        if name == "mesh_1x1":
            # the same step under a one-rank NCCL mesh: BatchNorm's global
            # statistics, the loss's all-reduced normalizers and metrics and
            # the gradient all-reduce, every collective the identity
            with one_rank_mesh(dev) as mesh:
                step, state = sharded_train_step(model, cfg, mesh, 100, state)
                ms = time_cuda(lambda: step(state, on_card), iters=iters, windows=windows)
            model.train_options.data_group = None
            rows[name] = {"ms_per_step": ms, "img_per_s": b / ms * 1e3,
                          "overhead_ms": ms - rows["plain"]["ms_per_step"],
                          "overhead_share": ms / rows["plain"]["ms_per_step"] - 1}
            print(json.dumps({"metric": "train_step", "variant": variant, "img": img, "batch": b,
                              "dtype": "bfloat16", "option": name, **rows[name], "card": card}), flush=True)
            continue
        step = make_train_step(model, cfg, 100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_cuda(lambda: step(state, on_card), iters=iters, windows=windows)
        rate = 3 * flops_fwd * b / (ms / 1e3)
        rows[name] = {"ms_per_step": ms, "img_per_s": b / ms * 1e3, "train_tflop_per_s": rate / 1e12,
                      "share_of_bf16_dense_peak": rate / BF16_FLOP_PER_S,
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name == "plain":
            prof = profile_step(lambda: step(state, on_card), n=1)
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
    steps = time_train_step(dev, card, batch, iters=2, windows=2)
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

# The TIFF compressions the device loader leaves to PIL ("pil" route):
# PIL's name for those PIL writes, and the mode it writes them from.
PIL_ROUTE_COMPRESSIONS = (("group3", "1"), ("group4", "1"), ("tiff_ccitt", "1"), ("tiff_raw_16", "1"),
                          ("lzma", "RGB"))


def pil_tiff_compressions() -> dict:
    """Which compressions on the "pil" route PIL here writes and reads back
    (a 16 x 16 file each, in a temporary directory): name -> "reads",
    or what failed."""
    from PIL import Image

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, mode in PIL_ROUTE_COMPRESSIONS:
            path = os.path.join(d, f"{name}.tif")
            img = Image.fromarray((np.arange(256) * 37 % 256).astype(np.uint8).reshape(16, 16)).convert(mode)
            try:
                img.save(path, compression=name)
            except Exception as e:  # noqa: BLE001 (a report, gating nothing)
                out[name] = f"does not write: {type(e).__name__}: {e}"
                continue
            try:
                with Image.open(path) as back:
                    back.load()
                out[name] = "reads"
            except Exception as e:  # noqa: BLE001
                out[name] = f"writes, does not read: {type(e).__name__}: {e}"
    return out


def probe() -> dict:
    """What the card's machine offers later work: triton, CUTLASS's
    headers (a fused int8 conv), matplotlib (figures), libjpeg's and
    libtiff's headers and libraries (what the JAX package's C++ tile
    loader links; the port's device loader parses JPEG itself and needs
    neither), the codec libraries libtiff would link (libwebp, libzstd,
    liblzma, libLerc, libjbig), and which of the compressions the loader
    leaves to PIL the machine's PIL reads. Gates nothing."""
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
    # what the JAX package's tile loader links (-ljpeg -ltiff); the port's needs neither
    out["headers"] = {h: [r for r in ("/usr/include", "/usr/local/include") if os.path.exists(os.path.join(r, h))]
                      for h in ("jpeglib.h", "tiffio.h")}
    try:
        libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        libs = [f"ldconfig failed: {e}"]
    out["libraries"] = {lib: sorted({ln.split()[0] for ln in libs if ln.strip().startswith(lib + ".so")})
                        for lib in ("libjpeg", "libtiff", "libwebp", "libzstd", "liblzma", "libLerc", "libjbig")}
    try:
        from PIL import features

        out["pil"] = {"webp": features.version("webp"), "libtiff": features.version("libtiff")}
    except ImportError as e:
        out["pil"] = f"absent: {e}"
    out["pil_route_compressions"] = pil_tiff_compressions()
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


def accuracy_configs() -> tuple:
    """The accuracy table's rows: every serving configuration and topk512."""
    from aquaculture_tpu_torch.eval.accuracy import SERVING_CONFIGS

    return SERVING_CONFIGS + ("topk512",)


def accuracy_table(img_dir: str, lab_dir: str, device: str) -> dict:
    """serving_accuracy_table of the trained fixture at 160 px, every row of
    ``accuracy_configs``, on ``device`` (TF32 off, so that the f32 row is f32):
    through the device loader on the card, the Python loader on the CPU;
    with the kernels' launches counted in this process."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_cuda
    from aquaculture_tpu_torch.eval.accuracy import serving_accuracy_table
    from aquaculture_tpu_torch.ops import int8_conv, nms_cuda

    nms_cuda.launches = int8_conv.mm_calls = int8_conv.plain_calls = 0
    jpeg_cuda.decode_launches = 0
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        rows = serving_accuracy_table(img_dir, lab_dir, FIXTURE, img_size=160, configs=accuracy_configs(),
                                      device=device, use_native=device == "cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    table = {"rows": {r.name: {"map50": r.map50, "map": r.map} for r in rows},
             "seconds": time.perf_counter() - t0, "launches": nms_cuda.launches,
             "jpeg_launches": jpeg_cuda.decode_launches}
    if device == "cuda":
        table["int8_conv_calls"] = check_int8_routes("accuracy table", True)
    return table


def _cpu_reference_worker_init() -> None:
    import torch

    torch.set_num_threads(CPU_REFERENCE_THREADS)


# the CPU reference worker's torch threads: the card phases beside it keep
# the rest of the host's cores
CPU_REFERENCE_THREADS = 4


def start_cpu_references(d: str, img_dir: str, lab_dir: str) -> dict:
    """The CPU halves of the trained fixture's pipeline runs and of the
    accuracy table, in a spawned worker that imports and runs them while
    the card's phases run (the card halves stay in this process): each
    dtype's ``trained_fixture_run`` and the CPU ``accuracy_table``, as
    futures, and the worker's executor under "pool" (phase 10 gives it its
    CPU side too)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    write_land(os.path.join(d, "land.geojson"), -100.0, 3700.0, 1100.0, 2500.0, seed=3)  # over part of the world
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_cpu_reference_worker_init)
    return {"pool": pool, "bfloat16": pool.submit(trained_fixture_run, d, img_dir, "bfloat16", "cpu"),
            "float32": pool.submit(trained_fixture_run, d, img_dir, "float32", "cpu"),
            "accuracy": pool.submit(accuracy_table, img_dir, lab_dir, "cpu")}


def run_accuracy_phase(dev, card: str, img_dir: str, lab_dir: str, cpu_table) -> dict:
    """The accuracy table for the trained fixture on its rendered 12-image
    world (seed 0; tests/test_accuracy.py's) at 160 px, every row, on the
    card through the device loader (here) and on the CPU through the Python
    loader (``cpu_table``, the CPU reference worker's future): the f32 rows
    agree, and every card row holds tests/test_accuracy.py's bounds against
    the card's bf16 row."""
    configs = accuracy_configs()
    tables = {"cuda": accuracy_table(img_dir, lab_dir, "cuda"), "cpu": cpu_table.result()}
    card, cpu = tables["cuda"]["rows"], tables["cpu"]["rows"]
    # two batches of 8 tiles per row, one launch each, on the card only
    if tables["cuda"]["launches"] != 2 * len(configs) or tables["cpu"]["launches"]:
        fail(f"accuracy table: {tables['cuda']['launches']} launches on the card, "
             f"{tables['cpu']['launches']} on the CPU")
    if tables["cuda"]["jpeg_launches"] != 2 * len(configs) or tables["cpu"]["jpeg_launches"]:
        fail(f"accuracy table: the device loader's kernel launched {tables['cuda']['jpeg_launches']} times "
             f"on the card, {tables['cpu']['jpeg_launches']} on the CPU")
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
# phase 9: multi-process serving (aq-pod) and the one-rank training mesh
# ---------------------------------------------------------------------------

POD_RANKS = 2
POD_BATCH = 8   # 8 tiles per rank: each rank's batch is one of the 1-rank run's
POD_CONF = 1e-5  # random weights: rows on every tile
# each rank runs cli.pod's main in its own interpreter and reports what its
# process counted: the suppression kernel's launches and its stats. With a
# go file it first waits, imported, until the file exists (a restarted
# run's processes start beside the first run's and begin when told).
POD_RANK_CODE = """
import json, os, sys, time
from aquaculture_tpu_torch.cli import pod
from aquaculture_tpu_torch.ops import nms_cuda
go, t0 = sys.argv[1], time.time()
while go != "-" and not os.path.exists(go):
    if time.time() - t0 > 300:
        sys.exit("no go file")
    time.sleep(0.02)
t1 = time.time()
nms_cuda.launches = 0
det, stats = pod.main(sys.argv[2:])
print("POD_RANK " + json.dumps({"launches": nms_cuda.launches, "tiles": stats.tiles, "batches": stats.batches,
                                 "rows": len(det), "main_s": time.time() - t1}), flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_pod_ranks(d: str, root: str, boxes_csv: str, out: str, ckpt: str, go: str = "-",
                    tag: str = "run") -> list:
    """POD_RANKS processes of cli.pod (mt at 640 on cuda:0, store source,
    batch POD_BATCH, checkpoints every POD_BATCH tiles) over a tcp
    rendezvous on this machine, started once ``go`` exists ("-": at once);
    returns the Popen handles."""
    port = _free_port()
    procs = []
    for rank in range(POD_RANKS):
        argv = ["--source", f"store:{root}::tiles/", "--download-bboxes", boxes_csv, "--out", out,
                "--variant", "mt", "--conf", str(POD_CONF), "--batch", str(POD_BATCH),
                "--checkpoint-dir", ckpt, "--checkpoint-every", str(POD_BATCH),
                "--coordinator", f"tcp://127.0.0.1:{port}", "--num-processes", str(POD_RANKS),
                "--process-id", str(rank)]
        path = os.path.join(d, f"pod_{tag}_rank{rank}.log")
        log = open(path, "w")
        procs.append((subprocess.Popen([sys.executable, "-c", POD_RANK_CODE, go, *argv], stdout=log,
                                       stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__))),
                      log, path))
    return procs


def stop_processes(procs: list) -> None:
    for p, log, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def wait_pod_ranks(procs: list, what: str) -> list:
    """Wait for every rank (120 s at most; a rank left running is killed)
    and return each rank's report."""
    reports = []
    try:
        for rank, (p, log, path) in enumerate(procs):
            rc = p.wait(timeout=120)
            log.close()
            text = open(path).read()
            if rc != 0:
                fail(f"{what}: pod rank {rank} exited {rc}: {text[-2000:]}")
            line = next((ln for ln in text.splitlines() if ln.startswith("POD_RANK ")), None)
            if line is None:
                fail(f"{what}: pod rank {rank} printed no report: {text[-2000:]}")
            reports.append(json.loads(line[len("POD_RANK "):]))
    finally:
        stop_processes(procs)
    return reports


def pod_rows_equal(path: str, ref: str, what: str) -> dict:
    """The GeoJSON at ``path`` against the 1-rank run's at ``ref``, row for
    row: the same images, classes and integer boxes, confidences within
    1e-6."""
    from aquaculture_tpu_torch import frame as gf

    got, want = gf.read_file(path), gf.read_file(ref)
    px = ["xmin", "ymin", "xmax", "ymax"]
    if len(got) != len(want) or not len(want):
        fail(f"{what}: {len(got)} rows against the 1-rank run's {len(want)}")
    if got["image"].tolist() != want["image"].tolist() or got["type"].tolist() != want["type"].tolist():
        fail(f"{what}: images or classes differ from the 1-rank run's, row for row")
    if not np.array_equal(got[px].to_numpy(np.int64), want[px].to_numpy(np.int64)):
        fail(f"{what}: integer boxes differ from the 1-rank run's")
    conf_err = float(np.abs(got["det_conf"].to_numpy(np.float64) - want["det_conf"].to_numpy(np.float64)).max())
    if not conf_err <= 1e-6:
        fail(f"{what}: confidences {conf_err} from the 1-rank run's")
    with open(path, "rb") as f1, open(ref, "rb") as f2:
        same_bytes = f1.read() == f2.read()
    return {"rows": len(got), "conf_max_abs_err": conf_err, "same_bytes": same_bytes}


def check_nccl_step_f32(dev, mesh, variant: str = "n", img: int = 160, b: int = 4) -> dict:
    """One f32 train step of ``variant`` at img px, TF32 off, under a
    one-rank NCCL sharded_train_step against the plain card step on the same
    init and batch: losses within 1e-5, every leaf of params, EMA and
    momentum within TRAIN_LEAF_TOL of its magnitude, each tree within
    TRAIN_TREE_TOL."""
    import torch

    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.models.weights import flatten_tree, load_train_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
    from aquaculture_tpu_torch.parallel.mesh import shard_batch
    from aquaculture_tpu_torch.parallel.sharded import full_state_tree, sharded_train_step
    from aquaculture_tpu_torch.train.trainer import init_train_state, make_train_step

    _, params = yolov5_init(variant, 2, seed=11)
    batch = _train_batch(np.random.default_rng(12), b, img)
    cfg = TrainConfig(img_size=img, batch_size=b, compute_dtype="float32")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for key in ("plain", "nccl"):
            model = load_train_params(YoloV5(variant, 2, trainable=True), params)
            model.to(device=dev, memory_format=torch.channels_last)
            state = init_train_state(model)
            if key == "plain":
                step = make_train_step(model, cfg, 1)
            else:
                step, state = sharded_train_step(model, cfg, mesh, 1, state)
            m = step(state, shard_batch(batch, mesh, dev))
            runs[key] = ({k: float(v) for k, v in m.items()}, full_state_tree(state))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (want_m, want), (got_m, got) = runs["plain"], runs["nccl"]
    for k in want_m:
        if not abs(got_m[k] - want_m[k]) <= 1e-5 * abs(want_m[k]) + 1e-9:
            fail(f"one-rank NCCL f32 step vs plain: loss {k} {got_m[k]} vs {want_m[k]}")
    report = {"loss_nccl": got_m, "loss_plain": want_m}
    for part in ("params", "ema", "opt_momentum"):
        w, g = flatten_tree(want[part]), flatten_tree(got[part])
        worst = max((float(np.abs(g[k].astype(np.float64) - w[k]).max()) / (float(np.abs(w[k]).max()) or 1.0), k)
                    for k in w)
        tree = _rel_l2(g, w, w)
        if worst[0] > TRAIN_LEAF_TOL or not tree <= TRAIN_TREE_TOL[part]:
            fail(f"one-rank NCCL f32 step vs plain: {part} worst leaf {worst}, tree relative L2 {tree}")
        report[part] = {"worst_leaf_share": worst[0], "worst_leaf": worst[1], "tree_rel_l2": tree}
    return {"variant": variant, "img": img, "batch": b, "leaf_tol": TRAIN_LEAF_TOL, "tree_tol": TRAIN_TREE_TOL,
            **report}


@contextlib.contextmanager
def one_rank_mesh(dev):
    """A one-rank NCCL world on ``dev`` and its 1x1 (data, model) mesh: every
    collective of the mesh step runs, as the identity."""
    import torch.distributed as dist

    from aquaculture_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0, device_id=dev)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def start_pod_phase(d: str, tile_dir: str, n_tiles: int) -> dict:
    """The pod phase's inputs (the main path's tiles as a local store under
    ``tiles/``, one download box per 4 tiles) and the processes of both its
    runs, started now: they import and wait for their go files while the
    pipeline phases and the card-vs-CPU checks run.
    Every process is killed at exit if it is still running."""
    root = os.path.dirname(tile_dir)  # the store's keys: tiles/<name>
    boxes_csv = os.path.join(d, "pod_boxes.csv")
    write_boxes_csv(boxes_csv, [(1200.0 * i, 0.0, 1200.0 * (i + 1), 1200.0) for i in range(n_tiles // 4)])
    pod = {"d": d, "root": root, "boxes_csv": boxes_csv, "n_tiles": n_tiles, "out": os.path.join(d, "pod.geojson"),
           "ckpt": os.path.join(d, "pod_ckpt"), "go": [os.path.join(d, "pod_go_run"), os.path.join(d, "pod_go_resume")]}
    pod["procs"] = [start_pod_ranks(d, root, boxes_csv, pod["out"], pod["ckpt"], go=go, tag=tag)
                    for go, tag in zip(pod["go"], ("run", "resume"))]
    atexit.register(stop_processes, pod["procs"][0] + pod["procs"][1])
    return pod


def run_pod_phase(dev, card: str, pod: dict) -> dict:
    """The pod phase, on start_pod_phase's processes: cli.pod on POD_RANKS
    processes sharing cuda:0 (gloo) over the main path's tiles streamed
    from a local store, against the in-process 1-rank run_pod_pipeline;
    suppression launches per rank == that rank's batches; rank 1's last
    chunk manifest deleted and the run repeated by the second set of
    processes (the same output, rank 1 serving exactly that chunk); and on a
    one-rank NCCL mesh the f32 step against the plain card step. The
    1-rank reference and the f32 step run in this process while the first
    run serves (checks, not timings). The full-width step with and without
    the mesh is timed in the train phase (time_train_step), beside the
    plain step it is compared with."""
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.data.store import LocalBlobStore
    from aquaculture_tpu_torch.parallel.pod import run_pod_pipeline

    t_phase = time.perf_counter()
    d, n_tiles, out, ckpt = pod["d"], pod["n_tiles"], pod["out"], pod["ckpt"]
    (procs, restart), (go_run, go_resume) = pod["procs"], pod["go"]
    open(go_run, "w").close()
    try:
        store = LocalBlobStore(pod["root"])
        keys = store.list("tiles/")
        if len(keys) != n_tiles:
            fail(f"pod: the store lists {len(keys)} tiles, expected {n_tiles}")
        ref = os.path.join(d, "pod_one_rank.geojson")
        want, one = run_pod_pipeline(keys, load_model(None, "mt", 5), load_download_bboxes(pod["boxes_csv"]),
                                     DetectConfig(img_size=640, conf_threshold=POD_CONF), batch_size=POD_BATCH,
                                     store=store, out_path=ref, device=dev)
        with one_rank_mesh(dev) as mesh:
            nccl_step = check_nccl_step_f32(dev, mesh)
        print(json.dumps({"phase": "pod_nccl_step_f32", "tf32": False, **nccl_step}), flush=True)
        ranks = wait_pod_ranks(procs, "cli.pod")
        per_rank = n_tiles // POD_RANKS
        for rank, r in enumerate(ranks):
            if r["tiles"] != per_rank or r["launches"] != r["batches"] or r["batches"] != -(-per_rank // POD_BATCH):
                fail(f"cli.pod rank {rank}: {r} (expected {per_rank} tiles, launches == batches)")
        rows = pod_rows_equal(out, ref, "cli.pod")
        # a lost chunk: rank 1's last manifest deleted, the run repeated
        chunks = sorted(f for f in os.listdir(ckpt) if f.startswith(f"pod_host{POD_RANKS - 1}_"))
        lost = np.load(os.path.join(ckpt, chunks[-1]))["done_paths"].tolist()
        os.remove(os.path.join(ckpt, chunks[-1]))
        os.remove(out)
        open(go_resume, "w").close()
        resumed = wait_pod_ranks(restart, "cli.pod resume")
        if [r["tiles"] for r in resumed] != [0] * (POD_RANKS - 1) + [len(lost)]:
            fail(f"cli.pod resume: tiles per rank {[r['tiles'] for r in resumed]}, expected only rank "
                 f"{POD_RANKS - 1}'s lost chunk of {len(lost)}")
        if any(r["launches"] != r["batches"] for r in resumed):
            fail(f"cli.pod resume: launches != batches: {resumed}")
        rows_resumed = pod_rows_equal(out, ref, "cli.pod resume")
    finally:
        stop_processes(procs + restart)
    torch.cuda.empty_cache()
    return {"ranks": POD_RANKS, "tiles": n_tiles, "batch": POD_BATCH, "one_rank": {"tiles": one.tiles,
            "batches": one.batches, "rows": len(want)}, "per_rank": ranks, "rows_equal": rows,
            "resume": {"lost_chunk_tiles": len(lost), "per_rank": resumed, "rows_equal": rows_resumed},
            "launches": sum(r["launches"] for r in ranks), "launches_resume": sum(r["launches"] for r in resumed),
            "nccl_step_f32_worst_leaf": max(nccl_step[p]["worst_leaf_share"] for p in ("params", "ema", "opt_momentum")),
            "seconds": time.perf_counter() - t_phase}


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
# cli.evaluate's folds (the reference uses 5): the full grid is swept on
# every fold, and each fold adds ~1.5 s of host work (the subsets, the
# match matrix) and a sweep; 2 folds keep each check (rows of both
# splits, the held-out table) at the least depth that has a fold to hold
# out against another
EVAL_FOLDS = 2
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
    combinations, EVAL_FOLDS folds, seed 1): the fold rows, the held-out table, and
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
                                                "--out", os.path.join(d, "folds.csv"), "--folds", str(EVAL_FOLDS)])
    finally:
        kfold._sweep, kfold._match_matrix = real_sweep, real_match
    if len(res) != 2 * EVAL_FOLDS or len(sweep_s) != EVAL_FOLDS or len(match_s) != EVAL_FOLDS:
        fail(f"cli.evaluate: {len(res)} fold rows and {len(sweep_s)} sweeps for {EVAL_FOLDS} folds")
    num = res[[c for c in res.columns if c != "metric"]].to_numpy(np.float64)
    if not np.isfinite(num).all() or test.shape != (2, 2) or not np.isfinite(test.to_numpy()).all():
        fail(f"cli.evaluate: non-finite fold rows or held-out table:\n{res}\n{test}")
    return test, {"grid": f"GridConfig() 82 x 8 x 10 = 6,560, {EVAL_FOLDS} folds, seed 1", "sweep_s_per_fold": sweep_s,
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


# The tonnage world (phase 10): the evaluation world's detections and labels
# with an image box for each tile and survey year, the download boxes they
# were tiled from, a bathymetry GeoTIFF, the factor workbook, FAO
# production and Trujillo points, all from a numpy seed. EVAL_YEARS put
# 2000 and 2003 inside the 2000-2004 pass and 2006 and 2009 inside
# 2005-2009, so tiles imaged in both years overlap; on half of them the
# later year's image is cut by whitespace, so that the min and max
# selections differ.
TONNAGE_FAO_YEARS = range(2000, 2021)
# the world's cut: its westmost 0.25 degrees of longitude (of 4.5), so that
# cli.facilities' host work (a dedup and a clustering per selection, exact
# intersection areas in EPSG:3035) fits the phase twice, card and CPU
TONNAGE_LON_MAX = 3.25
TONNAGE_K_CLI, TONNAGE_K_CPU = 10_000, 2_000
# the bootstrap at the paper's scale: cage pairs, facilities, passes, draws
LATTICE_N, LATTICE_M, LATTICE_PASSES, LATTICE_K = 16_384, 512, 6, 10_000


def _xml_text(v) -> str:
    return str(v).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def write_xlsx(path: str, sheets: dict) -> None:
    """A minimal .xlsx (zip + XML) of {sheet name: DataFrame}: a header row
    of inline strings, then numbers as numbers and everything else as
    inline strings, the layout ``utils.xlsx.read_xlsx`` reads."""
    import zipfile

    def col(i):
        name = ""
        i += 1
        while i:
            i, r = divmod(i - 1, 26)
            name = chr(65 + r) + name
        return name

    def cell(ref, v):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return f'<c r="{ref}"><v>{v!r}</v></c>' if np.isfinite(v) else ""
        return f'<c r="{ref}" t="inlineStr"><is><t>{_xml_text(v)}</t></is></c>'

    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    rel_ns = 'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships"'
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        entries = "".join(f'<sheet name="{_xml_text(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
                          for i, n in enumerate(sheets))
        z.writestr("xl/workbook.xml", f"<workbook {ns} {rel_ns}><sheets>{entries}</sheets></workbook>")
        rels = "".join(f'<Relationship Id="rId{i + 1}" Type="http://schemas.openxmlformats.org/officeDocument/'
                       f'2006/relationships/worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
                       for i in range(len(sheets)))
        z.writestr("xl/_rels/workbook.xml.rels",
                   f'<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
                   f"{rels}</Relationships>")
        for i, df in enumerate(sheets.values()):
            rows = [list(df.columns)] + df.values.tolist()
            xml = "".join(f'<row r="{r + 1}">' + "".join(cell(f"{col(c)}{r + 1}", v) for c, v in enumerate(row))
                          + "</row>" for r, row in enumerate(rows))
            z.writestr(f"xl/worksheets/sheet{i + 1}.xml", f"<worksheet {ns}><sheetData>{xml}</sheetData></worksheet>")


def write_factor_inputs(d: str, seed: int = 0) -> tuple:
    """(factors.xlsx, fao.csv): the production-factor workbook in the
    reference's layout (sheet "Production Factors": species, factor type,
    factor and its range; stocking density in kg/m3, harvest frequency in
    months between harvests) and FAO French-Mediterranean production in the
    FishStat export's columns ("[YYYY]" quantities, "S" status columns),
    2000-2020, from a numpy seed."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    factors = pd.DataFrame({
        "Species": ["Seabass", "Seabream", "Meagre"] * 2,
        "Factor Type": ["Stocking density"] * 3 + ["Harvest frequency"] * 3,
        "Factor": [20.0, 15.0, 12.0, 20.0, 18.0, 24.0],
        "Range (lower)": [5.0, 5.0, 5.0, 14.0, 12.0, 18.0],
        "Range (upper)": [25.0, 20.0, 18.0, 24.0, 22.0, 30.0],
        "Unit": ["kg/m3"] * 3 + ["months"] * 3,
    })
    species = ("European seabass", "Gilthead seabream", "Meagre", "Marine fishes nei", "Mussels nei")
    fao = pd.DataFrame({"Country (Name)": "France", "FAO major fishing area (Name)": "Mediterranean and Black Sea",
                        "Environment (Name)": "Marine", "ASFIS species (Name)": list(species),
                        "Unit (Name)": "Tonnes - live weight", "Unit": "t"})
    for i, y in enumerate(TONNAGE_FAO_YEARS):
        fao[f"[{y}]"] = np.round(rng.uniform(200, 4000, len(species)), 1)
        fao["S" if i == 0 else f"S.{i}"] = ""
    paths = os.path.join(d, "factors.xlsx"), os.path.join(d, "fao.csv")
    write_xlsx(paths[0], {"Production Factors": factors})
    fao.to_csv(paths[1], index=False)
    return paths


def write_tonnage_world(d: str, seed: int = 0, world: tuple = None, lon_max: float = TONNAGE_LON_MAX) -> dict:
    """The inputs of cli.facilities and cli.tonnage on the evaluation world
    (``world``: write_evaluation_world's paths, written here if None), cut
    to its detections and labels west of ``lon_max``: those with their
    images renamed onto the download boxes that hold them (numbered in
    order, as wanted_bboxes.csv numbers them), the labels as cage types
    with the pixel and meter columns the error fit reads, one image box per
    tile and year, the boxes' CSV, a bathymetry GeoTIFF over the coast, the
    factor inputs and 12 Trujillo points at facility sites."""
    import pandas as pd

    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.data.filenames import TileSpec, decode_tile_name, encode_tile_name
    from aquaculture_tpu_torch.data.geotiff import write_geotiff
    from aquaculture_tpu_torch.geo import crs as C
    from aquaculture_tpu_torch.geo import polygon as P
    from aquaculture_tpu_torch.geo.polygon import centroid_array

    world = world or write_evaluation_world(d, seed)
    det, lab = gf.read_file(world[0]), gf.read_file(world[1])
    rng = np.random.default_rng(seed + 1)
    (x0, x1), (y0, _) = C.transform(4326, 3857, np.array([3.0, 7.5]), np.array([42.3, 43.6]))
    west = float(C.transform(4326, 3857, np.array([lon_max]), np.array([43.0]))[0][0])
    det, lab = (f[f.bounds_array()[:, 2] < west].reset_index(drop=True) for f in (det, lab))
    det.crs = lab.crs = 3857
    width = int((x1 - x0) // (6 * EVAL_TILE_M)) + 1
    specs = {name: decode_tile_name(name) for name in set(det["image"]) | set(lab["image"])}
    old_boxes = sorted({s.bbox_ind for s in specs.values()})
    new_ind = {b: i for i, b in enumerate(old_boxes)}
    renamed = {n: encode_tile_name(TileSpec(s.year, new_ind[s.bbox_ind], s.x_offset, s.y_offset))
               for n, s in specs.items()}
    box_m = 6 * EVAL_TILE_M

    def corner(b):
        return x0 + (b % width) * box_m, y0 + (b // width) * box_m

    det["image"] = det["image"].map(renamed)
    lab["image"] = lab["image"].map(renamed)
    lab["type"] = lab["type"].map({"circle_farm": "circle_cage", "square_farm": "square_cage",
                                   "rectangle_farm": "square_cage"})
    lab3035 = lab.to_crs(3035).bounds_array()
    for i, c in enumerate(("xmin_m", "ymin_m", "xmax_m", "ymax_m")):
        lab[c] = lab3035[:, i]
    lab["xmin"], lab["ymin"], lab["xmax"], lab["ymax"] = 100, 100, 160, 160

    tiles = sorted({(s.bbox_ind, s.x_offset, s.y_offset, s.year) for s in map(decode_tile_name, set(det["image"]))})
    boxes, recs = [], {"bbox_ind": [], "x_offset": [], "y_offset": [], "year": [], "image_file": []}
    cut = rng.random(len(tiles)) < 0.5
    for (b, xo, yo, year), c in zip(tiles, cut):
        bx, by = corner(old_boxes[b])
        tx, ty = bx + xo / 1024 * EVAL_TILE_M, by + yo / 1024 * EVAL_TILE_M
        right = tx + (0.6 if c and year in (2003, 2009) else 1.0) * EVAL_TILE_M
        boxes.append(P.box(tx, ty, right, ty + EVAL_TILE_M))
        for k, v in zip(recs, (b, xo, yo, year, encode_tile_name(TileSpec(year, b, xo, yo)))):
            recs[k].append(v)
    image_boxes = gf.GeoFrame(recs, geometry=boxes, crs=3857)

    paths = {"detections": os.path.join(d, "tonnage_detections.geojson"),
             "labels": os.path.join(d, "tonnage_labels.geojson"),
             "image_boxes": os.path.join(d, "image_boxes.geojson"),
             "bboxes": os.path.join(d, "tonnage_bboxes.csv"),
             "bathymetry": os.path.join(d, "bathymetry.tif"),
             "trujillo": os.path.join(d, "trujillo.csv")}
    det.to_file(paths["detections"])
    lab.to_file(paths["labels"])
    image_boxes.to_file(paths["image_boxes"])
    write_boxes_csv(paths["bboxes"], [(*corner(b), corner(b)[0] + box_m, corner(b)[1] + box_m) for b in old_boxes])
    # 0.05 degree cells over lon 3.0-7.5, lat 42.3-43.6, 5-65 m deep
    depth = -(5.0 + 60.0 * rng.random((27, 91))).astype(np.float32)
    write_geotiff(paths["bathymetry"], depth, (3.0 - 0.025, 42.3 - 0.025, 7.5 + 0.025, 43.6 + 0.025), epsg=4326)
    sites = det[det["det_conf"] > 0.9]["geometry"]
    xy = centroid_array(list(sites.iloc[rng.choice(len(sites), 12, replace=False)]))
    lon, lat = C.transform(3857, 4326, xy[:, 0], xy[:, 1])
    pd.DataFrame({"lon": lon, "lat": lat}).to_csv(paths["trujillo"], index=False)
    paths["factors"], paths["fao"] = write_factor_inputs(d, seed)
    paths["counts"] = {"detections": len(det), "labels": len(lab), "image_boxes": len(image_boxes),
                       "download_boxes": len(old_boxes)}
    return paths


def facility_tables(fac) -> dict:
    """An AquaFacility as plain frames (geometries as WKT, lists kept): its
    final facilities, cages and each pass's coverage, for equality checks
    across processes and devices."""
    import pandas as pd

    from aquaculture_tpu_torch.geo import polygon as P
    from aquaculture_tpu_torch.geo.io import to_wkt

    def plain(frame):
        out = pd.DataFrame(frame).copy()
        for c in out.columns:
            if out[c].dtype == object:
                out[c] = [to_wkt(v) if isinstance(v, P.Geometry) else v for v in out[c]]
        return out

    return {"final": plain(fac.final_facilities), "cages": plain(fac.facility_cages),
            **{f"coverage {p}": plain(c) for p, c in fac.annual_coverage.items()}}


def _facilities_argv(paths: dict, out: str, device: str) -> list:
    return ["--detections", paths["detections"], "--image-boxes", paths["image_boxes"], "--out", out,
            "--bathymetry", paths["bathymetry"], "--device", device]


def _tonnage_argv(paths: dict, pkl: str, out: str, k: int, device: str) -> list:
    return ["--facility", pkl, "--labels", paths["labels"], "--detections", paths["detections"],
            "--download-bboxes", paths["bboxes"], "--prod-factors", paths["factors"], "--fao", paths["fao"],
            "--trujillo", paths["trujillo"], "--out", out, "--K", str(k), "--device", device]


def facilities_tonnage_cpu(paths: dict, d: str) -> tuple:
    """Phase 10's CPU reference: cli.facilities and cli.tonnage at
    K = TONNAGE_K_CPU with --device cpu, and their seconds."""
    from aquaculture_tpu_torch.cli import facilities as cli_facilities
    from aquaculture_tpu_torch.cli import tonnage as cli_tonnage

    t0 = time.perf_counter()
    fac = cli_facilities.main(_facilities_argv(paths, os.path.join(d, "facility_cpu.pkl"), "cpu"))
    t1 = time.perf_counter()
    est = cli_tonnage.main(_tonnage_argv(paths, os.path.join(d, "facility_cpu.pkl"), os.path.join(d, "tonnage_cpu.csv"),
                                         TONNAGE_K_CPU, "cpu"))
    return facility_tables(fac), est, t1 - t0, time.perf_counter() - t1


def bootstrap_lattice(seed: int = 0, degenerate: bool = False) -> tuple:
    """(facility frame, predictions, error table, factor table) of a seeded
    bootstrap lattice at the paper's scale: LATTICE_M facilities over the
    LATTICE_PASSES passes, each holding LATTICE_N / LATTICE_M cages (its
    random list 7/8 of them, its min list 3/4, its max list all), so that
    the lattice has LATTICE_N (facility, cage) pairs. ``degenerate``: every
    distribution collapses (circle cages with zero area variance, zero sds,
    one cage list, depth at the 5 m threshold), so that each pass's total
    is a closed form with variance 0."""
    import pandas as pd

    from aquaculture_tpu_torch.tonnage.periods import PASSES

    rng = np.random.default_rng(seed)
    per = LATTICE_N // LATTICE_M
    passes = [name for _, _, name in PASSES[:LATTICE_PASSES]]
    ids = np.arange(LATTICE_N).reshape(LATTICE_M, per)
    fac = pd.DataFrame({"facility_index": np.arange(LATTICE_M),
                        "pass": [passes[i % LATTICE_PASSES] for i in range(LATTICE_M)],
                        "cage_depth": rng.uniform(6, 40, LATTICE_M),
                        "cage_ids": [r[: per * 7 // 8].tolist() for r in ids],
                        "cage_ids_min": [r[: per * 3 // 4].tolist() for r in ids],
                        "cage_ids_max": [r.tolist() for r in ids]})
    types = rng.choice(np.array(["circle_farm", "square_farm"]), LATTICE_N, p=[0.6, 0.4])
    preds = pd.DataFrame({"index": np.arange(LATTICE_N), "type": types, "farm_type": types,
                          "area": rng.uniform(30, 600, LATTICE_N),
                          "area_var": np.where(rng.random(LATTICE_N) < 0.3, 0.0, 25.0)})
    errs = pd.DataFrame({"pass": [p for p in passes for _ in range(2)],
                         "farm_type": ["circle_farm", "square_farm"] * LATTICE_PASSES,
                         "model_error_mean": rng.normal(0, 20, 2 * LATTICE_PASSES),
                         "model_error_sd": rng.uniform(5, 40, 2 * LATTICE_PASSES)})
    pft = pd.DataFrame({"pass": passes, "s_mean": rng.uniform(10, 16, LATTICE_PASSES),
                        "s_sd": rng.uniform(1, 4, LATTICE_PASSES), "h_mean": rng.uniform(0.5, 0.9, LATTICE_PASSES),
                        "h_sd": rng.uniform(0.02, 0.12, LATTICE_PASSES)})
    if degenerate:
        fac["cage_depth"] = 5.0
        fac["cage_ids_min"] = fac["cage_ids_max"] = fac["cage_ids"]
        preds["type"] = preds["farm_type"] = "circle_farm"
        preds["area_var"] = 0.0
        errs["model_error_sd"] = 0.0
        pft["s_sd"] = pft["h_sd"] = 0.0
    return fac, preds, errs, pft


def check_bootstrap_lattice(dev, card: str) -> dict:
    """run_bootstrap on the card at K = LATTICE_K over the paper-scale
    lattice: prepare_bootstrap_inputs' host seconds, the card time (CUDA
    events around the whole call, median of 3 after a warm call), the peak
    memory (torch.cuda.max_memory_allocated over the timed calls, and less
    what was allocated before them: the bootstrap's own), and the
    degenerate lattice against its closed form."""
    import torch

    from aquaculture_tpu_torch.tonnage.bootstrap import prepare_bootstrap_inputs, run_bootstrap

    fac, preds, errs, pft = bootstrap_lattice(0)
    t0 = time.perf_counter()
    inputs = prepare_bootstrap_inputs(fac, preds, errs, pft, "pass")
    prepare_s = time.perf_counter() - t0
    if (len(inputs.cage_fac), len(inputs.cage_depth), len(inputs.periods)) != (LATTICE_N, LATTICE_M, LATTICE_PASSES):
        fail(f"bootstrap lattice: {len(inputs.cage_fac)} pairs, {len(inputs.cage_depth)} facilities")
    args = (inputs, 0, LATTICE_K, 5.0, 0.85)
    first = run_bootstrap(*args, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        est = run_bootstrap(*args, device=dev)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    max_allocated = torch.cuda.max_memory_allocated()
    peak = max_allocated - base
    if not est.equals(first) or not np.isfinite(est.to_numpy()).all() or not (est["tonnage"] > 0).all():
        fail(f"run_bootstrap on the card: repeats differ or non-finite/non-positive:\n{first}\n{est}")

    dfac, dpreds, derrs, dpft = bootstrap_lattice(0, degenerate=True)
    dinp = prepare_bootstrap_inputs(dfac, dpreds, derrs, dpft, "pass")
    dest = run_bootstrap(dinp, 1, LATTICE_K, 5.0, 1.0, device=dev)
    area = (dinp.area_orig + dinp.err_mean) * dinp.in_min
    closed = np.bincount(dinp.fac_period, np.bincount(dinp.cage_fac, area, minlength=LATTICE_M) * 5.0
                         * dinp.s_mean * dinp.h_mean / 1000.0)
    rel = np.abs(dest["tonnage"].to_numpy(np.float64) - closed) / closed
    if rel.max() > 1e-5 or (dest["tonnage_sd"].to_numpy(np.float64) > 1e-5 * closed).any():
        fail(f"degenerate bootstrap on the card != closed form: rel {rel.max():.3g}\n{dest}\n{closed}")
    return {"lattice": {"K": LATTICE_K, "pairs": LATTICE_N, "facilities": LATTICE_M, "passes": LATTICE_PASSES},
            "prepare_host_s": prepare_s, "card_ms": statistics.median(times), "card_ms_runs": times,
            "peak_bytes": int(peak), "max_memory_allocated": int(max_allocated), "base_bytes": int(base),
            "kn_f32_bytes": 4 * LATTICE_K * LATTICE_N,
            "tonnage": est["tonnage"].round(3).tolist(),
            "degenerate_vs_closed_form_max_rel": float(rel.max()),
            "degenerate_max_sd": float(dest["tonnage_sd"].max()), "card": card}


def run_facilities_tonnage_phase(dev, card: str, d: str, world: tuple, cpu_pool) -> dict:
    """Phase 10: cli.facilities then cli.tonnage on the card, on the tonnage
    world cut from the evaluation world, and the same calls with --device
    cpu (cli.tonnage at K = TONNAGE_K_CPU) in ``cpu_pool``, the CPU
    reference worker (imported long before: a worker spawned for this side
    would spend longer importing than the side takes). The facility frames
    must be equal card vs CPU, each pass's tonnage mean within 4 standard
    errors of the CPU's, and a second card run with the same seed
    identical; then the bootstrap at the paper's scale."""
    from aquaculture_tpu_torch.cli import facilities as cli_facilities
    from aquaculture_tpu_torch.cli import tonnage as cli_tonnage
    from aquaculture_tpu_torch.geo import boolean, native_boolean
    from aquaculture_tpu_torch.tonnage.periods import PASSES

    if boolean.sweep_engine() != "c++":
        fail(f"the overlay's default sweep engine is {boolean.sweep_engine()!r}, not 'c++' (AQUAGEO_NO_NATIVE set?)")
    t_phase, at = time.perf_counter(), {}

    def stamp(name):
        at[name] = time.perf_counter() - t_phase

    paths = write_tonnage_world(d, world=world)
    stamp("world")
    cpu_side = cpu_pool.submit(facilities_tonnage_cpu, paths, d)
    pkl = os.path.join(d, "facility_cuda.pkl")
    out = {}
    native_boolean.sweeps = 0
    t0 = time.perf_counter()
    fac = cli_facilities.main(_facilities_argv(paths, pkl, "cuda"))
    fac_s = time.perf_counter() - t0
    cxx_sweeps = native_boolean.sweeps
    stamp("cli_facilities_card")
    # the same run on the Python sweep: equal facility frames
    native_boolean.sweeps = 0
    t0 = time.perf_counter()
    with boolean.using_sweep_engine("python"):
        fac_py = cli_facilities.main(_facilities_argv(paths, os.path.join(d, "facility_python.pkl"), "cuda"))
    fac_py_s = time.perf_counter() - t0
    if cxx_sweeps == 0 or native_boolean.sweeps != 0:
        fail(f"cli.facilities ran {cxx_sweeps} C++ sweeps by default and {native_boolean.sweeps} on the "
             "Python engine (expected > 0 and 0)")
    mine, python = facility_tables(fac), facility_tables(fac_py)
    if list(mine) != list(python) or not all(mine[k].equals(python[k]) for k in python):
        fail(f"cli.facilities on the c++ and python sweep engines differ in "
             f"{[k for k in python if k not in mine or not mine[k].equals(python[k])]}")
    stamp("cli_facilities_python_engine")
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        runs.append(cli_tonnage.main(_tonnage_argv(paths, pkl, os.path.join(d, f"tonnage_cuda{i}.csv"),
                                                   TONNAGE_K_CLI, "cuda")))
        runs.append(time.perf_counter() - t0)
    stamp("cli_tonnage_card_x2")
    tables, est_cpu, fac_cpu_s, ton_cpu_s = cpu_side.result()
    stamp("cpu_reference")
    est, est2 = runs[0], runs[2]
    if list(mine) != list(tables) or not all(mine[k].equals(tables[k]) for k in tables):
        bad = [k for k in tables if k not in mine or not mine[k].equals(tables[k])]
        fail(f"cli.facilities on the card != --device cpu in {bad}")
    if not est.equals(est2):
        fail(f"cli.tonnage twice on the card with one seed gave different tables:\n{est}\n{est2}")
    if list(est.index) != list(est_cpu.index) or len(est) != len(PASSES):
        fail(f"cli.tonnage periods card {list(est.index)} vs CPU {list(est_cpu.index)}")
    se = np.sqrt(est["tonnage_var"].to_numpy(np.float64) / TONNAGE_K_CLI
                 + est_cpu["tonnage_var"].to_numpy(np.float64) / TONNAGE_K_CPU)
    z = np.abs(est["tonnage"].to_numpy(np.float64) - est_cpu["tonnage"].to_numpy(np.float64)) / se
    if not (z < 4).all() or not (est["tonnage"] > 0).all():
        fail(f"cli.tonnage card (K={TONNAGE_K_CLI}) vs CPU (K={TONNAGE_K_CPU}) beyond 4 standard errors "
             f"({z}):\n{est}\n{est_cpu}")
    out["bootstrap_lattice"] = check_bootstrap_lattice(dev, card)
    stamp("lattice")
    final = fac.final_facilities
    out.update({
        "world": {**paths["counts"], "kept_detections": int(len(fac.preds)), "lon_max": TONNAGE_LON_MAX},
        "cli_facilities": {"facilities": int(len(final)), "passes": sorted(set(final["pass"])),
                           "cages": int(len(fac.facility_cages)),
                           "min_max_lists_differ": int(sum(a != b for a, b in
                                                           zip(final["cage_ids_min"], final["cage_ids_max"]))),
                           "cuda_s": fac_s, "cpu_s": fac_cpu_s, "equal_card_vs_cpu": True,
                           "sweep_engine": "c++", "cxx_sweeps": cxx_sweeps, "python_engine_s": fac_py_s,
                           "equal_cxx_vs_python": True},
        "cli_tonnage": {"K_card": TONNAGE_K_CLI, "K_cpu": TONNAGE_K_CPU, "cuda_s": [runs[1], runs[3]],
                        "cpu_s": ton_cpu_s, "repeat_identical": True, "max_z": float(z.max()),
                        "tonnage": est.round(2).to_dict("index")},
        "at_s": at,
    })
    return out


# ---------------------------------------------------------------------------
# 12. acquire_to_map: from the WMS download through the detector to the map
# ---------------------------------------------------------------------------

ACQ_ORIGIN = (560_000.0, 5_330_000.0)  # EPSG:3857 south-west corner, the Var coast
ACQ_YEAR = 2014
ACQ_BOX_M = 1200.0
ACQ_WHITE_BOX = 1          # the server answers all white for this box: the probe calls it blank
ACQ_WHITE_TILE = (2048, 1024)  # box 0's all-white 1024 px tile (x, y offsets)
ACQ_BAND_TILE = (4096, 3072)   # box 0's tile with a white full-height band
ACQ_BAND_COL = 704         # the band: columns 704-1023, whole 16 px JPEG blocks
ACQ_BATCH = 32
ACQ_TILES = 72             # 2 downloads x 36 tiles
ACQ_ASC = """ncols 6
nrows 4
{corner} {x0}
{ycorner} 42.9
cellsize 0.05
NODATA_value -9999
-12 -14 -9999 -20 -25 -30
-10 -13 -15 -18 -22 -28
-8 -9999 -12 -15 -19 -24
-5 -7 -9 -12 -16 -21
"""


class WmsLoopback:
    """A WMS GetMap endpoint on 127.0.0.1, served by a thread of this
    process: ``respond(layer, bbox, size)`` makes each answer's bytes.
    Every request is recorded as (layer, bbox, size); a request whose
    parameter set is not HttpWmsTransport's is refused with 400."""

    PARAMS = {"SERVICE", "VERSION", "REQUEST", "LAYERS", "STYLES", "SRS", "BBOX", "WIDTH", "HEIGHT",
              "FORMAT", "TRANSPARENT", "EXCEPTIONS"}

    def __init__(self, respond):
        import http.server
        import threading
        import urllib.parse

        self.requests = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                q = {k: v[0] for k, v in urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query).items()}
                if set(q) != WmsLoopback.PARAMS or q["REQUEST"] != "GetMap":
                    self.send_error(400, f"not a GetMap request: {sorted(q)}")
                    return
                bbox = tuple(float(v) for v in q["BBOX"].split(","))
                size = int(q["WIDTH"])
                outer.requests.append((q["LAYERS"], bbox, size))
                body = respond(q["LAYERS"], bbox, size)
                self.send_response(200)
                self.send_header("Content-Type", "image/tiff")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/wms"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


@contextlib.contextmanager
def loopback_only():
    """urllib sends nothing through a proxy while this holds: the WMS
    requests of the acquisition phase stay on 127.0.0.1."""
    keys = ("no_proxy", "NO_PROXY")
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ[k] = "127.0.0.1,localhost"
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tiff_bytes(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="TIFF")
    return buf.getvalue()


def sea_image(seed: int, px: int = 6144, white_tile=None, band_tile=None):
    """A ``px`` square RGB sea texture, each 1024 px tile a shifted copy of
    one seeded noise tile; ``white_tile`` (x, y) is painted white, and
    ``band_tile`` gets a white band over its columns ACQ_BAND_COL-1023."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 96, (1024, 1024, 3), dtype=np.uint8) + np.array([20, 60, 90], np.uint8)
    img = np.empty((px, px, 3), np.uint8)
    for k, (y, x) in enumerate((y, x) for y in range(0, px, 1024) for x in range(0, px, 1024)):
        img[y:y + 1024, x:x + 1024] = base + np.uint8(k % 7)
    if white_tile is not None:
        x, y = white_tile
        img[y:y + 1024, x:x + 1024] = 255
    if band_tile is not None:
        x, y = band_tile
        img[y:y + 1024, x + ACQ_BAND_COL:x + 1024] = 255
    return img


def write_acquire_world(d: str) -> dict:
    """The acquisition inputs: the coast polygon (EPSG:3857 GeoJSON) that
    tile_shapefile cuts into 3 download boxes of 1200 m, the coastline
    loops (mainland, one island), country and EEZ as .shp in lon/lat
    (geo/shapefile.py), and two EMODnet-style .asc grids, one
    corner- and one center-registered."""
    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.geo import crs as C
    from aquaculture_tpu_torch.geo import polygon as P
    from aquaculture_tpu_torch.geo.shapefile import write_shapefile

    x0, y0 = ACQ_ORIGIN
    rng = np.random.default_rng(12)
    # the coast strip: bounds (x0, y0, x0 + 3599, y0 + 1199), so 3 x 1 boxes
    xs = np.linspace(x0, x0 + 3 * ACQ_BOX_M - 1, 25)
    top = y0 + rng.uniform(800, 1150, len(xs))
    top[5] = y0 + ACQ_BOX_M - 1
    coast = P.Polygon(np.concatenate([np.stack([xs, top], 1), [[xs[-1], y0], [x0, y0]]], 0))
    paths = {k: os.path.join(d, f) for k, f in (("coast", "coast.geojson"), ("coastline", "coastline.shp"),
                                                  ("country", "country.shp"), ("eez", "eez.shp"))}
    gf.GeoFrame({"name": ["coast"]}, geometry=[coast], crs=3857).to_file(paths["coast"])

    def lonlat(ring):
        ring = np.asarray(ring, np.float64)
        return P.Polygon(np.stack(C.transform(3857, 4326, ring[:, 0], ring[:, 1]), 1))

    # mainland: a jagged shore through the boxes, land to the north
    sx = np.linspace(x0 - 600, x0 + 4200, 33)
    sy = y0 + 950 + rng.uniform(-100, 100, len(sx))
    mainland = np.concatenate([np.stack([sx, sy], 1), [[sx[-1], y0 + 3000], [sx[0], y0 + 3000]]], 0)
    island = [(x0 + 1500, y0 + 300), (x0 + 1700, y0 + 300), (x0 + 1700, y0 + 450), (x0 + 1500, y0 + 450)]
    country = [(x0 - 1000, y0 - 500), (x0 + 5000, y0 - 500), (x0 + 5000, y0 + 3500), (x0 - 1000, y0 + 3500)]
    eez = [(x0 - 1000, y0 - 500), (x0 + 5000, y0 - 500), (x0 + 5000, y0 + 200), (x0 - 1000, y0 + 200)]
    for key, rings in (("coastline", [mainland, island]), ("country", [country]), ("eez", [eez])):
        write_shapefile(paths[key], gf.GeoFrame({"name": [f"{key}{i}" for i in range(len(rings))]},
                                                geometry=[lonlat(r) for r in rings], crs=4326))
    for name, corner, x in (("F4_2022", "xllcorner", 4.9), ("F5_2022", "xllcenter", 5.225)):
        paths[name] = os.path.join(d, f"{name}.asc")
        with open(paths[name], "w") as f:
            f.write(ACQ_ASC.format(corner=corner, x0=x, ycorner=corner.replace("x", "y", 1)))
    return paths


def _box_of(bbox) -> int:
    return int(round((bbox[0] - ACQ_ORIGIN[0]) / ACQ_BOX_M))


def acquire_images(d: str, world: dict) -> dict:
    """Part (a): cli.acquire wms against the loopback WMS (the port's
    HttpWmsTransport, unpatched), run twice; bathymetry on the two .asc
    grids; landfilter on the .shp linework. Returns what the later parts
    read and the checks' numbers."""
    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.acquire.bathymetry import merge_asc_grids, read_asc
    from aquaculture_tpu_torch.acquire.wms import FULL_SIZE, PROBE_SIZE, layer_name
    from aquaculture_tpu_torch.cli import acquire as cli_acquire
    from aquaculture_tpu_torch.data.geotiff import read_geotiff

    t0 = time.perf_counter()

    def answer(box, **kw):
        img = sea_image(box, **kw)
        return {FULL_SIZE: tiff_bytes(img), PROBE_SIZE: tiff_bytes(np.ascontiguousarray(img[::6, ::6]))}

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        made = {0: pool.submit(answer, 0, white_tile=ACQ_WHITE_TILE, band_tile=ACQ_BAND_TILE),
                2: pool.submit(answer, 2)}
        answers = {box: f.result() for box, f in made.items()}
    white = {n: tiff_bytes(np.full((n, n, 3), 255, np.uint8)) for n in (FULL_SIZE, PROBE_SIZE)}
    made_s = time.perf_counter() - t0

    def respond(layer, bbox, size):
        return answers.get(_box_of(bbox), white)[size]

    store = os.path.join(d, "store")
    prefix = "coastal_french_data/tifs"
    boxes_csv = os.path.join(d, "wanted_bboxes.csv")
    argv = ["wms", "--coast", world["coast"], "--years", str(ACQ_YEAR), "--store", store]
    with loopback_only(), WmsLoopback(respond) as wms:
        t0 = time.perf_counter()
        cli_acquire.main([*argv, "--url", wms.url, "--bboxes-out", boxes_csv])
        wms_s = time.perf_counter() - t0
        first = list(wms.requests)
        t0 = time.perf_counter()
        cli_acquire.main([*argv, "--url", wms.url])
        resume_s = time.perf_counter() - t0
        second = wms.requests[len(first):]
    layer = layer_name(ACQ_YEAR)
    stored = sorted(os.listdir(os.path.join(store, prefix)))
    want = [f"{layer}_{b}.tif" for b in (0, 2)]
    full = sorted(_box_of(b) for _, b, s in first if s == FULL_SIZE)
    probes = sorted(_box_of(b) for _, b, s in first if s == PROBE_SIZE)
    if stored != want or full != [0, 2] or probes != [0, 1, 2] or {r[0] for r in first} != {layer}:
        fail(f"aq-acquire wms: stored {stored}, full fetches of boxes {full}, probes {probes}; expected {want}, "
             "2 downloaded and 1 blank of 3 boxes")
    if [s for _, _, s in second] != [PROBE_SIZE] or _box_of(second[0][1]) != ACQ_WHITE_BOX:
        fail(f"aq-acquire wms resumed with requests {[(_box_of(b), s) for _, b, s in second]}; expected only "
             "the blank box's probe")
    for b in (0, 2):
        with open(os.path.join(store, prefix, f"{layer}_{b}.tif"), "rb") as f:
            if f.read() != answers[b][FULL_SIZE]:
                fail(f"aq-acquire wms stored other bytes than the server sent for box {b}")
    # bathymetry: the merged GeoTIFF equals merge_asc_grids of the two grids
    bathy = os.path.join(d, "bathymetry", "EMOD_2022.tif")
    t0 = time.perf_counter()
    cli_acquire.main(["bathymetry", "--out", bathy, "--asc", world["F4_2022"], world["F5_2022"]])
    bathy_s = time.perf_counter() - t0
    merged = merge_asc_grids([read_asc(world["F4_2022"]), read_asc(world["F5_2022"])])
    got = read_geotiff(bathy)
    if not (np.array_equal(got.array, merged.array, equal_nan=True)
            and np.allclose(got.bounds, merged.bounds, rtol=0, atol=1e-9)):
        fail(f"aq-acquire bathymetry: {got.array.shape} over {got.bounds} != merge_asc_grids' "
             f"{merged.array.shape} over {merged.bounds}")
    # the land filter from the .shp linework, country and EEZ
    land = os.path.join(d, "land.geojson")
    t0 = time.perf_counter()
    cli_acquire.main(["landfilter", "--coastline", world["coastline"], "--country", world["country"],
                      "--eez", world["eez"], "--out", land])
    land_s = time.perf_counter() - t0
    kinds = list(gf.read_file(land)["kind"])
    if kinds.count("primary") < 1:
        fail(f"aq-acquire landfilter kept no primary face ({kinds})")
    return {"store": os.path.join(store, prefix), "boxes_csv": boxes_csv, "land": land, "stored": stored,
            "requests": len(first), "resume_requests": len(second),
            "bathymetry_shape": list(got.array.shape), "land_kinds": kinds,
            "seconds": {"server_images": made_s, "wms": wms_s, "wms_resume": resume_s, "bathymetry": bathy_s,
                        "landfilter": land_s}}


def tile_acquired(acq: dict, tile_dir: str) -> float:
    """Part (b), first half: the reference's tiling step (tile_tifs.py:
    1024 px JPEG tiles named by the filename codec). Returns its seconds."""
    from PIL import Image

    from aquaculture_tpu_torch.data.filenames import encode_tile_name
    from aquaculture_tpu_torch.data.geotiff import read_image
    from aquaculture_tpu_torch.data.tiling import split_image, tile_specs_for_image

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        saves = []
        for name in acq["stored"]:
            ind = int(name[:-len(".tif")].rsplit("_", 1)[1])
            tiles, offsets = split_image(read_image(os.path.join(acq["store"], name)))
            specs = tile_specs_for_image(ACQ_YEAR, ind)
            if [(s.x_offset, s.y_offset) for s in specs] != list(offsets):
                fail(f"split_image's offsets differ from tile_specs_for_image's for {name}")
            saves += [pool.submit(Image.fromarray(tile).save, os.path.join(tile_dir, encode_tile_name(spec)),
                                  quality=75) for tile, spec in zip(tiles, specs)]
        for f in saves:
            f.result()
    return time.perf_counter() - t0


def _import_image_boxes() -> None:
    import aquaculture_tpu_torch.data.imageboxes  # noqa: F401


def start_screening_worker() -> tuple:
    """The worker process of phase 12's image-box screening, spawned and
    importing (about as long as phase 12's first parts take) before it is
    needed: (executor, the import's future)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(_import_image_boxes)


def screen_acquired_tiles(boxes_csv: str, tile_dir: str) -> dict:
    """Part (b), second half, in a worker process beside part (c):
    load_final_image_boxes over the tiles, without and then with its cache.
    Returns what check_image_boxes holds."""
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.data.imageboxes import LocalImageStore, load_final_image_boxes

    dl = load_download_bboxes(boxes_csv)
    store = LocalImageStore(tile_dir)
    cache = os.path.dirname(tile_dir)
    t0 = time.perf_counter()
    boxes = load_final_image_boxes(dl, store, cache_dir=cache)
    boxes_s = time.perf_counter() - t0
    cached = load_final_image_boxes(dl, store, cache_dir=cache)
    return {"tiles": len(store.list_images()), "boxes": len(boxes), "cached": len(cached),
            "status": dict(zip(boxes["image_file"], boxes["image_status"])),
            "area": dict(zip(boxes["image_file"], [float(g.area) for g in boxes["geometry"]])), "seconds": boxes_s}


def check_image_boxes(got: dict, tiling_s: float) -> dict:
    """72 tiles -> 71 image boxes (from the screening and from its cache),
    the white tile dropped, the banded one the only partly blank box, its
    area above zero and below the full box's."""
    from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name

    white = encode_tile_name(TileSpec(ACQ_YEAR, 0, *ACQ_WHITE_TILE))
    band = encode_tile_name(TileSpec(ACQ_YEAR, 0, *ACQ_BAND_TILE))
    status = got["status"]
    if got["tiles"] != ACQ_TILES or got["boxes"] != ACQ_TILES - 1 or got["cached"] != got["boxes"] or white in status:
        fail(f"load_final_image_boxes: {got['tiles']} tiles -> {got['boxes']} boxes ({got['cached']} from its "
             f"cache), white tile kept: {white in status}; expected {ACQ_TILES} -> {ACQ_TILES - 1}")
    partly = [f for f, s in status.items() if s == "partly blank"]
    full_area = (ACQ_BOX_M / 6) ** 2
    band_area = got["area"].get(band, 0.0)
    if partly != [band] or not 0 < band_area < full_area:
        fail(f"partly blank tiles {partly} (expected [{band}]); its box's area {band_area} of {full_area}")
    return {"tiles": got["tiles"], "image_boxes": got["boxes"], "partly_blank": partly,
            "band_box_area_m2": band_area, "full_box_area_m2": full_area,
            "seconds": {"tiling": tiling_s, "image_boxes": got["seconds"]}}


@contextlib.contextmanager
def recording_suppression(calls: list):
    """While this holds, each call of the kernel's wrapper appends copies of
    its inputs and its keep mask to ``calls`` (it launches as before)."""
    from aquaculture_tpu_torch.ops import nms_cuda

    real = nms_cuda.greedy_suppress_cuda

    def record(boxes, valid, iou_thresh=0.45):
        keep = real(boxes, valid, iou_thresh)
        calls.append((boxes.clone(), valid.clone(), iou_thresh, keep.clone()))
        return keep

    nms_cuda.greedy_suppress_cuda = record
    try:
        yield
    finally:
        nms_cuda.greedy_suppress_cuda = real


def serve_acquired(d: str, tile_dir: str, acq: dict) -> dict:
    """Part (c): cli.pipeline on the card over the acquired tiles (mt at
    640, random weights from seed 0, conf 1e-5, batch 32) with the
    download boxes and land of part (a), the counters zeroed around it;
    each launch's keep mask against the plain version's on the same
    candidates (the ones this run gave the kernel)."""
    import torch

    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.cli import pipeline as cli_pipeline
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.data.filenames import decode_tile_name
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.ops.nms import greedy_suppress_plain

    out = os.path.join(d, "acquired_detections.geojson")
    calls = []
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    with recording_suppression(calls):
        det, stats = cli_pipeline.main([
            "--source", tile_dir, "--download-bboxes", acq["boxes_csv"], "--land", acq["land"], "--out", out,
            "--variant", "mt", "--batch", str(ACQ_BATCH), "--conf", "1e-5",
        ])
    seconds = time.perf_counter() - t0
    launches = nms_cuda.launches
    n_batches = -(-ACQ_TILES // ACQ_BATCH)
    if not launches == stats.batches == n_batches or stats.tiles != ACQ_TILES:
        fail(f"acquired pipeline: nms_suppress launched {launches} times for {stats.batches} batches of "
             f"{stats.tiles} tiles, expected {n_batches} batches of {ACQ_TILES}")
    rows = stats.stage_rows
    if not len(det) or not rows["land_filter"] < rows["areas"]:
        fail(f"acquired pipeline: {len(det)} rows, land filter {rows}; expected rows and some on land removed")
    dl = load_download_bboxes(acq["boxes_csv"])
    names, row_image = np.unique(det["image"].to_numpy(str), return_inverse=True)
    box = np.asarray([dl["geometry"].iloc[decode_tile_name(n).bbox_ind].bounds for n in names])[row_image]
    b = det.to_crs(3857).bounds_array()
    outside = int(((b[:, :2] < box[:, :2] - 1e-6) | (b[:, 2:] > box[:, 2:] + 1e-6)).any(axis=1).sum())
    on_land = len(det.sjoin(gf.read_file(acq["land"]).to_crs(det.crs), how="inner"))
    if outside or on_land:
        fail(f"acquired pipeline: {outside} rows outside their download boxes, {on_land} on land")
    check_geojson(out, det, n_classes=5)
    if len(calls) != launches:
        fail(f"acquired pipeline: {len(calls)} suppression calls recorded for {launches} launches")
    vs_plain = []
    for boxes, valid, thr, keep in calls:
        if not torch.equal(greedy_suppress_plain(boxes, valid, thr), keep):
            fail(f"acquired pipeline: the kernel's keep mask != the plain version's on {tuple(valid.shape)}")
        vs_plain.append({"B": valid.shape[0], "K": valid.shape[1], "valid_candidates": int(valid.sum()),
                         "kept": int(keep.sum())})
    return {"launches": {"nms_suppress": launches}, "rows": len(det), "outside_boxes": outside, "on_land": on_land,
            "dedup_clipped_rows": clipped_rows(det, acq["boxes_csv"]), "seconds": seconds,
            "loader": stats.loader, "kernel_vs_plain": vs_plain, **_stage_report(stats)}


def figures_on_tonnage(d10: str, d: str, dev) -> dict:
    """Part (d): cli.figures' computations on phase 10's outputs (its
    detections, labels, facility pickle and Trujillo CSV): the clustered
    stage on the card equal to the CPU's, the P/R sweep over 100
    thresholds for the raw and clustered stages, true_positive_facilities
    -> classify_our_facilities, classify_facilities, unique_locations and
    facility_map_html (one point per facility). The plots run where
    matplotlib imports, and are skipped (and said so) where not."""
    import pandas as pd

    from aquaculture_tpu_torch import frame as gf
    from aquaculture_tpu_torch.config import OPTIMAL_DISTANCE_THRESHOLD, OPTIMAL_MIN_CLUSTER_SIZE
    from aquaculture_tpu_torch.eval.kfold import clustered_detections
    from aquaculture_tpu_torch.results import maps
    from aquaculture_tpu_torch.results.performance import plot_precision_recall_curves, stats_at_thresholds
    from aquaculture_tpu_torch.tonnage.facility import load_AquaFacility
    from aquaculture_tpu_torch.tonnage.periods import load_trujillo_locations, map_year_to_image_pass

    at, t0 = {}, time.perf_counter()
    dets = gf.read_file(os.path.join(d10, "tonnage_detections.geojson"))
    labels = gf.read_file(os.path.join(d10, "tonnage_labels.geojson")).to_crs(dets.crs)
    labels["type"] = labels["type"].replace({"circle_cage": "circle_farm", "square_cage": "square_farm"})
    thresholds = np.linspace(0, 1, 100)
    all_stats = stats_at_thresholds(labels, dets, thresholds)
    at["stats_raw"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clustered = clustered_detections(dets, 0.0, OPTIMAL_DISTANCE_THRESHOLD, OPTIMAL_MIN_CLUSTER_SIZE, device=dev)
    at["clustered_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clustered_cpu = clustered_detections(dets, 0.0, OPTIMAL_DISTANCE_THRESHOLD, OPTIMAL_MIN_CLUSTER_SIZE,
                                         device="cpu")
    at["clustered_cpu"] = time.perf_counter() - t0
    if not (len(clustered) and list(clustered.index) == list(clustered_cpu.index)
            and pd.DataFrame(clustered).drop(columns="geometry").equals(
                pd.DataFrame(clustered_cpu).drop(columns="geometry"))):
        fail(f"clustered_detections on the card ({len(clustered)} rows) != on the CPU ({len(clustered_cpu)})")
    t0 = time.perf_counter()
    cluster_stats = stats_at_thresholds(labels, clustered, thresholds)
    at["stats_clustered"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = load_AquaFacility(os.path.join(d10, "facility_cuda.pkl")).final_facilities
    tru = load_trujillo_locations(os.path.join(d10, "trujillo.csv"))
    tp = maps.true_positive_facilities(fac, labels.to_crs(fac.crs or 3857), map_year_to_image_pass)
    combined = maps.classify_our_facilities(tp, maps.trujillo_1km_boxes(tru, box_crs=3035), tru)
    tagged = maps.classify_facilities(fac, maps.trujillo_1km_boxes(tru))
    unique = maps.unique_locations(tagged)
    html = os.path.join(d, "facility_map.html")
    maps.facility_map_html(tagged, html)
    at["classify_and_html"] = time.perf_counter() - t0
    with open(html) as f:
        text = f.read()
    points = json.loads(text.split("const data = ", 1)[1].split(";\n", 1)[0])
    if len(all_stats) != len(thresholds) or len(cluster_stats) != len(thresholds):
        fail(f"stats_at_thresholds gave {len(all_stats)} / {len(cluster_stats)} rows for {len(thresholds)}")
    if not (len(tp) and len(combined) and len(tagged)) or not 0 < unique <= len(tagged):
        fail(f"figures: {len(tp)} true-positive facilities, {len(combined)} classified rows, {len(tagged)} "
             f"tagged facilities, {unique} unique locations")
    if len(points) != len(tagged):
        fail(f"facility_map_html holds {len(points)} points for {len(tagged)} facilities")
    plots = {}
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        plots["skipped"] = {"calls": ["plot_precision_recall_curves", "plot_combined_map", "plot_facility_map"],
                            "why": f"no matplotlib on this machine ({e})"}
    else:
        t0 = time.perf_counter()
        plot_precision_recall_curves(all_stats, None, cluster_stats, out_path=os.path.join(d, "pr.pdf"))
        maps.plot_combined_map(combined, out_path=os.path.join(d, "facilities.pdf"))
        maps.plot_facility_map(tagged, trujillo=tru, out_path=os.path.join(d, "facility_map.png"))
        plots["drawn"] = ["pr.pdf", "facilities.pdf", "facility_map.png"]
        at["plots"] = time.perf_counter() - t0
    return {"detections": len(dets), "labels": len(labels), "clustered": len(clustered),
            "equal_card_vs_cpu": True, "thresholds": len(thresholds),
            "true_positive_facilities": len(tp), "classified_rows": len(combined),
            "types": combined["type"].value_counts().to_dict(), "facilities": len(tagged),
            "known": int((tagged["status"] == "known").sum()), "unique_locations": unique,
            "html_points": len(points), "plots": plots, "seconds": at}


def run_acquire_to_map_phase(dev, card: str, d: str, d10: str, screening_worker: tuple) -> dict:
    """Phase 12: acquisition (a), the reference's tiling step (b), serving
    the acquired tiles on the card (c), and the figures on phase 10's
    outputs (d), each part's seconds beside. (b)'s image-box screening is
    host work that (c) does not read: it runs in ``screening_worker``
    (start_screening_worker's, shut down here) while (c) serves, and is
    checked after."""
    world_dir, tile_dir = os.path.join(d, "inputs"), os.path.join(d, "tiles")
    os.makedirs(world_dir)
    os.makedirs(tile_dir)
    t_phase = time.perf_counter()
    pool, warm = screening_worker
    with pool:
        world = write_acquire_world(world_dir)
        seconds = {"world": time.perf_counter() - t_phase}
        t0 = time.perf_counter()
        acquire = acquire_images(d, world)
        seconds["acquire"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiling_s = tile_acquired(acquire, tile_dir)
        screening = pool.submit(screen_acquired_tiles, acquire["boxes_csv"], tile_dir)
        seconds["tiling"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline = serve_acquired(d, tile_dir, acquire)
        seconds["pipeline"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm.result()
        tiling = check_image_boxes(screening.result(), tiling_s)
        seconds["image_boxes_wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    figures = figures_on_tonnage(d10, d, dev)
    seconds["figures"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_phase
    for k in ("store", "boxes_csv", "land"):
        acquire.pop(k)
    return {"acquire": acquire, "tiling": tiling, "pipeline": pipeline, "figures": figures,
            "seconds_by_part": seconds, "card": card}


# ---------------------------------------------------------------------------
# phase 13: the feed (the device tile loader)
# ---------------------------------------------------------------------------

FEED_BATCH = 128
FEED_DISTINCT = 32   # written tiles, reused under many tile-codec names
FEED_PATHS = 1024    # 8 batches of 128 per timed device-loader run
FEED_PY_PATHS = 384  # 3 batches per timed Python-loader run (4x slower)
FEED_HOST_FILES = 16  # host decode timing: files per thread
FEED_ROWS_TILES = 16
# (name, (height, width), PIL save options, "gray", "440" or "411" for
# 4:4:0 or 4:1:1 through OpenCV, or "fixture": a file of FEED_FIXTURES): the
# samplings, qualities, partial MCUs, restart intervals, a progressive file,
# a raster of 2 x 2 tiles, an RGB-coded file, luma sampled 4x1, 3x1 and 1x4,
# arithmetic coding, and interrupted progressive files (smoothed)
FEED_CASES = (
    ("q75_420", (1024, 1024), dict(quality=75)),
    ("q90_420", (1024, 1024), dict(quality=90)),
    ("q95_420", (1024, 1024), dict(quality=95)),
    ("q90_444", (1024, 1024), dict(quality=90, subsampling=0)),
    ("q90_422", (1024, 1024), dict(quality=90, subsampling=1)),
    ("q90_440", (1024, 1024), "440"),
    ("gray", (1024, 1024), "gray"),
    ("1000x750", (750, 1000), dict(quality=90)),
    ("restart", (1024, 1024), dict(quality=90, restart_marker_blocks=7)),
    ("progressive", (1024, 1024), dict(quality=90, progressive=True)),
    ("raster_2048", (2048, 2048), dict(quality=90)),
    ("rgb", (1024, 1024), dict(quality=90, keep_rgb=True)),
    ("q90_411", (1024, 1024), "411"),
    ("luma31", (256, 384), "fixture"),
    ("luma14", (256, 384), "fixture"),
    ("arith_restart", (256, 384), "fixture"),
    ("arith_progressive", (256, 384), "fixture"),
    ("interrupted", (256, 384), "fixture"),
    ("interrupted_ac", (256, 384), "fixture"),
    ("dc_only", (256, 384), "fixture"),
)
# Files this machine has no libjpeg to write: tests/data/torch_jpeg/, as
# tests/torch_jax_native.py's write_feed_fixtures wrote them (libjpeg-turbo
# 2.1.5's encoder; 384 x 256, quality 90): arithmetic sequential with a
# restart every MCU row and progressive, progressive files whose scans stop
# short of the last bits of the DC and AC, of the AC alone, or after the DC
# scan, and luma sampled 3x1 and 1x4
FEED_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "torch_jpeg")
# the cases PIL's libjpeg-turbo decodes otherwise than the JAX package's
# 2.1.5: 3.x smooths interrupted progressive files with another filter
PIL_DIFFERS = ("interrupted", "interrupted_ac", "dc_only")
# the scales besides 8/8 and 5/8: libjpeg's 1x1, 2x2, 3x3, 4x4, 6x6 and
# 7x7 IDCTs, and 4:2:0 chroma through the 4x4 .. 14x14
OTHER_SCALES = (1, 2, 3, 4, 6, 7)
FEED_SCALE_IMG = 512  # the file-fed detect_files run at 4/8


def aerial_image(rng, h: int, w: int) -> np.ndarray:
    """A seeded stand-in for an aerial tile: a smooth field (bilinear up
    from a coarse grid), fine texture and a few bright rectangles, so that
    it compresses as imagery does (a noise tile would not)."""
    from PIL import Image

    coarse = rng.integers(0, 255, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    img = img + rng.integers(-10, 11, (h, w, 3), dtype=np.int16)
    for _ in range(6):
        x, y = rng.integers(0, w - 124), rng.integers(0, h - 124)
        img[y:y + rng.integers(30, 120), x:x + rng.integers(30, 120)] = rng.integers(150, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_feed_files(d: str) -> tuple:
    """The exactness cases and the corpus: FEED_DISTINCT q90 4:2:0 1024 px
    tiles, linked under FEED_PATHS tile-codec names (6 x 6 tiles a box)."""
    from PIL import Image

    from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name

    rng = np.random.default_rng(13)
    cases = {}
    for name, (h, w), kw in FEED_CASES:
        p = os.path.join(d, f"case_{name}.jpg")
        if kw == "fixture":
            cases[name] = os.path.join(FEED_FIXTURES, f"{name}.jpg")
            continue
        img = aerial_image(rng, h, w)
        if kw == "gray":
            Image.fromarray(img[..., 1]).save(p, quality=90)
        elif kw in ("440", "411"):
            import cv2

            factor = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440 if kw == "440" else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411
            cv2.imwrite(p, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        else:
            Image.fromarray(img).save(p, **kw)
        cases[name] = p
    distinct = [os.path.join(d, f"distinct_{i}.jpg") for i in range(FEED_DISTINCT)]

    def write(i: int) -> None:
        img = aerial_image(np.random.default_rng(1300 + i), 1024, 1024)
        Image.fromarray(img).save(distinct[i], quality=90)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(FEED_DISTINCT)))
    corpus = os.path.join(d, "corpus")
    os.makedirs(corpus)
    paths = []
    for i in range(FEED_PATHS):
        spec = TileSpec(year=2014, bbox_ind=i // 36, x_offset=1024 * (i % 6), y_offset=1024 * (i // 6 % 6))
        p = os.path.join(corpus, encode_tile_name(spec, "jpg"))
        os.symlink(distinct[i % FEED_DISTINCT], p)
        paths.append(p)
    return cases, distinct, paths


def jpeg_batch(images: list, eff: int, dev):
    """One kernel batch of entropy-decoded ``images`` on the card: the
    coefficients, the descriptors, the layout and the slot shape (each
    image's tile grid at ``eff``, or the whole of the one image at 0), plus
    a zero slot."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_plain as jp

    offs, o = [], 0
    for im in images:
        offs.append(o)
        o += im.coef.numel()
    tiles = []
    for i, im in enumerate(images):
        grid = jp.tile_grid(im.out_width, im.out_height, eff) if eff else [(0, 0)]
        tiles += [(jp.TILE_DECODED, i, x, y) for x, y in grid]
    tiles.append((jp.TILE_ZERO, 0, 0, 0))
    packed, lay = jp.describe_batch([im.meta for im in images], offs, tiles)
    desc = jp.unpack_batch(torch.from_numpy(packed).to(dev), lay)
    coef = torch.cat([im.coef for im in images]).to(dev)
    shape = (eff, eff) if eff else (images[0].out_height, images[0].out_width)
    return coef, desc, lay, (len(tiles), *shape, 3)


def jpeg_kernel_vs_plain(images: list, eff: int, dev, what: str) -> dict:
    """The fused kernel on one batch against its plain version on the same
    card tensors, torch.equal, or the run fails."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain as jp

    coef, (qt, comps, imgs, tiles), lay, shape = jpeg_batch(images, eff, dev)
    out = jpeg_cuda.jpeg_decode(coef, qt, comps, imgs, tiles, torch.full(shape, 7, dtype=torch.uint8, device=dev),
                                lay)
    want = jp.decode_batch_plain(coef, qt, comps, imgs, tiles, torch.full_like(out, 7))
    if not torch.equal(out, want):
        fail(f"jpeg_decode != plain on {what}: {int((out != want).sum())} bytes differ")
    torch.cuda.synchronize()
    return {"slots": shape[0], "out": out}


def entropy_decode_all(paths: list, scale: int) -> list:
    """The host half for many files at once (the decoder's ctypes calls
    release the GIL)."""
    from aquaculture_tpu_torch.data import native_loader

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda p: native_loader.entropy_decode(p, scale), paths))


def check_jpeg_exactness(cases: dict, dev) -> dict:
    """Every case at 8/8 and 5/8, alone (the whole image) and all in one
    batch on their tile grids, and the 2048 px raster at 5/8 in 625 px
    tiles, kernel == plain; at 8/8 the card's whole image also equals
    PIL's decode on this host, byte for byte, but for PIL_DIFFERS. At each
    of OTHER_SCALES the cases but the 2048 px raster in one batch on their
    grids of 128 N px tiles, kernel == plain."""
    from PIL import Image, features

    out = {"pil_libjpeg_turbo": features.version("libjpeg_turbo"), "pil_not_compared": list(PIL_DIFFERS)}
    for scale, eff in ((8, 1024), (5, 640)):
        images = dict(zip(cases, entropy_decode_all(list(cases.values()), scale)))
        for name, im in images.items():
            if im is None:
                fail(f"the entropy decoder refused case {name}")
            got = jpeg_kernel_vs_plain([im], 0, dev, f"{name} at {scale}/8")["out"][0]
            if scale == 8 and name not in PIL_DIFFERS:
                pil = np.asarray(Image.open(cases[name]).convert("RGB"))
                if got.shape != pil.shape or not np.array_equal(got.cpu().numpy(), pil):
                    fail(f"the card's 8/8 decode of {name} != PIL's")
        batch = jpeg_kernel_vs_plain(list(images.values()), eff, dev, f"all cases at {scale}/8 on the grid")
        out[f"{scale}/8"] = {"cases": len(images), "slots": batch["slots"], "kernel_equals_plain": True,
                             "equal_pil": len(images) - len(PIL_DIFFERS) if scale == 8 else 0}
        if scale == 5:
            # 1000 px tiles at 5/8: stripes start 3 past a 10x10 chroma
            # block (625 + 128), the widest ring row
            odd = jpeg_kernel_vs_plain([images["raster_2048"]], 625, dev, "raster_2048 at 5/8 in 625 px tiles")
            out["5/8"]["odd_origin_slots"] = odd["slots"]
    names = [n for n in cases if n != "raster_2048"]
    for scale in OTHER_SCALES:
        images = entropy_decode_all([cases[n] for n in names], scale)
        if any(im is None for im in images):
            fail(f"the entropy decoder refused a case at {scale}/8")
        batch = jpeg_kernel_vs_plain(images, 128 * scale, dev, f"the cases at {scale}/8 on the grid")
        out[f"{scale}/8"] = {"cases": len(images), "slots": batch["slots"], "kernel_equals_plain": True,
                             "equal_pil": 0}
    return out


def write_refused_jpegs(d: str) -> list:
    """JPEGs that libjpeg-turbo 2.1.5 refuses: an 8 x 8 flat grey file at
    12 bits (SOF1) and one lossless (SOF3), written byte by byte, every
    difference coded as category 0 by a one-code Huffman table; and a CMYK
    one through PIL."""
    import struct

    from PIL import Image

    def seg(m: int, body: bytes) -> bytes:
        return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body

    dc = seg(0xC4, bytes([0x00, 1] + [0] * 15 + [0]))
    p12 = (seg(0xDB, bytes([0] + [1] * 64)) + dc + seg(0xC4, bytes([0x10, 1] + [0] * 15 + [0])) +
           seg(0xC1, bytes([12]) + struct.pack(">HH", 8, 8) + bytes([1, 1, 0x11, 0])) +
           seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0])) + b"\x00")
    lossless = (dc + seg(0xC3, bytes([8]) + struct.pack(">HH", 8, 8) + bytes([1, 1, 0x11, 0])) +
                seg(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + b"\x00" * 8)
    paths = []
    for i, body in enumerate((p12, lossless)):
        paths.append(os.path.join(d, f"refused_{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(b"\xff\xd8" + body + b"\xff\xd9")
    paths.append(os.path.join(d, "refused_cmyk.jpg"))
    cmyk = aerial_image(np.random.default_rng(14), 256, 256)
    Image.fromarray(np.concatenate([cmyk, cmyk[..., :1]], -1), "CMYK").save(paths[-1], quality=90)
    return paths


def check_feed_routing(dev, d: str, distinct: list) -> dict:
    """native_tile_batches on the card over a corpus of 3 good 1024 px
    tiles, a TIFF and the JPEGs libjpeg refuses (12-bit, lossless, CMYK):
    no exception, 3 skipped, the TIFF through the TIFF reader (PIL's
    resize at 5/8), the good tiles and the TIFF served, equal to the
    loader's plain path on the CPU; at 5/8 too."""
    import torch
    from PIL import Image

    from aquaculture_tpu_torch.data import native_loader

    tiff = os.path.join(d, "routing.tif")
    Image.fromarray(aerial_image(np.random.default_rng(15), 1024, 1024)).save(tiff)
    paths = [distinct[0], *write_refused_jpegs(d), distinct[1], tiff, distinct[2]]
    out = {"files": len(paths)}
    for out_tile in (0, 640):
        counts, cpu_counts = {}, {}
        card = list(native_loader.native_tile_batches(paths, batch_size=4, out_tile=out_tile, device=dev,
                                                      counts=counts))
        cpu = list(native_loader.native_tile_batches(paths, batch_size=4, out_tile=out_tile, device="cpu",
                                                     counts=cpu_counts))
        want = {"device": 3, "tiff": 0 if out_tile else 1, "tiff_jpeg": 0, "pil": 0,
                "pil_resize": 1 if out_tile else 0, "skipped": 3}
        if counts != want or cpu_counts != want:
            fail(f"routing at out_tile {out_tile}: counts {counts} (CPU {cpu_counts}), expected {want}")
        valid = [b.valid.tolist() for b in card]
        if valid != [[True] * 4] or valid != [b.valid.tolist() for b in cpu] or not all(
                torch.equal(a.images.cpu(), b.images) for a, b in zip(card, cpu)):
            fail(f"routing at out_tile {out_tile}: tiles on the card != the plain path's (valid {valid})")
        out[f"out_tile_{out_tile}"] = {"counts": counts, "valid": valid}
    return out


# The TIFF corpus (csrc/tiff_decode.cc): a 6144 px uncompressed RGB
# download as aq-acquire wms stores it, and smaller files in the reader's
# other routes: LZW with Predictor 2, Deflate and a BigTIFF (2048 px, PIL),
# JPEG tiled at 256 with JPEGTables and JPEG in strips through libtiff (PIL;
# 1024 px: their plain decode on the CPU is the slow half of the check),
# and WebP (compression 50001, csrc/webp_decode.cc; segments from PIL's
# WebP encoder): lossy RGB tiled at 512 (2048 px, GDAL's COMPRESS=WEBP
# layout), lossless in strips of 128 rows and lossy RGBA with unassociated
# alpha in strips of 256 (1024 px)
TIFF_CASES = {"wms_6144": "tiff", "lzw_predictor_2048": "tiff", "deflate_2048": "tiff", "bigtiff_2048": "tiff",
              "jpeg_tiles_256": "tiff_jpeg", "jpeg_strips": "tiff_jpeg", "webp_lossy_tiles_2048": "tiff",
              "webp_lossless_strips_1024": "tiff", "webp_rgba_1024": "tiff"}
WEBP_HOST_CASES = ("webp_lossy_tiles_2048", "webp_lossless_strips_1024")
TIFF_PASSES = 5  # the corpus linked 5 times over for its tiles/s (250 tiles of 1024 px)
# Files of the codecs a host without libtiff, libLerc or jbigkit cannot
# write: tests/data/torch_tiff/, as tests/torch_tiff_writer.py's
# write_legacy_fixtures wrote them (NeXT, ThunderScan, PixarLog at 8 and 16
# bits, LogL, LogLuv, LogLuv24, JBIG from libtiff's encoder and from
# jbigkit's with AT moves and SDRST, LERC bare, in Deflate and in ZSTD,
# ZSTD, and associated alpha and CMYK in LZMA and JPEG, which stay on the
# PIL route), and pixels.json: the route and the sha256 of libtiff 4.5.0's
# RGB pixels of each
LEGACY_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "torch_tiff")


def tiff_writer():
    """tests/torch_tiff_writer.py, loaded from its path: a ``tests``
    package installed on a machine would shadow the directory."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_tiff_writer.py")
    spec = importlib.util.spec_from_file_location("torch_tiff_writer", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_tiff_corpus(d: str) -> dict:
    """TIFF_CASES' files under d: name -> path."""
    from PIL import Image

    writer = tiff_writer()

    paths = {name: os.path.join(d, f"tiff_{name}.tif") for name in TIFF_CASES}
    with open(paths["wms_6144"], "wb") as f:
        f.write(tiff_bytes(sea_image(17)))
    small = aerial_image(np.random.default_rng(18), 2048, 2048)
    Image.fromarray(small).save(paths["lzw_predictor_2048"], compression="tiff_lzw", tiffinfo={317: 2})
    Image.fromarray(small).save(paths["deflate_2048"], compression="tiff_adobe_deflate")
    Image.fromarray(small).save(paths["bigtiff_2048"], big_tiff=True)
    segs, tables = writer.jpeg_tiles(small[:1024, :1024], 256, 256, "YCbCr")
    tags = {256: (3, [1024]), 257: (3, [1024]), 258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 322: (3, [256]), 323: (3, [256]), 347: (7, list(tables)),
            530: (3, [2, 2])}
    with open(paths["jpeg_tiles_256"], "wb") as f:
        f.write(writer.tiff_bytes(segs, tags, tiled=True))
    Image.fromarray(small[1024:, 1024:]).save(paths["jpeg_strips"], compression="jpeg", quality=90)
    webp = {"webp_lossy_tiles_2048": (small, dict(quality=80), dict(tile=(512, 512))),
            "webp_lossless_strips_1024": (small[:1024, 1024:], dict(lossless=True, method=1), dict(rps=128)),
            "webp_rgba_1024": (np.dstack([small[1024:, :1024], np.flipud(small[1024:, :1024, 1])]),
                               dict(quality=75), dict(rps=256))}
    for name, (img, enc, lay) in webp.items():
        segs, tags = writer.webp_layout(np.ascontiguousarray(img), lambda b, enc=enc: writer.webp_pil(
            np.ascontiguousarray(b), **enc), **lay)
        with open(paths[name], "wb") as f:
            f.write(writer.tiff_bytes(segs, tags, tiled="tile" in lay))
    return paths


def start_tiff_corpus(d: str) -> tuple:
    """write_tiff_corpus(d) in a spawned process of its own, started with
    the builds, so that the feed phase finds the corpus written: (executor,
    future of name -> path)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(write_tiff_corpus, d)


def tiff_jpeg_kernel(path: str, dev, rate: float, card: str) -> dict:
    """One JPEG-compressed TIFF's segments as the loader decodes them (one
    launch, a slot per strip or tile): the kernel == its plain version on
    the same card tensors, timed (CUDA events, 10 launches a window) beside
    its bound and the plain version's one call."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain as jp, native_loader

    meta, metas, coef = native_loader.tiff_segments(path)
    decoded, offs, tiles = native_loader.segment_slots(metas)
    images = [jp.EntropyImage(metas[s], coef[o:o + metas[s][jp.M_COEFS]]) for s, o in zip(decoded, offs)]
    packed, lay = jp.describe_batch([metas[s] for s in decoded], offs, tiles)
    qt, comps, imgs, tl = jp.unpack_batch(torch.from_numpy(packed).to(dev), lay)
    coef_d = coef.to(dev)
    shape = (len(tiles), int(meta[jp.T_SEG_H]), int(meta[jp.T_SEG_W]), 3)
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    ms = time_cuda(lambda: jpeg_cuda.jpeg_decode(coef_d, qt, comps, imgs, tl, out, lay), iters=10)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = jp.decode_batch_plain(coef_d, qt, comps, imgs, tl, torch.empty_like(out))
    end.record()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        fail(f"jpeg_decode != plain on the segments of {os.path.basename(path)}")
    bound = jpeg_bound_ms(images, tl, shape, coef.numel(), rate)
    row = {"segments": len(tiles), "slot": list(shape[1:3]), "tiled": bool(meta[jp.T_TILED]),
           "coef_bytes": 2 * coef.numel(), "out_bytes": int(np.prod(shape)), "ms": ms,
           "plain_ms": start.elapsed_time(end), "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "library_ms": None}
    print(json.dumps({"metric": "tiff_jpeg_kernel", "file": os.path.basename(path), **row, "card": card}),
          flush=True)
    return row


def check_legacy_fixtures(dev) -> dict:
    """LEGACY_FIXTURES through native_tile_batches at full size (64 px
    tiles) on the card and on the CPU: every file on the route pixels.json
    gives ("tiff", or "pil" for the layouts left to PIL), the card's tiles
    torch.equal to the CPU's batch for batch, and each file's pixels
    (decode_image: this host's reader, or its PIL) of the sha256 that
    pixels.json gives libtiff's, which holds this host's exp and log
    (PixarLog's and SGILog's tables) and its PIL to libtiff's. Untimed."""
    import hashlib

    import torch

    from aquaculture_tpu_torch.data import native_loader

    with open(os.path.join(LEGACY_FIXTURES, "pixels.json")) as f:
        table = json.load(f)
    paths = [os.path.join(LEGACY_FIXTURES, name) for name in sorted(table)]
    counts, cpu_counts = {}, {}
    card_b = list(native_loader.native_tile_batches(paths, batch_size=8, tile=64, device=dev, counts=counts))
    torch.cuda.synchronize()
    cpu_b = list(native_loader.native_tile_batches(paths, batch_size=8, tile=64, device="cpu", counts=cpu_counts))
    want = {r: 0 for r in native_loader.ROUTES}
    for row in table.values():
        want[row["route"]] += 1
    if counts != want or cpu_counts != want:
        fail(f"TIFF fixtures: counts {counts} (CPU {cpu_counts}), expected {want}")
    if len(card_b) != len(cpu_b) or not all(torch.equal(a.images.cpu(), b.images) and
                                            a.valid.tolist() == b.valid.tolist() for a, b in zip(card_b, cpu_b)):
        fail("TIFF fixtures: the card's tiles != the CPU route's")
    for name, path in zip(sorted(table), paths):
        px = native_loader.decode_image(path, "cpu")
        digest = None if px is None else hashlib.sha256(px.contiguous().numpy().tobytes()).hexdigest()
        if digest != table[name]["sha256"] or list(px.shape) != table[name]["shape"]:
            fail(f"{name}: this host's pixels are not libtiff's (sha256 {digest})")
    return {"files": len(paths), "tiles": sum(int(b.valid.sum()) for b in card_b), "counts": counts,
            "tiles_equal_cpu": True, "pixels_equal_libtiff": True}


def check_tiff_feed(dev, card: str, writer: tuple) -> dict:
    """The TIFF corpus (``start_tiff_corpus``'s) through native_tile_batches
    at full size (1024 px tiles, batch 8) on the card and on the CPU: each
    file on its route (TIFF_CASES), the card's tiles torch.equal to the
    CPU's batch for batch, jpeg_decode launched once per JPEG-compressed
    file (the count zeroed just before the card's run, read just after; the
    batches hold no JPEG of their own); the committed fixtures of the
    codecs a host without libtiff cannot write (``check_legacy_fixtures``);
    then each JPEG-compressed file's segments through the kernel against
    its plain version, timed."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_cuda, native_loader

    t0 = time.perf_counter()
    cases = writer[1].result()
    writer[0].shutdown()
    paths = list(cases.values())
    write_wait_s = time.perf_counter() - t0
    counts, cpu_counts = {}, {}
    jpeg_cuda.decode_launches = 0
    card_b = list(native_loader.native_tile_batches(paths, batch_size=8, device=dev, counts=counts))
    torch.cuda.synchronize()
    launches = jpeg_cuda.decode_launches
    cpu_b = list(native_loader.native_tile_batches(paths, batch_size=8, device="cpu", counts=cpu_counts))
    want = {r: 0 for r in native_loader.ROUTES}
    for route in TIFF_CASES.values():
        want[route] += 1
    if counts != want or cpu_counts != want:
        fail(f"TIFF routing: counts {counts} (CPU {cpu_counts}), expected {want}")
    if len(card_b) != len(cpu_b) or not all(torch.equal(a.images.cpu(), b.images) and
                                            a.valid.tolist() == b.valid.tolist() for a, b in zip(card_b, cpu_b)):
        fail("TIFF corpus: the card's tiles != the CPU route's")
    if launches != want["tiff_jpeg"]:
        fail(f"jpeg_decode launched {launches} times for {want['tiff_jpeg']} JPEG-compressed TIFFs")
    legacy = check_legacy_fixtures(dev)
    rate = int_ops_per_s()
    kernels = {name: tiff_jpeg_kernel(cases[name], dev, rate, card) for name, r in TIFF_CASES.items()
               if r == "tiff_jpeg"}
    tiles = sum(int(b.valid.sum()) for b in card_b)
    return {"files": len(paths), "tiles": tiles, "counts": counts, "tiles_equal_cpu": True,
            "launches": launches, "kernels": kernels, "legacy_fixtures": legacy, "write_wait_s": write_wait_s,
            "paths": cases}


def time_webp_host(cases: dict, card: str) -> dict:
    """The WebP codec's host rate: WEBP_HOST_CASES read whole by
    decode_image on the CPU (the loader threads' work), in megapixels a
    second on one thread (3 reads) and on every core (2 reads a core)."""
    from aquaculture_tpu_torch.data import native_loader

    cores = os.cpu_count() or 1
    out = {"cores": cores}
    for name in WEBP_HOST_CASES:
        path = cases[name]
        img = native_loader.decode_image(path, "cpu")
        mp = img.shape[0] * img.shape[1] / 1e6
        row = {"mp": mp}
        for threads, n in ((1, 3), (cores, 2 * cores)):
            with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda p: native_loader.decode_image(p, "cpu"), [path] * n))
                row[f"mp_per_s_{threads}_threads"] = n * mp / (time.perf_counter() - t0)
        out[name] = row
    print(json.dumps({"metric": "webp_host_decode", **out, "card": card}), flush=True)
    return out


def time_lerc_zstd_host(d: str, card: str) -> dict:
    """LERC's and Zstandard's host rate: a 1024 px file of each, 64 copies
    of the 128 px tile of the committed fixture (rate_tile_lerc.tif, LERC
    v4 lossless; rate_tile_zstd.tif), read whole by decode_image on the CPU
    on one thread (3 reads), in megapixels a second; each read must give
    the tile's pixels (pixels.json's digest holds the tile). Untimed."""
    import struct

    from aquaculture_tpu_torch.data import native_loader

    writer = tiff_writer()
    out = {}
    for codec, compression in (("lerc", 34887), ("zstd", 50000)):
        tile_path = os.path.join(LEGACY_FIXTURES, f"rate_tile_{codec}.tif")
        with open(tile_path, "rb") as f:
            data = f.read()
        ifd = struct.unpack("<I", data[4:8])[0]
        entries = {}
        for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
            tag, typ, _, value = struct.unpack("<HHII", data[ifd + 2 + 12 * k:ifd + 14 + 12 * k])
            entries[tag] = value & 0xFFFF if typ == 3 else value
        blob = data[entries[324]:entries[324] + entries[325]]
        tags = {256: (3, [1024]), 257: (3, [1024]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [2]),
                277: (3, [3]), 322: (3, [128]), 323: (3, [128])}
        if compression == 34887:
            tags[50674] = (4, [4, 0])
        path = os.path.join(d, f"rate_{codec}_1024.tif")
        with open(path, "wb") as f:
            f.write(writer.tiff_bytes([blob] * 64, tags, tiled=True))
        tile = native_loader.decode_image(tile_path, "cpu").numpy()
        t0 = time.perf_counter()
        for _ in range(3):
            img = native_loader.decode_image(path, "cpu")
        seconds = (time.perf_counter() - t0) / 3
        if img is None or not np.array_equal(img.numpy(), np.tile(tile, (8, 8, 1))):
            fail(f"the {codec} 1024 px file does not give its tile's pixels")
        out[codec] = {"mp": 1024 * 1024 / 1e6, "mp_per_s_1_thread": 1024 * 1024 / 1e6 / seconds,
                      "file_bytes": os.path.getsize(path)}
        os.remove(path)
    print(json.dumps({"metric": "lerc_zstd_host_decode", **out, "card": card}), flush=True)
    return out


def tiff_feed_paths(d: str, cases: dict) -> list:
    """The TIFF corpus linked TIFF_PASSES times over under tile-codec names."""
    from aquaculture_tpu_torch.data.filenames import TileSpec, encode_tile_name

    corpus = os.path.join(d, "tiff_corpus")
    os.makedirs(corpus)
    out = []
    for k in range(TIFF_PASSES):
        for i, src in enumerate(cases.values()):
            spec = TileSpec(year=2014, bbox_ind=1000 + k * len(cases) + i, x_offset=0, y_offset=0)
            out.append(os.path.join(corpus, encode_tile_name(spec, "tif")))
            os.symlink(src, out[-1])
    return out


# jidctint.c's, jdsample.c's and jdcolor.c's integer operations (one per
# +, -, *, shift, compare, min, max and table read), counted from
# libjpeg's formulas, not from the kernel, at the fewest they need: the
# descale's rounding added once to the butterfly's even part (two adds a
# pass), the range limit a shift and a clamp. jpeg_idct_islow: a pass-1
# column tests its 7 AC terms, then either dequantises and transforms all
# 8 (8 *, 46 in the butterfly, 2 rounding adds, 8 shifts) or, when they
# are all zero, only the DC (1 *, 1 shift); each of the 8 pass-2 rows
# takes 46 + 2 + 8 x (a shift and a clamp of 2).
ISLOW_COLUMN_OPS, ISLOW_ZERO_COLUMN_OPS, ISLOW_ROWS_OPS = 7 + 8 + 46 + 2 + 8, 7 + 2, 8 * (46 + 2 + 8 * 3)
# jpeg_idct_5x5: 5 columns of 31 (5 dequantising) and 5 rows of 36;
# jpeg_idct_10x10: 8 columns of 71 (8 dequantising), 10 rows of 84. The
# other scaled sizes, counted from data/jpeg_plain.py's passes (one per +,
# -, *, shift) with K dequantising multiplies a column and a shift and a
# clamp of 2 a sample: jpeg_idct_1x1 one multiply, one add, one shift and
# the clamp; jidctred.c's 2x2 5 columns of 5 + 14 (it reads rows and
# columns 0, 1, 3, 5, 7), 2 rows of 14 + 2 x 3; its 4x4 7 columns of 7 + 32
# (it reads 0-3 and 5-7), 4 rows of 32 + 4 x 3; jidctint.c's 3x3 3 x (3 + 12) + 3 x (12 + 9),
# 6x6 6 x (6 + 31) + 6 x (32 + 18), 7x7 7 x (7 + 50) + 7 x (50 + 21),
# 12x12 8 x (8 + 75) + 12 x (75 + 36), 14x14 8 x (8 + 92) + 14 x (93 + 42)
IDCT_OPS = {1: 5, 2: 5 * 19 + 2 * 20, 3: 3 * 15 + 3 * 21, 4: 7 * 39 + 4 * 44, 5: 5 * 31 + 5 * 36,
            6: 6 * 37 + 6 * 50, 7: 7 * 57 + 7 * 71, 10: 8 * 71 + 10 * 84, 12: 8 * 83 + 12 * 111,
            14: 8 * 100 + 14 * 135}
# per output pixel: h2v2 fancy (a column sum of 2 per 2 pixels, then 4),
# h2v1 (3 * x once per 2 pixels, then 3), h1v2 (4); jdcolor's
# ycc_rgb_convert with its tables (4 table reads, 4 adds, 1 shift, 3
# range-limit reads: fewer than its arithmetic without tables)
UPSAMPLE_OPS = {1: 3.5, 2: 4.0, 3: 5.0}   # UP_H2V1, UP_H1V2, UP_H2V2; full and box copy
COLOR_OPS = 12
# Hopper's integer issue per SM and clock: 64 lanes on the ALU pipe (IADD3,
# LOP3, shifts, min/max) beside 64 on the FMA pipe (IMAD), and one
# instruction does at most two of the operations counted above (IMAD a
# multiply and an add, IADD3 two adds, LEA a shift and an add)
INT_LANES_PER_SM, OPS_PER_INSTRUCTION = 128, 2


def int_ops_per_s() -> float:
    """The most integer operations a second the card can do: its SMs x
    INT_LANES_PER_SM x OPS_PER_INSTRUCTION x its top SM clock (nvidia-smi's
    clocks.max.sm)."""
    import torch

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_LANES_PER_SM * OPS_PER_INSTRUCTION * float(mhz) * 1e6


def jpeg_ops(images: list, tiles, shape) -> float:
    """libjpeg's integer operations for one batch: each image's blocks
    through its IDCT (islow's zero-column shortcut counted from these
    coefficients), and each decoded pixel inside its image through the
    upsampling and the colour conversion."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_plain as jp

    ops, idct = 0.0, {}
    for im in images:
        if id(im) in idct:  # a batch repeats its distinct images
            ops += idct[id(im)]
            continue
        before = ops
        for c in im.components:
            n = c.blocks_w * c.blocks_h
            blocks = im.coef[c.offset:c.offset + n * c.kept * c.kept]
            if c.size == 8:
                zero = int((blocks.view(n, 8, 8)[:, 1:, :] == 0).all(1).sum())
                ops += (8 * n - zero) * ISLOW_COLUMN_OPS + zero * ISLOW_ZERO_COLUMN_OPS + n * ISLOW_ROWS_OPS
            else:
                ops += n * IDCT_OPS[c.size]
        idct[id(im)] = ops - before
    th, tw = shape[1:3]
    for kind, i, x, y in tiles.tolist():
        if kind != jp.TILE_DECODED:
            continue
        im = images[i]
        px = max(0, min(tw, im.out_width - x)) * max(0, min(th, im.out_height - y))
        modes = [jp.upsample_mode(c, im.meta)[0] for c in im.components]
        ops += px * (sum(UPSAMPLE_OPS.get(m, 0.0) for m in modes) + (COLOR_OPS if len(modes) == 3 else 0))
    return ops


def jpeg_bound_ms(images: list, tiles, shape, coefs: int, int_rate: float) -> dict:
    """The least ms of one batch's decode, whatever implements it: the
    larger of its bytes (the int16 coefficients read once: each block's
    kept square, what its IDCT reads; the tiles written once) at HBM rate and libjpeg's integer operations at the
    card's most integer operations a second (``int_ops_per_s``)."""
    bytes_ms = (2 * coefs + int(np.prod(shape))) / HBM_BYTES_PER_S * 1e3
    ops = jpeg_ops(images, tiles, shape)
    ops_ms = ops / int_rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_jpeg_decode(distinct: list, dev, card: str) -> dict:
    """jpeg_decode per batch of FEED_BATCH 1024 px tiles at every N/8
    (128 N px tiles; CUDA events) beside its bound, held equal to its plain
    version; with the kernel's registers, shared memory and spills per CTA
    (each scale's kernel). At 8/8 the plain version runs on the same card
    tensors, timed (one call); at the other scales, untimed, on the batch's
    distinct images alone (the batch repeats them), each slot held to its
    image's."""
    import torch

    from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain as jp

    rate = int_ops_per_s()
    out = {}
    for scale in (8, 5, *OTHER_SCALES):
        eff = 128 * scale
        base = entropy_decode_all(distinct, scale)
        images = [base[i % len(base)] for i in range(FEED_BATCH)]
        coef, (qt, comps, imgs, tiles), lay, shape = jpeg_batch(images, eff, dev)
        res = torch.empty(shape, dtype=torch.uint8, device=dev)
        ms = time_cuda(lambda: jpeg_cuda.jpeg_decode(coef, qt, comps, imgs, tiles, res, lay), iters=10)
        bound = jpeg_bound_ms(images, tiles, shape, coef.numel(), rate)
        row = {"scale": f"{scale}/8", "batch": FEED_BATCH, "tile": eff, "coef_bytes": 2 * coef.numel(),
               "out_bytes": int(np.prod(shape)), "decode_ms": ms, "decode_bound_ms": bound["bound_ms"],
               "bound_bytes_ms": bound["bytes_ms"], "bound_ops_ms": bound["ops_ms"], "ops": bound["ops"],
               "bound_by": bound["bound_by"], "library_ms": None, "int_ops_per_s": rate,
               "kernel": jpeg_cuda.attributes(scale)}
        if scale == 8:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            want = jp.decode_batch_plain(coef, qt, comps, imgs, tiles, torch.empty_like(res))
            end.record()
            torch.cuda.synchronize()
            row["decode_plain_ms"] = start.elapsed_time(end)
        else:
            c32, (q32, k32, i32, t32), _, s32 = jpeg_batch(base, eff, dev)
            one = jp.decode_batch_plain(c32, q32, k32, i32, t32, torch.empty(s32, dtype=torch.uint8, device=dev))
            want = one[[i % len(base) for i in range(FEED_BATCH)] + [len(base)]]  # the zero slot last
        if not torch.equal(res, want):
            fail(f"jpeg_decode != plain on the timed batch at {scale}/8")
        print(json.dumps({"metric": "jpeg_kernels", **row, "card": card}), flush=True)
        out[f"{scale}/8"] = row
        del coef, res, want
    return out


def time_host_decode(paths: list, card: str) -> dict:
    """The host half: entropy decodes and PIL's full decodes per second,
    on one thread (FEED_HOST_FILES files) and on every core (as many per
    thread)."""
    from aquaculture_tpu_torch.data import native_loader
    from aquaculture_tpu_torch.data.geotiff import read_image

    cores = os.cpu_count() or 1
    out = {"cores": cores}
    for name, fn in (("entropy", lambda p: native_loader.entropy_decode(p, 8)), ("pil_full", read_image)):
        for threads, n in ((1, FEED_HOST_FILES), (cores, cores * FEED_HOST_FILES)):
            todo = [paths[i % len(paths)] for i in range(n)]
            with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                list(pool.map(fn, todo[:threads]))  # warm
                t0 = time.perf_counter()
                list(pool.map(fn, todo))
                out[f"{name}_tiles_per_s_{threads}_threads"] = n / (time.perf_counter() - t0)
    print(json.dumps({"metric": "host_decode", **out, "card": card}), flush=True)
    return out


def _rows_of(result) -> list:
    boxes, conf, cls, specs, _ = result
    keys = [(s.bbox_ind, s.x_offset, s.y_offset) for s in specs]
    return sorted(zip(keys, map(tuple, boxes.tolist()), conf.tolist(), cls.tolist()))


def drive_scaled_feed(paths: list, model, dev) -> dict:
    """detect_files(decode_scale=True) of mt bf16 at --img FEED_SCALE_IMG
    (4/8 of the 1024 px tiles) through the loader it takes by default, the
    device loader: each kernel launched once a batch (counts zeroed just
    before, read just after); and the loader's tiles on the card equal its
    plain path's on the CPU, batch for batch."""
    import torch

    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.data import jpeg_cuda, native_loader
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import detect_files, make_infer_fn

    img = FEED_SCALE_IMG
    card_b = list(native_loader.native_tile_batches(paths, batch_size=8, out_tile=img, device=dev))
    cpu_b = list(native_loader.native_tile_batches(paths, batch_size=8, out_tile=img, device="cpu"))
    if len(card_b) != len(cpu_b) or not all(torch.equal(a.images.cpu(), b.images) for a, b in zip(card_b, cpu_b)):
        fail(f"the device loader's {img} px tiles on the card != its plain path's on the CPU")
    cfg = DetectConfig(img_size=img, conf_threshold=1e-5)
    infer = make_infer_fn(model, cfg, 1024, device=dev)
    nms_cuda.launches = 0
    jpeg_cuda.decode_launches = 0
    *_, stats = detect_files(paths, model, cfg, 8, infer_fn=infer, device=dev, decode_scale=True)
    launches = {"nms_suppress": nms_cuda.launches, "jpeg_decode": jpeg_cuda.decode_launches}
    if stats.loader != "device" or stats.tiles != len(paths) or set(launches.values()) != {stats.batches}:
        fail(f"detect_files at --img {img}: the {stats.loader!r} loader, {stats.tiles} tiles, "
             f"{stats.batches} batches, launches {launches}")
    return {"img": img, "tiles": stats.tiles, "batches": stats.batches, "launches": launches,
            "detections": stats.detections, "tiles_equal_cpu_plain": True, "files": stats.files}


def drive_feed_path(paths: list, model, dev, card: str, serving_tps: float) -> dict:
    """detect_files (mt, bf16) through the device loader and the Python
    loader: full-decode rows equal on FEED_ROWS_TILES tiles (conf 1e-5,
    batch 8), decode-at-scale rows reported; the kernel launched once per
    batch; then file-fed tiles/s at b128, conf 0.25, the loaders in turns
    (python, device, device, python, then 5/8 device, and python over half
    a batch): the device loader over FEED_PATHS files, the Python loader
    over FEED_PY_PATHS. Each timed run gives its whole-run rate (the first
    batch's fill and the last harvest included) and its steady rate: the
    tiles of batches 2..n over the time from batch 1's entry into the
    serving program to batch n's; and each timed run's peak device memory."""
    import torch

    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.data import jpeg_cuda
    from aquaculture_tpu_torch.pipeline import detect_files, make_infer_fn

    out = {"rows": {}, "tiles_per_s": {}, "steady_tiles_per_s": {}, "batches": {}, "peak_bytes": {}}
    cfg = DetectConfig(img_size=640, conf_threshold=1e-5)
    infer = make_infer_fn(model, cfg, 1024, device=dev)
    few = paths[:FEED_ROWS_TILES]
    for decode_scale in (False, True):
        res = {}
        for native in (True, False):
            jpeg_cuda.decode_launches = 0
            res[native] = detect_files(few, model, cfg, 8, infer_fn=infer, device=dev, use_native=native,
                                       decode_scale=decode_scale)
            stats = res[native][-1]
            want_loader = "device" if native else "python"
            if stats.loader != want_loader or stats.tiles != len(few):
                fail(f"detect_files(use_native={native}) ran {stats.loader!r} on {stats.tiles} tiles")
            if native and jpeg_cuda.decode_launches != stats.batches:
                fail(f"jpeg_decode launched {jpeg_cuda.decode_launches} times for {stats.batches} batches")
            if native and stats.files != {"device": len(few), "tiff": 0, "tiff_jpeg": 0, "pil": 0, "pil_resize": 0,
                                          "skipped": 0}:
                fail(f"device loader routes {stats.files}")
        dev_rows, py_rows = _rows_of(res[True]), _rows_of(res[False])
        key = "decode_scale_5/8" if decode_scale else "full"
        if not decode_scale and dev_rows != py_rows:
            fail(f"full-decode rows differ: device loader {len(dev_rows)}, Python loader {len(py_rows)}")
        out["rows"][key] = {"device": len(dev_rows), "python": len(py_rows), "equal": dev_rows == py_rows}
    out["decode_scale_512"] = drive_scaled_feed(few, model, dev)
    cfg = DetectConfig(img_size=640, conf_threshold=0.25)
    infer = make_infer_fn(model, cfg, 1024, device=dev)
    detect_files(paths[:FEED_BATCH], model, cfg, FEED_BATCH, infer_fn=infer, device=dev, use_native=True)  # warm
    # the Python loader's 5/8 (a PIL resize per tile on the consuming
    # thread: 56-72 tiles/s) reads half a batch
    for native, scale in ((False, False), (True, False), (True, False), (False, False), (True, True),
                          (False, True)):
        todo = paths if native else paths[:FEED_BATCH // 2] if scale else paths[:FEED_PY_PATHS]
        stamps = []

        def stamped(images, stamps=stamps):
            stamps.append(time.perf_counter())
            return infer(images)

        torch.cuda.reset_peak_memory_stats(dev)
        *_, stats = detect_files(todo, model, cfg, FEED_BATCH, infer_fn=stamped, device=dev, use_native=native,
                                 decode_scale=scale)
        if stats.tiles != len(todo) or stats.batches != len(stamps):
            fail(f"file-fed run: {stats.tiles} tiles in {stats.batches} batches of {len(todo)} files")
        name = f"{stats.loader}{'_5/8' if scale else ''}"
        out["tiles_per_s"].setdefault(name, []).append(stats.tiles_per_second)
        out["peak_bytes"].setdefault(name, []).append(torch.cuda.max_memory_allocated(dev))
        if len(stamps) > 1:
            out["steady_tiles_per_s"].setdefault(name, []).append(
                FEED_BATCH * (len(stamps) - 1) / (stamps[-1] - stamps[0]))
        out["batches"][name] = stats.batches
    out["serving_tiles_on_card_per_s"] = serving_tps
    print(json.dumps({"metric": "file_fed", "variant": "mt", "dtype": "bfloat16", "batch": FEED_BATCH,
                      "conf": 0.25, **out, "card": card}), flush=True)
    return out


def time_tiff_feed(tiff_paths: list, model, dev) -> dict:
    """The TIFF corpus (``tiff_feed_paths``) through detect_files on the
    device loader (mt bf16, b128, conf 0.25), twice after a warm run that
    pins the raster slots: each run's tiles/s (a smoke-level reading of a
    second or so; scripts/tiff_feed_ab.py times the corpus at length)."""
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.pipeline import detect_files, make_infer_fn

    cfg = DetectConfig(img_size=640, conf_threshold=0.25)
    infer = make_infer_fn(model, cfg, 1024, device=dev)
    detect_files(tiff_paths[:len(TIFF_CASES)], model, cfg, FEED_BATCH, infer_fn=infer, device=dev,
                 use_native=True)  # warm: the pinned raster slots
    rates = []
    for _ in range(2):
        *_, stats = detect_files(tiff_paths, model, cfg, FEED_BATCH, infer_fn=infer, device=dev, use_native=True)
        want = {r: 0 for r in stats.files}
        for route in TIFF_CASES.values():
            want[route] += TIFF_PASSES
        if stats.loader != "device" or stats.files != want:
            fail(f"TIFF corpus through detect_files: the {stats.loader!r} loader, routes {stats.files}")
        rates.append(stats.tiles_per_second)
    return {"tiles_per_s": rates, "batches": stats.batches, "files": stats.files}


def run_feed_phase(dev, card: str, d: str, serving_tps: float, tiff_writer: tuple) -> dict:
    """Phase 13: the device loader's kernels exact on every case, the path
    through detect_files, and its times beside the tiles-on-card rate; then
    the TIFF corpus (written meanwhile by ``tiff_writer``), checked and
    timed after the JPEG readings so that it does not disturb them, and
    deleted."""
    import shutil

    from aquaculture_tpu_torch.cli.detect import load_model

    t0 = time.perf_counter()
    cases, distinct, paths = write_feed_files(d)
    seconds = {"write": time.perf_counter() - t0}
    out = {"exactness": check_jpeg_exactness(cases, dev)}
    seconds["exactness"] = time.perf_counter() - t0 - sum(seconds.values())
    out["routing"] = check_feed_routing(dev, d, distinct)
    seconds["routing"] = time.perf_counter() - t0 - sum(seconds.values())
    out["kernels"] = time_jpeg_decode(distinct, dev, card)
    seconds["kernel_times"] = time.perf_counter() - t0 - sum(seconds.values())
    out["host_decode"] = time_host_decode(distinct, card)
    seconds["host_decode"] = time.perf_counter() - t0 - sum(seconds.values())
    model = load_model(None, "mt", 5)
    out["path"] = drive_feed_path(paths, model, dev, card, serving_tps)
    seconds["path"] = time.perf_counter() - t0 - sum(seconds.values())
    out["tiff"] = check_tiff_feed(dev, card, tiff_writer)
    cases = out["tiff"].pop("paths")
    out["tiff"]["webp_host"] = time_webp_host(cases, card)
    out["tiff"]["lerc_zstd_host"] = time_lerc_zstd_host(d, card)
    seconds["tiff"] = time.perf_counter() - t0 - sum(seconds.values())
    out["tiff"].update(time_tiff_feed(tiff_feed_paths(d, cases), model, dev))
    shutil.rmtree(os.path.join(d, "tiff_corpus"))
    for path in cases.values():
        os.remove(path)
    print(json.dumps({"metric": "tiff_feed", **{k: v for k, v in out["tiff"].items() if k != "kernels"},
                      "card": card}), flush=True)
    seconds["tiff_times"] = time.perf_counter() - t0 - sum(seconds.values())
    out["seconds"] = seconds
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    from aquaculture_tpu_torch.data import jpeg_cuda, native_loader
    from aquaculture_tpu_torch.geo import native_boolean
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

    # the artifact of phase 4d, exported by a process of its own meanwhile
    root = tempfile.TemporaryDirectory()
    d = root.name
    d4 = os.path.join(d, "tooling")
    os.makedirs(d4)
    aot_export = start_aot_export(d4, batch=8)
    # phase 13's TIFF corpus, written by a process of its own meanwhile
    d13 = os.path.join(d, "feed")
    os.makedirs(d13)
    tiff_writer = start_tiff_corpus(d13)

    # 2. build the kernels (one nvcc per source), the overlay sweep and the
    # entropy decoder (g++), all at once; 3. the suppression kernel against
    # its plain version and the int8 conv routes while the others build
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        t0 = time.perf_counter()
        builds = {name: pool.submit(lambda f=f: (f(), time.perf_counter() - t0)[1])
                  for name, f in (("booleanop", native_boolean.build), ("jpeg_entropy", native_loader.build),
                                  ("jpeg_decode", jpeg_cuda.build))}
        nms_cuda.build()
        print(f"build: nms_suppress {time.perf_counter() - t0:.2f} s ({nms_cuda.library_path()})", flush=True)
        t1 = time.perf_counter()
        shapes = check_shapes()
        suites = check_kernels(dev, shapes)
        print(f"kernels: nms_suppress == plain (exact) on suites {','.join(suites)} x shapes "
              f"{list(shapes)} in {time.perf_counter() - t1:.1f} s", flush=True)
        print(json.dumps({"phase": "int8_conv", **check_int8_conv(dev)}), flush=True)
        for name, job in builds.items():
            print(f"build: {name} {job.result():.2f} s", flush=True)

    # 4. the main path; the tiles serve every later phase that needs files
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
    # 4d. the serving tooling on the main path's tiles. Its --aot detect's
    # first load imports the export machinery (dynamo): import it while the
    # export process finishes, not after
    import torch._dynamo  # noqa: F401

    tooling = run_tooling_phase(d4, tile_dir, label_dir, n_tiles=16, batch=8, export=wait_aot_export(aot_export))
    print(json.dumps({"phase": "tooling", **tooling, "card": card}), flush=True)
    mark("tooling")
    # 4b/4c. aq-pipeline at full width, the trained fixture on its world (the
    # accuracy phase's), P6, overlap, --int8
    from examples.end_to_end_demo import render_world

    d1, dw = os.path.join(d, "pipeline"), os.path.join(d, "world")
    os.makedirs(d1)
    inputs = write_pipeline_inputs(d1)
    world = render_world(dw, n_images=12, seed=0)
    # the CPU halves of the trained fixture's runs and of the accuracy table
    # start in a worker now; the card halves come last in their phases
    cpu_refs = start_cpu_references(dw, *world)
    # 9. aq-pod: its processes start here and import while the pipeline
    # phases run (they need some 10 s; the card-vs-CPU checks alone are 2 s)
    pod_run = start_pod_phase(d, tile_dir, n_tiles=16)
    full_width = drive_pipeline_full_width(d1, inputs)
    p6 = drive_pipeline_full_width(d1, inputs, variant="m6")
    print(json.dumps({"phase": "p6", **p6, "card": card}), flush=True)
    overlap = drive_pipeline_overlap(d1, inputs[1])
    print(json.dumps({"phase": "overlap", **overlap, "card": card}), flush=True)
    int8_pipeline = drive_pipeline_full_width(d1, inputs, options=("--int8",))
    print(json.dumps({"phase": "int8_pipeline", **int8_pipeline, "card": card}), flush=True)
    pipeline = {"full_width": full_width,
                "trained_fixture": drive_pipeline_trained_card_vs_cpu(dw, world[0], cpu_refs), "card": card}
    print(json.dumps({"phase": "pipeline", **pipeline}), flush=True)
    mark("pipeline")
    print(json.dumps({"phase": "f32_card_vs_cpu_n160", "tf32": False, **check_f32_vs_cpu(dev)}), flush=True)
    print(json.dumps({"phase": "f32_card_vs_cpu_n6_256", "tf32": False, **check_f32_vs_cpu(dev, "n6", 256)}),
          flush=True)
    print(json.dumps({"phase": "m_builds", **check_m_builds(dev)}), flush=True)
    print(json.dumps({"phase": "int8_n160_card_vs_cpu", "tf32": False, **check_int8_forward_card_vs_cpu(dev)}),
          flush=True)
    mark("card_vs_cpu")
    pod = run_pod_phase(dev, card, pod_run)
    print(json.dumps({"phase": "pod", **pod, "card": card}), flush=True)
    mark("pod")
    # the accuracy table after the pod phase: its CPU half has had the
    # worker since the pipeline phases began
    accuracy = run_accuracy_phase(dev, card, *world, cpu_refs["accuracy"])
    print(json.dumps({"phase": "accuracy", **accuracy, "card": card}), flush=True)
    mark("accuracy")
    # 8. aq-cluster and aq-evaluate on the evaluation world
    d8 = os.path.join(d, "evaluation")
    os.makedirs(d8)
    print(json.dumps({"phase": "cluster_evaluate", **run_cluster_evaluate_phase(dev, d8), "card": card}),
          flush=True)
    mark("cluster_evaluate")
    # 10. aq-facilities -> aq-tonnage on a cut of the evaluation world, and
    # the bootstrap at the paper's scale
    d10 = os.path.join(d, "tonnage")
    os.makedirs(d10)
    screening_worker = start_screening_worker()  # phase 12's; it imports while phase 10 runs
    eval_world = tuple(os.path.join(d8, f) for f in ("detections.geojson", "labels.geojson", "images.csv"))
    print(json.dumps({"phase": "facilities_tonnage",
                      **run_facilities_tonnage_phase(dev, card, d10, eval_world, cpu_refs["pool"]), "card": card}),
          flush=True)
    cpu_refs["pool"].shutdown()
    torch.cuda.empty_cache()
    mark("facilities_tonnage")
    # 12. aq-acquire -> the reference's tiling -> aq-pipeline on the card,
    # and the figures on phase 10's outputs
    d12 = os.path.join(d, "acquire")
    os.makedirs(d12)
    acquire = run_acquire_to_map_phase(dev, card, d12, d10, screening_worker)
    print(json.dumps({"phase": "acquire_to_map", **acquire}), flush=True)
    mark("acquire_to_map")

    # 5. times (the int8 model calibrated on the main path's first 8 tiles)
    tiles = serving_tiles(dev)
    times = time_serving_and_kernel(dev, card, tiles, iters=3, profile=True)
    times_p6 = time_serving_and_kernel(dev, card, tiles, "m6", shapes=((128, 1024),), iters=1)
    times_int8 = time_serving_and_kernel(dev, card, tiles, shapes=((128, 1024),), iters=2,
                                         int8_paths=paths[:8], profile=True)
    print(json.dumps({"metric": "int8_safe_over_bf16", "variant": "mt", "batch": tiles.shape[0],
                      **{c: times_int8[c]["tiles_per_s"] / times[c]["tiles_per_s"] for c in ("conf_0.25", "conf_1e-05")},
                      "card": card}), flush=True)
    k, k6 = times["kernel"], times_p6["kernel"]
    mark("serving_times")
    # 13. the feed: the device loader's kernels, path and times
    feed = run_feed_phase(dev, card, d13, times["conf_0.25"]["tiles_per_s"], tiff_writer)
    print(json.dumps({"phase": "feed", **feed, "card": card}), flush=True)
    torch.cuda.empty_cache()
    mark("feed")
    # 11. the serving plan: its recommendations, one batch of the default served
    plan = run_plan_phase(dev, card, tiles)
    print(json.dumps({"phase": "plan_served", **plan["served"], "card": card}), flush=True)
    del tiles
    torch.cuda.empty_cache()
    mark("plan")

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
        "launches_decode_scale_512": feed["path"]["decode_scale_512"]["launches"]["nms_suppress"],
        "launches_pod": pod["launches"],
        "launches_pod_resume": pod["launches_resume"],
        "launches_aot_detect": tooling["aot_detect"]["launches"]["nms_suppress"],
        "launches_profiled_detect": tooling["profiled_detect"]["launches"]["nms_suppress"],
        "launches_plan": plan["served"]["launches"],
        "launches_acquire_pipeline": acquire["pipeline"]["launches"]["nms_suppress"],
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
    }, {
        "name": "jpeg_decode",
        "route": "cuda",
        "source": "aquaculture_tpu_torch/csrc/jpeg_decode.cu",
        "replaces": "none, not a TPU kernel: the JAX package decodes on host threads (tileloader.cc:53, decode_jpeg)",
        "launches": main_path["launches"]["jpeg_decode"],
        "launches_decode_scale": options["decode_scale"]["launches"]["jpeg_decode"],
        "launches_pipeline": pipeline["full_width"]["launches"]["jpeg_decode"],
        "launches_accuracy": accuracy["on_card"]["jpeg_launches"],
        "launches_decode_scale_512": feed["path"]["decode_scale_512"]["launches"]["jpeg_decode"],
        "launches_tiff_feed": feed["tiff"]["launches"],
        "max_abs_err": 0.0,
        "ms": feed["kernels"]["8/8"]["decode_ms"],
        "plain_ms": feed["kernels"]["8/8"]["decode_plain_ms"],
        "bound_ms": feed["kernels"]["8/8"]["decode_bound_ms"],
        "bound_by": feed["kernels"]["8/8"]["bound_by"],
        "library_ms": None,
        "ms_5/8": feed["kernels"]["5/8"]["decode_ms"],
        "bound_ms_5/8": feed["kernels"]["5/8"]["decode_bound_ms"],
        "bound_by_5/8": feed["kernels"]["5/8"]["bound_by"],
        **{f"{key}_{n}/8": feed["kernels"][f"{n}/8"][field] for n in OTHER_SCALES
           for key, field in (("ms", "decode_ms"), ("bound_ms", "decode_bound_ms"), ("bound_by", "bound_by"))},
        **{k: feed["kernels"]["8/8"]["kernel"][k] for k in ("registers", "shared_bytes", "local_bytes", "ctas_per_sm")},
        "registers_by_scale": {n: row["kernel"]["registers"] for n, row in feed["kernels"].items()},
        "local_bytes_by_scale": {n: row["kernel"]["local_bytes"] for n, row in feed["kernels"].items()},
        **{f"{key}_tiff_{name}": row[key] for name, row in feed["tiff"]["kernels"].items()
           for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "exact_on": sorted(feed["exactness"]) + [f"tiff_{name}" for name in feed["tiff"]["kernels"]],
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
