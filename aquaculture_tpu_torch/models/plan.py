"""Serving-plan recommender: the measured decision rules as an API.

The port's counterpart of aquaculture_tpu/models/plan.py, with the same
API (``ServingPlan``, ``TrainingPlan``, ``recommend_serving``,
``recommend_training``), the same rule structure and the same refusals.
The rules that follow from the arguments alone (the .pt interop pin, the
img default by family, overlap, TTA, decode-at-scale, batch 1 on the
latency path) are the JAX package's. Every rule that rests on a speed
measurement is re-read from the H100: the readings below are
scripts/plan_sweep.py's lines on an NVIDIA H100 80GB HBM3 at 700.00 W,
summarised in PERF.md section 5 ("Plan inputs"), and each note cites its
reading. A rule whose input the card did not measure keeps the plan's
conservative default and says "unmeasured on the H100". Rules about
accuracy cite the port's accuracy table (eval/accuracy.py, held to
tests/test_accuracy.py's bounds on the card) where it has a row, else
the JAX package's accuracy record by its file.

    >>> from aquaculture_tpu_torch.models.plan import (
    ...     recommend_serving, recommend_training)
    >>> plan = recommend_serving()                      # throughput serving
    >>> plan.variant, plan.batch, plan.int8
    ('mt', 192, False)
    >>> recommend_serving(pt_interop=True).variant      # need .pt weights
    'm'
    >>> recommend_training().variant, recommend_training().batch
    ('mt', 128)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

# Host-only copies: importing the plan pulls in no torch (config.py and
# models/yolov5.py import it). tests/test_torch_plan.py holds both equal to
# their sources.
IM_WIDTH = 1024  # config.IM_WIDTH
VARIANTS = ("n", "s", "m", "l", "x", "n6", "s6", "m6", "l6", "x6", "mt")  # models.yolov5.VARIANTS

# --------------------------------------------------------------------------
# H100 readings (scripts/plan_sweep.py; PERF.md section 5, "Plan inputs")
# --------------------------------------------------------------------------
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
_WHERE = f"H100 reading, {CARD}; PERF.md section 5 'Plan inputs'"

# Serving tiles/s by batch: bf16, conf 1e-5, 1024 px uint8 tiles on the
# card, the median of 5 windows of 5 batches (part "serving"), keyed by
# (variant, img).
_SERVING_TILES_PER_S: Dict[Tuple[str, int], Dict[int, float]] = {
    ("mt", 640): {1: 135.3, 8: 1444.6, 32: 1921.1, 64: 2030.6, 128: 2163.8, 192: 2186.6, 256: 2210.5},
    ("m", 640): {1: 152.4, 8: 1258.6, 32: 1688.5, 64: 1799.8, 128: 1892.7, 192: 1923.1, 256: 1936.0},
    ("m6", 1280): {8: 430.1, 32: 494.5, 64: 515.0, 128: 514.2},
}
# the windows' extremes of the b128 rows of mt and m (the call's spread)
_B128_RANGE = {"mt": (2152.0, 2170.6), "m": (1890.5, 1895.4)}
# int8_safe over bf16 at b128, in turns bf16, int8, int8, bf16 (part
# "int8"): (the img it was read at, the ratio of the means, the two sides'
# window ranges apart). As in the JAX package's rule, a P5 variant's
# reading stands for it at any img; a P6 variant's only at its own.
_INT8_OVER_BF16: Dict[str, Tuple[int, float, bool]] = {
    "mt": (640, 0.4548, True),
    "m": (640, 0.4508, True),
    "m6": (1280, 0.4245, True),
}
# --pre-topk 512 over 1024, mt b128, in turns (part "topk")
_TOPK512_OVER_1024 = (1.0040, False)
# single-tile host wall ms per synchronized call, 200 calls (part "latency")
_LATENCY_P50_P90_MS = {"mt": (4.557, 7.294), "m": (4.576, 6.817)}
# bf16 train step at 640 (part "train"): img/s without and with remat,
# and peak GB without and with remat, keyed by (variant, batch); every row
# fit on the card's 80 GB
_TRAIN: Dict[Tuple[str, int], Tuple[float, float, float, float]] = {
    ("m", 16): (175.4, 109.8, 8.14, 3.67),
    ("m", 32): (270.8, 196.4, 14.36, 5.29),
    ("m", 64): (329.8, 253.5, 26.69, 8.61),
    ("m", 128): (378.8, 292.2, 51.05, 15.25),
    ("mt", 16): (193.7, 125.0, 7.82, 4.08),
    ("mt", 32): (272.3, 198.0, 13.65, 5.57),
    ("mt", 64): (330.5, 253.2, 25.03, 8.62),
    ("mt", 128): (385.8, 296.6, 47.91, 15.21),
}
# the b128 rows' window ranges apart, mt against m (img/s)
_TRAIN_B128_APART = True
# the augmented 640 px feed, a cold epoch over 32 rendered tiles (part
# "feed"): img/s on 1 thread and on 8 (the card's host has 8 cores)
_FEED_IMG_PER_S = {1: 19.47, 8: 70.23}

# "Within the spread": two readings are told apart only when their windows'
# ranges do not meet; a batch is at the knee within 2% of the best
# (PERF.md section 2: ~2% between repeated runs).
_KNEE_SHARE = 0.98
_DEFAULT_BATCH = 128  # unmeasured variants: the largest batch measured for every one


def _knee(rates: Dict[int, float]) -> int:
    best = max(rates.values())
    return min(b for b, r in rates.items() if r >= _KNEE_SHARE * best)


# derived rules
_BATCH_KNEE = {key: _knee(rates) for key, rates in _SERVING_TILES_PER_S.items()}
_INT8_SAFE_WINS = {v for v, (_, r, apart) in _INT8_OVER_BF16.items() if apart and r > 1}
_INT8_LOSES = {v for v, (_, r, apart) in _INT8_OVER_BF16.items() if apart and r < 1}
_MT_OVER_M = _SERVING_TILES_PER_S[("mt", 640)][128] / _SERVING_TILES_PER_S[("m", 640)][128]
_MT_M_APART = _B128_RANGE["m"][1] < _B128_RANGE["mt"][0] or _B128_RANGE["mt"][1] < _B128_RANGE["m"][0]


def _fmt(x: float) -> str:
    return f"{x:,.1f}"


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """A concrete, measurement-backed serving configuration."""

    variant: str
    batch: int
    int8: bool
    img_size: int
    overlap_px: int          # 0 = hard tile grid
    tta: bool                # multi-scale test-time augmentation (--augment)
    decode_scale: bool       # DCT-domain host decode at img_size (--decode-scale)
    notes: Tuple[str, ...]   # provenance: why each choice, PERF.md refs


def recommend_serving(
    img: int | None = None,
    latency_sensitive: bool = False,
    pt_interop: bool = False,
    boundary_accuracy: bool = False,
    scale_shifted: bool = False,
    variant: str | None = None,
) -> ServingPlan:
    """Recommend a serving configuration from the measured trade-offs.

    Args:
      img: inference resolution. None (the default) means the chosen
        variant's native size: 1280 for the P6 family, else 640. An
        explicit value is honored verbatim; a pick measured only at
        another resolution falls back to the path for yours.
      latency_sensitive: optimize single-tile p50 instead of batched
        throughput (changes the variant pick AND the batch).
      pt_interop: weights must round-trip with ultralytics ``.pt``
        (rules out the framework-own mt channel map).
      boundary_accuracy: detections near tile boundaries matter more than
        raw tiles/s: picks the P6 family (m6 at 1280), which sees the whole
        1024 px tile, at its measured batch. A latency-sensitive plan, an
        explicit non-1280 img, or a pinned variant that cannot see the
        whole tile fall back to overlap serving.
      scale_shifted: the corpus's object scales are uncertain or exceed
        the training distribution: turns on multi-scale TTA, a loss in
        distribution that recovers large-object recall under scale
        mismatch.
      variant: pin a variant explicitly; the plan then only fills in the
        measured batch/int8 choices for it.
    """
    notes: List[str] = []

    # the m6 pick is a batched, native-1280 choice: batch 1 and any other
    # img fall back to the overlap path below
    p6_pick_applies = (
        boundary_accuracy
        and not latency_sensitive
        and (img is None or img == 1280)
    )
    m6_rates = _SERVING_TILES_PER_S[("m6", 1280)]
    mt_best = max(_SERVING_TILES_PER_S[("mt", 640)].values())
    m6_best = max(m6_rates.values())
    if variant is None and p6_pick_applies:
        variant = "m6"
        notes.append(
            f"variant=m6 @1280: picked for boundary accuracy, not speed — on the H100 m6 at 1280 serves "
            f"{_fmt(m6_best)} 1024 px tiles/s at best against mt's {_fmt(mt_best)} at 640 "
            f"({mt_best / m6_best:.1f}x slower over the same ground; {_WHERE}); it sees the whole tile, so no "
            "seam splits a cage (the JAX package's boundary-accuracy record: BENCH_P6_ACCURACY.jsonl; the "
            "port's accuracy table has no P6 row); m6 is an ultralytics-standard variant, so .pt interop holds")
    elif variant is None:
        if boundary_accuracy and latency_sensitive:
            notes.append(
                "P6 not auto-picked: the m6 boundary-accuracy pick is a batched serving choice; at batch 1 "
                "m6 at 1280 is unmeasured on the H100 — overlap serving covers boundary accuracy on the "
                "latency path")
        elif boundary_accuracy:
            notes.append(
                f"P6 not auto-picked: the m6 boundary-accuracy pick was measured at its native 1280px only; "
                f"img={img} was stated, so the plan keeps it and serves boundary accuracy via overlap "
                f"tiling (pin variant='m6' to serve P6 at a custom resolution anyway)")
        if pt_interop:
            variant = "m"
            notes.append(
                "variant=m: .pt interop pins m (no ultralytics yaml/.pt exists for the framework-own mt "
                "channel map)")
        elif latency_sensitive:
            variant = _latency_variant(notes)
        else:
            variant = "mt"
            m128 = _SERVING_TILES_PER_S[("m", 640)][128]
            mt128 = _SERVING_TILES_PER_S[("mt", 640)][128]
            if _MT_M_APART and mt128 < m128:
                variant = "m"
                notes.append(
                    f"variant=m: m serves {_fmt(m128)} tiles/s at b128 against mt's {_fmt(mt128)} ({_WHERE})")
            elif _MT_M_APART:
                notes.append(
                    f"variant=mt: {_fmt(mt128)} tiles/s at b128 against m's {_fmt(m128)} "
                    f"({_MT_OVER_M:.2f}x; {_WHERE}), at >= m capacity")
            else:
                notes.append(
                    f"variant=mt: equal to m on the H100 within the call's spread at b128 ({_WHERE}); the "
                    "JAX package's choice kept")
    elif variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {sorted(VARIANTS)}")
    elif variant == "mt" and pt_interop:
        # not a trade-off but an impossibility: no ultralytics yaml/.pt
        # exists for the framework-own channel map
        raise ValueError(
            "variant='mt' cannot satisfy pt_interop: mt is framework-own "
            "(no ultralytics .pt exists for its channel map) — pin 'm' "
            "or drop the pin")
    elif variant == "m" and latency_sensitive:
        (p50_mt, _), (p50_m, _) = _LATENCY_P50_P90_MS["mt"], _LATENCY_P50_P90_MS["m"]
        notes.append(
            f"variant=m pinned on the latency path: b1 p50 {p50_m:.2f} ms against mt's {p50_mt:.2f} ms "
            f"({_WHERE}) — fine; mt serves {_MT_OVER_M:.2f}x m's tiles/s batched (b128)")

    if img is None:
        # the variant's native size: P6 heads were designed for 1280
        img = 1280 if variant.endswith("6") else 640

    if latency_sensitive:
        batch = 1
        notes.append("batch=1: single-tile latency path")
    elif (variant, img) in _BATCH_KNEE:
        batch = _BATCH_KNEE[(variant, img)]
        rates = _SERVING_TILES_PER_S[(variant, img)]
        best = max(rates, key=rates.get)
        sweep = ", ".join(f"b{b} {_fmt(r)}" for b, r in sorted(rates.items()))
        notes.append(
            f"batch={batch}: the smallest batch within 2% of the best tiles/s ({_fmt(rates[best])} at "
            f"b{best}) on the H100: {sweep} ({_WHERE})")
    else:
        batch = _DEFAULT_BATCH
        notes.append(
            f"batch={batch}: unmeasured on the H100 for {variant} at {img}px — the plan's default "
            "(the largest batch measured for every variant)")
    if not latency_sensitive and not variant.endswith("6"):
        ratio, apart = _TOPK512_OVER_1024
        verdict = ("within the call's spread — no gain" if not apart
                   else f"{ratio:.3f}x of 1024")
        notes.append(
            f"optional: --pre-topk 512 measured {ratio:.3f}x the tiles/s of 1024 at mt/b128, {verdict} "
            f"({_WHERE}); its mAP row is in the port's accuracy table (eval/accuracy.py 'topk512'); the "
            "default stays 1024 — truncation binds only above pre_topk candidates/tile")

    # the int8 reading applies off the latency path, and for P6 only at the
    # img it was read at
    read_img, r, _ = _INT8_OVER_BF16.get(variant, (None, None, None))
    applies = not latency_sensitive and read_img is not None and (not variant.endswith("6") or img == read_img)
    int8 = applies and variant in _INT8_SAFE_WINS
    if int8:
        notes.append(
            f"int8=True: int8_safe served {r:.2f}x bf16's tiles/s for {variant} at {read_img}px b128 "
            f"({_WHERE}), and its mAP holds tests/test_accuracy.py's bounds in the port's accuracy table "
            "('int8_safe')")
    elif applies and variant in _INT8_LOSES:
        notes.append(
            f"int8=False: int8_safe served {r:.2f}x bf16's tiles/s for {variant} at {read_img}px b128, outside "
            f"the call's spread ({_WHERE}): a net loss on the H100 (its mAP holds the bounds — the port's "
            "accuracy table, 'int8_safe' — so speed alone decides)")
    else:
        notes.append(
            "int8=False: unmeasured on the H100 for this variant, resolution or the latency path — bf16 "
            "is the safe default")

    tta = scale_shifted
    if scale_shifted:
        notes.append(
            "tta=True: serving scales exceed the trained range — TTA's down-scale passes recover "
            "large-object recall (the JAX package's scale-shift record: BENCH_TTA.jsonl); it runs three "
            "forward passes per tile. For a KNOWN resolution change, re-serve at the matching --img "
            "instead; point DetectConfig.tta_scales at the mismatch direction for small objects")
    else:
        notes.append(
            "tta=False: an mAP loss in distribution at three forward passes per tile (the port's "
            "accuracy table, 'tta'; the JAX package's record: BENCH_TTA.jsonl); only pays under scale "
            "mismatch")

    overlap_px = 0
    # "whole tile" = a P6 variant whose input covers the full source tile
    # (IM_WIDTH px), so tiles are never sliced and there are no seams; any
    # other config slices, and boundary accuracy needs overlap serving
    whole_tile = variant.endswith("6") and img >= IM_WIDTH
    if boundary_accuracy and not whole_tile:
        overlap_px = 64
        notes.append(
            "overlap=64px: boundary accuracy on a config that slices tiles (non-P6 variant, or P6 below "
            "the 1024px tile size) — aug-train + overlap-serve tiling (the JAX package's record: "
            "BENCH_P6_ACCURACY.jsonl); cross-tile NMS merges the seams")
    elif boundary_accuracy:
        notes.append(
            f"overlap=0: the P6 family at {img}px sees the whole {IM_WIDTH}px tile — no seams to stitch")

    # decode-at-scale needs img a proper N/8 fraction of the 1024px tile;
    # the overlap path slices at source resolution so it stays full-decode
    decode_scale = (
        overlap_px == 0 and img < IM_WIDTH and (8 * img) % IM_WIDTH == 0
    )
    if decode_scale:
        notes.append(
            "decode_scale=True: DCT-domain decode at img from the 1024px tile, mAP-neutral on the JAX "
            "package's mt@640 gate (scripts/decode_scale_ab.py; BENCHMARKS.md 'Decode-at-scale') with "
            "less host->device traffic; its tiles/s is unmeasured on the H100. CAVEAT: the decode "
            "filter differs from training's resize — re-run the gate on a sample of the real corpus "
            "before flipping a production deployment")
    else:
        notes.append(
            "decode_scale=False: needs img = N/8 of the tile and the hard grid (overlap slices at "
            "source resolution)")

    return ServingPlan(
        variant=variant,
        batch=batch,
        int8=int8,
        img_size=img,
        overlap_px=overlap_px,
        tta=tta,
        decode_scale=decode_scale,
        notes=tuple(notes),
    )


def _latency_variant(notes: List[str]) -> str:
    """The latency path's variant by b1 p50; p50s within 2% of each other
    are equal within the call's spread, and then mt (the batched pick and
    the JAX package's choice) serves."""
    (p50_mt, p90_mt), (p50_m, p90_m) = _LATENCY_P50_P90_MS["mt"], _LATENCY_P50_P90_MS["m"]
    readings = (f"b1 p50/p90 mt {p50_mt:.2f}/{p90_mt:.2f} ms, m {p50_m:.2f}/{p90_m:.2f} ms ({_WHERE})")
    if abs(p50_mt - p50_m) <= (1 - _KNEE_SHARE) * min(p50_mt, p50_m):
        notes.append(f"variant=mt: {readings}: equal on the H100 within the call's spread, so the batched "
                     "winner serves the latency path too")
        return "mt"
    variant = "mt" if p50_mt < p50_m else "m"
    notes.append(f"variant={variant}: the lower single-tile p50 — {readings}")
    return variant


@dataclasses.dataclass(frozen=True)
class TrainingPlan:
    """A concrete, measurement-backed training configuration.

    Field names match TrainConfig so a plan maps 1:1 onto it:
    TrainConfig(batch_size=plan.batch, compute_dtype=plan.compute_dtype,
    remat=plan.remat, scale=plan.scale_jitter, mosaic=plan.mosaic, ...).
    """

    variant: str
    batch: int
    compute_dtype: str
    remat: bool
    augment: bool
    mosaic: float
    scale_jitter: float
    budget_multiplier: float  # step budget vs an equal-budget no-aug run
    feed_cores: int           # host decode/aug cores needed at full step rate
    notes: Tuple[str, ...]


def recommend_training(
    pt_interop: bool = False,
    small_targets: bool = False,
    memory_constrained: bool = False,
    variant: str | None = None,
) -> TrainingPlan:
    """Recommend a training configuration from the measured trade-offs.

    Args:
      pt_interop: the trained weights must round-trip with ultralytics
        ``.pt`` (rules out the framework-own mt channel map).
      small_targets: the dataset's objects are small relative to the
        image — moderates the affine scale jitter so mosaic+scale doesn't
        shrink targets below detectability.
      memory_constrained: the per-card batch doesn't fit device memory —
        turns on remat (a MEMORY lever: slower steps, bigger batches),
        instead of silently shrinking the batch.
      variant: pin a variant; the plan fills in the measured knobs.
    """
    notes: List[str] = []

    if variant is None:
        if pt_interop:
            variant = "m"
            notes.append(
                "variant=m: .pt interop requires the public channel map "
                "(no ultralytics yaml/.pt exists for mt)")
        else:
            variant = "mt"
            mt, m = _TRAIN[("mt", 128)][0], _TRAIN[("m", 128)][0]
            if _TRAIN_B128_APART and m > mt:
                variant = "m"
                notes.append(f"variant=m: {_fmt(m)} img/s at b128 against mt's {_fmt(mt)} ({_WHERE})")
            elif _TRAIN_B128_APART:
                notes.append(
                    f"variant=mt: {_fmt(mt)} img/s at b128 against m's {_fmt(m)} ({mt / m:.3f}x; {_WHERE}), "
                    "at >= m capacity")
            else:
                notes.append(f"variant=mt: equal to m on the H100 within the call's spread ({_WHERE}); the "
                             "JAX package's choice kept")
    elif variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {sorted(VARIANTS)}")
    elif variant == "mt" and pt_interop:
        raise ValueError(
            "variant='mt' cannot satisfy pt_interop: mt is framework-own "
            "(no ultralytics .pt exists for its channel map) — pin 'm' "
            "or drop the pin")

    measured = variant if (variant, 128) in _TRAIN else None
    rows = {b: v for (name, b), v in _TRAIN.items() if name == (measured or "m")}
    batch = max(rows, key=lambda b: rows[b][0])
    step_rate, remat_rate, peak, peak_remat = rows[batch]
    sweep = ", ".join(f"b{b} {_fmt(v[0])}" for b, v in sorted(rows.items()))
    if measured:
        notes.append(
            f"batch={batch}: the best img/s that fits without remat, bf16 at 640: {sweep} "
            f"(peak {peak:.1f} GB of 80; {_WHERE})")
    else:
        notes.append(
            f"batch={batch}: unmeasured on the H100 for {variant} — m's best batch ({sweep}; {_WHERE})")
    notes.append(
        "compute_dtype=bfloat16: the port's training default (f32 master params, BN statistics and loss), "
        "held to the JAX package block by block (tests/test_torch_train.py); f32 training speed is "
        "unmeasured on the H100")

    remat = bool(memory_constrained)
    cost = step_rate / remat_rate
    notes.append(
        (f"remat=True: a MEMORY lever — {cost:.2f}x the step time at b{batch} for peak {peak_remat:.1f} GB "
         f"instead of {peak:.1f} GB ({_WHERE})")
        if remat else
        (f"remat=False: {cost:.2f}x the step time at b{batch} for no throughput gain, and b{batch} fits "
         f"without it ({peak:.1f} GB; {_WHERE})"))

    scale_jitter = 0.3 if small_targets else 0.5
    notes.append(
        "augment=True, mosaic=0.5, budget_multiplier=4 against a memorization run: the recipe "
        "generalizes (the JAX package's augmentation record: BENCH_AUG.jsonl); not re-measured on "
        "the H100")
    if small_targets:
        notes.append(
            "scale=0.3: the ultralytics default 0.5 shrinks small targets below detectability under "
            "mosaic — moderate the jitter for small-object datasets")

    per_thread = _FEED_IMG_PER_S[1]
    feed_cores = math.ceil(step_rate / per_thread)
    notes.append(
        f"feed_cores={feed_cores}: the augmented 640px feed produced {per_thread:.2f} img/s on one thread "
        f"(a cold epoch) against this variant's {_fmt(step_rate)} img/s step ({_WHERE}) — thread the "
        f"dataset feed (TrainConfig.feed_threads; batches are thread-count-invariant). CAVEAT: 8 threads "
        f"gave {_fmt(_FEED_IMG_PER_S[8])} img/s on the card's 8-core host, short of one thread's rate "
        "times 8, so this count is a lower bound")

    return TrainingPlan(
        variant=variant,
        batch=batch,
        compute_dtype="bfloat16",
        remat=remat,
        augment=True,
        mosaic=0.5,
        scale_jitter=scale_jitter,
        budget_multiplier=4.0,
        feed_cores=feed_cores,
        notes=tuple(notes),
    )
