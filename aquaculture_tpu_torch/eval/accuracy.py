"""Serving-accuracy harness of the PyTorch port: mAP for every serving option.

A copy of aquaculture_tpu/eval/accuracy.py. The reference's operating point
is accuracy-selected (reference src/get_kfold_cluster_performance.py:538-546),
so a serving option that changes the arithmetic (int8, TTA, multi-label, a
smaller candidate pool) is bounded by its measured mAP, not only by its
speed: ``serving_accuracy_table`` evaluates a trained checkpoint on a
rendered world under each option (tests/test_accuracy.py holds the bounds).
The port's models hold their weights, so the functions take a model where
the JAX package takes a model and its parameters, and a ``device``
(CUDA unless the CPU is asked for).
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.eval.map import evaluate_map


def load_world_ground_truths(lab_dir: str, tile: int = 1024) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """YOLO-format label dir -> [(stem, boxes_xyxy_px, cls)] sorted by stem."""
    out = []
    for lp in sorted(glob.glob(os.path.join(lab_dir, "*.txt"))):
        stem = os.path.basename(lp)[:-4]
        rows = np.loadtxt(lp, ndmin=2)
        if rows.size == 0:
            out.append((stem, np.zeros((0, 4)), np.zeros(0, int)))
            continue
        g = rows[:, 1:5] * float(tile)
        gb = np.stack(
            [g[:, 0] - g[:, 2] / 2, g[:, 1] - g[:, 3] / 2,
             g[:, 0] + g[:, 2] / 2, g[:, 1] + g[:, 3] / 2],
            axis=1,
        )
        out.append((stem, gb, rows[:, 0].astype(int)))
    return out


def detections_by_image(
    paths: Sequence[str],
    model,
    cfg: DetectConfig,
    batch_size: int = 8,
    decode_scale: bool = False,
    device="cuda",
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Run the serving pipeline (pipeline.detect_files) and group the
    detections by tile stem. decode_scale: the host decodes at img/tile
    scale, so the harness bounds decode-at-scale serving too."""
    from aquaculture_tpu_torch.pipeline import detect_files

    boxes, conf, cls, specs, _ = detect_files(
        paths, model, cfg, batch_size=batch_size, decode_scale=decode_scale, device=device,
    )
    per: Dict[str, List[int]] = {}
    for i, sp in enumerate(specs):
        stem = f"{sp.name}_{sp.bbox_ind}_{sp.x_offset}_{sp.y_offset}"
        per.setdefault(stem, []).append(i)
    out = {}
    for stem, idx in per.items():
        sel = np.asarray(idx, int)
        out[stem] = (boxes[sel].astype(float), conf[sel], cls[sel])
    return out


def world_map(
    paths: Sequence[str],
    lab_dir: str,
    model,
    cfg: DetectConfig,
    num_classes: int = 2,
    batch_size: int = 8,
    tile: int = 1024,
    decode_scale: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """mAP of one serving configuration over a rendered world.

    tile: the world's image size in px; YOLO labels are normalized, so the
    ground-truth boxes scale by it."""
    gts = load_world_ground_truths(lab_dir, tile=tile)
    dets = detections_by_image(paths, model, cfg, batch_size, decode_scale=decode_scale, device=device)
    # A detection stem with no ground-truth entry would vanish from the
    # evaluation (its false positives never counted): an image without a
    # labels/*.txt, or a raster larger than `tile` split into subtiles.
    # Both misconfigure the harness, so it raises.
    gt_stems = {stem for stem, _, _ in gts}
    unmatched = sorted(set(dets) - gt_stems)
    if unmatched:
        raise ValueError(
            f"{len(unmatched)} detection stem(s) have no ground-truth label "
            f"file (first: {unmatched[0]!r}). Every world image needs a "
            f"labels/<stem>.txt (empty for negatives), and `tile` must match "
            f"the world's image size so images aren't split into subtiles."
        )
    d_list, g_list = [], []
    for stem, gb, gk in gts:
        db, dc, dk = dets.get(stem, (np.zeros((0, 4)), np.zeros(0), np.zeros(0, int)))
        d_list.append((db, dc, dk))
        g_list.append((gb, gk))
    return evaluate_map(d_list, g_list, num_classes=num_classes)


@dataclasses.dataclass
class ServingConfigResult:
    name: str
    map50: float
    map: float


def load_checkpoint_f32(ckpt_dir: str, variant: str, num_classes: int):
    """A checkpoint's float leaves upcast to float32, then BN-fused and
    loaded into a serving YoloV5 (the committed fixture
    tests/data/demo_ckpt_n160 stores float16; fusion runs in float32)."""
    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5
    from aquaculture_tpu_torch.utils.checkpoint import flatten_tree, load_params, unflatten_paths

    flat = flatten_tree(load_params(ckpt_dir))
    flat = {k: v.astype(np.float32) if np.issubdtype(v.dtype, np.floating) else v for k, v in flat.items()}
    return load_jax_params(YoloV5(variant, num_classes), unflatten_paths(flat))


SERVING_CONFIGS = (
    "f32", "bf16", "int8_mixed", "int8_full", "int8_safe", "tta", "multi_label"
)


def serving_accuracy_table(
    world_images_dir: str,
    lab_dir: str,
    ckpt_dir: str,
    variant: str = "n",
    num_classes: int = 2,
    img_size: int = 160,
    conf_threshold: float = 1e-3,
    configs: Sequence[str] = SERVING_CONFIGS,
    batch_size: int = 8,
    tile: int = 1024,
    device="cuda",
) -> List[ServingConfigResult]:
    """Evaluate every serving option on one world with one checkpoint, on
    ``device``: one row per config ('bf16' is the serving default and the
    baseline of the others; 'topk512' is the candidate pool of 512 in place
    of 1024, outside the default set as in the JAX package). Each row
    serves its own copy of the float32 model, since serving casts a model
    in place."""
    from aquaculture_tpu_torch.cli.detect import quantize_for_serving
    from aquaculture_tpu_torch.models.quantize import SERVING_INT8_SKIP, serving_int8_safe_skip

    paths = sorted(
        p
        for ext in ("jpeg", "jpg", "png")
        for p in glob.glob(os.path.join(world_images_dir, f"*.{ext}"))
    )
    model = load_checkpoint_f32(ckpt_dir, variant, num_classes)
    int8_skips = {"int8_mixed": SERVING_INT8_SKIP, "int8_full": (), "int8_safe": serving_int8_safe_skip(variant)}

    rows: List[ServingConfigResult] = []
    for name in configs:
        cfg_kw = dict(img_size=img_size, conf_threshold=conf_threshold)
        m = copy.deepcopy(model)
        if name == "f32":
            cfg_kw["dtype"] = "float32"
        elif name == "bf16":
            pass
        elif name in int8_skips:
            m = quantize_for_serving(m, paths, img_size, skip=int8_skips[name], device=device)
        elif name == "tta":
            cfg_kw["augment"] = True
        elif name == "multi_label":
            cfg_kw["multi_label"] = True
        elif name == "topk512":
            cfg_kw["pre_nms_topk"] = 512
        else:
            raise ValueError(f"unknown serving config {name!r}")
        r = world_map(paths, lab_dir, m, DetectConfig(**cfg_kw), num_classes, batch_size, tile=tile,
                      device=device)
        rows.append(ServingConfigResult(name=name, map50=r["map50"], map=r["map"]))
    return rows
