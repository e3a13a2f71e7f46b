"""Detection mAP: COCO-style AP@[.5:.95] and AP@.5 (numpy, host side).

A copy of aquaculture_tpu/eval/map.py: per image, detections
(score-descending) greedily claim the best-IoU unmatched ground truth of the
same class at each IoU threshold, with COCOeval's tie-break (the last of
equal best-IoU ground truths wins); AP integrates the 101-point interpolated
precision-recall curve. The reference's training stack reports mAP through
ultralytics val.py (reference README.md:52).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_image(
    det_boxes: np.ndarray,
    det_cls: np.ndarray,
    gt_boxes: np.ndarray,
    gt_cls: np.ndarray,
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
) -> np.ndarray:
    """(n_det, n_thresh) bool TP matrix for one image. Detections must be
    score-descending; each GT is claimed at most once per threshold."""
    n_t = len(iou_thresholds)
    tp = np.zeros((len(det_boxes), n_t), bool)
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return tp
    iou = _box_iou(det_boxes, gt_boxes)
    same = det_cls[:, None] == gt_cls[None, :]
    iou = np.where(same, iou, 0.0)
    for ti, t in enumerate(iou_thresholds):
        claimed = np.zeros(len(gt_boxes), bool)
        for di in range(len(det_boxes)):
            cand = np.where(~claimed & (iou[di] >= t))[0]
            if len(cand):
                # COCOeval tie-break: among equal best-IoU ground truths
                # the LAST one wins (cocoeval.py's `ious < iou: continue`
                # lets an equal IoU overwrite the match). Claiming the
                # first instead can strand a later detection whose only
                # candidate was the earlier gt — found by the round-5
                # oracle fuzz's adversarial tie case.
                rev = iou[di, cand][::-1]
                best = cand[len(cand) - 1 - int(np.argmax(rev))]
                claimed[best] = True
                tp[di, ti] = True
    return tp


def average_precision(tp: np.ndarray, conf: np.ndarray, n_gt: int) -> np.ndarray:
    """(n_det, n_thresh) TP flags + confidences -> per-threshold AP via the
    101-point interpolation (COCO)."""
    n_t = tp.shape[1] if tp.ndim == 2 else 1
    if n_gt == 0 or len(tp) == 0:
        return np.zeros(n_t)
    order = np.argsort(-conf, kind="stable")
    tp = tp[order]
    aps = np.zeros(n_t)
    for ti in range(n_t):
        cum_tp = np.cumsum(tp[:, ti])
        cum_fp = np.cumsum(~tp[:, ti])
        recall = cum_tp / n_gt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
        # precision envelope + 101-point integration
        r_pts = np.linspace(0, 1, 101)
        p_env = np.maximum.accumulate(precision[::-1])[::-1]
        idx = np.searchsorted(recall, r_pts, side="left")
        p_at = np.where(idx < len(p_env), p_env[np.minimum(idx, len(p_env) - 1)], 0.0)
        aps[ti] = p_at.mean()
    return aps


def evaluate_map(
    detections: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
) -> Dict[str, float]:
    """Dataset mAP.

    Args:
        detections: per image (boxes (N,4) xyxy, conf (N,), cls (N,)) —
            e.g. the outputs of batched_nms after masking
        ground_truths: per image (boxes (M,4) xyxy, cls (M,))
    Returns:
        {'map50': ..., 'map': ..., 'ap_per_class': {cls: ap50_95}}
    """
    per_class_tp: Dict[int, List[np.ndarray]] = {c: [] for c in range(num_classes)}
    per_class_conf: Dict[int, List[np.ndarray]] = {c: [] for c in range(num_classes)}
    per_class_ngt = np.zeros(num_classes, int)

    for (db, dc, dk), (gb, gk) in zip(detections, ground_truths):
        order = np.argsort(-np.asarray(dc), kind="stable")
        db, dc, dk = np.asarray(db)[order], np.asarray(dc)[order], np.asarray(dk)[order]
        gb, gk = np.asarray(gb), np.asarray(gk)
        tp = match_image(db, dk, gb, gk, iou_thresholds)
        for c in range(num_classes):
            sel = dk == c
            per_class_tp[c].append(tp[sel])
            per_class_conf[c].append(dc[sel])
            per_class_ngt[c] += int((gk == c).sum())

    ap50, ap_all = [], []
    ap_per_class = {}
    for c in range(num_classes):
        if per_class_ngt[c] == 0:
            continue
        tp = np.concatenate(per_class_tp[c]) if per_class_tp[c] else np.zeros((0, len(iou_thresholds)), bool)
        conf = np.concatenate(per_class_conf[c]) if per_class_conf[c] else np.zeros(0)
        aps = average_precision(tp, conf, int(per_class_ngt[c]))
        ap50.append(aps[0])
        ap_all.append(aps.mean())
        ap_per_class[c] = float(aps.mean())
    return {
        "map50": float(np.mean(ap50)) if ap50 else 0.0,
        "map": float(np.mean(ap_all)) if ap_all else 0.0,
        "ap_per_class": ap_per_class,
    }
