"""Fixed-shape class-aware non-maximum suppression in PyTorch.

Counterpart of aquaculture_tpu/ops/nms.py: top-K candidate selection, exact
greedy suppression over the K score-sorted candidates, and a fixed
(max_det, 6) output plus a validity mask. Ultralytics non_max_suppression
semantics (conf = obj * cls, class-offset boxes for class-aware NMS, hard
suppression at iou_thresh): the argmax-class branch of detect.py and the
multi-label branch of val.py. Two entry points build the candidates, from
decoded rows (``batched_nms``, ``nms``) or straight from the raw head maps
(``batched_nms_feats``); all end in the same suppression and compaction.

Suppression follows the tensors' device: CUDA tensors go through the
hand-written kernel in ops/nms_cuda.py (which launches or raises), CPU
tensors through ``greedy_suppress_plain``. Nothing chooses by catching an
error.
"""

from __future__ import annotations

from typing import Tuple

import torch

_CLASS_OFFSET = 7680.0  # > max image dim; separates classes in box space


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU in f32, the reference formula
    (aquaculture_tpu/ops/nms.py:24-32) operation for operation."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), torch.zeros_like(inter))


def greedy_suppress_plain(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float = 0.45
) -> torch.Tensor:
    """Plain PyTorch greedy suppression, batched over B: boxes (B, K, 4)
    score-sorted xyxy, valid (B, K) bool -> keep (B, K) bool.

    keep[i] survives unless an earlier kept candidate overlaps > thresh:
    K sequential steps of O(B*K) vector work over the full IoU matrix.
    The CPU path, and the oracle the CUDA kernel is held against."""
    iou = _iou_matrix(boxes.float())
    thr = torch.tensor(iou_thresh, dtype=torch.float32, device=boxes.device)
    k = iou.shape[-1]
    idx = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        suppress = (iou[:, i] > thr) & (idx > i) & keep[:, i : i + 1]
        keep &= ~suppress
    return keep


def greedy_suppress(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Suppression by device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if boxes.is_cuda:
        from aquaculture_tpu_torch.ops import nms_cuda

        return nms_cuda.greedy_suppress_cuda(boxes.contiguous(), valid.contiguous(), iou_thresh)
    if boxes.device.type != "cpu":
        raise ValueError(f"no suppression for tensors on {boxes.device}")
    return greedy_suppress_plain(boxes, valid, iou_thresh)


def _select_topk(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis in the reference's order.

    A stable descending sort sliced to k: ties keep the lower index first,
    which is lax.top_k's order and the order of the reference's exact
    two-stage path on large pools. torch.topk does not reproduce it."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _prepare_candidates(preds: torch.Tensor, conf_thresh: float, pre_topk: int,
                        class_agnostic: bool, multi_label: bool = False):
    """Batched candidate selection over (B, N, 5+nc) rows: returns (boxes
    xyxy, nms_boxes with class offsets, top_scores, cls ids, valid), each
    with a leading B axis and K = min(pre_topk, pool).

    The pool is N rows (argmax class, detect.py) or, with multi_label and
    nc > 1, the N*nc (row, class) pairs of val.py: the flat index f of a
    pair is row f // nc, class f % nc, and one row can be picked once per
    class, each copy with its own class offset."""
    pred = preds.float()
    b, n, no = pred.shape
    nc = no - 5
    obj = pred[..., 4]
    cls_scores = pred[..., 5:] * obj[..., None]
    if multi_label and nc > 1:
        k = min(pre_topk, n * nc)
        score_mat = torch.where(cls_scores >= conf_thresh, cls_scores, torch.full_like(cls_scores, -1.0))
        top_scores, flat_idx = _select_topk(score_mat.reshape(b, n * nc), k)
        top_idx = flat_idx // nc
        cls_top = (flat_idx % nc).to(torch.int32)
        sel = torch.gather(pred[..., 0:4], 1, top_idx[..., None].expand(-1, -1, 4))  # (B, k, 4)
    else:
        k = min(pre_topk, n)
        cls_id = torch.argmax(cls_scores, dim=-1)
        conf = cls_scores.amax(dim=-1) if nc > 1 else cls_scores[..., 0]
        score = torch.where(conf >= conf_thresh, conf, torch.full_like(conf, -1.0))
        top_scores, top_idx = _select_topk(score, k)
        base = torch.cat([pred[..., 0:4], cls_id.float()[..., None]], dim=-1)  # (B, N, 5)
        sel = torch.gather(base, 1, top_idx[..., None].expand(-1, -1, 5))      # (B, k, 5)
        cls_top = sel[..., 4].to(torch.int32)
    cxy, wh = sel[..., 0:2], sel[..., 2:4]
    valid = top_scores > 0
    boxes = torch.cat([cxy - wh / 2.0, cxy + wh / 2.0], dim=-1)
    nms_boxes = boxes
    if not class_agnostic:
        nms_boxes = boxes + (cls_top.float() * _CLASS_OFFSET)[..., None]
    return boxes, nms_boxes, top_scores, cls_top, valid


def _prepare_candidates_feats(feats, anchor_table, strides, conf_thresh: float, pre_topk: int,
                              class_agnostic: bool):
    """Batched argmax-class candidate selection straight from the raw NHWC
    head maps (B, h, w, na*no), one per level: the columns (B, no, na*HW)
    with HW = sum of h*w, scores and the top-k over them, then the public
    YOLOv5 decode on the k survivors only, grid cell and anchor recomputed
    from the flat index. The flat order is (anchor, position), not
    decode's (position, anchor), as in the JAX package's
    ``_prepare_candidates_feats``; only exactly tied scores can resolve
    differently from ``batched_nms`` on decoded rows."""
    b = feats[0].shape[0]
    na = len(anchor_table[0])
    c = feats[0].shape[-1]
    no = c // na
    nc = no - 5
    lvl_hw = [f.shape[1] * f.shape[2] for f in feats]
    cols = torch.cat([f.reshape(b, hw, c).float().transpose(1, 2) for f, hw in zip(feats, lvl_hw)],
                     dim=-1)                                        # (b, C, HW)
    hw_all = sum(lvl_hw)
    cols = cols.reshape(b, na, no, hw_all).transpose(1, 2).reshape(b, no, na * hw_all)

    obj = torch.sigmoid(cols[:, 4])                                 # (b, K)
    if nc > 1:
        clsz = torch.sigmoid(cols[:, 5:]) * obj[:, None, :]         # (b, nc, K)
        conf = clsz.amax(dim=1)
        cls_id = torch.argmax(clsz, dim=1).to(torch.int32)
    else:
        conf = torch.sigmoid(cols[:, 5]) * obj
        cls_id = torch.zeros_like(conf, dtype=torch.int32)
    score = torch.where(conf >= conf_thresh, conf, torch.full_like(conf, -1.0))
    top_scores, q = _select_topk(score, min(pre_topk, na * hw_all))

    tx, ty, tw, th = (torch.gather(cols[:, i], 1, q) for i in range(4))
    cls_top = torch.gather(cls_id, 1, q)

    # flat index -> (anchor, level, gy, gx) arithmetically
    a_idx = q // hw_all
    r = q % hw_all
    gx = torch.zeros_like(r)
    gy = torch.zeros_like(r)
    stride_f = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    aw = torch.zeros_like(stride_f)
    ah = torch.zeros_like(stride_f)
    off = 0
    for li, (hw_l, f) in enumerate(zip(lvl_hw, feats)):
        w_l = f.shape[2]
        in_l = (r >= off) & (r < off + hw_l)
        rl = r - off
        gx = torch.where(in_l, rl % w_l, gx)
        gy = torch.where(in_l, rl // w_l, gy)
        stride_f = torch.where(in_l, torch.full_like(stride_f, float(strides[li])), stride_f)
        for ai, (anc_w, anc_h) in enumerate(anchor_table[li]):
            m = in_l & (a_idx == ai)
            aw = torch.where(m, torch.full_like(aw, float(anc_w)), aw)
            ah = torch.where(m, torch.full_like(ah, float(anc_h)), ah)
        off += hw_l

    cx = (torch.sigmoid(tx) * 2.0 - 0.5 + gx.float()) * stride_f
    cy = (torch.sigmoid(ty) * 2.0 - 0.5 + gy.float()) * stride_f
    bw = torch.square(torch.sigmoid(tw) * 2.0) * aw
    bh = torch.square(torch.sigmoid(th) * 2.0) * ah
    boxes = torch.stack([cx - bw / 2.0, cy - bh / 2.0, cx + bw / 2.0, cy + bh / 2.0], dim=-1)
    valid = top_scores > 0
    nms_boxes = boxes
    if not class_agnostic:
        nms_boxes = boxes + (cls_top.float() * _CLASS_OFFSET)[..., None]
    return boxes, nms_boxes, top_scores, cls_top, valid


def _compact(boxes, cls_top, top_scores, keep, max_det):
    """Batched max_det compaction: the kept candidates by score, padded to
    (B, max_det, 6) rows [x0, y0, x1, y1, conf, cls] + the (B, max_det)
    validity mask."""
    kept_score = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    k = kept_score.shape[-1]
    k_out = min(max_det, k)
    out_scores, order = _select_topk(kept_score, k_out)
    det = torch.cat(
        [
            torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            out_scores[..., None],
            torch.gather(cls_top, 1, order).float()[..., None],
        ],
        dim=-1,
    )
    if k_out < max_det:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_det - k_out))
        out_scores = torch.nn.functional.pad(out_scores, (0, max_det - k_out), value=-1.0)
    return det, out_scores > 0


def _check_backend(backend: str) -> None:
    if backend != "auto":
        raise ValueError(f"unknown NMS backend {backend!r}; only 'auto' (by device)")


def batched_nms(
    preds: torch.Tensor,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_det: int = 300,
    pre_topk: int = 1024,
    class_agnostic: bool = False,
    backend: str = "auto",
    multi_label: bool = False,
    approx_topk: bool = False,
):
    """Batched NMS over (B, N, 5+nc) -> ((B, max_det, 6), (B, max_det)).

    backend: 'auto' is the only value: suppression follows the device of
    ``preds`` (CUDA -> the hand-written kernel, CPU -> the plain version).
    multi_label: one candidate per (box, class) above conf_thresh
    (ultralytics val.py semantics) instead of argmax-class.
    approx_topk: accepted for the JAX package's signature and exact here:
    its approximate top-k is a TPU lowering, and off the TPU the JAX
    package's ``approx_max_k`` is the exact top-k too."""
    _check_backend(backend)
    boxes, nms_boxes, top_scores, cls_top, valid = _prepare_candidates(
        preds, conf_thresh, pre_topk, class_agnostic, multi_label
    )
    keep = greedy_suppress(nms_boxes, valid, iou_thresh)
    return _compact(boxes, cls_top, top_scores, keep, max_det)


def nms(
    pred: torch.Tensor,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_det: int = 300,
    pre_topk: int = 1024,
    class_agnostic: bool = False,
    multi_label: bool = False,
):
    """Single-image NMS over (N, 5+nc) decoded rows -> ((max_det, 6) rows
    [x0, y0, x1, y1, conf, cls] by confidence, (max_det,) validity)."""
    det, valid = batched_nms(pred[None], conf_thresh, iou_thresh, max_det, pre_topk,
                             class_agnostic, multi_label=multi_label)
    return det[0], valid[0]


def batched_nms_feats(
    feats,
    anchor_table,
    strides,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    max_det: int = 300,
    pre_topk: int = 1024,
    class_agnostic: bool = False,
    backend: str = "auto",
    approx_topk: bool = False,
):
    """Batched NMS straight from the raw NHWC head maps (``YoloV5.features``)
    -> ((B, max_det, 6), (B, max_det)), the contract of ``batched_nms``.
    Argmax-class semantics only, as in the JAX package; approx_topk is
    exact, as in ``batched_nms``."""
    _check_backend(backend)
    boxes, nms_boxes, top_scores, cls_top, valid = _prepare_candidates_feats(
        feats, anchor_table, strides, conf_thresh, pre_topk, class_agnostic
    )
    keep = greedy_suppress(nms_boxes, valid, iou_thresh)
    return _compact(boxes, cls_top, top_scores, keep, max_det)
