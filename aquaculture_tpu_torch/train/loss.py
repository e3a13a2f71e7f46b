"""YOLOv5 composite detection loss on fixed-shape labels.

Counterpart of aquaculture_tpu/train/loss.py, expression for expression:
anchor-ratio target assignment with 3-cell neighbourhood expansion, CIoU
box regression, BCE objectness with IoU-valued targets and per-level
balance, BCE classification, and ultralytics' gain rescaling by level
count, class count and resolution. Labels are a fixed (B, M, 5) tensor
with a validity mask; every match lives in a fixed (B, M, na, 5) lattice
whose invalid entries are masked out of each reduction, so the loss has no
data-dependent control flow.

Where the JAX package differentiates, this module does the same: the
gather of matched predictions accumulates the gradients of repeated
indices (advanced indexing), ``jnp.maximum`` ties split the gradient
(``torch.maximum``), and the two ``stop_gradient``s are ``detach``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

# Per-level objectness balance: 3-level P5 models use ultralytics'
# [4.0, 1.0, 0.4]; 4-level P6 models its nl=4 table [4.0, 1.0, 0.25, 0.06].
OBJ_BALANCE = (4.0, 1.0, 0.4)
OBJ_BALANCE_P6 = (4.0, 1.0, 0.25, 0.06)

# Neighbour-cell offsets: centre, left, up, right, down (in grid cells).
_OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))
_OFFSET_GAIN = 0.5


@functools.lru_cache(maxsize=None)
def _constant(device: torch.device, values: tuple) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once per device and
    value: a tensor made from host values inside the step would copy
    synchronously, and the host would wait for the card at every level.
    Made outside inference mode, as autograd saves the anchors."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def _max(a: torch.Tensor, b: float) -> torch.Tensor:
    # jnp.maximum against a constant: ties split the gradient, as there
    return torch.maximum(a, a.new_full((), b))


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between (..., 4) cxcywh boxes."""
    b1x, b1y, b1w, b1h = box1.unbind(-1)
    b2x, b2y, b2w, b2h = box2.unbind(-1)
    b1x0, b1x1 = b1x - b1w / 2, b1x + b1w / 2
    b1y0, b1y1 = b1y - b1h / 2, b1y + b1h / 2
    b2x0, b2x1 = b2x - b2w / 2, b2x + b2w / 2
    b2y0, b2y1 = b2y - b2h / 2, b2y + b2h / 2

    iw = _max(torch.minimum(b1x1, b2x1) - torch.maximum(b1x0, b2x0), 0.0)
    ih = _max(torch.minimum(b1y1, b2y1) - torch.maximum(b1y0, b2y0), 0.0)
    inter = iw * ih
    union = b1w * b1h + b2w * b2h - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x1, b2x1) - torch.minimum(b1x0, b2x0)  # enclosing box
    ch = torch.maximum(b1y1, b2y1) - torch.minimum(b1y0, b2y0)
    c2 = cw * cw + ch * ch + eps
    rho2 = (b2x - b1x) ** 2 + (b2y - b1y) ** 2
    v = (4.0 / math.pi**2) * torch.square(
        torch.arctan(b2w / _max(b2h, eps)) - torch.arctan(b1w / _max(b1h, eps))
    )
    alpha = (v / (v - iou + (1.0 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (the JAX package's
    stable form)."""
    return _max(logits, 0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def _level_matches(
    labels: torch.Tensor,
    label_mask: torch.Tensor,
    anchors_grid: torch.Tensor,
    gh: int,
    gw: int,
    anchor_t: float,
) -> Dict[str, torch.Tensor]:
    """Fixed-shape target assignment for one detection level.

    Args:
        labels: (B, M, 5) rows [cls, cx, cy, w, h] in GRID units of this level
        label_mask: (B, M) validity
        anchors_grid: (na, 2) anchor wh in grid units
    Returns a dict of (B, M, na, O) match tensors: valid, gi, gj (int64),
    txy and twh (..., 2) relative to the cell, tcls (int64).
    """
    b, m, _ = labels.shape
    na = anchors_grid.shape[0]
    o = len(_OFFSETS)
    offsets = _constant(labels.device, _OFFSETS)

    wh = labels[..., 3:5]  # (B, M, 2)
    r = wh[:, :, None, :] / anchors_grid[None, None, :, :]  # (B, M, na, 2)
    ratio_ok = torch.amax(torch.maximum(r, 1.0 / _max(r, 1e-9)), dim=-1) < anchor_t

    gxy = labels[..., 1:3]  # (B, M, 2) grid coords
    gxi = torch.stack([gw - gxy[..., 0], gh - gxy[..., 1]], -1)  # inverse grid coords
    fx, fy = gxy[..., 0] % 1.0, gxy[..., 1] % 1.0
    ix, iy = gxi[..., 0] % 1.0, gxi[..., 1] % 1.0
    g = _OFFSET_GAIN
    # offset validity: centre always; left/up need frac < g and coord > 1;
    # right/down need inverse-frac < g and inverse-coord > 1 (public v5 rule)
    off_ok = torch.stack(
        [
            torch.ones_like(fx, dtype=torch.bool),
            (fx < g) & (gxy[..., 0] > 1.0),
            (fy < g) & (gxy[..., 1] > 1.0),
            (ix < g) & (gxi[..., 0] > 1.0),
            (iy < g) & (gxi[..., 1] > 1.0),
        ],
        dim=-1,
    )  # (B, M, O)

    valid = (
        label_mask[:, :, None, None]
        & ratio_ok[:, :, :, None]
        & off_ok[:, :, None, :]
        & (torch.amin(wh, -1) > 0)[:, :, None, None]
    )  # (B, M, na, O)

    cell = torch.floor(gxy[:, :, None, :] - offsets[None, None, :, :] * g)  # (B, M, O, 2)
    gi = cell[..., 0].clamp(0, gw - 1).long()  # (B, M, O)
    gj = cell[..., 1].clamp(0, gh - 1).long()
    gi = gi[:, :, None, :].expand(b, m, na, o)
    gj = gj[:, :, None, :].expand(b, m, na, o)

    txy = gxy[:, :, None, None, :] - torch.stack([gi, gj], -1).float()  # relative to the cell
    twh = wh[:, :, None, None, :].expand(b, m, na, o, 2)
    tcls = labels[..., 0][:, :, None, None].expand(b, m, na, o).long()
    return {"valid": valid, "gi": gi, "gj": gj, "txy": txy, "twh": twh, "tcls": tcls}


def yolo_loss(
    feats: List[torch.Tensor],
    labels: torch.Tensor,
    label_mask: torch.Tensor,
    anchors: Sequence,
    num_classes: int,
    strides: Sequence[int] = (8, 16, 32),
    box_gain: float = 0.05,
    cls_gain: float = 0.5,
    obj_gain: float = 1.0,
    anchor_t: float = 4.0,
    label_smoothing: float = 0.0,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total detection loss over raw head maps.

    Args:
        feats: per-level raw maps (B, H_l, W_l, na*no) from ``YoloV5.features``
        labels: (B, M, 5) [cls, cx, cy, w, h] in INPUT-IMAGE pixels
        label_mask: (B, M) bool validity (fixed-shape padding)
        anchors: per level (na, 2) anchor wh in input-image pixels
    Returns:
        (loss, metrics): the loss summed per ultralytics convention
        (mean per component * batch size); metrics holds the scaled
        ``box``, ``obj``, ``cls`` terms and ``total``.

    Callers pass the raw hyp gains; they are rescaled here as ultralytics'
    train.py does (box *= 3/nl, cls *= nc/80 * 3/nl, obj *= (img/640)^2 *
    3/nl), with nl from ``feats``, img from the stride-8 grid.

    group: the data-axis process group of a multi-process step, whose ranks
    each hold their rows of the global batch. The normalizers are then the
    global batch's, as in the JAX package's step over a mesh: the match
    count and the objectness element count of each level and the batch size
    are all-reduced, so the returned loss is this rank's SHARE of the
    global loss (the shares sum to it, and so do their gradients), and the
    metrics are all-reduced sums of the shares: the global values, equal
    on every rank.
    """
    b = feats[0].shape[0]
    na = len(anchors[0])
    no = num_classes + 5
    cp = 1.0 - 0.5 * label_smoothing
    cn = 0.5 * label_smoothing
    dev = feats[0].device

    nl = len(feats)
    img_size = float(feats[0].shape[1] * strides[0])
    box_gain = box_gain * 3.0 / nl
    cls_gain = cls_gain * (num_classes / 80.0) * 3.0 / nl
    obj_gain = obj_gain * (img_size / 640.0) ** 2 * 3.0 / nl

    lbox = 0.0
    lobj = 0.0
    lcls = 0.0

    # zip would silently drop levels on a feats/strides mismatch (a P6
    # model with the 3-level default strides): fail loudly instead
    if not len(feats) == len(strides) == len(anchors):
        raise ValueError(
            f"level mismatch: {len(feats)} feature maps, {len(strides)} strides, "
            f"{len(anchors)} anchor levels; pass strides=model.strides and "
            "anchors=model.anchor_table")
    balance = OBJ_BALANCE_P6 if len(feats) == 4 else OBJ_BALANCE
    lab = labels.float()
    levels = []
    for li, (f, stride) in enumerate(zip(feats, strides)):
        anc = _constant(dev, tuple(map(tuple, anchors[li]))) / float(stride)  # grid units
        lab_grid = torch.cat([lab[..., 0:1], lab[..., 1:5] / float(stride)], -1)
        levels.append((anc, _level_matches(lab_grid, label_mask, anc, f.shape[1], f.shape[2], anchor_t)))
    if group is not None:
        # the global batch's normalizers: per level the matches and the
        # objectness elements, then the batch size, in one all-reduce
        sizes = tuple(float(b * f.shape[1] * f.shape[2] * na) for f in feats) + (float(b),)
        norms = torch.cat([torch.stack([mt["valid"].sum() for _, mt in levels]).float(), _constant(dev, sizes)])
        dist.all_reduce(norms, group=group)
    for li, (f, bal, (anc, mt)) in enumerate(zip(feats, balance, levels)):
        gh, gw = f.shape[1], f.shape[2]
        p = f.reshape(b, gh, gw, na, no).float()
        valid = mt["valid"]  # (B, M, na, O)
        n_match = valid.sum().clamp_min(1).float() if group is None else norms[li].clamp_min(1)

        # gather the predictions at matched cells (repeated cells accumulate
        # their gradients)
        bidx = torch.arange(b, device=dev)[:, None, None, None].expand(valid.shape)
        aidx = torch.arange(na, device=dev)[None, None, :, None].expand(valid.shape)
        flat = p.reshape(b, gh * gw, na, no)
        lin = mt["gj"] * gw + mt["gi"]  # (B, M, na, O)
        pm = flat[bidx, lin, aidx]  # (B, M, na, O, no)

        # decode the matched predictions (training transform, grid units)
        pxy = torch.sigmoid(pm[..., 0:2]) * 2.0 - 0.5
        pwh = torch.square(torch.sigmoid(pm[..., 2:4]) * 2.0) * anc[None, None, :, None, :]
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([mt["txy"], mt["twh"]], -1)
        iou = ciou(pbox, tbox)  # (B, M, na, O)
        lbox = lbox + torch.where(valid, 1.0 - iou, 0.0).sum() / n_match

        # objectness targets: the detached IoU at matched positions, the
        # largest where several matches share a cell
        scat = torch.where(valid, iou.detach().clamp_min(0.0), 0.0)
        idx = ((bidx * (gh * gw) + lin) * na + aidx).reshape(-1)
        tobj = torch.zeros(b * gh * gw * na, dtype=torch.float32, device=dev)
        tobj = tobj.scatter_reduce(0, idx, scat.reshape(-1), "amax", include_self=True)
        obj_bce = _bce(flat[..., 4], tobj.reshape(b, gh * gw, na))
        if group is None:
            lobj = lobj + bal * torch.mean(obj_bce)
        else:
            lobj = lobj + bal * (obj_bce.sum() / norms[nl + li])

        # classification (only when multi-class); an out-of-range class
        # index gives an all-zero row, as jax.nn.one_hot does
        if num_classes > 1:
            onehot = (mt["tcls"][..., None] == torch.arange(num_classes, device=dev)).float()
            cls_bce = _bce(pm[..., 5:], onehot * cp + cn).sum(-1)
            lcls = lcls + torch.where(valid, cls_bce, 0.0).sum() / (n_match * num_classes)

    lbox = lbox * box_gain
    lobj = lobj * obj_gain
    lcls = lcls * cls_gain if num_classes > 1 else torch.zeros((), dtype=torch.float32, device=dev)
    if group is None:
        total = (lbox + lobj + lcls) * b
        return total, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}
    total = (lbox + lobj + lcls) * norms[-1]
    metrics = torch.stack([lbox, lobj, lcls, total]).detach()
    dist.all_reduce(metrics, group=group)
    return total, dict(zip(("box", "obj", "cls", "total"), metrics.unbind()))
