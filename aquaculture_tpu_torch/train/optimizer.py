"""Grouped nesterov SGD with warmup: the public YOLOv5 training recipe.

Counterpart of aquaculture_tpu/train/optimizer.py. Three parameter groups,
classified by the last component of the parameter's name:
  g0: BatchNorm scales        (``scale``)                no weight decay
  g1: conv weights            (``weight`` / ``w``)       weight decay 5e-4
  g2: biases                  (``bias``/``b``, BN too)   no decay, warmup lr from 0.1
BN running statistics (``mean``/``var``) are group 2 in the JAX package's
tree with a zero gradient, so they never move: here they are buffers and
stay out of the update (the checkpoint still carries zero momenta for them).

Schedules: linear epoch lr lf(e) = (1 - e/E)(1 - lrf) + lrf; per-step
warmup over the first max(3 epochs, 100 steps): lr rises 0 -> lr0*lf
(biases fall 0.1 -> lr0*lf), momentum 0.8 -> 0.937. ``lr_at`` computes the
schedule in float32 on the host, as the JAX package computes it on the
device, from the optimizer's own step counter.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from aquaculture_tpu_torch.config import TrainConfig

# Parameter groups
G_BN_SCALE, G_WEIGHT, G_BIAS = 0, 1, 2


def group_of(name: str) -> int:
    """The group of a parameter by its ``.``- or ``/``-separated name."""
    last = name.replace("/", ".").split(".")[-1]
    if last == "scale":
        return G_BN_SCALE
    if last in ("b", "bias", "mean", "var"):
        return G_BIAS
    return G_WEIGHT


def group_tree(tree):
    """A JAX-format parameter tree -> the same tree of group ids."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return group_of(".".join(path))

    return walk(tree, ())


def lr_at(step: int, steps_per_epoch: int, cfg: TrainConfig) -> Tuple[np.float32, np.float32, np.float32]:
    """(lr_main, lr_bias, momentum) at an integer step, in float32 with the
    JAX package's operation order."""
    f = np.float32
    step = f(step)
    epoch_f = np.clip(step / f(steps_per_epoch), f(0.0), f(cfg.epochs))  # never negative past the end
    lf = (f(1.0) - epoch_f / f(cfg.epochs)) * f(1.0 - cfg.lrf) + f(cfg.lrf)
    target = f(cfg.lr0) * lf

    nw = f(max(cfg.warmup_epochs * steps_per_epoch, 100.0))
    w = np.clip(step / nw, f(0.0), f(1.0))
    warm = step < nw
    lr_main = w * target if warm else target
    lr_bias = f(cfg.warmup_bias_lr) + w * (target - f(cfg.warmup_bias_lr)) if warm else target
    mom = f(cfg.warmup_momentum) + w * f(cfg.momentum - cfg.warmup_momentum) if warm else f(cfg.momentum)
    return f(lr_main), f(lr_bias), f(mom)


@torch.no_grad()
def sgd_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    momentum: Dict[str, torch.Tensor],
    step: int,
    steps_per_epoch: int,
    cfg: TrainConfig,
) -> None:
    """One nesterov-SGD step with grouped lr and decay, in place on
    ``params`` and ``momentum`` (float32, by name), at optimizer step
    ``step``. Per parameter, as in the JAX package:
        g = g + wd * p                 (group 1 only)
        buf = mom * buf + g
        p = p - lr * (g + mom * buf)
    with one multi-tensor op per group and operation."""
    lr_main, lr_bias, mom = (float(v) for v in lr_at(step, steps_per_epoch, cfg))
    groups: Dict[int, tuple] = {}
    for name, p in params.items():
        ps, gs, bs = groups.setdefault(group_of(name), ([], [], []))
        ps.append(p)
        gs.append(grads[name].float())
        bs.append(momentum[name])
    for gid, (ps, gs, bs) in groups.items():
        if gid == G_WEIGHT:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, cfg.weight_decay))
        torch._foreach_mul_(bs, mom)
        torch._foreach_add_(bs, gs)
        step_dir = torch._foreach_mul(bs, mom)
        torch._foreach_add_(step_dir, gs)
        torch._foreach_mul_(step_dir, lr_bias if gid == G_BIAS else lr_main)
        torch._foreach_sub_(ps, step_dir)
