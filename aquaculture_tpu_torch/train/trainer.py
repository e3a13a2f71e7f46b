"""The training step: forward in train mode, loss, gradients, grouped SGD,
EMA.

Counterpart of aquaculture_tpu/train/trainer.py. The JAX package's step is
a pure function of a state tree; here the state is the training model
(parameters and BN running statistics, in place on its device) plus the
optimizer's momenta, the EMA and two step counters, updated in place.

Mixed precision by explicit casts, as the JAX package does them (no
autocast): the input is cast to ``cfg.compute_dtype``, which every conv,
BatchNorm and activation then follows; the master parameters stay float32
and are cast to the activation dtype at use; the BN running statistics
update in float32; the loss casts the head maps to float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from aquaculture_tpu_torch.config import DTYPES, TrainConfig
from aquaculture_tpu_torch.models.weights import from_tree, load_train_params, to_tree, train_state
from aquaculture_tpu_torch.models.yolov5 import YoloV5
from aquaculture_tpu_torch.train.ema import ema_update
from aquaculture_tpu_torch.train.loss import yolo_loss
from aquaculture_tpu_torch.train.optimizer import sgd_update


@dataclasses.dataclass
class TrainState:
    model: YoloV5                      # parameters + BN running statistics
    momentum: Dict[str, torch.Tensor]  # by parameter name
    opt_step: int
    ema: Dict[str, torch.Tensor]       # every tensor of the model's state
    step: int


def init_train_state(model: YoloV5) -> TrainState:
    """Zero momenta, the EMA as a copy of the model's state, step 0."""
    return TrainState(
        model=model,
        momentum={n: torch.zeros_like(p) for n, p in model.named_parameters()},
        opt_step=0,
        ema={n: t.detach().clone() for n, t in train_state(model).items()},
        step=0,
    )


def state_tree(state: TrainState) -> dict:
    """The JAX package's ``state/`` tree: params, opt_momentum (zeros for
    the BN running statistics, which have no momentum), opt_step, ema,
    step."""
    momentum = {n: state.momentum.get(n, torch.zeros_like(t)) for n, t in train_state(state.model).items()}
    return {
        "params": to_tree(train_state(state.model)),
        "opt_momentum": to_tree(momentum),
        "opt_step": np.asarray(state.opt_step, np.int32),
        "ema": to_tree(state.ema),
        "step": np.asarray(state.step, np.int32),
    }


def load_state_tree(state: TrainState, tree: dict) -> None:
    """Restore a ``state/`` tree written by either package, in place."""
    load_train_params(state.model, tree["params"])
    with torch.no_grad():
        for name, arr in from_tree(state.model, tree["ema"]).items():
            state.ema[name].copy_(torch.from_numpy(arr))
        momentum = from_tree(state.model, tree["opt_momentum"])
        for name, buf in state.momentum.items():
            buf.copy_(torch.from_numpy(momentum[name]))
    state.opt_step = int(tree["opt_step"])
    state.step = int(tree["step"])


def make_train_step(model: YoloV5, cfg: TrainConfig, steps_per_epoch: int) -> Callable:
    """Build ``train_step(state, batch) -> metrics`` for ``model`` (a
    training ``YoloV5``); sets the model's remat switch from ``cfg``.

    Batch dict, on the model's device: images (B, S, S, 3) float in [0, 1];
    labels (B, M, 5) pixel [cls, cx, cy, w, h]; label_mask (B, M) bool.
    Metrics are 0-dim float32 tensors on the device (box, obj, cls, total).
    """
    if not model.trainable:
        raise ValueError("make_train_step needs a training model: YoloV5(..., trainable=True)")
    model.train_options.remat = cfg.remat
    compute_dtype = DTYPES[cfg.compute_dtype]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        feats = model.features(batch["images"].to(compute_dtype))
        loss, metrics = yolo_loss(
            feats,
            batch["labels"],
            batch["label_mask"],
            model.anchor_table,
            model.num_classes,
            strides=model.strides,
            box_gain=cfg.box_gain,
            cls_gain=cfg.cls_gain,
            obj_gain=cfg.obj_gain,
            anchor_t=cfg.anchor_t,
            label_smoothing=cfg.label_smoothing,
        )
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        sgd_update(params, dict(zip(params, grads)), state.momentum, state.opt_step, steps_per_epoch, cfg)
        state.opt_step += 1
        ema_update(state.ema, train_state(model), state.step + 1, cfg.ema_decay)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
