"""The train step and the serving program over a (data, model) mesh.

Counterpart of aquaculture_tpu/parallel/sharded.py. The JAX package jits
one SPMD program whose arithmetic is the global batch's and lets GSPMD
insert the collectives. Here each rank runs the port's step on its rows of
the global batch with the collectives written out, so the arithmetic is the
same (train/trainer.py, train/loss.py, models/layers.BatchNorm):

* data axis: BatchNorm statistics and the loss's normalizers over the
  global batch, gradients summed over the data group, SGD and EMA
  replicated;
* model axis (n_model > 1): every TrainConvBlock whose output channels
  divide n_model holds its rank's channel slice (mesh.param_shardings)
  and gathers its output channels, so everything else stays replicated.
  Checkpoints hold the gathered tree (``full_state_tree``), the single
  process's ``state/``: ``--resume`` works across mesh shapes and
  packages.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aquaculture_tpu_torch.config import IM_WIDTH, DetectConfig, TrainConfig
from aquaculture_tpu_torch.models.layers import ModelShard, TrainConvBlock
from aquaculture_tpu_torch.models.weights import to_tree, train_state
from aquaculture_tpu_torch.models.yolov5 import YoloV5
from aquaculture_tpu_torch.parallel.mesh import axis_rank, axis_size, batch_sharding, param_shardings, put_global
from aquaculture_tpu_torch.pipeline import make_infer_fn
from aquaculture_tpu_torch.train.trainer import TrainState, make_state_tree, make_train_step


def _shard_model(state: TrainState, mesh: DeviceMesh) -> None:
    """Keep this rank's model-axis slice of every tensor param_shardings
    splits, in the model, its momenta and its EMA (in place), and mark the
    sharded blocks."""
    n_model = axis_size(mesh, "model")
    rank = axis_rank(mesh, "model")
    model = state.model
    shardings = param_shardings(model, n_model)
    named = train_state(model)
    with torch.no_grad():
        for name, axis in shardings.items():
            if axis is None:
                continue
            fmt = torch.channels_last if named[name].dim() == 4 else torch.contiguous_format
            piece = lambda t: t.chunk(n_model, axis)[rank].clone().contiguous(memory_format=fmt)
            named[name].data = piece(named[name].data)
            state.ema[name] = piece(state.ema[name])
            if name in state.momentum:
                state.momentum[name] = piece(state.momentum[name])
    shard = ModelShard(mesh.get_group("model"), rank, n_model)
    for prefix, m in model.named_modules():
        if isinstance(m, TrainConvBlock) and shardings[f"{prefix}.weight"] is not None:
            m.shard = shard


def sharded_train_step(model: YoloV5, cfg: TrainConfig, mesh: DeviceMesh, steps_per_epoch: int,
                       state: TrainState) -> Tuple[Callable, TrainState]:
    """The train step over ``mesh``: rank 0's state broadcast to every rank
    (every rank then starts from the same parameters, momenta and EMA),
    BatchNorm and the loss over the data group, the model axis's slices
    taken. Returns (step_fn, state): ``step_fn(state, local_batch) ->
    metrics`` with this rank's rows of the global batch (shard_batch /
    shard_local_batch) on the model's device; the metrics are the global
    batch's on every rank. A one-rank mesh runs every collective as the
    identity."""
    if state.model is not model:
        raise ValueError("state does not belong to model")
    put_global([model, state.momentum, state.ema])
    model.train_options.data_group = mesh.get_group("data")
    if axis_size(mesh, "model") > 1:
        _shard_model(state, mesh)
    return make_train_step(model, cfg, steps_per_epoch), state


def _sharded_names(model: torch.nn.Module) -> set:
    out = set()
    for prefix, m in model.named_modules():
        if isinstance(m, TrainConvBlock) and m.shard is not None:
            out.update(f"{prefix}.{n}" for n, _ in list(m.named_parameters()) + list(m.named_buffers()))
    return out


def _gather_named(named: Dict[str, torch.Tensor], sharded: set, shard: ModelShard) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in named.items():
        if name not in sharded:
            out[name] = t
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(shard.size)]
        dist.all_gather(parts, t, group=shard.group)
        out[name] = torch.cat(parts, 0)
    return out


def _model_shard(model: torch.nn.Module):
    return next((m.shard for m in model.modules() if isinstance(m, TrainConvBlock) and m.shard is not None), None)


def full_state_tree(state: TrainState) -> dict:
    """The gathered, unsharded ``state/`` tree (trainer.state_tree's): a
    collective over the model group when the model axis splits tensors,
    which every rank calls; rank 0 writes it."""
    model = state.model
    shard = _model_shard(model)
    named = train_state(model)
    if shard is None:
        return make_state_tree(named, state.momentum, state.opt_step, state.ema, state.step)
    sharded = _sharded_names(model)
    return make_state_tree(_gather_named(named, sharded, shard), _gather_named(state.momentum, sharded, shard),
                           state.opt_step, _gather_named(state.ema, sharded, shard), state.step)


def full_ema_tree(state: TrainState):
    """The gathered EMA as a JAX-format tree (``<out>/last``); a collective
    over the model group like ``full_state_tree``."""
    shard = _model_shard(state.model)
    if shard is None:
        return to_tree(state.ema)
    return to_tree(_gather_named(state.ema, _sharded_names(state.model), shard))


def sharded_infer_fn(model: YoloV5, mesh: DeviceMesh, cfg: DetectConfig = DetectConfig(), tile: int = IM_WIDTH,
                     device="cuda") -> Callable:
    """Serving over the data axis: ``infer(images_u8)`` takes the GLOBAL
    (B, tile, tile, 3) uint8 batch and runs this rank's rows through
    ``make_infer_fn``'s program, returning this rank's (dets, valid) on the
    device. B must divide over the data ranks."""
    infer = make_infer_fn(model, cfg, tile, device=device)

    def run(images_u8: torch.Tensor):
        return infer(images_u8[batch_sharding(mesh, images_u8.shape[0])])

    return run
