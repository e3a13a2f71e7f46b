"""The (data, model) layout of the world's ranks and its sharding rules.

Counterpart of aquaculture_tpu/parallel/mesh.py. The JAX package builds a
``jax.sharding.Mesh`` over devices and lets GSPMD insert the collectives;
the port runs one process per device and lays the ranks out as a
``DeviceMesh`` of shape (n_data, n_model), rank = d * n_model + m as in
the JAX package's ``devices.reshape(n_data, n_model)``, with one process
group per axis:

* ``data``: the batch. Each data rank holds its rows of the global batch
  (``shard_batch`` / ``shard_local_batch``); BatchNorm statistics, the
  loss's normalizers and the gradients are summed over this group.
* ``model``: channel sharding of the training conv blocks. The tensors
  ``param_shardings`` names are split on their first (output-channel) axis
  over this group.

``put_global`` broadcasts rank 0's tensors, so every rank starts from the
same state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from aquaculture_tpu_torch.models.layers import TrainConvBlock
from aquaculture_tpu_torch.models.weights import train_state

AXES = ("data", "model")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A (data, model) DeviceMesh over every rank of the initialized world
    (one process group per axis). The device type follows the default
    backend: cuda under NCCL, cpu under gloo. n_data defaults to
    world // n_model; n_data * n_model must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized (parallel.pod.init_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else int(mesh.shape[AXES.index(axis)])


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def batch_sharding(mesh: Optional[DeviceMesh], batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size``: a contiguous
    block, in data-rank order (the JAX package's P("data"))."""
    n = axis_size(mesh, "data")
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not divide over {n} data ranks")
    per = batch_size // n
    r = axis_rank(mesh, "data")
    return slice(r * per, (r + 1) * per)


def replicated(mesh: Optional[DeviceMesh] = None) -> slice:
    """The rows of a tensor that every rank holds whole: ``slice(None)``,
    the whole batch on every rank. Counterpart of the JAX package's
    ``replicated`` (``NamedSharding(mesh, P())``): in the port's layout a
    sharding is the slice of the leading axis a rank keeps, beside
    ``batch_sharding``'s contiguous block, and a replicated tensor keeps
    all of it on every rank of any mesh."""
    return slice(None)


def _to_tensor(v, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    return t.to(device, non_blocking=True)


def shard_batch(batch: dict, mesh: Optional[DeviceMesh], device) -> dict:
    """A global host batch -> this rank's rows, as tensors on ``device``
    (no default: the caller names the card or the CPU)."""
    rows = batch_sharding(mesh, len(next(iter(batch.values()))))
    return {k: _to_tensor(v[rows], device) for k, v in batch.items()}


def shard_local_batch(batch: dict, mesh: Optional[DeviceMesh], device) -> dict:
    """Multi-process data parallelism where each rank already holds only its
    LOCAL rows of the global batch (global = the concatenation over data
    ranks, in rank order; train/dataset.py builds a rank's slots alone):
    the rows as tensors on ``device`` (no default, as ``shard_batch``)."""
    return {k: _to_tensor(v, device) for k, v in batch.items()}


def _spec_for_param(shape, n_model: int) -> Optional[int]:
    """The axis the model axis splits, or None (replicated): OIHW conv
    weights on O, and 1-D vectors (BN scale, bias and statistics), where
    the channel count divides n_model."""
    if n_model <= 1:
        return None
    if len(shape) == 4 and shape[0] % n_model == 0:
        return 0
    if len(shape) == 1 and shape[0] % n_model == 0:
        return 0
    return None


def param_shardings(model: torch.nn.Module, n_model: int) -> Dict[str, Optional[int]]:
    """By name, every tensor of a training model's state (parameters and BN
    statistics) -> the axis the model axis splits, or None.

    The port splits what a ``TrainConvBlock`` holds (its weight and its BN
    vectors) when the block's output channels divide n_model: the block
    gathers its channels after the SiLU, so its consumers stay replicated.
    The detect head's 1x1 convs stay replicated (GSPMD may split them in
    the JAX package; the arithmetic is the same)."""
    out = {}
    for prefix, module in model.named_modules():
        if not isinstance(module, TrainConvBlock):
            continue
        # the weight and the BN vectors all lead with the output channels
        axis = _spec_for_param(tuple(module.weight.shape), n_model)
        for name, _ in list(module.named_parameters()) + list(module.named_buffers()):
            out[f"{prefix}.{name}"] = axis
    return {name: out.get(name) for name in train_state(model)}


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def put_global(tree, group=None):
    """Broadcast every tensor of ``tree`` (a module's parameters and buffers,
    or the tensors of a dict or list) from the group's first rank, in place:
    every rank then holds the same values, as the JAX package's put_global
    builds global arrays from identical host copies. The identity without
    an initialized multi-rank world."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in _tensors(tree):
        dist.broadcast(t.data, src=src, group=group)
    return tree
