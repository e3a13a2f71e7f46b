"""Carry a JAX-package parameter tree into the PyTorch model.

The JAX package keeps parameters as nested dicts/lists of HWIO arrays
(``utils/checkpoint.py`` saves them by ``/``-joined path). The port's
``YoloV5`` names its parameters after the same paths, so the mapping is by
name: ``b2/m/0/cv1/w`` -> ``b2.m.0.cv1.weight`` (HWIO -> OIHW with
``transpose(3, 2, 0, 1)``) and ``.../b`` -> ``.../bias``. Ultralytics
``.pt`` files come in a later slice of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from aquaculture_tpu_torch.models.yolov5 import DOWN_LAYERS


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree -> {"/"-joined path: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _is_unfused(tree) -> bool:
    if isinstance(tree, dict):
        return "bn" in tree or any(_is_unfused(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_is_unfused(v) for v in tree)
    return False


def _accepts(name: str, want: tuple, got: tuple) -> bool:
    """Shape check, allowing the kernel layouts ``features`` dispatches on:
    the stem as k6 over 3 channels or k3 over 12 (space-to-depth), a
    downsample as k3 or k2 over 4x the channels (space-to-depth)."""
    if want == got:
        return True
    layer = name.split(".")[0]
    if not name.endswith("weight") or len(got) != 4 or got[0] != want[0]:
        return False
    if layer == "b0":
        return got[1:] in ((3, 6, 6), (12, 3, 3))
    if layer in DOWN_LAYERS and name == f"{layer}.weight":
        cin = want[1] // 4 if want[-1] == 2 else want[1]  # an earlier load may hold k2
        return got[1:] in ((cin, 3, 3), (4 * cin, 2, 2))
    return False


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a JAX-package tree of numpy arrays into ``model`` (a ``YoloV5``,
    or one of its blocks given a fused tree) in place and return it.

    An unfused tree is fused first with the port's numpy fuse (as the JAX
    package's ``YoloV5.fuse``). Every leaf is consumed exactly once; a
    missing or extra leaf, or a shape the model cannot run, raises. Weights
    are stored as float32 (an exact upcast of float16 leaves); cast the
    model for serving."""
    if _is_unfused(tree):
        tree = model.fuse(tree)
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    want = {}
    for name in params:
        *path, leaf = name.split(".")
        want["/".join([*path, {"weight": "w", "bias": "b"}[leaf]])] = name
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree does not match {type(model).__name__}: "
                       f"missing {missing}, extra {extra}")
    for key, name in want.items():
        *path, leaf = name.split(".")
        arr = np.asarray(flat[key])
        if leaf == "weight":
            arr = arr.transpose(3, 2, 0, 1)
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
        p = params[name]
        if not _accepts(name, tuple(p.shape), tuple(t.shape)):
            raise ValueError(f"{key}: shape {tuple(t.shape)} (OIHW) does not fit {name} {tuple(p.shape)}")
        setattr(model.get_submodule(".".join(path)), leaf,
                torch.nn.Parameter(t.to(p.device), requires_grad=False))
    return model
