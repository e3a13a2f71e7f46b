"""The JAX package's parameter checkpoints, read and written without JAX.

A checkpoint directory holds ``params.npz`` (one array per leaf, keyed by
the ``/``-joined dict keys and list indices of its path) and
``treedef.json`` (``{"treedef": nested dicts/lists with null leaves,
"metadata": {...}}``), as aquaculture_tpu/utils/checkpoint.py writes them.
``save_params`` writes the same files: the npz entries in the JAX
package's flattening order (dict keys sorted, lists by index) and the
treedef in the tree's own order, so either package reads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


def _unflatten(spec, flat: Dict[str, np.ndarray], prefix: str = ""):
    if spec is None:
        return flat[prefix.rstrip("/")]
    if isinstance(spec, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in spec.items()}
    return [_unflatten(v, flat, f"{prefix}{i}/") for i, v in enumerate(spec)]


def load_params(path: str) -> Any:
    """-> nested dict/list tree of numpy arrays, in the stored dtypes."""
    with open(os.path.join(path, "treedef.json")) as f:
        spec = json.load(f)["treedef"]
    with np.load(os.path.join(path, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(spec, flat)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "treedef.json")) as f:
        return json.load(f).get("metadata", {})


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree -> {"/"-joined path: leaf}, in the JAX
    package's flattening order (dict keys sorted, lists by index)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def unflatten_paths(flat: Dict[str, np.ndarray]):
    """{"/"-joined path: leaf} -> nested tree; a dict whose keys are all
    indices becomes a list. Dict keys come out sorted, the order the JAX
    package's trees have after a training step."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[k]) for k in sorted(node, key=int)]
        return {k: build(node[k]) for k in sorted(node)}

    return build(root)


def _treedef_spec(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _treedef_spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_treedef_spec(v) for v in tree]
    return None  # leaf


def save_params(path: str, params: Any, metadata: dict | None = None) -> None:
    """Save a tree of numpy arrays to ``<path>/params.npz`` + ``treedef.json``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **flatten_tree(params))
    with open(os.path.join(path, "treedef.json"), "w") as f:
        json.dump({"treedef": _treedef_spec(params), "metadata": metadata or {}}, f)
