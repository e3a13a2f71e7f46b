"""Reader of the JAX package's parameter checkpoints, without JAX.

A checkpoint directory holds ``params.npz`` (one array per leaf, keyed by
the ``/``-joined dict keys and list indices of its path) and
``treedef.json`` (``{"treedef": nested dicts/lists with null leaves,
"metadata": {...}}``), as aquaculture_tpu/utils/checkpoint.py writes them.
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
