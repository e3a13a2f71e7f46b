"""Weights into the PyTorch model: JAX-package trees and ultralytics ``.pt``.

The JAX package keeps parameters as nested dicts/lists of HWIO arrays
(``utils/checkpoint.py`` saves them by ``/``-joined path). The port's
``YoloV5`` names its parameters after the same paths, so the mapping is by
name: ``b2/m/0/cv1/w`` -> ``b2.m.0.cv1.weight`` (HWIO -> OIHW with
``transpose(3, 2, 0, 1)``) and ``.../b`` -> ``.../bias``
(``load_jax_params``, into the BN-folded serving model). The int8 tree the
JAX package's ``models/quantize.quantize`` builds (and the port's copy)
loads the same way: a conv of ``{wq, wscale, xscale, b[, yscale]}`` becomes
a ``layers.QConvBlock`` (``b5/wq`` -> ``b5.wq``, kept int8), a shortcut
bottleneck's ``sum_yscale`` a parameter of its ``Bottleneck``, and the
scales stay float32. The training model
keeps the unfused tree's BatchNorm leaves (``b2/m/0/cv1/bn/mean`` <->
``b2.m.0.cv1.bn.mean``) and goes both ways: ``load_train_params`` in,
``to_tree`` back out to HWIO float32 (checkpoints, EMA, momenta).

An ultralytics ``.pt`` (the reference's weights, reference README.md:60,77)
is first turned into that same numpy tree (``load_pretrained``, a copy of
aquaculture_tpu/models/weights.py), so one bridge serves both formats. The
mapping is by layer INDEX in the ultralytics sequential model, fixed for
the public v6 architecture:

    model.0..9    backbone (Conv, Conv, C3, Conv, C3, Conv, C3, Conv, C3, SPPF)
    model.10..23  PANet neck
    model.24      Detect (m.0/m.1/m.2 1x1 convs)

P6 models (n6..x6) use the yolov5-p6 numbering instead: backbone
model.0..11 (an extra 768 -> 1024 Conv + C3 before SPPF), 4-level neck
model.12..32, Detect at model.33 with four m.* convs. Torch tensors are OIHW;
the tree stores HWIO. BatchNorm maps 1:1 (weight->scale, bias->bias,
running_mean->mean, running_var->var).

The file is read by one path, ``read_pt_state_dict``: a restricted
unpickler over the torch zip container that never imports or runs a class
named in the file (``torch.load(weights_only=False)`` would, and needs the
ultralytics ``models`` package importable for the object-pickled layout).
"""

from __future__ import annotations

import collections
import io
import pickle
import zipfile
from typing import Dict

import numpy as np
import torch

from aquaculture_tpu_torch.models import layers as L
from aquaculture_tpu_torch.models.yolov5 import DOWN_LAYERS, DOWN_LAYERS_P6
from aquaculture_tpu_torch.utils.checkpoint import flatten_tree, unflatten_paths

# our-name -> ultralytics model index
_LAYER_INDEX = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
    "b7": 7, "b8": 8, "b9": 9,
    "n10": 10, "n13": 13, "n14": 14, "n17": 17, "n18": 18, "n20": 20,
    "n21": 21, "n23": 23,
}
_DETECT_INDEX = 24

# P6 family (public yolov5-p6 yaml layer numbering)
_LAYER_INDEX_P6 = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
    "b7": 7, "b8": 8, "b9": 9, "b10": 10, "b11": 11,
    "n12": 12, "n15": 15, "n16": 16, "n19": 19, "n20": 20, "n23": 23,
    "n24": 24, "n26": 26, "n27": 27, "n29": 29, "n30": 30, "n32": 32,
}
_DETECT_INDEX_P6 = 33


def family_layout(model) -> tuple:
    """(layer_index, detect_index, sppf_name) of ``model``'s family: the
    ultralytics layer numbering, as the JAX package's ``family_layout``."""
    if getattr(model, "is_p6", False):
        return _LAYER_INDEX_P6, _DETECT_INDEX_P6, "b11"
    return _LAYER_INDEX, _DETECT_INDEX, "b9"


def has_bn(tree) -> bool:
    """Whether a parameter tree holds BatchNorm parameters (unfused)."""
    if isinstance(tree, dict):
        return "bn" in tree or any(has_bn(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_bn(v) for v in tree)
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
    # P5 "b9" is the SPPF and P6 has no "n18"/"n21", so one name set serves
    # both families: only a downsample conv has the weight "<layer>.weight"
    if layer in DOWN_LAYERS + DOWN_LAYERS_P6 and name == f"{layer}.weight":
        cin = want[1] // 4 if want[-1] == 2 else want[1]  # an earlier load may hold k2
        return got[1:] in ((cin, 3, 3), (4 * cin, 2, 2))
    return False


def tree_key(name: str) -> str:
    """A model's state name -> its path in the JAX tree:
    ``b2.m.0.cv1.weight`` -> ``b2/m/0/cv1/w``, ``head.0.bias`` ->
    ``head/0/b``, ``b2.cv1.bn.mean`` -> ``b2/cv1/bn/mean``."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        leaf = "w"
    elif leaf == "bias" and (not path or path[-1] != "bn"):
        leaf = "b"
    return "/".join([*path, leaf])


def train_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor of a model's state by name: the parameters, then the BN
    running statistics of a training model (the JAX package's ``params``
    tree)."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def from_tree(model: torch.nn.Module, tree) -> Dict[str, np.ndarray]:
    """A JAX-format tree -> arrays by the model's state names (OIHW
    weights), float32 but for int8 leaves (quantized weights), which stay
    int8; every leaf consumed once, a missing or extra leaf raises."""
    flat = flatten_tree(tree)
    names = {tree_key(n): n for n in train_state(model)}
    if set(names) != set(flat):
        raise KeyError(f"parameter tree does not match {type(model).__name__}: "
                       f"missing {sorted(set(names) - set(flat))}, extra {sorted(set(flat) - set(names))}")
    out = {}
    for key, name in names.items():
        arr = np.asarray(flat[key])
        dtype = np.int8 if arr.dtype == np.int8 else np.float32
        out[name] = np.array(arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr, dtype=dtype, order="C")
    return out


def _place_quantized_blocks(model: torch.nn.Module, node, path=()) -> None:
    """Swap a ``layers.QConvBlock`` in for every conv of ``node`` that holds
    int8 weights, and register ``sum_yscale`` on every bottleneck that has
    one, so that the model's state names match the quantized tree."""
    if isinstance(node, dict):
        if "wq" in node:
            k, _, cin, cout = node["wq"].shape
            *parent, name = path
            setattr(model.get_submodule(".".join(parent)), name, L.QConvBlock(cin, cout, k, "yscale" in node))
            return
        if "sum_yscale" in node:
            model.get_submodule(".".join(path)).register_parameter(
                "sum_yscale", torch.nn.Parameter(torch.zeros(()), requires_grad=False))
        for k, v in node.items():
            _place_quantized_blocks(model, v, (*path, k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _place_quantized_blocks(model, v, (*path, str(i)))


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a JAX-package tree of numpy arrays into ``model`` (a ``YoloV5``,
    or one of its blocks given a fused tree) in place and return it.

    An unfused tree is fused first with the port's numpy fuse (as the JAX
    package's ``YoloV5.fuse``). Every leaf is consumed exactly once; a
    missing or extra leaf, or a shape the model cannot run, raises. Weights
    are stored as float32 (an exact upcast of float16 leaves); cast the
    model for serving. An int8 tree (models/quantize.py, either package)
    first puts a QConvBlock at each quantized conv of ``model``."""
    if has_bn(tree):
        tree = model.fuse(tree)
    _place_quantized_blocks(model, tree)
    params = dict(model.named_parameters())
    for name, arr in from_tree(model, tree).items():
        *path, leaf = name.split(".")
        p = params[name]
        if not _accepts(name, tuple(p.shape), arr.shape):
            raise ValueError(f"{tree_key(name)}: shape {arr.shape} (OIHW) does not fit {name} {tuple(p.shape)}")
        setattr(model.get_submodule(".".join(path)), leaf,
                torch.nn.Parameter(torch.from_numpy(arr).to(p.device), requires_grad=False))
    return model


# ---------------------------------------------------------------------------
# the training model <-> unfused JAX-format trees, both ways
# ---------------------------------------------------------------------------

def load_train_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy an UNFUSED JAX-format tree (HWIO weights, ``bn`` dicts; from
    ``YoloV5.init``, a training checkpoint or an ultralytics training
    ``.pt``) into a training model (``YoloV5(trainable=True)``) in place, as
    float32, on the model's device. Every leaf is consumed exactly once; a
    missing or extra leaf or a shape mismatch raises."""
    state = train_state(model)
    with torch.no_grad():
        for name, arr in from_tree(model, tree).items():
            t = state[name]
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{tree_key(name)}: shape {arr.shape} (OIHW) does not fit {name} "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
    return model


def to_tree(named: Dict[str, torch.Tensor]):
    """Tensors by training-model name -> the JAX-format numpy tree (HWIO
    weights, float32), e.g. the model's state, its EMA or its momenta."""
    flat = {}
    for name, t in named.items():
        arr = t.detach().float().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        flat[tree_key(name)] = np.ascontiguousarray(arr)
    return unflatten_paths(flat)


# ---------------------------------------------------------------------------
# ultralytics .pt -> numpy parameter tree
# ---------------------------------------------------------------------------

def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv_from_torch(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    out = {"w": _hwio(sd[f"{prefix}.conv.weight"])}
    if f"{prefix}.bn.weight" in sd:
        out["bn"] = {
            "scale": sd[f"{prefix}.bn.weight"],
            "bias": sd[f"{prefix}.bn.bias"],
            "mean": sd[f"{prefix}.bn.running_mean"],
            "var": sd[f"{prefix}.bn.running_var"],
        }
    elif f"{prefix}.conv.bias" in sd:
        # Fused checkpoint: conv carries the folded bias.
        out["b"] = sd[f"{prefix}.conv.bias"]
    return out


def _c3_from_torch(sd: Dict[str, np.ndarray], prefix: str, n: int) -> dict:
    return {
        "cv1": _conv_from_torch(sd, f"{prefix}.cv1"),
        "cv2": _conv_from_torch(sd, f"{prefix}.cv2"),
        "cv3": _conv_from_torch(sd, f"{prefix}.cv3"),
        "m": [
            {
                "cv1": _conv_from_torch(sd, f"{prefix}.m.{i}.cv1"),
                "cv2": _conv_from_torch(sd, f"{prefix}.m.{i}.cv2"),
            }
            for i in range(n)
        ],
    }


def params_from_state_dict(model, state_dict: Dict[str, np.ndarray]) -> dict:
    """The numpy parameter tree (float32, HWIO) of an ultralytics state
    dict, for ``model`` (a ``YoloV5``): the tree the JAX package's
    ``params_from_state_dict`` builds. Keys look like
    ``model.4.cv1.conv.weight``; a ``model.model.`` prefix is stripped."""
    sd = {}
    for k, v in state_dict.items():
        sd[k.replace("model.model.", "model.")] = np.asarray(v, dtype=np.float32)

    dp = model.depths()
    layer_index, detect_index, sppf_name = family_layout(model)
    if getattr(model, "is_p6", False):
        c3_depths = {
            "b2": dp["n3"], "b4": dp["n6"], "b6": dp["n9"], "b8": dp["n3"],
            "b10": dp["n3"], "n15": dp["n3"], "n19": dp["n3"], "n23": dp["n3"],
            "n26": dp["n3"], "n29": dp["n3"], "n32": dp["n3"],
        }
    else:
        c3_depths = {
            "b2": dp["n3"], "b4": dp["n6"], "b6": dp["n9"], "b8": dp["n3"],
            "n13": dp["n3"], "n17": dp["n3"], "n20": dp["n3"], "n23": dp["n3"],
        }

    params: dict = {}
    for name, idx in layer_index.items():
        prefix = f"model.{idx}"
        if name in c3_depths:
            params[name] = _c3_from_torch(sd, prefix, c3_depths[name])
        elif name == sppf_name:
            params[name] = {
                "cv1": _conv_from_torch(sd, f"{prefix}.cv1"),
                "cv2": _conv_from_torch(sd, f"{prefix}.cv2"),
            }
        else:
            params[name] = _conv_from_torch(sd, prefix)

    params["head"] = [
        {"w": _hwio(sd[f"model.{detect_index}.m.{i}.weight"]),
         "b": sd[f"model.{detect_index}.m.{i}.bias"]}
        for i in range(len(model.strides))
    ]
    return params


def anchors_from_state_dict(state_dict: Dict[str, np.ndarray]):
    """The per-stride anchor table in pixels, if the file has one: (3, 3, 2)
    for P5 checkpoints, (4, 3, 2) for the P6 family."""
    for k in state_dict:
        if k.endswith("anchors"):
            a = np.asarray(state_dict[k], dtype=np.float32)
            if a.shape in ((3, 3, 2), (4, 3, 2)):
                # ultralytics stores anchors in grid units; scale by stride.
                strides = np.array([8.0, 16.0, 32.0, 64.0][: a.shape[0]])[:, None, None]
                return tuple(tuple(map(tuple, lvl)) for lvl in a * strides)
    return None


class _Shadow:
    """Stand-in for every class the file names (models.yolo.Model,
    torch.nn.* modules, anything else): absorbs constructor arguments and
    state as plain attributes, and runs nothing of the named class."""

    def __init__(self, *args, **kwargs):
        self._shadow_args = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_shadow_state"] = state


# Storage classes torch names in its zip container -> numpy dtype.
_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "HalfStorage": np.float16,
    "DoubleStorage": np.float64,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}

# The only globals the reader resolves to real objects: OrderedDict and
# numpy's array and scalar rebuild functions, which build data and call
# nothing named in the file.
_NP_MULTIARRAY = (np._core if hasattr(np, "_core") else np.core).multiarray
_DATA_GLOBALS = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("numpy", "dtype"): np.dtype,
    ("numpy", "ndarray"): np.ndarray,
}
for _mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
    _DATA_GLOBALS[(_mod, "_reconstruct")] = _NP_MULTIARRAY._reconstruct
    _DATA_GLOBALS[(_mod, "scalar")] = _NP_MULTIARRAY.scalar


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    u16 = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32)
    return (u16 << 16).view(np.float32)


def _harvest(module_obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Walk a pickled nn.Module tree (its ``_parameters`` / ``_buffers`` /
    ``_modules`` dicts) into a flat state dict."""
    d = getattr(module_obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for src in ("_parameters", "_buffers"):
        entries = d.get(src)
        if isinstance(entries, dict):
            for name, t in entries.items():
                if isinstance(t, np.ndarray):
                    out[prefix + name] = t
    subs = d.get("_modules")
    if isinstance(subs, dict):
        for name, sub in subs.items():
            if sub is not None:
                _harvest(sub, f"{prefix}{name}.", out)


def read_pt_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch-zip ``.pt`` -> flat {name: float32 array} state dict.

    Reads both layouts the reference's tooling writes: a tensor-only state
    dict (possibly mixed with scalar metadata such as ``epoch``), and the
    object-pickled ``{'model': Model, 'ema': Model, ...}`` payload of
    ``multilabel_farms_exp2.pt`` (reference README.md:77), whose module tree
    is walked through its pickled ``_parameters`` / ``_buffers`` /
    ``_modules``; the EMA weights win when present, as in ultralytics'
    ``attempt_load``. Storages of float16/32/64, bfloat16 and the integer
    and bool types are read; any other storage type raises ``ValueError``.
    """
    with zipfile.ZipFile(path) as zf:
        pkl_name = next((n for n in zf.namelist() if n.endswith("data.pkl")), None)
        if pkl_name is None:
            raise ValueError(f"{path!r} is not a torch zip checkpoint (no data.pkl)")
        root = pkl_name[: -len("data.pkl")]

        def rebuild(storage, offset, size, stride, *_):
            sname, key = storage
            raw = zf.read(f"{root}data/{key}")
            if sname == "BFloat16Storage":
                arr = _bf16_to_f32(raw)
            elif sname in _STORAGE_DTYPES:
                arr = np.frombuffer(raw, dtype=_STORAGE_DTYPES[sname])
            else:
                raise ValueError(f"unsupported torch storage type in {path!r}: {sname}")
            size, stride = tuple(size), tuple(stride)
            if 0 in size:
                return np.zeros(size, arr.dtype)
            # the view must lie inside the storage: as_strided does not check
            last = offset + sum((n - 1) * st for n, st in zip(size, stride))
            if len(size) != len(stride) or offset < 0 or min(stride + size, default=0) < 0 or last >= len(arr):
                raise ValueError(f"tensor of size {size}, stride {stride} at offset {offset} "
                                 f"lies outside its {len(arr)}-element storage in {path!r}")
            return np.lib.stride_tricks.as_strided(
                arr[offset:], shape=size, strides=[st * arr.itemsize for st in stride]
            ).copy()

        def rebuild_parameter(data, *_):
            return data

        rebuild_fns = {
            "_rebuild_tensor_v2": rebuild,
            "_rebuild_tensor": rebuild,
            "_rebuild_parameter": rebuild_parameter,
            "_rebuild_parameter_with_state": rebuild_parameter,
        }
        shadows: Dict[str, type] = {}

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module == "torch._utils" and name in rebuild_fns:
                    return rebuild_fns[name]
                if module == "torch" and name.endswith("Storage"):
                    return name
                if (module, name) in _DATA_GLOBALS:
                    return _DATA_GLOBALS[(module, name)]
                full = f"{module}.{name}"
                if full not in shadows:
                    shadows[full] = type(name, (_Shadow,), {"_shadow_origin": full})
                return shadows[full]

            def persistent_load(self, pid):
                # ('storage', storage type, key, location, numel)
                _, stype, key, _, _ = pid
                return (stype if isinstance(stype, str) else getattr(stype, "__name__", str(stype)), key)

        obj = _Unpickler(io.BytesIO(zf.read(pkl_name))).load()

    if isinstance(obj, dict) and not any(k in obj for k in ("ema", "model")):
        flat = {k: np.asarray(v, np.float32) for k, v in obj.items() if isinstance(v, np.ndarray)}
        if flat:
            return flat
    candidates = []
    if isinstance(obj, dict):
        candidates = [obj[k] for k in ("ema", "model") if isinstance(obj.get(k), _Shadow)]
    elif isinstance(obj, _Shadow):
        candidates = [obj]
    for m in candidates:
        sd: Dict[str, np.ndarray] = {}
        _harvest(m, "", sd)
        if sd:
            return {k: np.asarray(v, np.float32) for k, v in sd.items()}
    raise ValueError(f"no tensors found in {path!r}: unsupported checkpoint layout")


def load_pretrained(model, path: str):
    """An ultralytics ``.pt`` -> (numpy parameter tree for ``model``, anchor
    table in pixels or None). Load the tree with ``load_jax_params``."""
    sd = read_pt_state_dict(path)
    return params_from_state_dict(model, sd), anchors_from_state_dict(sd)
