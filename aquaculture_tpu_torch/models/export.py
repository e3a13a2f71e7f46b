"""Parameter tree -> ultralytics ``.pt`` checkpoint export.

Counterpart of aquaculture_tpu/models/export.py, and the inverse of
:mod:`aquaculture_tpu_torch.models.weights`: serializes a JAX-format
parameter tree (the numpy tree ``utils/checkpoint.load_params`` reads) as a
torch-zip checkpoint holding a flat ultralytics-layout state dict
(``model.4.cv1.conv.weight`` etc., OIHW). The pickle stream is emitted
opcode by opcode with numpy and ``zipfile``, in the exact shape torch's
unpickler rebuilds tensors from (``torch._utils._rebuild_tensor_v2`` +
persistent storage ids), not with ``torch.save``: the writer's bytes equal
the JAX package's for the same tree, and the full-model pickle names
classes (``models.yolo.DetectionModel`` and its kin) that resolve only in
the consumer's environment, so no torch object could stand in for them.

Why: the reference ecosystem consumes ``.pt`` weights everywhere
(reference README.md:52,60,77 — train from yolov5m.pt, serve
multilabel_farms_exp2.pt). The port reads them (models/weights.py);
export closes the loop so a model trained here flows back into
ultralytics tooling.

Two formats:

* ``export_ultralytics_pt`` — STATE-DICT checkpoint (``torch.load`` ->
  ``{name: Tensor}``), the layout ``Model.load_state_dict`` and the port's
  own reader (``weights.read_pt_state_dict``) consume.
* ``export_full_model_pt`` — FULL-MODEL object pickle
  (``{'model': models.yolo.DetectionModel}``), the graph ultralytics'
  ``attempt_load`` rebuilds (see the shadow-graph section below). The
  classes resolve from the CONSUMER's environment at load time — which is
  exactly the environment that runs attempt_load.
"""

from __future__ import annotations

import zipfile
from typing import Dict, Optional, Sequence

import numpy as np

from aquaculture_tpu_torch.models.weights import family_layout

# ---------------------------------------------------------------------------
# param tree -> ultralytics state dict
# ---------------------------------------------------------------------------


def _oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def _conv_to_torch(p: dict, prefix: str, sd: Dict[str, np.ndarray]) -> None:
    if "wq" in p:
        raise ValueError(
            f"{prefix}: int8-quantized layer (wq layout) — ultralytics .pt "
            "stores float weights; export the pre-quantization tree"
        )
    w = np.asarray(p["w"])
    if w.ndim == 4 and w.shape[0] == 2:
        raise ValueError(
            f"{prefix}: k2 kernel — this tree was fused with down_s2d; "
            "export the training-layout (or plain-fused) tree instead"
        )
    sd[f"{prefix}.conv.weight"] = _oihw(w)
    if "bn" in p:
        bn = p["bn"]
        sd[f"{prefix}.bn.weight"] = np.asarray(bn["scale"], np.float32)
        sd[f"{prefix}.bn.bias"] = np.asarray(bn["bias"], np.float32)
        sd[f"{prefix}.bn.running_mean"] = np.asarray(bn["mean"], np.float32)
        sd[f"{prefix}.bn.running_var"] = np.asarray(bn["var"], np.float32)
        # ultralytics BN modules carry this buffer; harmless but expected
        sd[f"{prefix}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    elif "b" in p:
        sd[f"{prefix}.conv.bias"] = np.asarray(p["b"], np.float32)


def _c3_to_torch(p: dict, prefix: str, sd: Dict[str, np.ndarray]) -> None:
    _conv_to_torch(p["cv1"], f"{prefix}.cv1", sd)
    _conv_to_torch(p["cv2"], f"{prefix}.cv2", sd)
    _conv_to_torch(p["cv3"], f"{prefix}.cv3", sd)
    for i, m in enumerate(p["m"]):
        _conv_to_torch(m["cv1"], f"{prefix}.m.{i}.cv1", sd)
        _conv_to_torch(m["cv2"], f"{prefix}.m.{i}.cv2", sd)


def state_dict_from_params(
    model, params: dict, anchors: Optional[Sequence] = None
) -> Dict[str, np.ndarray]:
    """Flat ultralytics state dict (OIHW numpy arrays) from a param tree.

    The exact inverse of weights.params_from_state_dict: layer-index map
    per family, Conv/C3/SPPF sub-layouts, Detect head at model.24 (P5) /
    model.33 (P6). ``anchors`` defaults to the model's anchor table and is
    stored as the Detect ``anchors`` buffer in grid units (the layout
    weights.anchors_from_state_dict reads back)."""
    layer_index, detect_index, sppf_name = family_layout(model)

    b0 = params["b0"]
    if "wq" in b0:
        raise ValueError(
            "this tree is int8-quantized (wq/wscale layout) — ultralytics "
            ".pt stores float weights; export the pre-quantization tree"
        )
    if "w" not in b0:
        raise ValueError(f"b0 has no conv weight (keys: {sorted(b0)})")
    w0 = np.asarray(b0["w"])
    if w0.shape[0] != 6:
        raise ValueError(
            "b0 kernel is not k6 — this tree was fused with stem_s2d; "
            "export the training-layout tree (or fuse(stem_s2d=False))"
        )

    sd: Dict[str, np.ndarray] = {}
    for name, idx in layer_index.items():
        p = params[name]
        prefix = f"model.{idx}"
        if name == sppf_name:
            _conv_to_torch(p["cv1"], f"{prefix}.cv1", sd)
            _conv_to_torch(p["cv2"], f"{prefix}.cv2", sd)
        elif "m" in p:  # C3
            _c3_to_torch(p, prefix, sd)
        else:
            _conv_to_torch(p, prefix, sd)

    for i, hp in enumerate(params["head"]):
        sd[f"model.{detect_index}.m.{i}.weight"] = _oihw(hp["w"])
        sd[f"model.{detect_index}.m.{i}.bias"] = np.asarray(hp["b"], np.float32)

    table = np.asarray(anchors if anchors is not None else model.anchor_table, np.float32)
    strides = np.asarray(model.strides, np.float32)[:, None, None]
    sd[f"model.{detect_index}.anchors"] = table / strides
    return sd


# ---------------------------------------------------------------------------
# .pt writer (torch zip format, hand-emitted pickle stream)
# ---------------------------------------------------------------------------

_DTYPE_STORAGE = {
    np.dtype(np.float32): "FloatStorage",
    np.dtype(np.float64): "DoubleStorage",
    np.dtype(np.float16): "HalfStorage",
    np.dtype(np.int64): "LongStorage",
    np.dtype(np.int32): "IntStorage",
    np.dtype(np.int16): "ShortStorage",
    np.dtype(np.int8): "CharStorage",
    np.dtype(np.uint8): "ByteStorage",
    np.dtype(np.bool_): "BoolStorage",
}

# pickle protocol-2 opcodes (only what the stream needs)
_PROTO2 = b"\x80\x02"
_EMPTY_DICT, _MARK, _SETITEMS, _STOP = b"}", b"(", b"u", b"."
_TUPLE, _EMPTY_TUPLE, _REDUCE = b"t", b")", b"R"
_BINPERSID, _NEWFALSE = b"Q", b"\x89"


def _op_str(s: str) -> bytes:  # BINUNICODE
    b = s.encode("utf-8")
    return b"X" + len(b).to_bytes(4, "little") + b


def _op_int(i: int) -> bytes:  # BININT (32-bit signed covers all our sizes)
    return b"J" + int(i).to_bytes(4, "little", signed=True)


def _op_global(module: str, name: str) -> bytes:
    return b"c" + module.encode() + b"\n" + name.encode() + b"\n"


def _pickle_tensor(key: str, arr: np.ndarray) -> bytes:
    """Opcode sequence rebuilding one tensor:
    torch._utils._rebuild_tensor_v2(
        <persistent ('storage', torch.XStorage, key, 'cpu', numel)>,
        0, size, contiguous_strides, False, collections.OrderedDict())."""
    storage_cls = _DTYPE_STORAGE[arr.dtype]
    strides = []
    acc = 1
    for dim in reversed(arr.shape):
        strides.insert(0, acc)
        acc *= dim
    out = [_op_global("torch._utils", "_rebuild_tensor_v2"), _MARK]
    out += [
        _MARK,
        _op_str("storage"),
        _op_global("torch", storage_cls),
        _op_str(key),
        _op_str("cpu"),
        _op_int(arr.size),
        _TUPLE,
        _BINPERSID,
    ]
    out.append(_op_int(0))  # storage_offset
    out += [_MARK, *[_op_int(d) for d in arr.shape], _TUPLE]
    out += [_MARK, *[_op_int(s) for s in strides], _TUPLE]
    out.append(_NEWFALSE)  # requires_grad
    out += [_op_global("collections", "OrderedDict"), _EMPTY_TUPLE, _REDUCE]
    out += [_TUPLE, _REDUCE]
    return b"".join(out)


def _write_torch_zip(path: str, pkl: bytes, entries, root: str) -> None:
    """The torch-zip container (data.pkl + data/<key> payloads + version/
    byteorder) — ONE encoding shared by the state-dict and full-model
    writers so the format can never drift between them."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(f"{root}/data.pkl", pkl)
        for key, raw in entries:
            zf.writestr(f"{root}/data/{key}", raw)
        zf.writestr(f"{root}/version", b"3\n")
        zf.writestr(f"{root}/byteorder", b"little")


def write_pt(path: str, state_dict: Dict[str, np.ndarray], root: str = "archive") -> None:
    """Write ``{name: array}`` as a torch-zip ``.pt`` (flat tensor state
    dict — the layout ``torch.load(..., weights_only=True)`` accepts and
    weights.read_pt_state_dict reads back)."""
    entries = []  # (storage_key, bytes)
    pkl = [_PROTO2, _EMPTY_DICT, _MARK]
    for i, (name, arr) in enumerate(state_dict.items()):
        # NB: ascontiguousarray promotes 0-d to 1-d; reshape restores it
        arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
        if arr.dtype not in _DTYPE_STORAGE:
            arr = arr.astype(np.float32)
        key = str(i)
        pkl.append(_op_str(name))
        pkl.append(_pickle_tensor(key, arr))
        entries.append((key, arr.tobytes()))
    pkl += [_SETITEMS, _STOP]
    _write_torch_zip(path, b"".join(pkl), entries, root)


def export_ultralytics_pt(
    model, params: dict, path: str, anchors: Optional[Sequence] = None
) -> Dict[str, np.ndarray]:
    """Export a (training-layout or plain-fused) param tree as an
    ultralytics-layout ``.pt``. Returns the state dict written."""
    sd = state_dict_from_params(model, params, anchors=anchors)
    write_pt(path, sd)
    return sd


# ---------------------------------------------------------------------------
# attempt_load-compatible FULL-MODEL .pt (shadow object-graph pickle)
# ---------------------------------------------------------------------------
#
# The reference's serving command loads a full-model pickle
# (``{'model': models.yolo.DetectionModel}``) through ultralytics
# ``attempt_load`` (reference README.md:77 -> yolov5 detect.py ->
# experimental.attempt_load). torch pickles an nn.Module via protocol-2
# NEWOBJ + BUILD of its __dict__, so the file can be emitted opcode by opcode:
# GLOBAL refs to ``models.yolo``/``models.common``/``torch.nn`` classes and
# ``torch._utils`` tensor rebuilders, plus each module's instance state
# (_parameters/_buffers/_modules + per-class attrs). By pickle's design,
# the CLASSES themselves resolve at LOAD time from the consumer's
# environment — ultralytics is importable wherever attempt_load runs, so
# the only ultralytics-supplied ingredient is the class source. The
# emitted file equals the JAX package's byte for byte
# (tests/test_torch_export.py), whose graph tests/test_export_full.py
# loads with torch.load against a distilled stand-in class set.

_NEWOBJ, _BUILD = b"\x81", b"b"
_EMPTY_LIST, _APPENDS = b"]", b"e"
_NEWTRUE, _NONE = b"\x88", b"N"


class _G:
    def __init__(self, module, name):
        self.module, self.name = module, name


class _Call:
    def __init__(self, g, *args):
        self.g, self.args = g, args


class _Obj:
    def __init__(self, g, state):
        self.g, self.state = g, state


class _OD:
    def __init__(self, items):
        self.items = list(items)


class _Tensor:
    def __init__(self, arr, param=False, dtype=np.float32):
        self.arr = np.ascontiguousarray(np.asarray(arr, dtype)).reshape(np.shape(arr))
        self.param = param


def _emit(v, entries) -> bytes:
    """Recursive shadow-value -> pickle opcode emitter. `entries`
    accumulates (storage_key, raw bytes) zip payloads."""
    import struct

    if v is None:
        return _NONE
    if v is True:
        return _NEWTRUE
    if v is False:
        return _NEWFALSE
    if isinstance(v, bool):  # pragma: no cover - covered above
        return _NEWTRUE if v else _NEWFALSE
    if isinstance(v, int):
        return _op_int(v)
    if isinstance(v, float):
        return b"G" + struct.pack(">d", v)
    if isinstance(v, str):
        return _op_str(v)
    if isinstance(v, tuple):
        if not v:
            return _EMPTY_TUPLE
        return _MARK + b"".join(_emit(x, entries) for x in v) + _TUPLE
    if isinstance(v, list):
        out = _EMPTY_LIST
        if v:
            out += _MARK + b"".join(_emit(x, entries) for x in v) + _APPENDS
        return out
    if isinstance(v, dict):
        out = _EMPTY_DICT
        if v:
            out += _MARK
            for k, x in v.items():
                out += _emit(k, entries) + _emit(x, entries)
            out += _SETITEMS
        return out
    if isinstance(v, _OD):
        out = _op_global("collections", "OrderedDict") + _EMPTY_TUPLE + _REDUCE
        if v.items:
            out += _MARK
            for k, x in v.items:
                out += _emit(k, entries) + _emit(x, entries)
            out += _SETITEMS
        return out
    if isinstance(v, _G):
        return _op_global(v.module, v.name)
    if isinstance(v, _Call):
        return (
            _op_global(v.g.module, v.g.name)
            + _emit(tuple(v.args), entries)
            + _REDUCE
        )
    if isinstance(v, _Obj):
        return (
            _op_global(v.g.module, v.g.name)
            + _EMPTY_TUPLE
            + _NEWOBJ
            + _emit(v.state, entries)
            + _BUILD
        )
    if isinstance(v, _Tensor):
        key = str(len(entries))
        entries.append((key, v.arr.tobytes()))
        t = _pickle_tensor(key, v.arr)
        if v.param:
            t = (
                _op_global("torch._utils", "_rebuild_parameter")
                + _MARK + t + _NEWTRUE
                + _op_global("collections", "OrderedDict") + _EMPTY_TUPLE + _REDUCE
                + _TUPLE + _REDUCE
            )
        return t
    raise TypeError(f"unpicklable shadow value: {type(v)}")


def _nn(name):
    # torch.nn.Conv2d etc. pickle as their defining submodule globals
    mod = {
        "Conv2d": "torch.nn.modules.conv",
        "BatchNorm2d": "torch.nn.modules.batchnorm",
        "SiLU": "torch.nn.modules.activation",
        "MaxPool2d": "torch.nn.modules.pooling",
        "Upsample": "torch.nn.modules.upsampling",
        "Sequential": "torch.nn.modules.container",
        "ModuleList": "torch.nn.modules.container",
    }[name]
    return _G(mod, name)


def _module_state(modules=(), parameters=(), buffers=(), extra=None):
    st = {
        "training": False,
        "_parameters": _OD(parameters),
        "_buffers": _OD(buffers),
        "_modules": _OD(modules),
        # torch Module.__setstate__ back-fills the other hook dicts but
        # not these two (real torch pickles always carry them)
        "_backward_hooks": _OD([]),
        "_forward_hooks": _OD([]),
    }
    if extra:
        st.update(extra)
    return st


def _sh_conv2d(w_oihw: np.ndarray, bias, stride, padding):
    o, i, kh, kw = w_oihw.shape
    params = [("weight", _Tensor(w_oihw, param=True))]
    params.append(("bias", _Tensor(bias, param=True) if bias is not None else None))
    return _Obj(_nn("Conv2d"), _module_state(
        parameters=params,
        extra={
            "in_channels": i, "out_channels": o,
            "kernel_size": (kh, kw), "stride": (stride, stride),
            "padding": (padding, padding), "dilation": (1, 1),
            "transposed": False, "output_padding": (0, 0), "groups": 1,
            "padding_mode": "zeros",
            "_reversed_padding_repeated_twice": [padding] * 4,
        },
    ))


def _sh_bn(bn: dict):
    n = int(np.asarray(bn["scale"]).shape[0])
    return _Obj(_nn("BatchNorm2d"), _module_state(
        parameters=[("weight", _Tensor(bn["scale"], param=True)),
                    ("bias", _Tensor(bn["bias"], param=True))],
        buffers=[("running_mean", _Tensor(bn["mean"])),
                 ("running_var", _Tensor(bn["var"])),
                 ("num_batches_tracked", _Tensor(np.asarray(0), dtype=np.int64))],
        # ultralytics initialize_weights sets eps=1e-3, momentum=0.03
        # (mirrored by layers.batch_norm)
        extra={"num_features": n, "eps": 1e-3, "momentum": 0.03,
               "affine": True, "track_running_stats": True},
    ))


def _sh_silu():
    return _Obj(_nn("SiLU"), _module_state(extra={"inplace": True}))


def _sh_uconv(p: dict, k: int, s: int, pad: int, meta):
    """ultralytics models.common.Conv (conv+bn+act)."""
    if "bn" not in p:
        raise ValueError(
            "full-model export hit a conv without BN (fused tree?) — "
            "export the training-layout tree"
        )
    w = _oihw(p["w"])
    return _Obj(_G("models.common", "Conv"), _module_state(
        modules=[("conv", _sh_conv2d(w, None, s, pad)),
                 ("bn", _sh_bn(p["bn"])),
                 ("act", _sh_silu())],
        extra=meta))


def _seq(children):
    return _Obj(_nn("Sequential"), _module_state(
        modules=[(str(i), c) for i, c in enumerate(children)]))


def _sh_bottleneck(mp: dict, shortcut: bool):
    return _Obj(_G("models.common", "Bottleneck"), _module_state(
        modules=[("cv1", _sh_uconv(mp["cv1"], 1, 1, 0, {})),
                 ("cv2", _sh_uconv(mp["cv2"], 3, 1, 1, {}))],
        extra={"add": shortcut}))


def _sh_c3(p: dict, shortcut: bool, meta):
    return _Obj(_G("models.common", "C3"), _module_state(
        modules=[("cv1", _sh_uconv(p["cv1"], 1, 1, 0, {})),
                 ("cv2", _sh_uconv(p["cv2"], 1, 1, 0, {})),
                 ("cv3", _sh_uconv(p["cv3"], 1, 1, 0, {})),
                 ("m", _seq([_sh_bottleneck(m, shortcut) for m in p["m"]]))],
        extra=meta))


def _sh_sppf(p: dict, meta):
    pool = _Obj(_nn("MaxPool2d"), _module_state(extra={
        "kernel_size": 5, "stride": 1, "padding": 2, "dilation": 1,
        "return_indices": False, "ceil_mode": False}))
    return _Obj(_G("models.common", "SPPF"), _module_state(
        modules=[("cv1", _sh_uconv(p["cv1"], 1, 1, 0, {})),
                 ("cv2", _sh_uconv(p["cv2"], 1, 1, 0, {})),
                 ("m", pool)],
        extra=meta))


def _sh_concat(meta):
    return _Obj(_G("models.common", "Concat"), _module_state(
        extra=dict(meta, d=1)))


def _sh_upsample(meta):
    return _Obj(_nn("Upsample"), _module_state(extra=dict(
        meta, size=None, scale_factor=2.0, mode="nearest",
        align_corners=None, recompute_scale_factor=None, name="Upsample")))


# (i, params-name, kind, f, conv geometry) per family; save = layers
# whose outputs later layers consume (the yolov5 v7 yaml graphs).
_P5_GRAPH = [
    (0, "b0", "conv", -1, (6, 2, 2)), (1, "b1", "conv", -1, (3, 2, 1)),
    (2, "b2", "c3", -1, True), (3, "b3", "conv", -1, (3, 2, 1)),
    (4, "b4", "c3", -1, True), (5, "b5", "conv", -1, (3, 2, 1)),
    (6, "b6", "c3", -1, True), (7, "b7", "conv", -1, (3, 2, 1)),
    (8, "b8", "c3", -1, True), (9, "b9", "sppf", -1, None),
    (10, "n10", "conv", -1, (1, 1, 0)), (11, None, "up", -1, None),
    (12, None, "cat", [-1, 6], None), (13, "n13", "c3", -1, False),
    (14, "n14", "conv", -1, (1, 1, 0)), (15, None, "up", -1, None),
    (16, None, "cat", [-1, 4], None), (17, "n17", "c3", -1, False),
    (18, "n18", "conv", -1, (3, 2, 1)), (19, None, "cat", [-1, 14], None),
    (20, "n20", "c3", -1, False), (21, "n21", "conv", -1, (3, 2, 1)),
    (22, None, "cat", [-1, 10], None), (23, "n23", "c3", -1, False),
]
_P5_SAVE = [4, 6, 10, 14, 17, 20, 23]
_P5_DETECT_F = [17, 20, 23]

_P6_GRAPH = [
    (0, "b0", "conv", -1, (6, 2, 2)), (1, "b1", "conv", -1, (3, 2, 1)),
    (2, "b2", "c3", -1, True), (3, "b3", "conv", -1, (3, 2, 1)),
    (4, "b4", "c3", -1, True), (5, "b5", "conv", -1, (3, 2, 1)),
    (6, "b6", "c3", -1, True), (7, "b7", "conv", -1, (3, 2, 1)),
    (8, "b8", "c3", -1, True), (9, "b9", "conv", -1, (3, 2, 1)),
    (10, "b10", "c3", -1, True), (11, "b11", "sppf", -1, None),
    (12, "n12", "conv", -1, (1, 1, 0)), (13, None, "up", -1, None),
    (14, None, "cat", [-1, 8], None), (15, "n15", "c3", -1, False),
    (16, "n16", "conv", -1, (1, 1, 0)), (17, None, "up", -1, None),
    (18, None, "cat", [-1, 6], None), (19, "n19", "c3", -1, False),
    (20, "n20", "conv", -1, (1, 1, 0)), (21, None, "up", -1, None),
    (22, None, "cat", [-1, 4], None), (23, "n23", "c3", -1, False),
    (24, "n24", "conv", -1, (3, 2, 1)), (25, None, "cat", [-1, 20], None),
    (26, "n26", "c3", -1, False), (27, "n27", "conv", -1, (3, 2, 1)),
    (28, None, "cat", [-1, 16], None), (29, "n29", "c3", -1, False),
    (30, "n30", "conv", -1, (3, 2, 1)), (31, None, "cat", [-1, 12], None),
    (32, "n32", "c3", -1, False),
]
_P6_SAVE = [4, 6, 8, 12, 16, 20, 23, 26, 29, 32]
_P6_DETECT_F = [23, 26, 29, 32]


def full_model_graph(model, params: dict,
                     names: Optional[Sequence[str]] = None) -> _Obj:
    """Shadow object graph of an ultralytics DetectionModel for this
    param tree (training layout, separate conv/bn). See module notes."""
    w0 = np.asarray(params["b0"]["w"])
    if (
        "wq" in params["b0"] or w0.ndim != 4 or w0.shape[0] != 6
        or "bn" not in params["b0"]
    ):
        # The bn check matters: a PLAIN-fused tree (fuse(stem_s2d=False))
        # keeps the k6 stem but folds every BN into conv biases — without
        # it the shadow Conv modules would silently emit bias=None and no
        # bn child, and the consumer's forward/fuse() would crash or
        # serve wrong numbers.
        raise ValueError(
            "full-model export needs the training-layout tree "
            "(un-quantized, un-fused: b0 kernel k6 with separate BN)"
        )
    if getattr(model, "is_p6", False):
        graph, save, det_f, det_i = _P6_GRAPH, _P6_SAVE, _P6_DETECT_F, 33
    else:
        graph, save, det_f, det_i = _P5_GRAPH, _P5_SAVE, _P5_DETECT_F, 24

    layers = []
    for i, pname, kind, f, geo in graph:
        meta = {"i": i, "f": f, "type": {
            "conv": "models.common.Conv", "c3": "models.common.C3",
            "sppf": "models.common.SPPF", "cat": "models.common.Concat",
            "up": "torch.nn.modules.upsampling.Upsample"}[kind], "np": 0}
        if kind == "conv":
            k, s, pad = geo
            layers.append(_sh_uconv(params[pname], k, s, pad, meta))
        elif kind == "c3":
            layers.append(_sh_c3(params[pname], geo, meta))
        elif kind == "sppf":
            layers.append(_sh_sppf(params[pname], meta))
        elif kind == "cat":
            layers.append(_sh_concat(meta))
        else:
            layers.append(_sh_upsample(meta))

    nl = len(det_f)
    na = model.na
    nc = model.num_classes
    strides = np.asarray(model.strides, np.float32)
    anchors_grid_units = (
        np.asarray(model.anchor_table, np.float32) / strides[:, None, None]
    )
    head_convs = []
    for i, hp in enumerate(params["head"]):
        head_convs.append((str(i), _sh_conv2d(
            _oihw(hp["w"]), np.asarray(hp["b"], np.float32), 1, 0)))
    detect = _Obj(_G("models.yolo", "Detect"), _module_state(
        modules=[("m", _Obj(_nn("ModuleList"),
                            _module_state(modules=head_convs)))],
        buffers=[("anchors", _Tensor(anchors_grid_units))],
        extra={
            "nc": nc, "no": nc + 5, "nl": nl, "na": na,
            "grid": [_Tensor(np.zeros((1,))) for _ in range(nl)],
            "anchor_grid": [_Tensor(np.zeros((1,))) for _ in range(nl)],
            "stride": _Tensor(strides),
            "inplace": True, "dynamic": False, "export": False,
            "i": det_i, "f": det_f,
            "type": "models.yolo.Detect", "np": 0,
        },
    ))
    layers.append(detect)

    if names is None:
        names = [f"class{i}" for i in range(nc)]
    return _Obj(_G("models.yolo", "DetectionModel"), _module_state(
        modules=[("model", _seq(layers))],
        extra={
            "save": save,
            "names": {i: str(n) for i, n in enumerate(names)},
            "stride": _Tensor(strides),
            "inplace": True,
            "yaml": {"nc": nc, "ch": 3},
        },
    ))


def export_full_model_pt(model, params: dict, path: str,
                         names: Optional[Sequence[str]] = None,
                         root: str = "archive") -> None:
    """Write an attempt_load-compatible full-model ``.pt``:
    ``torch.load(path)`` -> ``{'model': DetectionModel, 'ema': None, ...}``
    in any environment with ultralytics' yolov5 ``models`` package
    importable (the consumer of reference README.md:77 by definition).
    Requires the TRAINING-layout tree (conv+bn unfused) so the consumer's
    own ``fuse()`` runs."""
    g = full_model_graph(model, params, names=names)
    entries: list = []
    body = {
        "model": g,
        "ema": None,
        "epoch": -1,
        "best_fitness": None,
        "optimizer": None,
        "updates": None,
    }
    pkl = _PROTO2 + _emit(body, entries) + _STOP
    _write_torch_zip(path, pkl, entries, root)
