"""Ahead-of-time serving artifacts: the serving program as a file.

Counterpart of aquaculture_tpu/models/aot.py. ``torch.export`` traces the
FULL serving program (resize + forward + decode + NMS + pixel-space
mapping: ``pipeline.ServingProgram``, exactly what ``make_infer_fn`` runs)
once, at a fixed ``(batch, tile, tile, 3)`` uint8 input, and
``torch.export.save`` writes it. A later process loads the program and
serves any checkpoint of the same structure with it, without tracing the
model code again. Weights stay runtime inputs: the program takes the
placed model's tensors as a flat list (through
``torch.func.functional_call``), and the file holds none of them.

What the artifact does and does not buy:

* DOES: freezes the serving math (the ATen graph) against library drift,
  and makes the deployable unit a program file plus a checkpoint.
* DOES NOT: free the serving host of the framework. Unlike the JAX
  package's StableHLO artifact, the program runs on PyTorch, and its
  suppression is the port's registered operator
  ``aquaculture_tpu_torch::nms_suppress`` (ops/nms.py), which must be
  registered in the loading process: ``load_aot`` imports ``ops.nms``
  first. On the card that operator launches the hand-written kernel
  (ops/nms_cuda.py, built at first use), and counts the launch.
* The program is traced for one device type: ops that create tensors name
  it, and the int8 convolution takes its device's route (``torch._int_mm``
  over a padded im2col on the card, the float64 route on the CPU). The
  meta records the type and ``serving_fn_loaded`` refuses another.

File format: ``AQT1`` magic + u32 JSON-header length + JSON metadata +
the ``torch.export.save`` archive. The JAX package's artifacts start with
``AQX1``: each package refuses the other's.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aquaculture_tpu_torch.config import IM_WIDTH, DetectConfig, resolve_device
from aquaculture_tpu_torch.pipeline import ServingProgram, place_model

_MAGIC = b"AQT1"
_JAX_MAGIC = b"AQX1"


def serving_tensors(model: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """The (name, tensor) pairs the serving program takes as its weights:
    the model's parameters, then its buffers, in the module's order."""
    return [*model.named_parameters(), *model.named_buffers()]


def _leaf_fingerprint(named: Sequence[Tuple[str, torch.Tensor]]) -> dict:
    """Structure fingerprint of a placed model's serving tensors: a hash
    of each tensor's name, shape and dtype (not of its values), used to
    validate checkpoints against artifacts."""
    spec = [(name, list(t.shape), str(t.dtype)) for name, t in named]
    h = hashlib.sha256(json.dumps(spec).encode()).hexdigest()[:16]
    return {"n_leaves": len(spec), "spec_sha": h}


def _anchor_list(table) -> list:
    return [[[float(w), float(h)] for (w, h) in level] for level in table]


class _WeightsAsInputs(torch.nn.Module):
    """``(weights, images_u8) -> program(images_u8)`` with the model's
    tensors replaced by ``weights``. The program is held outside the
    module tree, so that ``torch.export`` lifts none of its tensors into
    the exported program's state."""

    def __init__(self, program: ServingProgram, names: Sequence[str]):
        super().__init__()
        self.__dict__["program"] = program
        self.names = [f"model.{n}" for n in names]

    def forward(self, weights: List[torch.Tensor], images_u8: torch.Tensor):
        return torch.func.functional_call(self.program, dict(zip(self.names, weights)), (images_u8,))


def export_serving(
    model,
    cfg: Optional[DetectConfig] = None,
    batch_size: int = 32,
    tile: Optional[int] = None,
    device="cuda",
) -> Tuple[bytes, dict]:
    """Export the serving program of (model, cfg) for ``device``'s type.
    Returns ``(blob, meta)``: the ``torch.export.save`` archive and the
    metadata ``save_aot`` writes beside it.

    Places ``model`` in place, as ``make_infer_fn`` does (device,
    channels_last, the compute dtype). Its tensors supply only names,
    shapes and dtypes: they are the program's inputs, and neither they
    nor the traced example inputs go into the blob. Export an int8 model
    after calibration (models/quantize.py), never while calibrating. The
    model's ANCHOR TABLE is a constant of the traced decode: it is
    recorded in meta and re-checked at serve time (``serving_fn_loaded``).
    """
    cfg = cfg or DetectConfig()
    tile = tile or IM_WIDTH
    dev = place_model(model, cfg.dtype, device)
    named = serving_tensors(model)
    names = [n for n, _ in named]
    weights = [t for _, t in named]
    images = torch.zeros((batch_size, tile, tile, 3), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        exported = torch.export.export(
            _WeightsAsInputs(ServingProgram(model, cfg, tile), names), (weights, images), strict=False)
    if exported.state_dict:
        raise RuntimeError(f"the exported program holds state {sorted(exported.state_dict)[:4]}")
    weight_ids = {id(t) for t in weights}
    for name, c in exported.constants.items():
        if id(c) in weight_ids or (isinstance(c, torch.Tensor) and c.numel() > 64):
            raise RuntimeError(f"the exported program holds a weight-sized constant {name!r}")
    exported.example_inputs = None  # the traced weights, which the file must not carry
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    meta = {
        "kind": "aquaculture_tpu_torch.serving",
        "variant": getattr(model, "variant", None),
        "num_classes": getattr(model, "num_classes", None),
        "batch_size": batch_size,
        "tile": tile,
        "img_size": cfg.img_size,
        "conf_threshold": cfg.conf_threshold,
        "iou_threshold": cfg.iou_threshold,
        "max_detections": cfg.max_detections,
        "pre_nms_topk": cfg.pre_nms_topk,
        "class_agnostic": cfg.class_agnostic,
        "multi_label": cfg.multi_label,
        "augment": cfg.augment,
        # the pass geometry is traced into the program; recorded so that the
        # artifact stays auditable
        "tta_scales": list(cfg.tta_scales),
        "tta_flips": list(cfg.tta_flips),
        "nms_backend": cfg.nms_backend,
        "dtype": cfg.dtype,
        "anchors": _anchor_list(getattr(model, "anchor_table", ())),
        "quantized": any(t.dtype == torch.int8 for t in weights),
        "device": dev.type,
        "torch_version": torch.__version__,
        "params": _leaf_fingerprint(named),
    }
    return buf.getvalue(), meta


def save_aot(path: str, blob: bytes, meta: dict) -> None:
    """Write a single-file artifact: AQT1 | len(json) | json | blob."""
    head = json.dumps(meta, sort_keys=True).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(blob)
    os.replace(tmp, path)


def _read_header(f, path: str) -> dict:
    magic = f.read(4)
    if magic == _JAX_MAGIC:
        raise ValueError(
            f"{path}: a JAX-package AOT artifact (AQX1, StableHLO); the PyTorch port "
            f"serves its own artifacts only (python -m aquaculture_tpu_torch.cli.aot export)"
        )
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an aquaculture_tpu_torch AOT artifact")
    raw = f.read(4)
    if len(raw) != 4:
        raise ValueError(f"{path}: truncated AOT artifact header")
    (n,) = struct.unpack("<I", raw)
    head = f.read(n)
    if len(head) != n:
        raise ValueError(f"{path}: truncated AOT artifact header")
    try:
        return json.loads(head)
    except ValueError:
        raise ValueError(f"{path}: corrupt AOT artifact metadata") from None


def read_meta(path: str) -> dict:
    with open(path, "rb") as f:
        return _read_header(f, path)


def load_aot(path: str):
    """Load an artifact -> (torch.export.ExportedProgram, meta)."""
    from aquaculture_tpu_torch.ops import nms  # noqa: F401  registers nms_suppress

    with open(path, "rb") as f:
        meta = _read_header(f, path)
        blob = f.read()
    return torch.export.load(io.BytesIO(blob)), meta


def serving_fn_loaded(
    exported, meta: dict, model, device="cuda", anchors=None, label: str = "artifact"
) -> Callable[[torch.Tensor], tuple]:
    """Already-loaded artifact + checkpoint (a loaded ``YoloV5``) -> an
    ``infer_fn`` for ``detect_files``: (B, tile, tile, 3) uint8 tiles on the
    host or the device -> (dets, valid) on the device.

    Places ``model`` in place on ``device`` in the artifact's compute dtype,
    then refuses an artifact traced for another device type, a model whose
    serving tensors differ in name, shape or dtype from those the artifact
    was exported with, and an anchor table (``anchors``, else the model's)
    other than the one traced into the decode: a checkpoint whose training
    evolved different anchors would silently decode every box wrong. The
    function reads the model's tensors at each call, so weights updated in
    place serve at once."""
    dev = resolve_device(device)
    if meta["device"] != dev.type:
        raise ValueError(
            f"{label}: the artifact was exported for {meta['device']!r} and cannot serve on "
            f"{dev.type!r}; re-export it with --device {dev.type}"
        )
    place_model(model, meta["dtype"], dev)
    named = serving_tensors(model)
    want, got = meta["params"], _leaf_fingerprint(named)
    if want != got:
        raise ValueError(
            f"{label}: checkpoint tree does not match the artifact "
            f"(artifact {want}, checkpoint {got}); re-export or load the "
            f"matching variant/precision"
        )
    baked = meta.get("anchors")
    table = anchors if anchors is not None else getattr(model, "anchor_table", None)
    if table is not None and baked:
        ours = _anchor_list(table)
        if len(ours) != len(baked) or not all(
            np.shape(a) == np.shape(b) and np.allclose(a, b) for a, b in zip(ours, baked)
        ):
            raise ValueError(
                f"{label}: anchor table mismatch — the artifact bakes "
                f"{baked} but the checkpoint's model uses {ours}; "
                f"re-export the artifact from this checkpoint"
            )
    call = exported.module()
    weights = [t for _, t in named]

    @torch.inference_mode()
    def fn(images_u8: torch.Tensor):
        return call(weights, images_u8.to(dev, non_blocking=True))

    return fn


def serving_fn(path: str, model, device="cuda", anchors=None):
    """Artifact file + checkpoint -> (``infer_fn`` for ``detect_files``, meta)."""
    exported, meta = load_aot(path)
    return serving_fn_loaded(exported, meta, model, device=device, anchors=anchors, label=path), meta


def warmup(path: str, model, device="cuda", anchors=None) -> float:
    """Load the artifact and run one zero batch on ``device``, which builds
    the suppression kernel's library and lets cuDNN pick its algorithms on
    the card. Returns the seconds of that first batch."""
    fn, meta = serving_fn(path, model, device=device, anchors=anchors)
    b, t = meta["batch_size"], meta["tile"]
    x = torch.zeros((b, t, t, 3), dtype=torch.uint8)
    t0 = time.perf_counter()
    det, valid = fn(x)
    det.cpu()
    return time.perf_counter() - t0
