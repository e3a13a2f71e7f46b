"""Training CLI of the PyTorch port: fine-tune the detector on a YOLO-format
dataset.

Equivalent of the reference's ``train.py --img 640 --batch 16 --epochs 50
--data model/multilabel_farms.yaml --weights yolov5m.pt`` (reference
README.md:52) and of ``aquaculture_tpu.cli.train``, on one device or, with ``--mesh DxM``, over D x M
processes (one per GPU):

    python -m aquaculture_tpu_torch.cli.train --images DATA/images --out CKPT \\
        [--weights yolov5m.pt | CKPT_DIR] --variant m [--epochs 50 --batch 16] \\
        [--remat] [--resume] [--device cuda|cpu]
    torchrun --nproc-per-node 8 -m aquaculture_tpu_torch.cli.train --mesh 8 ...

Warm-starts from an ultralytics training ``.pt`` or an unfused checkpoint
directory. After each epoch it saves ``<out>/last`` (the EMA weights, with
the JAX package's metadata: epoch, variant, num_classes, img_size) and
``<out>/state`` (params, optimizer momenta and step, EMA, step), in the
JAX package's checkpoint format: either package serves ``last`` and
resumes ``state``. Runs on the GPU unless ``--device cpu`` is given.

``--mesh D`` or ``DxM`` (data x model) runs the step of parallel/sharded.py
with the JAX package's global-batch arithmetic: ``--batch`` is the global
batch, and each data rank builds only its own rows of it. The rendezvous is
torchrun's environment (WORLD_SIZE must be D*M); ``--mesh 1`` without it
makes a one-rank group itself. Collectives run over NCCL on the card (rank
r on ``cuda:{LOCAL_RANK}``) and gloo on the CPU. Rank 0 writes ``last``
and ``state`` (the gathered, unsharded trees); every rank reads ``state``
on ``--resume``, from any mesh shape or package.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from aquaculture_tpu_torch.cli.detect import default_img_size, resolve_model_args
from aquaculture_tpu_torch.config import TrainConfig, resolve_device
from aquaculture_tpu_torch.models.weights import has_bn, load_pretrained, load_train_params
from aquaculture_tpu_torch.models.yolov5 import VARIANTS, YoloV5, yolov5_init
from aquaculture_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_local_batch
from aquaculture_tpu_torch.parallel.pod import local_device
from aquaculture_tpu_torch.parallel.sharded import full_ema_tree, full_state_tree, sharded_train_step
from aquaculture_tpu_torch.train.dataset import DetectionDataset
from aquaculture_tpu_torch.train.trainer import init_train_state, load_state_tree, make_train_step
from aquaculture_tpu_torch.utils.checkpoint import load_metadata, load_params, save_params


def build_model(weights: str | None, variant: str, num_classes: int, seed: int) -> YoloV5:
    """The training model from a warm-start source (ultralytics ``.pt`` or
    checkpoint directory, which must hold BatchNorm parameters) or, without
    one, the seeded random init of ``yolov5_init``."""
    anchors = None
    if weights:
        if weights.endswith(".pt"):
            params, anchors = load_pretrained(YoloV5(variant, num_classes), weights)
        else:
            params = load_params(weights)
        if not has_bn(params):
            raise SystemExit(
                f"{weights} holds FUSED inference weights (no BatchNorm parameters); "
                "warm-start needs an unfused source: a training checkpoint dir or an "
                "ultralytics training .pt")
    else:
        _, params = yolov5_init(variant, num_classes, seed=seed)
    return load_train_params(YoloV5(variant, num_classes, anchors=anchors, trainable=True), params)


def parse_mesh(mesh: str) -> tuple:
    """'D' or 'DxM' -> (n_data, n_model)."""
    dims = [int(v) for v in mesh.lower().split("x")]
    if not 1 <= len(dims) <= 2 or min(dims) < 1:
        raise ValueError(f"--mesh takes D or DxM, got {mesh!r}")
    return tuple(dims + [1])[:2]


def init_mesh_group(n_data: int, n_model: int, device: torch.device) -> bool:
    """Join the process group of a ``--mesh`` run: an existing group,
    torchrun's environment, or, for a one-rank mesh without either, a
    one-rank group of this process (NCCL on the card, gloo on the CPU). The
    world must hold n_data * n_model ranks. Returns whether this call made
    the group (and its caller should destroy it)."""
    made = not dist.is_initialized()
    if made:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            dist.init_process_group(backend, init_method="env://")
        elif n_data * n_model == 1:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
        else:
            raise SystemExit(f"--mesh {n_data}x{n_model} needs {n_data * n_model} processes: launch it "
                             f"with torchrun --nproc-per-node {n_data * n_model}")
    if dist.get_world_size() != n_data * n_model:
        raise SystemExit(f"--mesh {n_data}x{n_model} needs WORLD_SIZE={n_data * n_model}, "
                         f"got {dist.get_world_size()}")
    return made


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", required=True, help="training images directory")
    ap.add_argument("--labels", default=None, help="labels directory (default: sibling labels/)")
    ap.add_argument("--out", required=True, help="checkpoint output directory")
    ap.add_argument("--weights", default=None, help="warm-start .pt or checkpoint dir")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="(default: the warm-start checkpoint's saved variant, else m)")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="(default: the warm-start checkpoint's saved value, else 5)")
    ap.add_argument("--img", type=int, default=None,
                    help="training size (default: 1280 for P6 *6 variants, else 640)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true", help="resume from <out>/state if present")
    ap.add_argument("--remat", action="store_true", help="recompute block activations in the backward pass")
    ap.add_argument("--mesh", default=None,
                    help="train over processes: 'D' (data) or 'DxM' (data x model), one process per GPU "
                         "under torchrun; --batch is the global batch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    mesh, made_group = None, False
    if args.mesh:
        n_data, n_model = parse_mesh(args.mesh)
        if args.batch % n_data:
            raise SystemExit(f"--batch {args.batch} must divide over the {n_data} data ranks")
        device = local_device(args.device, share=False)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        made_group = init_mesh_group(n_data, n_model, device)
        mesh = make_mesh(n_data, n_model)
    else:
        device = resolve_device(args.device)
    try:
        return run_training(args, device, mesh)
    finally:
        if made_group:
            dist.destroy_process_group()


def run_training(args, device: torch.device, mesh) -> dict:
    """The training run of ``main``'s parsed ``args`` on ``device``, over
    ``mesh`` (a DeviceMesh, or None for one process)."""
    rank0 = mesh is None or dist.get_rank() == 0

    variant, num_classes = resolve_model_args(args.weights, args.variant, args.num_classes)
    img = default_img_size(args.img, variant)
    cfg = TrainConfig(img_size=img, batch_size=args.batch, epochs=args.epochs, remat=args.remat)
    ds = DetectionDataset(args.images, args.labels, cfg, augment=not args.no_augment, seed=args.seed)
    if rank0:
        print(f"[INFO] {len(ds)} images, {ds.steps_per_epoch} steps/epoch", flush=True)

    model = build_model(args.weights, variant, num_classes, args.seed)
    model.to(device=device, memory_format=torch.channels_last)
    state = init_train_state(model)
    start_epoch = 0
    state_dir = os.path.join(args.out, "state")
    if args.resume and os.path.exists(os.path.join(state_dir, "treedef.json")):
        load_state_tree(state, load_params(state_dir))
        start_epoch = int(load_metadata(state_dir).get("epoch", 0))
        if rank0:
            print(f"[INFO] resumed from {state_dir} at epoch {start_epoch}", flush=True)
    if mesh is None:
        step_fn, slots = make_train_step(model, cfg, ds.steps_per_epoch), None
    else:
        step_fn, state = sharded_train_step(model, cfg, mesh, ds.steps_per_epoch, state)
        rows = batch_sharding(mesh, cfg.batch_size)
        slots = range(rows.start, rows.stop)  # this data rank's rows of each global batch
        if rank0:
            print(f"[INFO] training over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{dist.get_backend()}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    epochs = []
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        last = {}
        for batch in ds.epoch(epoch, slots):
            last = step_fn(state, shard_local_batch(batch, mesh, device))
        host = {k: float(v) for k, v in last.items()}  # waits for the epoch's last step
        dt = time.perf_counter() - t0
        img_s = ds.steps_per_epoch * cfg.batch_size / dt
        epochs.append({"epoch": epoch + 1, **host, "seconds": dt, "img_per_s": img_s})
        # the gathered trees: collectives over the model axis, on every rank
        ema, tree = full_ema_tree(state), full_state_tree(state)
        if rank0:
            print(
                f"[INFO] epoch {epoch + 1}/{cfg.epochs}: loss={host.get('total', np.nan):.4f} "
                f"(box {host.get('box', np.nan):.4f} obj {host.get('obj', np.nan):.4f} "
                f"cls {host.get('cls', np.nan):.4f}) {dt:.1f}s ({img_s:.1f} img/s) on {device}",
                flush=True,
            )
            save_params(os.path.join(args.out, "last"), ema,
                        metadata={"epoch": epoch + 1, "variant": variant, "num_classes": num_classes,
                                  "img_size": img})
            save_params(state_dir, tree, metadata={"epoch": epoch + 1})
        if mesh is not None:
            # no rank goes on before rank 0's checkpoint of the epoch is
            # whole: a run that fails later resumes from it on every rank
            dist.barrier()
    if rank0:
        print(f"[INFO] saved EMA checkpoint -> {os.path.join(args.out, 'last')}", flush=True)
    return {"epochs": epochs, "step": state.step, "steps_per_epoch": ds.steps_per_epoch,
            "variant": variant, "img": img, "batch": cfg.batch_size, "device": str(device),
            "mesh": None if mesh is None else list(mesh.shape)}


if __name__ == "__main__":
    main()
