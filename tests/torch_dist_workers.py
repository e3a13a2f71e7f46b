"""Worker functions of the port's multi-process tests, started by
torch.multiprocessing.spawn as rank r of a gloo world that rendezvouses
through a file (``file://.../rdzv``: no TCP port to collide between test
processes). Inputs and results travel as pickles in the test's tmp_path.

Imports the port only (never jax): a spawned rank starts a fresh
interpreter and should start fast."""

from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist


def _init(rank: int, world: int, rdzv: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree.copy() if hasattr(tree, "copy") else tree


def read(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump(obj, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def train_steps(rank: int, world: int, rdzv: str, n_model: int, job: str, out: str) -> None:
    """Train steps of n under sharded_train_step on a (world / n_model) x
    n_model mesh, every rank on its rows of each global batch.

    job: a pickle of {params (JAX-format tree), batches (list of global
    batch dicts), cfg (TrainConfig kwargs), resume (a state/ dir or None),
    phases: [{steps (indices into batches), save (a state/ dir to write
    after them, or None)}]}. Rank 0 writes, per phase, {losses, state (the
    gathered state/ tree)} to ``out``."""
    from aquaculture_tpu_torch.config import TrainConfig
    from aquaculture_tpu_torch.models.weights import load_train_params
    from aquaculture_tpu_torch.models.yolov5 import YoloV5
    from aquaculture_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from aquaculture_tpu_torch.parallel.sharded import full_state_tree, sharded_train_step
    from aquaculture_tpu_torch.train.trainer import init_train_state, load_state_tree
    from aquaculture_tpu_torch.utils import checkpoint

    _init(rank, world, rdzv)
    spec = read(job)
    model = load_train_params(YoloV5("n", 2, trainable=True), spec["params"])
    state = init_train_state(model)
    if spec.get("resume"):
        load_state_tree(state, checkpoint.load_params(spec["resume"]))
    mesh = make_mesh(world // n_model, n_model)
    step, state = sharded_train_step(model, TrainConfig(**spec["cfg"]), mesh, 1, state)
    records = []
    for phase in spec["phases"]:
        losses = []
        for i in phase["steps"]:
            m = step(state, shard_batch(spec["batches"][i], mesh, "cpu"))
            losses.append({k: float(v) for k, v in m.items()})
        tree = full_state_tree(state)
        if rank == 0 and phase.get("save"):
            checkpoint.save_params(phase["save"], tree, metadata={"epoch": 1})
        records.append({"losses": losses, "state": _copy(tree)})  # to_tree's arrays share the tensors
    if rank == 0:
        dump(records, out)
    dist.barrier()
    dist.destroy_process_group()


def cli_train(rank: int, world: int, rdzv: str, runs: list, out: str, f32: bool = False) -> None:
    """``cli.train.main`` for each run in turn in one gloo world; rank 0
    writes the list of returns to ``out``. runs: [{argv, crash_at_epoch}]:
    with crash_at_epoch = e the run dies (raises) when epoch e starts, after
    the checkpoints of epoch e - 1 are written, and returns None. With f32,
    cli.train's TrainConfig computes in float32, as
    tests/test_torch_train_cli.py patches it."""
    import dataclasses

    from aquaculture_tpu_torch.cli import train as cli

    if f32:
        base = cli.TrainConfig
        cli.TrainConfig = lambda **kw: dataclasses.replace(base(**kw), compute_dtype="float32")
    _init(rank, world, rdzv)
    results = []
    for run in runs:
        crash = run.get("crash_at_epoch")
        epoch = cli.DetectionDataset.epoch

        def dying(self, epoch_index=0, slots=None):
            if epoch_index == crash:
                raise RuntimeError("simulated crash")
            return epoch(self, epoch_index, slots)

        cli.DetectionDataset.epoch = dying
        try:
            results.append(cli.main(run["argv"]))
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
            results.append(None)
        finally:
            cli.DetectionDataset.epoch = epoch
    if rank == 0:
        dump(results, out)
    dist.destroy_process_group()


def pod_runs(rank: int, world: int, rdzv: str, job: str, out_dir: str) -> None:
    """The pod's runs on one gloo world: job is a pickle of {weights,
    variant, num_classes, bboxes (CSV path), cfg (DetectConfig kwargs),
    batch, runs: [{name, paths, store_root, overlap, checkpoint_dir,
    checkpoint_every, drop_last_chunk_of}], cli: [argv of cli.pod]}. A run
    with drop_last_chunk_of = r first deletes rank r's last chunk manifest
    (a lost chunk). Each rank writes its stats, and rank 0 the gathered
    frame, per run to out_dir."""
    from aquaculture_tpu_torch.cli import pod as cli_pod
    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
    from aquaculture_tpu_torch.config import DetectConfig
    from aquaculture_tpu_torch.data.store import LocalBlobStore
    from aquaculture_tpu_torch.parallel.mesh import put_global
    from aquaculture_tpu_torch.parallel.pod import _chunk_files, run_pod_pipeline

    _init(rank, world, rdzv)
    spec = read(job)
    model = put_global(load_model(spec["weights"], spec["variant"], spec["num_classes"]))
    dl = load_download_bboxes(spec["bboxes"])
    for run in spec["runs"]:
        store = LocalBlobStore(run["store_root"]) if run.get("store_root") else None
        if run.get("drop_last_chunk_of") == rank:
            os.remove(_chunk_files(run["checkpoint_dir"], rank)[-1])
        det, stats = run_pod_pipeline(
            run["paths"], model, dl, DetectConfig(**spec["cfg"]), batch_size=spec["batch"],
            store=store, overlap=run.get("overlap", 0), checkpoint_dir=run.get("checkpoint_dir"),
            checkpoint_every=run.get("checkpoint_every", 1024), device="cpu")
        dump({"tiles": stats.tiles, "batches": stats.batches}, os.path.join(out_dir, f"{run['name']}.{rank}.pkl"))
        if rank == 0:
            det.to_pickle(os.path.join(out_dir, f"{run['name']}.frame.pkl"))
    for argv in spec.get("cli", []):
        _, stats = cli_pod.main(argv)
        dump({"tiles": stats.tiles, "batches": stats.batches}, os.path.join(out_dir, f"cli.{rank}.pkl"))
    dist.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks and wait."""
    import torch.multiprocessing as mp

    mp.spawn(fn, args=(world, *args), nprocs=world, join=True)


