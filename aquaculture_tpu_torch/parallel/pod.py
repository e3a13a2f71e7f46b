"""Multi-host serving: corpus shards, resumable chunk manifests and the
global detection gather (the "config-5 runner").

Counterpart of aquaculture_tpu/parallel/pod.py over torch.distributed:

* each rank claims a deterministic, contiguous, balanced shard of the tile
  corpus (files or object-store keys) and serves it on its own device
  (one process per GPU; the JAX package's intra-host ``data`` mesh);
* with a checkpoint directory, each rank publishes append-only chunk
  manifests as it goes and a restarted run skips what they hold. The
  fingerprint, file names and npz keys are the JAX package's, so either
  package resumes the other's run;
* the detection tables and the tile-spec tables are all-gathered over a
  gloo group (host numpy tables, whatever the device), padded to the
  largest count and unpadded in rank order: N ranks give the 1-rank row
  order. Cross-tile NMS (overlap serving) runs after the gather, and rank
  0 writes the GeoJSON.

With one process everything degenerates to the plain pipeline.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aquaculture_tpu_torch import pipeline
from aquaculture_tpu_torch.config import DetectConfig, resolve_device
from aquaculture_tpu_torch.data.filenames import TileSpec
from aquaculture_tpu_torch.post.dedup import nms_cross_tile
from aquaculture_tpu_torch.post.geocode import geocode_detections

_LAYER_BYTES = 96  # fixed-width utf-8 budget for gathering layer strings


def _log(msg: str) -> None:
    print(f"[INFO] {msg}", flush=True)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> Tuple[int, int]:
    """Join the process group when running multi-process; a no-op
    returning (0, 1) otherwise, and (rank, world) of the existing group when
    one is already initialized.

    The rendezvous is ``coordinator_address`` (``host:port``, or any
    torch.distributed init method: ``tcp://host:port``, ``file:///path``)
    with ``num_processes`` and ``process_id``, or torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``: ``env://``). The serving pod
    moves host tables, so its backend is gloo; training passes nccl on the
    card."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address:
        method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=method, world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    else:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda", share: bool = True) -> torch.device:
    """This rank's device: the CPU when asked for, else
    ``cuda:{LOCAL_RANK % device_count}`` (share=True: serving ranks may
    share a card, as no NCCL communicator is made) or ``cuda:{LOCAL_RANK}``
    (share=False: training, where NCCL takes one rank per GPU; a rank
    without its own GPU raises). Without a GPU, CUDA raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", 0))
    count = torch.cuda.device_count()
    if not share and local >= count:
        raise RuntimeError(f"rank with LOCAL_RANK={local} has no GPU of its own ({count} visible); "
                           "NCCL takes one rank per GPU")
    return torch.device("cuda", local % count)


def host_group():
    """A gloo group for the host-table collectives: the default group (None)
    when it is gloo, else a new gloo group over the world (a collective
    call: every rank makes it at the same point)."""
    return None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


def shard_corpus(paths: Sequence[str], num_hosts: int, host_id: int) -> List[str]:
    """Deterministic contiguous balanced shard of the corpus for one host:
    contiguous, so a host streams neighbouring objects; shard sizes differ
    by at most 1."""
    assert 0 <= host_id < num_hosts
    paths = list(paths)
    base, extra = divmod(len(paths), num_hosts)
    start = host_id * base + min(host_id, extra)
    size = base + (1 if host_id < extra else 0)
    return paths[start : start + size]


def _gather_counts(n: int, group) -> np.ndarray:
    t = torch.tensor([n], dtype=torch.int64)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.cat(out).numpy()


def _gather_padded(a: np.ndarray, n_max: int, group) -> List[np.ndarray]:
    """All-gather one (n, ...) array per rank, padded with zeros to n_max
    rows (at least one: a zero-size collective is not asked of gloo)."""
    pad = np.zeros((max(n_max, 1),) + a.shape[1:], a.dtype)
    pad[: len(a)] = a
    t = torch.from_numpy(pad)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [o.numpy() for o in out]


def gather_detection_tables(
    boxes: np.ndarray, conf: np.ndarray, cls: np.ndarray, tile_ids: np.ndarray, group=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All-gather every rank's detection table over the gloo ``group``
    (padded to the largest count, unpadded in rank order). One process: the
    identity."""
    if process_count() == 1:
        return boxes, conf, cls, tile_ids
    counts = _gather_counts(len(boxes), group)
    n_max = int(counts.max())
    tables = [
        _gather_padded(np.asarray(a, dtype).reshape((len(boxes),) + tail), n_max, group)
        for a, dtype, tail in ((boxes, np.float64, (4,)), (conf, np.float64, ()),
                               (cls, np.int64, ()), (tile_ids, np.int64, ()))
    ]
    return tuple(np.concatenate([g[h][:n] for h, n in enumerate(counts)]) for g in tables)


def _spec_rows(specs) -> np.ndarray:
    return np.asarray([(s.year, s.bbox_ind, s.x_offset, s.y_offset) for s in specs], np.int64).reshape(-1, 4)


def _spec_layers(specs) -> np.ndarray:
    return np.asarray([s.layer for s in specs], dtype=np.str_)


def _rows_to_specs(rows: np.ndarray, layers=None) -> List[TileSpec]:
    rows = np.asarray(rows, np.int64).reshape(-1, 4)
    lay = [""] * len(rows) if layers is None else [str(v) for v in layers]
    return [TileSpec(year=int(r[0]), bbox_ind=int(r[1]), x_offset=int(r[2]), y_offset=int(r[3]), layer=lay[i])
            for i, r in enumerate(rows)]


def _encode_layers(specs) -> np.ndarray:
    """Layer strings as fixed-width utf-8 rows; a layer over the budget
    raises (truncating could split a code point and would corrupt the tile
    identity)."""
    out = np.zeros((len(specs), _LAYER_BYTES), np.uint8)
    for i, s in enumerate(specs):
        b = s.layer.encode("utf-8")
        if len(b) > _LAYER_BYTES:
            raise ValueError(f"TileSpec layer exceeds the {_LAYER_BYTES}-byte gather budget: {s.layer!r}")
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def _gather_spec_tables(spec_table: List[TileSpec], group) -> Tuple[List[TileSpec], np.ndarray]:
    """All-gather every rank's tile-spec table over the gloo ``group``: the
    (year, bbox, x, y) rows as int64 and the layers as fixed-width utf-8.
    Returns the global table in rank order and each rank's offset into it."""
    lay = _encode_layers(spec_table)
    counts = _gather_counts(len(spec_table), group)
    n_max = int(counts.max())
    tables = _gather_padded(_spec_rows(spec_table), n_max, group)
    layer_tables = _gather_padded(lay, n_max, group)
    rows, layers = [], []
    for h, n in enumerate(counts):
        rows.append(tables[h][:n])
        layers.extend(bytes(layer_tables[h][i]).rstrip(b"\x00").decode("utf-8") for i in range(n))
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return _rows_to_specs(np.concatenate(rows), layers), offsets


def _corpus_fingerprint(all_paths: Sequence[str], n_hosts: int, cfg=None, overlap: int = 0) -> str:
    """Identity of a resumable run: corpus list, host count, the detection
    config and the tiling overlap; the JAX package's hex digest for the same
    inputs. Only a strided run hashes its overlap, so hard-grid manifests
    written before overlap existed stay resumable."""
    h = hashlib.sha1()
    h.update(f"hosts={n_hosts}\n".encode())
    if overlap:
        h.update(f"overlap={overlap}\n".encode())
    if cfg is not None:
        h.update(repr(cfg).encode())
        h.update(b"\n")
    for p in all_paths:
        h.update(p.encode())
        h.update(b"\n")
    return h.hexdigest()


def _chunk_files(checkpoint_dir: str, host: int) -> List[str]:
    return sorted(_glob.glob(os.path.join(checkpoint_dir, f"pod_host{host}_chunk*.npz")))


def _load_progress(checkpoint_dir: str, host: int, fingerprint: str):
    """Union of this host's chunk manifests: (done paths, boxes, conf, cls,
    spec rows, spec layers). A chunk written under another corpus, host
    count or config raises: resuming across a re-shard would count tiles
    twice that another host now owns."""
    done: set = set()
    bs, cs, ks, rs, ls = [], [], [], [], []
    for f in _chunk_files(checkpoint_dir, host):
        z = np.load(f, allow_pickle=False)
        fp = str(z["fingerprint"])
        if fp != fingerprint:
            raise RuntimeError(
                f"pod checkpoint {f} was written for a different corpus, "
                f"host count, or detection config (fingerprint {fp[:12]} != "
                f"{fingerprint[:12]}); resume requires the SAME corpus list, "
                "process count, and config — delete the checkpoint dir to "
                "start fresh"
            )
        done.update(str(p) for p in z["done_paths"])
        bs.append(z["boxes"].reshape(-1, 4))
        cs.append(z["conf"])
        ks.append(z["cls"])
        rs.append(z["spec_rows"].reshape(-1, 4))
        ls.append(z["spec_layers"])
    if not bs:
        return (set(), np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64), np.zeros((0, 4), np.int64),
                np.zeros(0, np.str_))
    return done, np.concatenate(bs), np.concatenate(cs), np.concatenate(ks), np.concatenate(rs), np.concatenate(ls)


def _append_chunk(checkpoint_dir: str, host: int, idx: int, fingerprint: str,
                  chunk_paths, boxes, conf, cls, specs) -> None:
    """One append-only chunk manifest, published atomically by os.replace
    from a dot-prefixed temp file the glob never matches."""
    path = os.path.join(checkpoint_dir, f"pod_host{host}_chunk{idx:06d}.npz")
    tmp = os.path.join(checkpoint_dir, f".pod_host{host}_chunk{idx:06d}.tmp.npz")
    np.savez(
        tmp,
        fingerprint=np.str_(fingerprint),
        done_paths=np.asarray(list(chunk_paths), dtype=np.str_),
        boxes=np.asarray(boxes, np.float64).reshape(-1, 4),
        conf=np.asarray(conf, np.float64),
        cls=np.asarray(cls, np.int64),
        spec_rows=_spec_rows(specs),
        spec_layers=_spec_layers(specs),
    )
    os.replace(tmp, path)


def _detect_resumable(shard, model, cfg, batch_size, checkpoint_dir, checkpoint_every, fingerprint, host,
                      store, stride, device):
    """Detect over the shard's tiles that no manifest holds, one chunk
    manifest per ``checkpoint_every`` tiles; returns the merged tables of
    the earlier and this run and the stats of this run's work alone."""
    done, boxes0, conf0, cls0, rows0, layers0 = _load_progress(checkpoint_dir, host, fingerprint)
    todo = [p for p in shard if p not in done]
    if done:
        _log(f"host {host}: resuming: {len(done)} tiles already done, {len(todo)} remain")
    next_idx = len(_chunk_files(checkpoint_dir, host))
    stats = pipeline.PipelineStats()
    # one infer function for every chunk
    infer_fn = pipeline.make_infer_fn(model, cfg, device=device) if todo else None
    acc = [[np.asarray(boxes0).reshape(-1, 4)], [np.asarray(conf0)], [np.asarray(cls0, np.int64)],
           [np.asarray(rows0, np.int64).reshape(-1, 4)], [np.asarray(layers0, dtype=np.str_)]]
    for i in range(0, len(todo), checkpoint_every):
        chunk = todo[i : i + checkpoint_every]
        b, c, k, specs, st = pipeline.detect_files(chunk, model, cfg, batch_size, infer_fn=infer_fn,
                                                   device=device, stride=stride, store=store)
        stats.tiles += st.tiles
        stats.batches += st.batches
        stats.detections += st.detections
        stats.infer_seconds += st.infer_seconds
        _append_chunk(checkpoint_dir, host, next_idx, fingerprint, chunk, b, c, k, specs)
        next_idx += 1
        for a, v in zip(acc, (np.asarray(b).reshape(-1, 4), np.asarray(c), np.asarray(k, np.int64),
                              _spec_rows(specs), _spec_layers(specs))):
            a.append(v)
    boxes, conf, cls, rows, layers = (np.concatenate(a) for a in acc)
    return boxes, conf, cls, _rows_to_specs(rows, layers), stats


def run_pod_pipeline(
    all_paths: Sequence[str],
    model,
    download_bboxes,
    cfg: Optional[DetectConfig] = None,
    batch_size: int = 32,
    out_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1024,
    store=None,
    overlap: int = 0,
    overlap_iou: float = 0.5,
    device="cuda",
):
    """The config-5 runner: every rank detects over its corpus shard on
    ``device`` (CUDA unless the CPU is asked for) through the serving
    program of ``make_infer_fn``; the tables are gathered to every rank;
    rank 0 writes the global GeoJSON.

    store: a data.store.BlobStore; ``all_paths`` are then blob keys, and
    manifests are keyed by blob name. overlap > 0: overlap serving (tiles
    step by tile - overlap px), the duplicates collapsing by meter-space
    cross-tile NMS after the gather (rasters never split across ranks: the
    shards are per file). checkpoint_dir: elastic recovery; every
    ``checkpoint_every`` tiles each rank publishes a chunk manifest, and a
    restarted run skips finished tiles, so a failure costs at most one
    chunk. Resume needs the SAME corpus, process count and config.
    Returns (detections GeoFrame in EPSG:4326, this rank's PipelineStats).
    """
    cfg = cfg or DetectConfig()
    stride = pipeline.overlap_stride(overlap)
    dev = resolve_device(device)
    host, n_hosts = process_index(), process_count()
    shard = shard_corpus(all_paths, n_hosts, host)
    _log(f"host {host}/{n_hosts}: {len(shard)} of {len(all_paths)} tiles on {dev}")

    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        fingerprint = _corpus_fingerprint(all_paths, n_hosts, cfg, overlap=overlap)
        boxes, conf, cls, specs, stats = _detect_resumable(
            shard, model, cfg, batch_size, checkpoint_dir, checkpoint_every, fingerprint, host, store,
            stride, dev)
    else:
        boxes, conf, cls, specs, stats = pipeline.detect_files(shard, model, cfg, batch_size, device=dev,
                                                               stride=stride, store=store)

    # specs travel as ids into a spec table (numeric gathers), decoded after
    spec_table = list(dict.fromkeys(specs))
    spec_id = {s: i for i, s in enumerate(spec_table)}
    tile_ids = np.asarray([spec_id[s] for s in specs], np.int64)
    if n_hosts > 1:
        group = host_group()
        global_specs, offsets = _gather_spec_tables(spec_table, group)
        boxes, conf, cls, tile_ids = gather_detection_tables(boxes, conf, cls, tile_ids + offsets[host], group)
    else:
        global_specs = spec_table

    det = geocode_detections(np.asarray(boxes).astype(np.int64), conf, np.asarray(cls).astype(np.int64),
                             [global_specs[i] for i in tile_ids], download_bboxes)
    if overlap and len(det):
        before = len(det)
        det = nms_cross_tile(det, iou_thresh=overlap_iou)
        _log(f"cross-tile NMS: {before} -> {len(det)} detections")
    if out_path and host == 0:
        det.to_file(out_path)
        _log(f"host 0 wrote {len(det)} global detections -> {out_path}")
    return det, stats
