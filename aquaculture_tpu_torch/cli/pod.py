"""Pod-scale serving CLI of the PyTorch port: a sharded corpus -> one global
detections GeoJSON.

Counterpart of ``aquaculture_tpu.cli.pod`` (the config-5 runner): every
process detects over its contiguous shard of the tile corpus on its own GPU
(``cuda:{LOCAL_RANK % device_count}``; ``--device cpu`` for the CPU),
checkpoints its progress in chunk manifests when asked, and process 0
writes the gathered output. One process degenerates to the fused
pipeline's detect + geocode (+ cross-tile NMS with ``--overlap``).

    # one process per GPU on one host:
    torchrun --nproc-per-node 8 -m aquaculture_tpu_torch.cli.pod \\
        --source store:/data/corpus::jpegs --download-bboxes wanted_bboxes.csv \\
        --out global_detections.geojson --checkpoint-dir ckpt/
    # or per host, with an explicit rendezvous:
    python -m aquaculture_tpu_torch.cli.pod --source DIR --download-bboxes B.csv \\
        --out out.geojson --coordinator host0:1234 --num-processes 4 --process-id $HOST_ID

The collectives move host tables over gloo; no NCCL communicator is made,
so several processes may share one GPU.
"""

from __future__ import annotations

import argparse
import glob
import os

from aquaculture_tpu_torch.cli.detect import default_img_size, load_model, resolve_model_args
from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data.store import GcsBlobStore, LocalBlobStore
from aquaculture_tpu_torch.models.yolov5 import VARIANTS
from aquaculture_tpu_torch.parallel.mesh import put_global
from aquaculture_tpu_torch.parallel.pod import host_group, init_distributed, local_device, run_pod_pipeline

IMAGE_EXTS = ("jpeg", "jpg", "png", "tif", "tiff")


def resolve_source(source: str):
    """(store or None, sorted paths or keys) of a ``--source``: an image
    directory or glob, ``gs://bucket/prefix`` or ``store:ROOT::PREFIX``."""
    if source.startswith(("gs://", "store:")):
        if source.startswith("gs://"):
            bucket, _, prefix = source[len("gs://"):].partition("/")
            store = GcsBlobStore(bucket)
        else:
            root, _, prefix = source[len("store:"):].partition("::")
            store = LocalBlobStore(root)
        return store, [k for k in store.list(prefix) if k.rsplit(".", 1)[-1].lower() in IMAGE_EXTS]
    if os.path.isdir(source):
        return None, sorted(p for ext in IMAGE_EXTS for p in glob.glob(os.path.join(source, f"*.{ext}")))
    return None, sorted(glob.glob(source))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", required=True,
                    help="corpus: image directory or glob, 'gs://bucket/prefix' (GCS object-store "
                         "streaming), or 'store:ROOT::PREFIX' (local object-store streaming)")
    ap.add_argument("--download-bboxes", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="(default: the checkpoint's saved variant, else m)")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="(default: the checkpoint's saved value, else 5)")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--pre-topk", type=int, default=None,
                    help="candidate pool cap before suppression (default 1024)")
    ap.add_argument("--img", type=int, default=None,
                    help="inference size (default: 640, or 1280 for *6 variants)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous of process 0: host:port, or a torch.distributed init method "
                         "(tcp://..., file://...); without it torchrun's environment, if any")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="elastic recovery: per-process progress manifests; a restarted run resumes")
    ap.add_argument("--checkpoint-every", type=int, default=1024, help="tiles between progress checkpoints")
    ap.add_argument("--overlap", type=int, default=0,
                    help="overlap serving: tile overlap in px on large rasters; duplicates collapse by "
                         "meter-space IoU after the global gather. 0 = the reference's hard grid")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    device = local_device(args.device)
    host, n_hosts = init_distributed(args.coordinator, args.num_processes, args.process_id)
    print(f"[INFO] process {host} of {n_hosts} on {device}", flush=True)

    store, paths = resolve_source(args.source)
    args.variant, args.num_classes = resolve_model_args(args.weights, args.variant, args.num_classes)
    model = load_model(args.weights, args.variant, args.num_classes)
    put_global(model, host_group() if n_hosts > 1 else None)  # rank 0's weights on every rank
    cfg_kw = dict(img_size=default_img_size(args.img, args.variant), conf_threshold=args.conf)
    if args.pre_topk:
        cfg_kw["pre_nms_topk"] = args.pre_topk
    det, stats = run_pod_pipeline(
        paths, model, load_download_bboxes(args.download_bboxes), DetectConfig(**cfg_kw),
        batch_size=args.batch, out_path=args.out, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, store=store, overlap=args.overlap, device=device,
    )
    print(f"[INFO] done: {stats.tiles} local tiles in {stats.batches} batches at "
          f"{stats.tiles_per_second:.1f} tiles/s on {device}", flush=True)
    return det, stats


if __name__ == "__main__":
    main()
