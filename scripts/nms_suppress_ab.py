"""An earlier CUDA NMS-suppression kernel against the one in the tree, on one card.

Builds the port's kernel (aquaculture_tpu_torch/csrc/nms_suppress.cu) and a
second source with the same C interface (``aq_nms_suppress``,
``aq_nms_max_k``), both with the port's nvcc flags. On the serving
program's own candidates (mt, random weights from seed 0, conf 1e-5) at
each ``chip_smoke.TIMED_SHAPES`` entry, and at the first shape's scan floor
(no valid candidate), it holds each kernel's keep masks exactly against the
plain PyTorch version and then times them in the order old, new, new, old
(``chip_smoke.time_cuda`` with queued launches, 20 per window). A shape
above a kernel's K cap is timed for the other kernel only.

Run from the repository root on a machine with one H100; for example,
against the kernel as it stood at commit 3110b59:

    mkdir -p .archive_check
    git show 3110b59:aquaculture_tpu_torch/csrc/nms_suppress.cu \\
        > .archive_check/nms_suppress_3110b59.cu
    python3 scripts/nms_suppress_ab.py --old-source .archive_check/nms_suppress_3110b59.cu

Prints one JSON line per case, then the card's name and power limit as
nvidia-smi reports them. Exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402


def _launcher(lib, boxes, valid):
    """One launch of ``lib``'s kernel on the current stream into a keep
    buffer allocated once."""
    import torch

    b, k = valid.shape
    keep = torch.empty_like(valid)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.aq_nms_suppress(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                  b, k, 0.45, stream)
        if err != 0:
            raise RuntimeError(f"aq_nms_suppress launch failed: cudaError {err}")
        return keep

    return run


def main(argv=None) -> int:
    import torch

    from aquaculture_tpu_torch.cli.detect import load_model
    from aquaculture_tpu_torch.ops import nms as N
    from aquaculture_tpu_torch.ops import nms_cuda
    from aquaculture_tpu_torch.pipeline import preprocess

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--old-source", required=True, help="the earlier kernel's .cu file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    libs = {
        "old": nms_cuda.load_library(nms_cuda.compile_library(os.path.abspath(args.old_source))),
        "new": nms_cuda.build(),
    }
    caps = {name: lib.aq_nms_max_k() for name, lib in libs.items()}
    print(json.dumps({"old_source": args.old_source, "k_caps": caps, "card": card}), flush=True)

    model, tiles = load_model(None, "mt", 5), cs.serving_tiles(dev)
    model.to(dev, torch.bfloat16, memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        preds = model(preprocess(tiles, 640, torch.bfloat16))
        inputs = cs.timed_suppress_inputs(preds, cs.TIMED_SHAPES)
        cases = [("all_valid", *inp) for inp in inputs]
        b0, k0, boxes0, valid0 = inputs[0]
        cases.append(("scan_floor", b0, k0, boxes0, torch.zeros_like(valid0)))
        for case, b, k, boxes, valid in cases:
            plain = N.greedy_suppress_plain(boxes, valid, 0.45)
            runs = {name: _launcher(lib, boxes, valid) for name, lib in libs.items() if k <= caps[name]}
            for name, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, plain):
                    cs.fail(f"{name} kernel != plain ({case}, B={b}, K={k}): "
                            f"{int((got != plain).sum())} flags differ")
            times = {name: [] for name in runs}
            for name in ("old", "new", "new", "old"):
                if name in runs:
                    times[name].append(cs.time_cuda(runs[name], iters=20, queued=True))
            ms = {name: statistics.mean(times[name]) if name in times else None for name in libs}
            print(json.dumps({
                "case": case, "B": b, "K": k, "valid": int(valid.sum()), "kept": int(plain.sum()),
                "old_ms": ms["old"], "new_ms": ms["new"], "old_runs_ms": times.get("old"),
                "new_runs_ms": times["new"],
                "old_over_new": ms["old"] / ms["new"] if ms["old"] is not None else None,
                "card": card,
            }), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
