"""JPEG decode kernels on one card: the tree's fused kernel against others.

Builds the port's kernel (aquaculture_tpu_torch/csrc/jpeg_decode.cu) and,
with the port's nvcc flags, optionally:
- ``--pair SOURCE``: a source with the earlier two-kernel interface
  (``aq_jpeg_idct`` into planes in device memory, then ``aq_jpeg_color``,
  as at commit 4ef1674);
- ``--source NAME=PATH``: other sources with the fused interface
  (``aq_jpeg_decode``);
- ``--cuts``: two cuts of each fused source that split its time, built
  with the macro the source marks each cut with: ``AQ_AB_IDCT_ONLY`` (the
  colour pass never runs) and ``AQ_AB_COLOUR_ONLY`` (no IDCT job runs; the
  colour pass reads whatever the ring holds). A source without the marks
  is not cut.
On FEED_BATCH (128) of chip_smoke.write_feed_files' distinct q90 4:2:0
1024 px tiles at 8/8 and at 5/8 (640 px), plus the zero slot chip_smoke
adds, every whole source is held torch.equal to ``decode_batch_plain``;
then all are timed (``chip_smoke.time_cuda``, 10 launches a window) in
turns, each in order and then in reverse, in two rounds. The tree's
kernel is also timed at each ``--bands`` count of bands a tile.

Run from the repository root on a machine with one H100; for example,
against the pair as it stood at commit 4ef1674:

    mkdir -p .archive_check
    git show 4ef1674:aquaculture_tpu_torch/csrc/jpeg_decode.cu > .archive_check/pair.cu
    python3 scripts/jpeg_decode_ab.py --pair .archive_check/pair.cu --cuts --bands 1 2 4

Prints the kernel's registers, shared memory and CTAs per SM, one JSON
line per scale and round, then the card's name and power limit as
nvidia-smi reports them. Exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402

# each cut: the macro csrc/jpeg_decode.cu marks it with
CUTS = {"idct_only": "AQ_AB_IDCT_ONLY", "colour_only": "AQ_AB_COLOUR_ONLY"}


def _build(sources: dict) -> dict:
    """name -> loaded library, all built at once."""
    from aquaculture_tpu_torch.ops import nms_cuda

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        sos = dict(zip(sources, pool.map(lambda kv: nms_cuda.compile_library(kv[1], f"libab_{kv[0]}"),
                                         sources.items())))
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        if name == "pair":
            lib.aq_jpeg_idct.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
            lib.aq_jpeg_color.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        else:
            lib.aq_jpeg_decode.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch

    from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain as jp, native_loader

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", help="a source with the two-kernel aq_jpeg_idct / aq_jpeg_color interface")
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another source with the fused aq_jpeg_decode interface")
    ap.add_argument("--cuts", action="store_true", help="also time each fused source's IDCT and colour pass alone")
    ap.add_argument("--bands", type=int, nargs="*", default=[],
                    help="also time the tree's kernel at these counts of bands a tile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("this script needs an NVIDIA GPU")
    card = cs.card_line()
    print(json.dumps({"kernel": jpeg_cuda.attributes(), "card": card}), flush=True)

    work = tempfile.mkdtemp()
    fused = {"tree": jpeg_cuda.SOURCE, **dict(s.split("=", 1) for s in args.source)}
    sources = dict(fused)
    if args.cuts:
        for name, path in fused.items():
            text = open(path).read()
            for cut, macro in CUTS.items():
                if macro not in text:
                    print(json.dumps({"skipped": f"{name}_{cut}", "why": f"the source does not mark {macro}"}))
                    continue
                p = os.path.join(work, f"{name}_{cut}.cu")
                with open(p, "w") as f:
                    f.write(f"#define {macro}\n{text}")
                sources[f"{name}_{cut}"] = p
    if args.pair:
        sources["pair"] = args.pair
    libs = _build(sources)

    dev = torch.device("cuda", 0)
    _, distinct, _ = cs.write_feed_files(work)
    bad = []
    for scale, eff in ((8, 1024), (5, 640)):
        base = [native_loader.entropy_decode(p, scale) for p in distinct]
        images = [base[i % len(base)] for i in range(cs.FEED_BATCH)]
        coef, (qt, comps, imgs, tiles), lay, shape = cs.jpeg_batch(images, eff, dev)
        n, th, tw = shape[:3]
        want = jp.decode_batch_plain(coef, qt, comps, imgs, tiles, torch.full(shape, 7, dtype=torch.uint8, device=dev))
        res = torch.empty(shape, dtype=torch.uint8, device=dev)
        planes = torch.empty(lay.plane_bytes, dtype=torch.uint8, device=dev)
        max_blocks = max(c[2] * c[3] for c in comps.tolist())
        stream = torch.cuda.current_stream().cuda_stream
        runs = {}
        for name, lib in libs.items():
            if name == "pair":
                def run(lib=lib):
                    lib.aq_jpeg_idct(coef.data_ptr(), qt.data_ptr(), comps.data_ptr(), comps.shape[0], max_blocks,
                                     planes.data_ptr(), stream)
                    lib.aq_jpeg_color(planes.data_ptr(), comps.data_ptr(), imgs.data_ptr(), tiles.data_ptr(), n, th,
                                      tw, res.data_ptr(), stream)
                runs[name] = run
                continue
            band_rows = [jp.decode_grid(n, th, tw)[1]]
            if name == "tree":
                band_rows += [jp.BAND_ROWS * -(-th // jp.BAND_ROWS // b) for b in args.bands]
            for rows in dict.fromkeys(band_rows):
                def run(lib=lib, rows=rows):
                    lib.aq_jpeg_decode(coef.data_ptr(), qt.data_ptr(), comps.data_ptr(), imgs.data_ptr(),
                                       tiles.data_ptr(), n, th, tw, rows, res.data_ptr(), stream)
                runs[f"{name}@{-(-th // rows)}_bands"] = run
        equal = {}
        for key, run in runs.items():
            if "_only" in key:
                continue
            res.fill_(7)
            run()
            torch.cuda.synchronize()
            equal[key] = bool(torch.equal(res, want))
            if not equal[key]:
                bad.append(f"{key} at {scale}/8")
        for rnd in range(2):
            ms = {}
            for key in list(runs) + list(runs)[::-1]:
                ms.setdefault(key, []).append(cs.time_cuda(runs[key], iters=10))
            print(json.dumps({"scale": f"{scale}/8", "batch": cs.FEED_BATCH, "tile": eff, "round": rnd, "ms": ms,
                              "equal_plain": equal, "card": card}), flush=True)
        del coef, want, res, planes
    print(card, flush=True)
    if bad:
        cs.fail(f"not equal to decode_batch_plain: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
