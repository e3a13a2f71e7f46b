"""The device loader's two halves on one card's machine: the tree's fused
JPEG kernel against other kernel sources, and the tree's host entropy
decoder against other decoder sources.

Builds the port's kernel (aquaculture_tpu_torch/csrc/jpeg_decode.cu) and,
with the port's nvcc flags, optionally:
- ``--pair SOURCE``: a source with the earlier two-kernel interface
  (``aq_jpeg_idct`` into planes in device memory, then ``aq_jpeg_color``,
  as at commit 4ef1674);
- ``--source NAME=PATH``: other sources with the fused interface
  (``aq_jpeg_decode`` with its scale argument, as since this interface
  was built per scale);
- ``--cuts``: two cuts of each fused source that split its time, built
  with the macro the source marks each cut with: ``AQ_AB_IDCT_ONLY`` (the
  colour pass never runs) and ``AQ_AB_COLOUR_ONLY`` (no IDCT job runs; the
  colour pass reads whatever the ring holds). A source without the marks
  is not cut.
On FEED_BATCH (128) of chip_smoke.write_feed_files' distinct q90 4:2:0
1024 px tiles at each ``--scale`` N/8 (default 8/8 and 5/8: 1024 and
640 px tiles), plus the zero slot chip_smoke adds, every whole source is
held torch.equal to ``decode_batch_plain``;
then all are timed (``chip_smoke.time_cuda``, 10 launches a window) in
turns, each in order and then in reverse, in two rounds. The tree's
kernel is also timed at each ``--bands`` count of bands a tile.

``--entropy NAME=PATH``: other sources of csrc/jpeg_entropy.cc, each built
with the port's g++ flags (one that includes tiff_decode.h with the
tiff_decode.cc and tiff_decode.h beside it). On the 32 distinct tiles, every decoder probes
and decodes the same files (as the loader's workers do) at each scale, on
1 thread and on every core, in turns, each order then its reverse, in
``--rounds`` rounds; every source's coefficients are held equal to the tree's.

Run from the repository root on a machine with one H100; for example,
against the pair as it stood at commit 4ef1674:

    mkdir -p .archive_check
    git show 4ef1674:aquaculture_tpu_torch/csrc/jpeg_decode.cu > .archive_check/pair.cu
    python3 scripts/jpeg_decode_ab.py --pair .archive_check/pair.cu --cuts --bands 1 2 4

or the tree's kernel alone at 4/8 and 7/8: ``--scale 4 --scale 7``; or
the entropy decoder of the parent commit beside the tree's:

    git show HEAD~1:aquaculture_tpu_torch/csrc/jpeg_entropy.cc > .archive_check/parent.cc
    python3 scripts/jpeg_decode_ab.py --entropy parent=.archive_check/parent.cc

Prints each scale's kernel's registers, shared memory and CTAs per SM, one JSON
line per scale and round (and with ``--entropy`` one per scale and thread
count with each decoder's tiles/s per turn), then the card's name and power
limit as nvidia-smi reports them. Exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys
import tempfile
import time

import numpy as np

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
            lib.aq_jpeg_decode.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        libs[name] = lib
    return libs


def _entropy_sources(path: str):
    """A decoder source and, where it includes the TIFF reader's header (as
    since the loader reads TIFFs), the reader and header beside it."""
    with open(path) as f:
        if '#include "tiff_decode.h"' not in f.read():
            return (path,)
    d = os.path.dirname(os.path.abspath(path))
    return path, os.path.join(d, "tiff_decode.cc"), os.path.join(d, "tiff_decode.h")


def _entropy_lib(name: str, path: str) -> ctypes.CDLL:
    from aquaculture_tpu_torch.data import native_loader
    from aquaculture_tpu_torch.geo import native_boolean

    lib = ctypes.CDLL(native_boolean.compile_library(_entropy_sources(path), f"libab_entropy_{name}",
                                                     native_loader.CXX_FLAGS))
    lib.aq_jpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    lib.aq_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    return lib


def _entropy_decode(lib: ctypes.CDLL, path: bytes, scale: int) -> np.ndarray:
    meta = np.zeros(256, np.int32)
    lib.aq_jpeg_probe(path, scale, meta.ctypes.data)
    coef = np.empty(max(int(meta[11]), 1), np.int16)  # M_COEFS
    lib.aq_jpeg_decode(path, scale, meta.ctypes.data, coef.ctypes.data, coef.size)
    return coef


def time_entropy(sources: dict, distinct: list, scales: list, rounds: int, bad: list) -> None:
    """The tree's entropy decoder and ``sources`` in turns (module docstring)."""
    from aquaculture_tpu_torch.data import native_loader

    libs = {"tree": _entropy_lib("tree", native_loader.SOURCE),
            **{name: _entropy_lib(name, path) for name, path in sources.items()}}
    paths = [os.fsencode(p) for p in distinct]
    cores = os.cpu_count() or 1
    for scale in scales:
        want = [_entropy_decode(libs["tree"], p, scale) for p in paths]
        for name, lib in libs.items():
            if not all(np.array_equal(_entropy_decode(lib, p, scale), w) for p, w in zip(paths, want)):
                bad.append(f"entropy {name} at {scale}/8")
        for threads in (1, cores):
            todo = [paths[i % len(paths)] for i in range(threads * cs.FEED_HOST_FILES)]
            rates = {name: [] for name in libs}
            with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                for _ in range(rounds):
                    for name in list(libs) + list(libs)[::-1]:
                        run = lambda p, lib=libs[name]: _entropy_decode(lib, p, scale)
                        list(pool.map(run, todo[:threads]))  # warm
                        t0 = time.perf_counter()
                        list(pool.map(run, todo))
                        rates[name].append(len(todo) / (time.perf_counter() - t0))
            print(json.dumps({"scale": f"{scale}/8", "threads": threads, "entropy_tiles_per_s": rates,
                              "cores": cores}), flush=True)


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
    ap.add_argument("--entropy", action="append", default=[], metavar="NAME=PATH",
                    help="another jpeg_entropy.cc to time on the host beside the tree's")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of the entropy decoders' turns")
    ap.add_argument("--scale", type=int, action="append", choices=range(1, 9), metavar="N",
                    help="decode at N/8 (repeatable; default 8 and 5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("this script needs an NVIDIA GPU")
    card = cs.card_line()
    print(json.dumps({"kernel": {f"{n}/8": jpeg_cuda.attributes(n) for n in range(1, 9)}, "card": card}),
          flush=True)

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
    for scale in args.scale or [8, 5]:
        eff = 1024 * scale // 8
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
            unit = lay.band_unit
            band_rows = [jp.decode_grid(n, th, tw, lay)[1]]
            if name == "tree":
                band_rows += [unit * -(-(-(-th // b)) // unit) for b in args.bands]
            for rows in dict.fromkeys(band_rows):
                def run(lib=lib, rows=rows):
                    lib.aq_jpeg_decode(coef.data_ptr(), qt.data_ptr(), comps.data_ptr(), imgs.data_ptr(),
                                       tiles.data_ptr(), n, th, tw, rows, scale, res.data_ptr(), stream)
                runs[f"{name}@{-(-th // rows)}_bands_of_{rows}"] = run
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
    if args.entropy:
        time_entropy(dict(s.split("=", 1) for s in args.entropy), distinct, args.scale or [8, 5], args.rounds, bad)
    print(card, flush=True)
    if bad:
        cs.fail(f"not equal to decode_batch_plain: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
