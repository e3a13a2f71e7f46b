"""The fused JPEG kernel's own source, run on the CPU against its plain
version.

``csrc/jpeg_decode.cu`` up to its ``extern "C"`` block is compiled with
g++ behind a small header that stands in for CUDA: one std::thread per
CUDA thread, a std::barrier per CTA for ``__syncthreads`` and one per
8-lane group for ``__syncwarp``, static storage for ``__shared__``, plain
structs for the vector types. Each CTA of the grid runs in turn. That
checks the kernel's arithmetic, its stripe, band and ring bookkeeping and
its run paths, byte for byte against ``decode_batch_plain`` (tolerance
0), where no card is; the card itself holds the built kernel to the same
plain version in chip_smoke.py.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu_torch.data import jpeg_plain as jp, native_loader
from torch_jax_native import libjpeg_writer, write_jpeg

SOURCE = Path(__file__).resolve().parent.parent / "aquaculture_tpu_torch" / "csrc" / "jpeg_decode.cu"

SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
thread_local dim3 threadIdx, blockIdx;
std::barrier<>* g_block;
std::vector<std::unique_ptr<std::barrier<>>>* g_groups;
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned mask) {
  if (__builtin_popcount(mask) != 8) abort();  // the kernel syncs 8-lane groups only
  (*g_groups)[(threadIdx.x / 32) * 4 + __builtin_ctz(mask) / 8]->arrive_and_wait();
}
inline void __trap() { abort(); }
inline unsigned __umulhi(unsigned a, unsigned b) { return unsigned((unsigned long long)a * b >> 32); }
using std::max;
using std::min;
#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__
"""

LAUNCHER = r"""
extern "C" void host_decode(const void* coef, const void* qt, const void* comps, const void* images,
                            const void* tiles, int n_slots, int th, int tw, int band_rows, int scale, void* out) {
  const KernelFn kernel = kernel_for(scale);
  const int gx = (tw + STRIPE_W - 1) / STRIPE_W, gz = (th + band_rows - 1) / band_rows;
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < n_slots; ++y)
      for (int x = 0; x < gx; ++x) {
        std::barrier<> block(THREADS);
        std::vector<std::unique_ptr<std::barrier<>>> groups;
        for (int g = 0; g < GROUPS; ++g) groups.emplace_back(new std::barrier<>(8));
        g_block = &block;
        g_groups = &groups;
        std::vector<std::thread> threads;
        for (int t = 0; t < THREADS; ++t)
          threads.emplace_back([=] {
            threadIdx.x = t;
            blockIdx.x = x;
            blockIdx.y = y;
            blockIdx.z = z;
            kernel((const int16_t*)coef, (const int*)qt, (const int*)comps, (const int*)images,
                   (const int*)tiles, th, tw, band_rows, (uint8_t*)out);
          });
        for (auto& t : threads) t.join();
      }
}
"""

# (name, (height, width), PIL save options, "gray", "440" or "411" through
# OpenCV, or "luma44" through the libjpeg writer: luma sampled 4 x 4, one
# scan a component, so that chroma takes the 4N x 4N IDCT below 4/8)
CASES = (
    ("q90_420", (96, 144), dict(quality=90)),             # two stripes at 8/8
    ("q90_422", (64, 136), dict(quality=90, subsampling=1)),
    ("q90_444", (48, 130), dict(quality=90, subsampling=0)),
    ("q90_440", (50, 139), "440"),
    ("gray", (40, 70), "gray"),
    ("wide_420", (70, 333), dict(quality=85)),            # ragged right stripe, byte stores
    ("tiny_420", (3, 2), dict(quality=90)),               # box upsampling
    ("q90_411", (40, 150), "411"),                       # box upsampling by 4 across
    ("rgb_444", (40, 90), dict(quality=90, keep_rgb=True, subsampling=0)),  # RGB: pixel by pixel
    ("luma44", (56, 80), "luma44"),
)
NAMES = [c[0] for c in CASES]
SCALES = tuple(range(1, 9))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source compiled for the host, and the test JPEGs."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    d = tmp_path_factory.mktemp("jpeg_kernel_host")
    body = SOURCE.read_text().split('\nextern "C" {')[0].replace("#include <cuda_runtime.h>", "")
    src = d / "kernel.cc"
    src.write_text(SHIM + body + LAUNCHER)
    so = d / "libhostkernel.so"
    proc = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.host_decode.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.host_decode.restype = None
    lib.aq_jpeg_stripe_blocks.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.aq_jpeg_stripe_blocks.restype = ctypes.c_int
    rng = np.random.default_rng(14)
    writer = libjpeg_writer(d)
    paths = {}
    for name, (h, w), kw in CASES:
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 2)
        p = d / f"{name}.jpg"
        if kw == "gray":
            Image.fromarray(img[..., 0]).save(p, quality=90)
        elif kw in ("440", "411"):
            factor = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440 if kw == "440" else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411
            cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        elif kw == "luma44":
            if writer is None:
                continue
            write_jpeg(writer, img, p, "multiscan", 90, 0, (4, 4))
        else:
            Image.fromarray(img).save(p, **kw)
        paths[name] = str(p)
    return lib, paths


def _batch(images, eff, caller=False):
    """The descriptors of one batch: each image's tile grid at ``eff`` (or
    the one image whole at 0), a zero slot, and a caller slot if asked."""
    offs = np.cumsum([0] + [im.coef.numel() for im in images[:-1]]).tolist()
    tiles = []
    for i, im in enumerate(images):
        grid = jp.tile_grid(im.out_width, im.out_height, eff) if eff else [(0, 0)]
        tiles += [(jp.TILE_DECODED, i, x, y) for x, y in grid]
    tiles.append((jp.TILE_ZERO, 0, 0, 0))
    if caller:
        tiles.append((jp.TILE_CALLER, 0, 0, 0))
    packed, lay = jp.describe_batch([im.meta for im in images], offs, tiles)
    th, tw = (eff, eff) if eff else (images[0].out_height, images[0].out_width)
    return jp.unpack_batch(torch.from_numpy(packed), lay), lay, tiles, th, tw


def _decode_both(lib, images, eff, band_rows=None, caller=False):
    """(kernel on the host, plain) outputs of one batch (``_batch``); both
    outputs start as 7s."""
    (qt, comps, imgs, tt), lay, tiles, th, tw = _batch(images, eff, caller)
    coef = torch.cat([im.coef for im in images]).contiguous()
    out = torch.full((len(tiles), th, tw, 3), 7, dtype=torch.uint8)
    want = jp.decode_batch_plain(coef, qt, comps, imgs, tt, out.clone())
    rows = band_rows or jp.decode_grid(len(tiles), th, tw, lay)[1]
    lib.host_decode(coef.data_ptr(), qt.data_ptr(), comps.data_ptr(), imgs.data_ptr(), tt.data_ptr(), len(tiles),
                    th, tw, rows, lay.scale, out.data_ptr())
    return out, want


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_source_equals_plain_on_whole_images(host_kernel, name, scale):
    """Each image whole at every N/8 (every IDCT size: 7/8 puts 4:2:0
    chroma through the 14x14 and a ring row's widest stripe), in the
    wrapper's bands and in bands of 8 rows (steps cut short at the band's
    edges, context rows recomputed)."""
    lib, paths = host_kernel
    if name not in paths:
        pytest.skip("the libjpeg writer does not build here")
    image = native_loader.entropy_decode(paths[name], scale)
    for band_rows in (None, 8):
        got, want = _decode_both(lib, [image], 0, band_rows)
        assert torch.equal(got, want), (band_rows, int((got != want).sum()))


@pytest.mark.parametrize("scale,eff", [(8, 32), (8, 20), (5, 20), (7, 28)])
def test_kernel_source_equals_plain_on_a_tile_grid(host_kernel, scale, eff):
    """All cases in one batch on a grid of ``eff`` px tiles, with a zero
    slot and a caller slot, which stays untouched. At 8/8, 20 px origins
    put the luma rings' pads off the 8-byte grid (the IDCT's byte stores)."""
    lib, paths = host_kernel
    images = [native_loader.entropy_decode(paths[n], scale) for n in NAMES]
    got, want = _decode_both(lib, images, eff, caller=True)
    assert torch.equal(got, want), int((got != want).sum())
    assert (got[-1] == 7).all() and (got[-2] == 0).all()


def test_kernel_source_equals_plain_at_an_odd_tile_origin(host_kernel, tmp_path):
    """A 2000 px wide 4:2:0 image in tiles of 1000 px at 5/8 (625 px): the
    second tile's second stripe starts at x = 753, 3 past a 10x10 chroma
    block, where the stripe's chroma takes its widest ring row (14 blocks
    and a 13 byte pad)."""
    lib, _ = host_kernel
    img = cv2.GaussianBlur(np.random.default_rng(3).integers(0, 256, (48, 2000, 3), dtype=np.uint8), (5, 5), 2)
    p = tmp_path / "wide.jpg"
    Image.fromarray(img).save(p, quality=90)
    image = native_loader.entropy_decode(str(p), 5)
    assert (image.out_width, jp.tile_grid(image.out_width, image.out_height, 625)) == (1250, [(0, 0), (625, 0)])
    assert (625 + jp.STRIPE_W) % 10 == 3
    got, want = _decode_both(lib, [image], 625)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("scale", SCALES)
def test_stripe_blocks_are_the_kernels(host_kernel, scale):
    """``jpeg_plain.stripe_blocks`` (whose blocks the CPU stripe test shows
    are all a CTA's pixels read) names the blocks the kernel's own set-up
    computes (``aq_jpeg_stripe_blocks``), for every CTA of every case whole,
    in the wrapper's bands and in bands of 8 rows, and on the tile grids."""
    lib, paths = host_kernel
    images = [native_loader.entropy_decode(paths[n], scale) for n in NAMES]
    batches = [([im], 0) for im in images] + [(images, eff) for eff in (32, 20)]
    checked = 0
    for batch, eff in batches:
        (qt, comps, imgs, tt), lay, tiles, th, tw = _batch(batch, eff, caller=True)
        cs, ims = comps.tolist(), imgs.tolist()
        stripes, wrapper_rows = jp.decode_grid(len(tiles), th, tw, lay)
        for band_rows in (wrapper_rows, 8):
            for slot, tile in enumerate(tiles):
                for stripe in range(stripes):
                    for y0 in range(0, th, band_rows):
                        rows = (y0, min(y0 + band_rows, th))
                        want = jp.stripe_blocks(cs, ims[tile[1]], tile, th, tw, stripe, rows)
                        out = (ctypes.c_int * 12)()
                        n = lib.aq_jpeg_stripe_blocks(comps.data_ptr(), imgs.data_ptr(), tt.data_ptr(), slot, tw,
                                                      stripe, *rows, out)
                        assert [tuple(out[4 * c:4 * c + 4]) for c in range(n)] == want, (slot, stripe, rows)
                        checked += bool(want)
    assert checked > 100
