"""The device loader's TIFF reader (csrc/tiff_decode.cc) against libtiff.

The JAX package's native loader decodes TIFFs whole through libtiff's RGBA
interface (native/src/tileloader.cc: TIFFReadRGBAImageOriented at
ORIENTATION_TOPLEFT); the port reads them without libtiff. Every case here
goes through both, the port's ``decode_image`` on the CPU against the JAX
package's, byte for byte (tolerance 0), or both skip it. PIL writes what it
can (strips in every compression, BigTIFF, JPEG strips through libtiff);
``tiff_bytes`` writes the rest byte by byte: tiles with ragged edges,
planar files, big-endian files, Predictor 2 at 16 bits, 1-, 2- and 4-bit
grey and palette, raw YCbCr at every sampling libtiff takes, 16-bit
CIELab, JPEG tiles (PIL's JPEG encoder per tile, tables moved into
JPEGTables), old-style LZW and the samples libtiff refuses. The codecs are
also held alone: inflate against the stdlib's zlib on stored, fixed and
dynamic blocks, LZW and PackBits on strips PIL wrote.
"""

from __future__ import annotations

import ctypes
import io
import struct
import zlib
from collections import Counter

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain, native_loader
from torch_jax_native import jax_native_loader
from torch_tiff_writer import image, jpeg_tiles, layout, lzw, tiff_bytes, ycbcr_blocks

PREFIX = "2014_3857_1.000_0.000"  # a tile-codec name, so that each file has a TileSpec
ROUTE_NAMES = {jpeg_plain.TIFF_RASTER: "tiff", jpeg_plain.TIFF_JPEG: "tiff_jpeg",
               jpeg_plain.TIFF_PIL: "pil", jpeg_plain.TIFF_SKIP: "skipped"}


@pytest.fixture(scope="module")
def jn():
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jn


# ---------------------------------------------------------------- cases

def _write(path, segments, tags, **kw) -> None:
    path.write_bytes(tiff_bytes(segments, tags, **kw))


def _rgb_case(path, *, bps=8, alpha=None, planar=False, tile=None, order="<", big=False, compression=1,
              predictor=1, photometric=2, orientation=None, size=(200, 300), seed=1):
    """RGB (or RGBA: alpha None, 0 unspecified, 1 associated, 2
    unassociated, "none" a fourth sample without ExtraSamples)."""
    px = image(seed, *size, c=3).astype(np.uint16)
    if bps == 16:
        px = px * 257 + np.random.default_rng(seed).integers(0, 257, px.shape)
    if alpha is not None:
        a = np.random.default_rng(seed + 1).integers(0, 1 << bps, px.shape[:2] + (1,))
        px = np.concatenate([px, a], -1)
    segs, tags = layout(px, bps, planar=planar, tile=tile, order=order, compression=compression,
                        predictor=predictor)
    tags[262] = (3, [photometric])
    if alpha in (0, 1, 2):
        tags[338] = (3, [alpha])
    if orientation:
        tags[274] = (3, [orientation])
    _write(path, segs, tags, order=order, big=big, tiled=tile is not None)


def _grey_case(path, *, bps=8, white=False, alpha=None, planar=False, tile=None, order="<", fill=1,
               compression=1, predictor=1, seed=2):
    px = image(seed, c=1).astype(np.uint16)
    if bps == 16:
        px = px * 257 + np.random.default_rng(seed).integers(0, 257, px.shape)
    elif bps < 8:
        px = px >> (8 - bps)
    if alpha is not None:
        px = np.concatenate([px, np.random.default_rng(seed + 1).integers(0, 1 << bps, px.shape)], -1)
    segs, tags = layout(px, bps, planar=planar, tile=tile, order=order, compression=compression,
                        predictor=predictor)
    if fill == 2:  # FillOrder 2: each byte's bits reversed
        rev = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
        segs = [s.translate(rev) for s in segs]
        tags[266] = (3, [2])
    tags[262] = (3, [0 if white else 1])
    if alpha is not None:
        tags[338] = (3, [alpha])
    _write(path, segs, tags, order=order, tiled=tile is not None)


def _palette_case(path, *, bps=8, wide=True, tile=None, seed=3):
    rng = np.random.default_rng(seed)
    px = (image(seed, c=1).astype(np.uint16) >> (8 - bps))
    n = 1 << bps
    cmap = rng.integers(0, 65536 if wide else 256, 3 * n)
    segs, tags = layout(px, bps, tile=tile)
    tags[262], tags[320] = (3, [3]), (3, cmap.tolist())
    _write(path, segs, tags, tiled=tile is not None)


def _ycbcr_case(path, *, hs, vs, h=203, w=301, refbw=True, rps=None, seed=4):
    rng = np.random.default_rng(seed)
    y, cb, cr = (rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3))
    rps = rps or 8 * vs
    segs = ycbcr_blocks(y, cb, cr, hs, vs, rps)
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [6]), 277: (3, [3]),
            278: (3, [rps]), 284: (3, [1]), 530: (3, [hs, vs])}
    if refbw:
        tags[532] = (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])
        tags[529] = (5, [(2990, 10000), (5870, 10000), (1140, 10000)])
    _write(path, segs, tags)


def _planar_ycbcr_case(path, seed=5):
    px = image(seed)
    segs, tags = layout(px, 8, planar=True)
    tags[262], tags[530] = (3, [6]), (3, [1, 1])
    _write(path, segs, tags)


def _lab16_case(path, seed=6):
    rng = np.random.default_rng(seed)
    px = np.stack([rng.integers(0, 65536, (120, 90)), rng.integers(-20000, 20000, (120, 90)) % 65536,
                   rng.integers(-20000, 20000, (120, 90)) % 65536], -1)
    segs, tags = layout(px, 16)
    tags[262] = (3, [8])
    _write(path, segs, tags)


def _cmyk_case(path, planar=False, seed=7):
    px = image(seed, c=4)
    segs, tags = layout(px, 8, planar=planar)
    tags[262] = (3, [5])
    _write(path, segs, tags)


def _refused_case(path, bps=32, fmt=1, seed=8):
    px = image(seed, c=3).astype(np.uint32) * 16843009
    segs, tags = layout(px, bps)
    tags[262], tags[339] = (3, [2]), (3, [fmt] * 3)
    _write(path, segs, tags)


def _jpeg_tiled_case(path, mode="YCbCr", tables=True, subsampling_tag=True, orientation=None, seed=9,
                     strips=False, damage=None):
    """JPEG tiles of 128 x 96 (or, with strips, strips of 48 rows, the
    last one's stream taller than its rows); ``damage`` rewrites the list
    of segments before the file is written."""
    px = image(seed, c=1)[..., 0] if mode == "L" else image(seed)
    h, w = px.shape[:2]
    tw, th = (w, 48) if strips else (128, 96)
    segs, table = jpeg_tiles(px, tw, th, mode, tables)
    if damage is not None:
        def fresh(sw, sh):
            other = image(seed + 1, sh, sw, 1)[..., 0] if mode == "L" else image(seed + 1, sh, sw)
            return jpeg_tiles(other, sw, sh, mode, tables)[0][0]

        segs = damage(segs, fresh)
    spp = 1 if mode == "L" else 3
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8] * spp), 259: (3, [7]), 277: (3, [spp]),
            262: (3, [{"YCbCr": 6, "RGB": 2, "L": 1}[mode]]), 284: (3, [1])}
    tags.update({278: (3, [th])} if strips else {322: (3, [tw]), 323: (3, [th])})
    if table is not None:
        tags[347] = (7, list(table))
    if mode == "YCbCr" and subsampling_tag:
        tags[530] = (3, [2, 2])
    if orientation:
        tags[274] = (3, [orientation])
    _write(path, segs, tags, tiled=not strips)


def _cmyk_jpeg() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image(36, 96, 128, 4), "CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _sof_after_scan(seg: bytes, fresh) -> bytes:
    assert seg[-2:] == b"\xff\xd9"
    return seg[:-2] + b"\xff\xc1\x00\x0b\x08\x00\x10\x00\x10\x01\x01\x11\x00\xff\xd9"


def _replace(i, seg):
    """A damage for _jpeg_tiled_case: segment i replaced by seg(its bytes,
    a stream of the given size)."""
    return lambda segs, fresh: [seg(s, fresh) if k == i else s for k, s in enumerate(segs)]


def _short_case(path, *, rps=37, compression=1, cut=None, count=None, offset=None, seed=19):
    """Strips whose data run short, as libtiff reads them: strip ``cut``
    (index, bytes kept) cut short; ``count`` a single strip's byte count
    rewritten; ``offset`` the first strip's offset moved past the end."""
    segs, tags = layout(image(seed), 8, rps=rps, compression=compression)
    tags[262] = (3, [2])
    if cut is not None:
        i, keep = cut
        segs[i] = segs[i][:keep(len(segs[i]))]
    data = bytearray(tiff_bytes(segs, tags))
    if count is not None or offset is not None:
        ifd = struct.unpack("<I", data[4:8])[0]
        for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
            e = ifd + 2 + 12 * k
            tag = struct.unpack("<H", data[e:e + 2])[0]
            if tag == 279 and count is not None:
                data[e + 8:e + 12] = struct.pack("<I", count)
            if tag == 273 and offset is not None:
                data[e + 8:e + 12] = struct.pack("<I", offset)
    path.write_bytes(bytes(data))


def _ycbcr_tiles_case(path, *, hs, vs, tile=32, h=100, w=150, seed=33):
    """Raw YCbCr in tiles with ragged edges, each tile in the sampled
    layout of its own."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3)]
    segs = []
    for ty in range(-(-h // tile)):
        for tx in range(-(-w // tile)):
            cut = []
            for plane in planes:
                t = np.zeros((tile, tile), np.uint8)
                part = plane[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
                t[:part.shape[0], :part.shape[1]] = part
                cut.append(t)
            segs += ycbcr_blocks(*cut, hs, vs, tile)
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [6]), 277: (3, [3]),
            284: (3, [1]), 530: (3, [hs, vs]), 322: (3, [tile]), 323: (3, [tile])}
    _write(path, segs, tags, tiled=True)


def _tagged_case(path, *, c=3, bps=8, photometric=2, tags=None, drop=(), planar=False, tile=None, seed=34):
    """An uncompressed file whose tags the case sets or drops."""
    px = image(seed, c=c).astype(np.uint16) >> (8 - bps) if bps < 8 else image(seed, c=c)
    segs, base = layout(px, bps, planar=planar, tile=tile)
    if photometric is not None:
        base[262] = (3, [photometric])
    base.update(tags or {})
    for t in drop:
        base.pop(t)
    _write(path, segs, base, tiled=tile is not None)


def _jpeg_grey_min_is_white(path):
    Image.fromarray(image(35)[..., 0]).save(path, compression="jpeg")
    _retag(path, 262, 0)


def _pil(path, img, **kw) -> None:
    img.save(path, format="TIFF", **kw)


RGB_IMG = lambda: Image.fromarray(image(10))  # noqa: E731
# name -> (writer, the route the port takes)
CASES = {
    # PIL's writer: compressions, predictor, BigTIFF, modes, JPEG strips
    "pil_raw": (lambda p: _pil(p, RGB_IMG()), "tiff"),
    "pil_lzw": (lambda p: _pil(p, RGB_IMG(), compression="tiff_lzw"), "tiff"),
    "pil_lzw_predictor": (lambda p: _pil(p, RGB_IMG(), compression="tiff_lzw", tiffinfo={317: 2}), "tiff"),
    "pil_deflate": (lambda p: _pil(p, RGB_IMG(), compression="tiff_adobe_deflate"), "tiff"),
    "pil_deflate_predictor": (lambda p: _pil(p, RGB_IMG(), compression="tiff_adobe_deflate", tiffinfo={317: 2}),
                              "tiff"),
    "pil_packbits": (lambda p: _pil(p, RGB_IMG(), compression="packbits"), "tiff"),
    "pil_bigtiff": (lambda p: _pil(p, RGB_IMG(), big_tiff=True), "tiff"),
    "pil_bigtiff_lzw": (lambda p: _pil(p, RGB_IMG(), big_tiff=True, compression="tiff_lzw"), "tiff"),
    "pil_ycbcr": (lambda p: _pil(p, RGB_IMG().convert("YCbCr")), "tiff"),
    "pil_lab": (lambda p: _pil(p, RGB_IMG().convert("LAB")), "tiff"),
    "pil_grey": (lambda p: _pil(p, Image.fromarray(image(11)[..., 0])), "tiff"),
    "pil_la": (lambda p: _pil(p, Image.fromarray(image(12)[..., :2], "LA")), "tiff"),
    "pil_rgba": (lambda p: _pil(p, Image.fromarray(image(13, c=4))), "tiff"),
    "pil_cmyk": (lambda p: _pil(p, Image.fromarray(image(14, c=4), "CMYK")), "tiff"),
    "pil_palette": (lambda p: _pil(p, RGB_IMG().convert("P")), "tiff"),
    "pil_bilevel": (lambda p: _pil(p, Image.fromarray(image(15)[..., 0]).convert("1")), "tiff"),
    "pil_bilevel_packbits": (lambda p: _pil(p, Image.fromarray(image(15)[..., 0]).convert("1"),
                                            compression="packbits"), "tiff"),
    "pil_i16": (lambda p: _pil(p, Image.fromarray(np.random.default_rng(16).integers(0, 65536, (200, 300),
                                                                                        dtype=np.uint16))), "tiff"),
    "pil_jpeg_rgb": (lambda p: _pil(p, RGB_IMG(), compression="jpeg"), "tiff_jpeg"),
    "pil_jpeg_ycbcr": (lambda p: _pil(p, RGB_IMG().convert("YCbCr"), compression="jpeg"), "tiff_jpeg"),
    "pil_jpeg_grey": (lambda p: _pil(p, Image.fromarray(image(17)[..., 0]), compression="jpeg"), "tiff_jpeg"),
    "pil_jpeg_q50": (lambda p: _pil(p, Image.fromarray(image(18, 203, 301)), compression="jpeg", quality=50),
                     "tiff_jpeg"),
    # byte by byte: layouts
    "tiles_rgb": (lambda p: _rgb_case(p, tile=(64, 48)), "tiff"),
    "tiles_rgb_lzw_predictor": (lambda p: _rgb_case(p, tile=(64, 48), compression=5, predictor=2, size=(100, 150)),
                                "tiff"),
    "tiles_rgb_deflate": (lambda p: _rgb_case(p, tile=(64, 48), compression=8), "tiff"),
    "tiles_rgb_packbits": (lambda p: _rgb_case(p, tile=(64, 48), compression=32773), "tiff"),
    "tiles_planar_rgba_unassociated": (lambda p: _rgb_case(p, tile=(64, 48), planar=True, alpha=2), "tiff"),
    "tiles_bigtiff_mm": (lambda p: _rgb_case(p, tile=(64, 48), big=True, order=">"), "tiff"),
    "tiles_grey16": (lambda p: _grey_case(p, bps=16, tile=(64, 48)), "tiff"),
    "tiles_grey_alpha": (lambda p: _grey_case(p, alpha=2, tile=(64, 48)), "tiff"),
    "tiles_grey4": (lambda p: _grey_case(p, bps=4, tile=(32, 32)), "tiff"),
    "tiles_grey1": (lambda p: _grey_case(p, bps=1, tile=(32, 32)), "tiff"),
    "tiles_palette8": (lambda p: _palette_case(p, tile=(64, 48)), "tiff"),
    "planar_rgb": (lambda p: _rgb_case(p, planar=True), "tiff"),
    "planar_rgb_lzw_predictor": (lambda p: _rgb_case(p, planar=True, compression=5, predictor=2, size=(100, 150)),
                                 "tiff"),
    "planar_rgba_associated": (lambda p: _rgb_case(p, planar=True, alpha=1), "tiff"),
    "planar_rgb16_unassociated": (lambda p: _rgb_case(p, planar=True, bps=16, alpha=2), "tiff"),
    "planar_grey_alpha": (lambda p: _grey_case(p, planar=True, alpha=2), "tiff"),
    "planar_grey16_alpha": (lambda p: _grey_case(p, bps=16, planar=True, alpha=2), "tiff"),
    "planar_cmyk": (lambda p: _cmyk_case(p, planar=True), "tiff"),
    "planar_ycbcr": (_planar_ycbcr_case, "tiff"),
    "mm_rgb16_lzw_predictor": (lambda p: _rgb_case(p, bps=16, order=">", compression=5, predictor=2,
                                                   size=(100, 150)), "tiff"),
    "mm_rgb16_deflate_predictor": (lambda p: _rgb_case(p, bps=16, order=">", compression=8, predictor=2), "tiff"),
    "ii_rgb16_deflate_predictor": (lambda p: _rgb_case(p, bps=16, compression=32946, predictor=2), "tiff"),
    "mm_grey16_packbits": (lambda p: _grey_case(p, bps=16, order=">", compression=32773), "tiff"),
    "bigtiff_planar_deflate": (lambda p: _rgb_case(p, planar=True, big=True, compression=8), "tiff"),
    "lzw_compat": (lambda p: _rgb_case(p, compression="lzw_compat", size=(100, 150)), "tiff"),
    # photometrics, bit depths, alpha
    "rgb16": (lambda p: _rgb_case(p, bps=16), "tiff"),
    "rgb16_associated": (lambda p: _rgb_case(p, bps=16, alpha=1), "tiff"),
    "rgb16_unassociated": (lambda p: _rgb_case(p, bps=16, alpha=2), "tiff"),
    "rgb16_unspecified": (lambda p: _rgb_case(p, bps=16, alpha=0), "tiff"),
    "rgba_unassociated": (lambda p: _rgb_case(p, alpha=2), "tiff"),
    "rgba_unspecified": (lambda p: _rgb_case(p, alpha=0), "tiff"),
    "rgbx_no_extrasamples": (lambda p: _rgb_case(p, alpha="none"), "tiff"),
    **{f"grey{b}{'_white' if w else ''}": ((lambda p, b=b, w=w: _grey_case(p, bps=b, white=w)), "tiff")
       for b in (1, 2, 4, 8, 16) for w in (False, True)},
    "grey16_alpha": (lambda p: _grey_case(p, bps=16, alpha=2), "tiff"),
    "grey1_fill_order_2": (lambda p: _grey_case(p, bps=1, fill=2), "tiff"),
    "grey4_lzw_fill_order_2": (lambda p: _grey_case(p, bps=4, fill=2, compression=5), "tiff"),
    **{f"palette{b}_{'16' if w else '8'}bit_map": ((lambda p, b=b, w=w: _palette_case(p, bps=b, wide=w)), "tiff")
       for b in (1, 2, 4, 8) for w in (True, False)},
    "cmyk": (_cmyk_case, "tiff"),
    **{f"ycbcr_{h}{v}": ((lambda p, h=h, v=v: _ycbcr_case(p, hs=h, vs=v)), "tiff")
       for h, v in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2))},
    "ycbcr_22_default_refbw": (lambda p: _ycbcr_case(p, hs=2, vs=2, refbw=False), "tiff"),
    "ycbcr_22_odd_rows_per_strip": (lambda p: _ycbcr_case(p, hs=2, vs=2, rps=6, h=41, w=33), "tiff"),
    "cielab16": (_lab16_case, "tiff"),
    **{f"orientation{o}": ((lambda p, o=o: _pil(p, RGB_IMG(), tiffinfo={274: o})), "tiff") for o in range(2, 9)},
    "orientation6_tiles": (lambda p: _rgb_case(p, tile=(64, 48), orientation=6), "tiff"),
    "orientation8_planar_mm": (lambda p: _rgb_case(p, planar=True, order=">", orientation=8), "tiff"),
    # JPEG tiles: tables in JPEGTables or in each tile, YCbCr, RGB, grey
    "jpeg_tiles_ycbcr": (_jpeg_tiled_case, "tiff_jpeg"),
    "jpeg_tiles_ycbcr_no_subsampling_tag": (lambda p: _jpeg_tiled_case(p, subsampling_tag=False), "tiff_jpeg"),
    "jpeg_tiles_rgb": (lambda p: _jpeg_tiled_case(p, mode="RGB"), "tiff_jpeg"),
    "jpeg_tiles_grey_own_tables": (lambda p: _jpeg_tiled_case(p, mode="L", tables=False), "tiff_jpeg"),
    "jpeg_tiles_orientation7": (lambda p: _jpeg_tiled_case(p, orientation=7), "tiff_jpeg"),
    "jpeg_strips_own_writer": (lambda p: _jpeg_tiled_case(p, strips=True), "tiff_jpeg"),
    # JPEG segments that fail: libtiff's segment buffer keeps the last
    # segment decoded (all 128 columns of a right edge tile); before one
    # decodes, the image fails
    "jpeg_tiles_second_empty": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, lambda s, f: b"")), "tiff_jpeg"),
    "jpeg_tiles_second_not_jpeg": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, lambda s, f: bytes(len(s)))),
                                   "tiff_jpeg"),
    "jpeg_tiles_first_not_jpeg": (lambda p: _jpeg_tiled_case(p, mode="RGB",
                                                             damage=_replace(0, lambda s, f: bytes(len(s)))),
                                  "skipped"),
    "jpeg_tiles_second_truncated": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, lambda s, f: s[:len(s) // 2])),
                                    "tiff_jpeg"),
    "jpeg_tiles_second_too_wide": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, lambda s, f: f(136, 96))),
                                   "tiff_jpeg"),
    "jpeg_tiles_second_four_components": (lambda p: _jpeg_tiled_case(p, mode="L", tables=False,
                                                                     damage=_replace(1, lambda s, f: _cmyk_jpeg())),
                                          "tiff_jpeg"),
    "jpeg_tiles_after_edge_past_the_end": (lambda p: _jpeg_tiled_case(p, mode="RGB", damage=lambda segs, f: segs[:3]),
                                           "tiff_jpeg"),
    "jpeg_strips_third_empty": (lambda p: _jpeg_tiled_case(p, strips=True, damage=_replace(2, lambda s, f: b"")),
                                "tiff_jpeg"),
    "jpeg_strips_last_truncated": (lambda p: _jpeg_tiled_case(p, strips=True,
                                                              damage=_replace(4, lambda s, f: s[:len(s) // 3])),
                                   "tiff_jpeg"),
    "jpeg_tiles_first_empty": (lambda p: _jpeg_tiled_case(p, damage=_replace(0, lambda s, f: b"")), "skipped"),
    # streams smaller than their tile or strip, decoded over part of the
    # buffer: the rest as the segment before left it (zeros before the first)
    "jpeg_tiles_second_narrow": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, lambda s, f: f(64, 96))),
                                 "tiff_jpeg"),
    "jpeg_tiles_second_short": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, lambda s, f: f(128, 40))),
                                "tiff_jpeg"),
    "jpeg_tiles_first_narrow_and_short": (lambda p: _jpeg_tiled_case(p, mode="RGB",
                                                                     damage=_replace(0, lambda s, f: f(64, 40))),
                                          "tiff_jpeg"),
    "jpeg_tiles_empty_after_short": (lambda p: _jpeg_tiled_case(p, mode="L", tables=False, damage=lambda segs, f: [
        segs[0], f(128, 40), b""] + segs[3:]), "tiff_jpeg"),
    "jpeg_strips_second_short": (lambda p: _jpeg_tiled_case(p, strips=True,
                                                            damage=_replace(1, lambda s, f: f(300, 20))), "tiff_jpeg"),
    # a frame header after the scan: jpeg_finish_decompress fails after
    # the rows are written, and libtiff keeps them
    "jpeg_tiles_first_marker_after_scan": (lambda p: _jpeg_tiled_case(p, damage=_replace(0, _sof_after_scan)),
                                           "tiff_jpeg"),
    "jpeg_tiles_second_marker_after_scan": (lambda p: _jpeg_tiled_case(p, damage=_replace(1, _sof_after_scan)),
                                            "tiff_jpeg"),
    # data cut short: libtiff's byte-count repairs, strip chopping and
    # stale buffers at stop_on_error 0
    "short_single_strip_count": (lambda p: _short_case(p, rps=200, count=30000), "tiff"),
    "short_single_strip_past_end": (lambda p: _short_case(p, rps=200, offset=100000), "tiff"),
    "short_first_of_many_raw": (lambda p: _short_case(p, cut=(0, lambda n: 100)), "tiff"),
    "short_first_of_two_raw": (lambda p: _short_case(p, rps=100, cut=(0, lambda n: 1000)), "tiff"),
    "short_third_raw": (lambda p: _short_case(p, cut=(2, lambda n: 100)), "tiff"),
    "short_lzw_strip": (lambda p: _short_case(p, compression=5, cut=(1, lambda n: n // 2)), "tiff"),
    "short_packbits_strip": (lambda p: _short_case(p, compression=32773, cut=(3, lambda n: n // 2)), "tiff"),
    # libdeflate's stopping point: symbols that start up to a byte past the
    # stream's end less its four checksum bytes, decoded from zeros; a stored
    # block that runs past it unwritten
    "short_deflate_strip_half": (lambda p: _short_case(p, compression=8, cut=(1, lambda n: n // 2)), "tiff"),
    "short_deflate_strip_third": (lambda p: _short_case(p, compression=8, cut=(2, lambda n: n // 3)), "tiff"),
    "short_deflate_strip_less_5": (lambda p: _short_case(p, compression=8, cut=(1, lambda n: n - 5)), "tiff"),
    "short_deflate_strip_less_1": (lambda p: _short_case(p, compression=8, cut=(4, lambda n: n - 1)), "tiff"),
    "short_deflate_strip_9_bytes": (lambda p: _short_case(p, compression=8, cut=(1, lambda n: 9)), "tiff"),
    "short_deflate_stored_strip": (lambda p: _short_case(p, compression="deflate_stored",
                                                         cut=(1, lambda n: n // 2)), "tiff"),
    # libtiff's own readings: its 4x4 tile routine's skew, the directory's
    # fatal values, extra samples, an unknown scheme, missing tags
    **{f"ycbcr_{h}{v}_tiles": ((lambda p, h=h, v=v: _ycbcr_tiles_case(p, hs=h, vs=v)), "tiff")
       for h, v in ((2, 2), (4, 4), (4, 1))},
    "extrasamples_past_spp": (lambda p: _tagged_case(p, c=4, tags={338: (3, [2] * 5)}), "skipped"),
    "extrasamples_corel_999": (lambda p: _tagged_case(p, c=4, tags={338: (3, [999])}), "tiff"),
    "grey_two_extra_samples": (lambda p: _tagged_case(p, photometric=1, tags={338: (3, [0, 0])}), "tiff"),
    "grey_three_samples_no_extrasamples": (lambda p: _tagged_case(p, photometric=1), "tiff"),
    "no_photometric_rgb": (lambda p: _tagged_case(p, photometric=None), "tiff"),
    "no_photometric_grey": (lambda p: _tagged_case(p, c=1, photometric=None), "tiff"),
    "unknown_compression": (lambda p: _tagged_case(p, tags={259: (3, [12345])}), "tiff"),
    "rows_per_strip_0": (lambda p: _tagged_case(p, tags={278: (3, [0])}), "skipped"),
    "planar_config_3": (lambda p: _tagged_case(p, tags={284: (3, [3])}), "skipped"),
    "samples_per_pixel_0": (lambda p: _tagged_case(p, tags={277: (3, [0])}), "skipped"),
    "palette_without_colormap": (lambda p: _tagged_case(p, c=1, photometric=3), "tiff"),
    "palette4_without_colormap": (lambda p: _tagged_case(p, c=1, bps=4, photometric=3), "skipped"),
    "palette_colormap_short": (lambda p: _tagged_case(p, c=1, photometric=3, tags={320: (3, list(range(700)))}),
                               "tiff"),
    "cmyk_five_samples": (lambda p: _tagged_case(p, c=5, photometric=5), "tiff"),
    "orientation_9": (lambda p: _tagged_case(p, tags={274: (3, [9])}), "tiff"),
    "tiles_24_wide_grey1": (lambda p: _tagged_case(p, c=1, bps=1, photometric=1, tile=(24, 24)), "tiff"),
    "tiles_24_wide_rgb": (lambda p: _tagged_case(p, tile=(24, 40)), "tiff"),
    "jpeg_grey_min_is_white": (_jpeg_grey_min_is_white, "pil"),
    # refused by TIFFRGBAImageOK: skipped by both loaders
    "refused_32bit": (_refused_case, "skipped"),
    "refused_float": (lambda p: _refused_case(p, fmt=3), "skipped"),
    "refused_12bit": (lambda p: (_rgb_case(p), _retag(p, 258, 12)), "skipped"),
    "refused_rgb_4bit": (lambda p: _tagged_case(p, bps=4), "skipped"),
    "refused_cmyk_16bit": (lambda p: _tagged_case(p, c=4, photometric=5, bps=8, tags={258: (3, [16] * 4)}),
                           "skipped"),
    "refused_inkset_2": (lambda p: _tagged_case(p, c=4, photometric=5, tags={332: (3, [2])}), "skipped"),
    "refused_cielab_planar": (lambda p: _tagged_case(p, photometric=8, planar=True), "skipped"),
    "refused_palette_planar": (lambda p: _tagged_case(p, c=2, photometric=3, planar=True,
                                                      tags={320: (3, list(range(768))), 338: (3, [0])}), "skipped"),
    "refused_lzw_predictor_2_at_4_bits": (lambda p: _grey_case(p, bps=4, compression=5, predictor=2), "skipped"),
    "refused_lzw_predictor_3_at_8_bits": (lambda p: _rgb_case(p, compression=5, predictor=3, size=(60, 80)),
                                          "skipped"),
    "predictor_tag_on_uncompressed_4bit": (lambda p: _tagged_case(p, c=1, bps=4, photometric=1,
                                                                  tags={317: (3, [2])}), "tiff"),
}


def _retag(path, tag: int, value: int) -> None:
    """Rewrite one SHORT entry's first value in place (little-endian classic
    files this module wrote)."""
    data = bytearray(path.read_bytes())
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    for i in range(n):
        e = ifd + 2 + 12 * i
        t, typ, count = struct.unpack("<HHI", data[e:e + 8])
        if t == tag:
            if count * 2 > 4:
                at = struct.unpack("<I", data[e + 8:e + 12])[0]
                for k in range(count):
                    data[at + 2 * k:at + 2 * k + 2] = struct.pack("<H", value)
            else:
                data[e + 8:e + 10] = struct.pack("<H", value)
            path.write_bytes(bytes(data))
            return
    raise AssertionError(f"no tag {tag}")


def write_case(name: str, d) -> str:
    path = d / f"{PREFIX}_{list(CASES).index(name)}_0_0.tif"
    CASES[name][0](path)
    return str(path)


@pytest.mark.parametrize("name", list(CASES))
def test_reader_gives_libtiffs_pixels(name, tmp_path, jn):
    """decode_image on the CPU == the JAX native loader's libtiff pixels,
    byte for byte (or both skip the file), and the file takes the route
    stated for it."""
    path = write_case(name, tmp_path)
    want = jn.decode_image(path)
    got = native_loader.decode_image(path, "cpu")
    route = ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])]
    assert route == CASES[name][1]
    if want is None:
        assert got is None
        return
    assert got is not None and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- the faults

def test_bigtiff_is_read_not_skipped(tmp_path, jn):
    """A BigTIFF (magic 43) goes through the reader beside a classic TIFF:
    both files' tiles come out, as the JAX loader's do (the parent skipped
    the BigTIFF as unreadable)."""
    rgb = RGB_IMG()
    raw, big = tmp_path / f"{PREFIX}_1_0_0.tif", tmp_path / f"{PREFIX}_2_0_0.tif"
    rgb.save(raw)
    rgb.save(big, big_tiff=True)
    counts = {}
    got = list(native_loader.native_tile_batches([str(raw), str(big)], batch_size=2, tile=256, device="cpu",
                                                 counts=counts))
    ref = list(jn.native_tile_batches([str(raw), str(big)], batch_size=2, tile=256))
    assert sum(int(b.valid.sum()) for b in got) == sum(int(np.asarray(b.valid).sum()) for b in ref) == 2
    assert counts["tiff"] == 2 and counts["skipped"] == 0


def test_raw_ycbcr_decodes(tmp_path, jn):
    """Uncompressed YCbCr (PIL's YCbCr mode) decodes through libtiff's
    YCbCr tables (PIL raised 'image file is truncated' on it)."""
    p = tmp_path / "ycbcr.tif"
    Image.fromarray(image(20, 90, 120)).convert("YCbCr").save(p)
    got = native_loader.decode_image(str(p), "cpu")
    np.testing.assert_array_equal(got.numpy(), jn.decode_image(str(p)))


def test_cielab_takes_libtiffs_conversion(tmp_path, jn):
    """CIELab (PIL's LAB mode) through TIFFCIELabToRGB: libtiff's bytes,
    where PIL's differ in most of them."""
    p = tmp_path / "lab.tif"
    Image.fromarray(image(21, 90, 120)).convert("LAB").save(p)
    want = jn.decode_image(str(p))
    np.testing.assert_array_equal(native_loader.decode_image(str(p), "cpu").numpy(), want)
    assert (np.asarray(Image.open(p).convert("RGB")) != want).mean() > 0.5


@pytest.mark.parametrize("what", ["rgb16", "rgba16_unassociated", "grey16_alpha"])
def test_sixteen_bit_takes_libtiffs_rounding(what, tmp_path, jn):
    """16-bit RGB, RGBA (unassociated alpha) and grey with alpha: libtiff's
    (v + 128) / 257 and premultiplication, not a high byte."""
    p = tmp_path / f"{what}.tif"
    {"rgb16": lambda: _rgb_case(p, bps=16), "rgba16_unassociated": lambda: _rgb_case(p, bps=16, alpha=2),
     "grey16_alpha": lambda: _grey_case(p, bps=16, alpha=2)}[what]()
    np.testing.assert_array_equal(native_loader.decode_image(str(p), "cpu").numpy(), jn.decode_image(str(p)))


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4", "tiff_raw_16", "tiff_lzma", "tiff_zstd"])
def test_compressions_left_to_pil_give_libtiffs_pixels(compression, tmp_path, jn):
    """The compressions the reader leaves to PIL (CCITT 2, 3, 4 and RLE-W on
    bilevel files, LZMA on RGB) are routed by their tags and give libtiff's
    pixels here through PIL's own libtiff; ZSTD, which PIL wrote here, goes
    through the reader's own decoder (csrc/zstd_decode.cc) instead."""
    p = tmp_path / f"{compression}.tif"
    img = Image.fromarray(image(50)[..., 0]).convert("1") if "lz" not in compression and "zstd" not in compression \
        else Image.fromarray(image(51))
    try:
        img.save(p, compression=compression.replace("tiff_lzma", "lzma").replace("tiff_zstd", "zstd"))
    except OSError:
        pytest.skip(f"PIL's libtiff here does not write {compression}")
    want = jpeg_plain.TIFF_RASTER if compression == "tiff_zstd" else jpeg_plain.TIFF_PIL
    assert native_loader.probe(str(p))[jpeg_plain.T_ROUTE] == want
    np.testing.assert_array_equal(native_loader.decode_image(str(p), "cpu").numpy(), jn.decode_image(str(p)))


# ---------------------------------------------------------------- PIL's alpha and CMYK, StripByteCounts

@pytest.mark.parametrize("comp", [34925, 7])
@pytest.mark.parametrize("kind", ["associated_alpha", "cmyk"])
def test_pil_route_keeps_libtiffs_alpha_and_cmyk(kind, comp, tmp_path, jn):
    """An 80 x 64 RGBA file with ExtraSamples [1] and an 80 x 64 CMYK file,
    LZMA or JPEG (layouts the reader leaves to PIL), give libtiff's pixels:
    the stored colour of associated alpha (PIL un-premultiplied it) and
    putRGBcontig8bitCMYKtile's (255 - K) * (255 - C) // 255 (PIL's CMYK
    conversion rounds otherwise)."""
    from torch_tiff_writer import blocks, libtiff, libtiff_file

    if libtiff() is None:
        pytest.skip("no libtiff.so.6 here")
    px = image(60, 64, 80, 4)
    if kind == "associated_alpha":
        px[..., :3] = (px[..., :3].astype(np.uint32) * px[..., 3:] // 255).astype(np.uint8)
    tags = {256: 80, 257: 64, 258: 8, 259: comp, 262: 2 if kind == "associated_alpha" else 5, 277: 4, 278: 16}
    if kind == "associated_alpha":
        tags[338] = [1]
    p = tmp_path / f"{kind}_{comp}.tif"
    assert libtiff_file(p, tags, [np.ascontiguousarray(b).tobytes() for b in blocks(px, rps=16)])
    assert native_loader.probe(str(p))[jpeg_plain.T_ROUTE] == jpeg_plain.TIFF_PIL
    np.testing.assert_array_equal(native_loader.decode_image(str(p), "cpu").numpy(), jn.decode_image(str(p)))


def _without_counts(path, *, rps=16, compression=1, planar=False, tile=None) -> None:
    """An 80 x 64 RGB file with no StripByteCounts (TileByteCounts)."""
    segs, tags = layout(image(61, 64, 80), 8, rps=rps, compression=compression, planar=planar, tile=tile)
    tags[262] = (3, [2])
    path.write_bytes(tiff_bytes(segs, tags, tiled=bool(tile), omit=(325 if tile else 279,)))


@pytest.mark.parametrize("case,route", [
    ("four_strips", "skipped"), ("one_strip", "tiff"), ("four_strips_deflate", "skipped"),
    ("one_strip_deflate", "tiff"), ("planar_strip_a_sample", "tiff"), ("planar_two_strips_a_sample", "skipped"),
    ("one_tile", "tiff"), ("four_tiles_lzw", "skipped")])
def test_missing_strip_byte_counts_as_libtiff(case, route, tmp_path, jn):
    """A file without StripByteCounts takes TIFFReadDirectory's rule: a
    contiguous image of several segments or planes of several strips a
    sample is MissingRequired (skipped: the parent gave its tiles through
    PIL); else the counts are estimated (EstimateStripByteCounts: the file
    less its directory for a compressed segment, the rows or the tile
    uncompressed) and the reader decodes it as libtiff does."""
    p = tmp_path / f"{PREFIX}_1_0_0.tif"
    {"four_strips": lambda: _without_counts(p),
     "one_strip": lambda: _without_counts(p, rps=64),
     "four_strips_deflate": lambda: _without_counts(p, compression=8),
     "one_strip_deflate": lambda: _without_counts(p, rps=64, compression=8),
     "planar_strip_a_sample": lambda: _without_counts(p, rps=64, planar=True),
     "planar_two_strips_a_sample": lambda: _without_counts(p, rps=32, planar=True),
     "one_tile": lambda: _without_counts(p, tile=(80, 64)),
     "four_tiles_lzw": lambda: _without_counts(p, compression=5, tile=(48, 32))}[case]()
    want = jn.decode_image(str(p))
    got = native_loader.decode_image(str(p), "cpu")
    assert (want is None) == (route == "skipped") and (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), want)
    counts = {}
    tiles = _tiles(native_loader.native_tile_batches([str(p)], batch_size=2, tile=32, device="cpu", counts=counts))
    assert tiles == _tiles(jn.native_tile_batches([str(p)], batch_size=2, tile=32))
    assert counts[route] == 1 and counts["pil"] == 0


# ---------------------------------------------------------------- the loader

def _tiles(batches) -> Counter:
    out = Counter()
    for b in batches:
        images = b.images.numpy() if hasattr(b.images, "numpy") else np.asarray(b.images)
        for img, ok in zip(images, np.asarray(b.valid)):
            if ok:
                out[img.tobytes()] += 1
    return out


def test_tile_batches_equal_the_jax_loaders(tmp_path, jn):
    """native_tile_batches at full size over a mixed corpus (JPEG, TIFF
    in every route, a file neither) gives the JAX native loader's tiles as
    a multiset, and counts each route; the CPU path never launches the
    kernel."""
    names = ["pil_raw", "tiles_rgb_lzw_predictor", "pil_jpeg_ycbcr", "jpeg_tiles_rgb", "ycbcr_22", "cielab16",
             "refused_32bit", "orientation6", "planar_rgba_associated", "jpeg_tiles_second_not_jpeg",
             "jpeg_tiles_empty_after_short"]
    paths = [write_case(n, tmp_path) for n in names]
    jpg = tmp_path / f"{PREFIX}_900_0_0.jpg"
    Image.fromarray(image(30, 256, 384)).save(jpg, quality=90)
    fax = tmp_path / f"{PREFIX}_901_0_0.tif"
    Image.fromarray(image(31)[..., 0]).convert("1").save(fax, compression="group4")
    junk = tmp_path / f"{PREFIX}_902_0_0.jpg"
    junk.write_bytes(b"not an image")
    paths += [str(jpg), str(fax), str(junk)]
    launches = jpeg_cuda.decode_launches
    counts = {}
    got = _tiles(native_loader.native_tile_batches(paths, batch_size=4, tile=128, device="cpu", counts=counts))
    want = _tiles(jn.native_tile_batches(paths, batch_size=4, tile=128))
    assert got == want and sum(got.values()) > len(paths)
    assert counts == {"device": 1, "tiff": 6, "tiff_jpeg": 4, "pil": 1, "pil_resize": 0, "skipped": 2}
    assert jpeg_cuda.decode_launches == launches


def test_tiffs_at_scale_keep_the_pil_resize(tmp_path):
    """At out_tile > 0 every TIFF, JPEG-in-TIFF too, takes the Python
    loader's PIL resize, as the JAX package routes non-JPEG files."""
    paths = [write_case(n, tmp_path) for n in ("pil_raw", "pil_jpeg_ycbcr", "jpeg_tiles_ycbcr")]
    counts = {}
    batches = list(native_loader.native_tile_batches(paths, batch_size=4, tile=1024, out_tile=640, device="cpu",
                                                     counts=counts))
    assert counts["pil_resize"] == 3 and counts["tiff"] == counts["tiff_jpeg"] == 0
    assert sum(int(b.valid.sum()) for b in batches) == 3


def test_decode_image_scaled_reads_tiffs_whole(tmp_path, jn):
    path = write_case("jpeg_tiles_ycbcr", tmp_path)
    np.testing.assert_array_equal(native_loader.decode_image_scaled(path, 100, "cpu").numpy(),
                                  jn.decode_image(path))


# ---------------------------------------------------------------- codecs

def _codec(compression: int, src: bytes, occ: int) -> tuple:
    lib = native_loader.build()
    out = np.zeros(occ, np.uint8)
    buf = ctypes.create_string_buffer(src, len(src))
    ok = lib.aq_tiff_codec(compression, ctypes.cast(buf, ctypes.c_void_p), len(src), out.ctypes.data, occ)
    return ok, out.tobytes()


def _deflate(data: bytes, level: int, strategy: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    return c.compress(data) + c.flush()


@pytest.mark.parametrize("block", ["stored", "fixed", "dynamic", "dynamic_rle"])
def test_inflate_equals_zlib(block):
    """The reader's inflate on stored (level 0), fixed (Z_FIXED) and
    dynamic (level 9, and Z_RLE's long runs) blocks gives zlib's bytes; one
    byte more than the stream holds fails."""
    data = image(40, 64, 96).tobytes() + b"aquaculture " * 700
    stream = {"stored": lambda: _deflate(data, 0, zlib.Z_DEFAULT_STRATEGY),
              "fixed": lambda: _deflate(data, 6, zlib.Z_FIXED),
              "dynamic": lambda: _deflate(data, 9, zlib.Z_DEFAULT_STRATEGY),
              "dynamic_rle": lambda: _deflate(data, 6, zlib.Z_RLE)}[block]()
    assert zlib.decompress(stream) == data
    assert _codec(8, stream, len(data)) == (1, data)
    assert _codec(8, stream, len(data) + 1)[0] == 0


def _strips(path) -> tuple:
    with Image.open(path) as im:
        offs, counts = im.tag_v2[273], im.tag_v2[279]
    raw = open(path, "rb").read()
    return [raw[o:o + c] for o, c in zip(offs, counts)]


@pytest.mark.parametrize("compression", ["tiff_lzw", "packbits", "tiff_adobe_deflate"])
def test_codecs_on_pil_strips(compression, tmp_path):
    """LZW, PackBits and Deflate strips that PIL (through libtiff) wrote
    decode to the strip's pixels."""
    px = image(41, 64, 96)
    p = tmp_path / "s.tif"
    Image.fromarray(px).save(p, compression=compression)
    with Image.open(p) as im:
        rps = im.tag_v2.get(278, 64)
    code = {"tiff_lzw": 5, "packbits": 32773, "tiff_adobe_deflate": 8}[compression]
    for i, strip in enumerate(_strips(p)):
        want = px[i * rps:(i + 1) * rps].tobytes()
        assert _codec(code, strip, len(want)) == (1, want)


def _libdeflate_tif_zip():
    """libdeflate_zlib_decompress(d, in, n, out, occ, NULL) as tif_zip.c
    4.5.0 calls it (success or LIBDEFLATE_INSUFFICIENT_SPACE accepted), from
    the libdeflate.so.0 the system's libtiff links; None where missing."""
    try:
        ld = ctypes.CDLL("libdeflate.so.0")
    except OSError:
        return None
    vp = ctypes.c_void_p
    ld.libdeflate_alloc_decompressor.restype = vp
    ld.libdeflate_zlib_decompress.argtypes = [vp, vp, ctypes.c_size_t, vp, ctypes.c_size_t, vp]
    dec = ld.libdeflate_alloc_decompressor()

    def run(src: bytes, out: np.ndarray) -> bool:
        buf = ctypes.create_string_buffer(src, max(1, len(src)))
        return ld.libdeflate_zlib_decompress(dec, buf, len(src), out.ctypes.data, out.size, None) in (0, 3)
    return run


def _level1_strip(seed: int) -> tuple:
    px = image(102 + seed, 37, 96).tobytes()
    return px, zlib.compress(px, 1)


@pytest.mark.parametrize("seed", range(2))
def test_deflate_stops_where_libdeflate_stops(seed):
    """aq_tiff_codec(8) == libdeflate 1.14 as tif_zip.c calls it at every
    cut point of a level-1 strip, into a prefilled buffer: the same success
    and every byte, the bytes a match copied by whole words in libdeflate's
    fast loop leaves past a later failure included (the parent stopped at
    the failing symbol and differed at 124 of 31,356 cut points)."""
    run = _libdeflate_tif_zip()
    if run is None:
        pytest.skip("no libdeflate.so.0 here")
    px, stream = _level1_strip(seed)
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, len(px)).astype(np.uint8)
    lib = native_loader.build()
    for n in range(6, len(stream) + 1):
        want, got = pre.copy(), pre.copy()
        ok = run(stream[:n], want)
        buf = ctypes.create_string_buffer(stream[:n], n)
        assert (lib.aq_tiff_codec(8, ctypes.cast(buf, ctypes.c_void_p), n, got.ctypes.data, len(px)) == 1) == ok, n
        assert np.array_equal(got, want), n


def test_deflate_overrun_in_a_file_is_libtiffs(tmp_path, jn):
    """Files whose second level-1 strip is cut at each of 60 points (with
    this zlib's stream, four of them leave libdeflate's overrun in
    libtiff's strip buffer past the failure) give the JAX loader's
    pixels."""
    px, stream = _level1_strip(0)
    first = zlib.compress(image(101, 37, 96).tobytes(), 1)
    for n in range(4540, 4600):
        p = tmp_path / f"cut_{n}.tif"
        p.write_bytes(tiff_bytes([first, stream[:n]], {256: (3, [96]), 257: (3, [74]), 258: (3, [8, 8, 8]),
                                                       259: (3, [8]), 262: (3, [2]), 277: (3, [3]), 278: (3, [37])}))
        np.testing.assert_array_equal(native_loader.decode_image(str(p), "cpu").numpy(), jn.decode_image(str(p)))


def test_old_style_lzw_decodes():
    data = image(42, 40, 50).tobytes()
    assert _codec(5, lzw(data, compat=True), len(data)) == (1, data)
    assert _codec(5, lzw(data), len(data)) == (1, data)
