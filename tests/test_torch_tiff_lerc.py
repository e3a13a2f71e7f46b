"""The device loader's LERC TIFFs (compression 34887: csrc/lerc_decode.cc,
with its Deflate and Zstandard wrappers) against libtiff 4.5.0 and libLerc 4.

The JAX package's native loader reads a TIFF whole through libtiff's RGBA
interface (native/src/tileloader.cc: TIFFReadRGBAImageOriented at
ORIENTATION_TOPLEFT), whose tif_lerc.c hands each strip or tile to libLerc;
the port decodes the same segments with its own Lerc2 decoder inside its
TIFF reader. Every case goes through both, the port's ``decode_image`` and
``native_tile_batches`` on the CPU against the JAX package's, byte for byte
(tolerance 0), and takes the route stated for it; none goes to PIL.

Files come from the system's libtiff (``libtiff_file``: its LERC encoder
bare, in Deflate and in ZSTD, lossless and lossy, 8 and 16 bits, signed and
not, one to four samples, contiguous and planar, strips and tiles, both byte
orders, an unassociated alpha carried as Lerc's mask), and from libLerc's own
encoder at the codec versions libtiff does not write (2, 3, 5, 6: laid raw by
``lerc_strips``). Segments damaged on purpose: cut, a flipped byte, bytes
appended, a blob of another size, a wrapper that fails. The decoder alone is
held to libLerc's lerc_getBlobInfo and lerc_decode through ctypes.
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np
import pytest

from aquaculture_tpu_torch.data import jpeg_plain, native_loader
from test_torch_tiff import PREFIX, _tiles, image
from torch_jax_native import jax_native_loader
from torch_tiff_writer import (TAG_LERC_ADD_COMPRESSION, TAG_LERC_MAXZERROR, blocks, lerc_blob, lerc_strips, libtiff,
                               libtiff_file)

ROUTE_NAMES = {jpeg_plain.TIFF_RASTER: "tiff", jpeg_plain.TIFF_JPEG: "tiff_jpeg",
               jpeg_plain.TIFF_PIL: "pil", jpeg_plain.TIFF_SKIP: "skipped"}
H, W = 44, 70  # neither a multiple of Lerc's 8 px blocks nor of a strip


@pytest.fixture(scope="module")
def jn():
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jn


@pytest.fixture(scope="module")
def lt():
    if libtiff() is None or lerc_blob(np.zeros((1, 1, 1), np.uint8), 4) is None:
        pytest.skip("no libtiff.so.6 or libLerc.so.4 here")
    return True


def _px(seed: int, spp: int, bps: int = 8, *, signed: bool = False, alpha: str = "") -> np.ndarray:
    """A seeded image of spp samples; alpha "binary" (0 or 255, which
    tif_lerc.c carries as Lerc's mask) or "soft" in the last sample."""
    px = image(seed, H, W, spp)
    if alpha == "binary":
        px[..., -1] = np.where((np.arange(W)[None] // 9 + np.arange(H)[:, None] // 5) % 3 == 0, 0, 255)
    if bps == 16:
        px = px.astype(np.uint16) * 257 + np.uint16(seed)
    if signed:
        px = (px.astype(np.int32) - (128 if bps == 8 else 32768)).astype(np.int8 if bps == 8 else np.int16)
    return px


def _libtiff(path, px, *, add=0, err=0.0, rps=16, tile=None, planar=False, extra=None, mode="w") -> None:
    spp = px.shape[2]
    tags = {256: W, 257: H, 258: 8 * px.dtype.itemsize, 259: 34887, 262: 2 if spp >= 3 else 1, 277: spp,
            TAG_LERC_ADD_COMPRESSION: add, TAG_LERC_MAXZERROR: err, 284: 2 if planar else 1}
    if tile:
        tags.update({322: tile[0], 323: tile[1]})
    else:
        tags[278] = rps
    if px.dtype.kind == "i":
        tags[339] = 2
    tags.update(extra or {})
    segs = blocks(px, tile=tile, rps=rps, planar=planar)
    assert libtiff_file(path, tags, [np.ascontiguousarray(b).tobytes() for b in segs], tiled=bool(tile), mode=mode)


def _zstd(data: bytes) -> bytes:
    z = ctypes.CDLL("libzstd.so.1")
    z.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    z.ZSTD_compress.restype = ctypes.c_size_t
    out = ctypes.create_string_buffer(len(data) + 1024)
    n = z.ZSTD_compress(out, len(out), data, len(data), 3)
    return out.raw[:n]


def _laid(path, px, *, version=4, add=0, err=0.5, damage=None, params=None, extra=None, **kw) -> None:
    """libLerc's blobs laid raw (lerc_strips), wrapped (add 1 zlib, 2 ZSTD,
    as LercParameters says) and damaged as asked."""
    def edit(segs):
        segs = [b if add == 0 else zlib.compress(b) if add == 1 else _zstd(b) for b in segs]
        return damage(segs) if damage else segs
    with open(path, "wb") as f:
        f.write(lerc_strips(px, version, max_z_error=err, edit=edit, params=params or [version, add], extra=extra,
                            **kw))


def _cut(k: int, fn):
    return lambda segs: [fn(s) if i == k else s for i, s in enumerate(segs)]


def _flip(seed: int, k: int):
    """One seeded byte of segment k flipped."""
    def damage(s):
        rng = np.random.default_rng(seed)
        s = bytearray(s)
        s[int(rng.integers(0, len(s)))] ^= int(rng.integers(1, 256))
        return bytes(s)
    return _cut(k, damage)


CASES = {
    # libtiff's encoder: bare, Deflate, ZSTD
    **{f"{wrap}_{kind}": (lambda p, add=add, kw=kw: _libtiff(p, **kw(add)), "tiff")
       for wrap, add in (("none", 0), ("deflate", 1), ("zstd", 2))
       for kind, kw in (("rgb8", lambda a: dict(px=_px(1, 3), add=a)),
                        ("rgb16_lossy", lambda a: dict(px=_px(2, 3, 16), add=a, err=40.0)),
                        ("rgba8_mask", lambda a: dict(px=_px(3, 4, alpha="binary"), add=a, extra={338: [2]})))},
    "none_grey8_lossy": (lambda p: _libtiff(p, _px(4, 1), err=2.0), "tiff"),
    "none_grey16": (lambda p: _libtiff(p, _px(5, 1, 16)), "tiff"),
    "zstd_rgba8_soft_alpha": (lambda p: _libtiff(p, _px(6, 4, alpha="soft"), add=2, extra={338: [2]}), "tiff"),
    "deflate_rgba8_associated": (lambda p: _libtiff(p, _px(7, 4, alpha="binary"), add=1, extra={338: [1]}), "tiff"),
    "none_grey_alpha8_mask": (lambda p: _libtiff(p, _px(8, 2, alpha="binary"), extra={338: [2]}), "tiff"),
    "none_rgba16_alpha": (lambda p: _libtiff(p, _px(9, 4, 16, alpha="binary"), extra={338: [2]}), "tiff"),
    "none_rgb8_planar": (lambda p: _libtiff(p, _px(10, 3), planar=True), "tiff"),
    "deflate_rgba8_planar": (lambda p: _libtiff(p, _px(11, 4, alpha="binary"), add=1, planar=True,
                                                extra={338: [2]}), "tiff"),
    "zstd_rgb8_tiles": (lambda p: _libtiff(p, _px(12, 3), add=2, tile=(32, 16)), "tiff"),
    "none_rgb16_tiles": (lambda p: _libtiff(p, _px(13, 3, 16), tile=(16, 32)), "tiff"),
    "none_rgb16_mm": (lambda p: _libtiff(p, _px(14, 3, 16), mode="wb"), "tiff"),
    "deflate_rgb8_orientation3": (lambda p: _libtiff(p, _px(15, 3), add=1, extra={274: 3}), "tiff"),
    "none_signed8": (lambda p: _libtiff(p, _px(16, 1, signed=True)), "tiff"),
    "zstd_signed16": (lambda p: _libtiff(p, _px(17, 3, 16, signed=True), add=2), "tiff"),
    "none_rgb8_short_last_strip": (lambda p: _libtiff(p, _px(18, 3), rps=17), "tiff"),
    # libLerc's own blobs at the versions libtiff does not write
    **{f"v{v}_{kind}": (lambda p, v=v, kw=kw: _laid(p, version=v, **kw), "tiff")
       for v in (2, 3, 5, 6)
       for kind, kw in (("grey8", dict(px=_px(20, 1))), ("grey16_lossy", dict(px=_px(21, 1, 16), err=9.0)),
                        ("grey_alpha8_mask", dict(px=_px(22, 2, alpha="binary"), alpha_mask=True)))},
    **{f"v{v}_{kind}": (lambda p, v=v, kw=kw: _laid(p, version=v, **kw), "tiff")
       for v in (5, 6)
       for kind, kw in (("rgb8", dict(px=_px(23, 3))), ("rgb16", dict(px=_px(24, 3, 16))),
                        ("rgb8_lossy", dict(px=_px(25, 3), err=1.5)))},
    "v4_rgb8_zstd_laid": (lambda p: _laid(p, _px(26, 3), add=2), "tiff"),
    # refused before any decode: skipped, as the reference skips them
    "refused_sampleformat_void": (lambda p: _laid(p, _px(28, 1), extra={339: (3, [4])}), "skipped"),
    "refused_additional_compression_3": (lambda p: _laid(p, _px(29, 1), params=[4, 3]), "skipped"),
    # refused segment by segment (the first fails the image): probed as "tiff"
    "refused_rows_per_strip_other_than_blob": (lambda p: _laid(p, _px(30, 1), extra={278: (3, [8])}), "tiff"),
    # damaged: a first segment that fails fails the image; a later one
    # leaves the buffer as the segment before left it
    **{f"damaged_{name}": (lambda p, fn=fn, add=add: _laid(p, _px(31, 3), add=add, damage=fn), route)
       for name, fn, add, route in (
           ("first_cut", _cut(0, lambda s: s[:len(s) // 2]), 0, "tiff"),
           ("second_cut", _cut(1, lambda s: s[:len(s) // 2]), 0, "tiff"),
           ("second_appended", _cut(1, lambda s: s + b"\0" * 5), 0, "tiff"),
           ("third_flip_0", _flip(0, 2), 0, "tiff"),
           ("third_flip_1", _flip(1, 2), 0, "tiff"),
           ("second_empty", _cut(1, lambda s: b""), 0, "tiff"),
           ("deflate_second_flip", _flip(2, 1), 1, "tiff"),
           ("deflate_second_cut", _cut(1, lambda s: s[:-3]), 1, "tiff"),
           ("zstd_second_cut", _cut(1, lambda s: s[:-3]), 2, "tiff"),
           ("zstd_second_flip", _flip(3, 1), 2, "tiff"),
           ("second_blob_of_the_third", lambda segs: [segs[0], segs[2], segs[2]], 0, "tiff"))},
    "damaged_v2_second_flip": (lambda p: _laid(p, _px(32, 1), version=2, damage=_flip(4, 1)), "tiff"),
}


def write_case(name: str, d) -> str:
    path = d / f"{PREFIX}_{list(CASES).index(name)}_0_0.tif"
    CASES[name][0](path)
    return str(path)


@pytest.mark.parametrize("name", list(CASES))
def test_lerc_tiff_gives_libtiffs_pixels(name, tmp_path, jn, lt):
    """decode_image and native_tile_batches on the CPU == the JAX native
    loader's pixels and tiles through libtiff and libLerc, byte for byte (or
    both skip the file), and the file is probed on the route stated for it;
    none goes to PIL (the parent raised on every LERC file)."""
    path = write_case(name, tmp_path)
    route = CASES[name][1]
    assert ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])] == route
    want = jn.decode_image(path)
    got = native_loader.decode_image(path, "cpu")
    if want is None:
        assert got is None
    else:
        assert got is not None
        np.testing.assert_array_equal(got.numpy(), want)
    counts = {}
    tiles = _tiles(native_loader.native_tile_batches([path], batch_size=2, tile=32, device="cpu", counts=counts))
    assert tiles == _tiles(jn.native_tile_batches([path], batch_size=2, tile=32))
    assert counts["tiff" if want is not None else "skipped"] == 1 and counts["pil"] == 0


def test_lerc_corpus_takes_the_tiff_route(tmp_path, jn, lt):
    """native_tile_batches over LERC files of each wrapper and version, a
    damaged one, and the layouts the RGBA interface refuses before any
    decode (32-bit floating-point and integer samples) gives the JAX
    loader's tiles; the refused ones are skipped, no file goes to PIL and
    the run reaches its end (the parent's PIL route raised on the first)."""
    names = ["none_rgb8", "deflate_rgb16_lossy", "zstd_rgba8_mask", "v2_grey8", "v6_rgb8", "damaged_third_flip_0"]
    paths = [write_case(n, tmp_path) for n in names]
    for i, (px, extra) in enumerate(((image(27, H, W, 1).astype(np.float32) / 255, {339: 3}),
                                     (image(28, H, W, 1).astype(np.int32), {}))):
        paths.append(str(tmp_path / f"{PREFIX}_{900 + i}_0_0.tif"))
        _libtiff(paths[-1], px, extra=extra)
    counts = {}
    got = _tiles(native_loader.native_tile_batches(paths, batch_size=4, tile=32, device="cpu", counts=counts))
    assert got == _tiles(jn.native_tile_batches(paths, batch_size=4, tile=32)) and sum(got.values()) > len(names)
    assert counts == {"device": 0, "tiff": len(names), "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 2}


def test_mask_rebuilds_the_alpha(tmp_path, lt):
    """A binary unassociated alpha goes into the blob as Lerc's mask (the
    blob's depth is 3) and comes back as 255 * valid: the pixels are the
    colour premultiplied by it, zero where the alpha was."""
    path = write_case("none_rgba8_mask", tmp_path)
    px = _px(3, 4, alpha="binary")
    got = native_loader.decode_image(path, "cpu").numpy()
    np.testing.assert_array_equal(got, np.where(px[..., 3:] == 255, px[..., :3], 0))


# ---------------------------------------------------------------- the decoder alone

def _liblerc():
    lerc = ctypes.CDLL("libLerc.so.4")
    vp = ctypes.c_void_p
    lerc.lerc_getBlobInfo.argtypes = [vp, ctypes.c_uint, vp, vp, ctypes.c_int, ctypes.c_int]
    lerc.lerc_decode.argtypes = [vp, ctypes.c_uint, ctypes.c_int, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint, vp]
    return lerc


@pytest.mark.parametrize("seed", range(2))
def test_decoder_equals_liblerc(seed, lt):
    """aq_lerc_info and aq_lerc_decode == libLerc's lerc_getBlobInfo and
    lerc_decode (with and without the mask asked for) on seeded blobs of
    every codec version, the four integer types, depths 1 to 4, masks, lossy
    and lossless (Huffman, tiles, raw, constant), clean, cut, with a byte
    flipped or bytes appended: the same success, info, pixels and mask."""
    lib, lerc = native_loader.build(), _liblerc()
    vp = ctypes.c_void_p
    lib.aq_lerc_info.argtypes = [vp, ctypes.c_long, vp]
    lib.aq_lerc_decode.argtypes = [vp, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp]
    types = [np.int8, np.uint8, np.int16, np.uint16]
    rng = np.random.default_rng(seed)
    decoded = 0
    for _ in range(40):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        dt, depth = int(rng.integers(0, 4)), int(rng.choice([1, 1, 2, 3, 4]))
        version = int(rng.choice([2, 3, 4, 5, 6] if depth == 1 else [4, 5, 6]))
        kind = int(rng.integers(0, 4))
        a = (image(int(rng.integers(0, 999)), max(h, 2), max(w, 2), depth)[:h, :w].astype(np.int64) if kind < 2
             else rng.integers(0, 256, (h, w, depth)) if kind == 2 else np.full((h, w, depth), 9) + np.arange(depth))
        if dt >= 2:
            a = a * 257
        if dt in (0, 2):
            a = a - (128 if dt == 0 else 32768)
        a = np.ascontiguousarray(a.astype(types[dt]))
        mask = (rng.random((h, w)) > 0.3).astype(np.uint8) if rng.random() < 0.4 else None
        blob = lerc_blob(a, version, max_z_error=float(rng.choice([0.5, 0.5, 2.0])), mask=mask)
        if blob is None:
            continue
        for trial in range(4):
            b = bytearray(blob)
            if trial == 1:
                b = b[:int(rng.integers(0, len(b)))]
            elif trial == 2:
                b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            elif trial == 3:
                b += bytes(int(rng.integers(1, 30)))
            b = bytes(b)
            src = ctypes.create_string_buffer(b, max(1, len(b)))
            want_info, got_info = (ctypes.c_uint * 8)(), (ctypes.c_uint * 8)()
            ok_info = lerc.lerc_getBlobInfo(src, len(b), want_info, None, 8, 0) == 0
            assert (lib.aq_lerc_info(src, len(b), got_info) == 1) == ok_info
            if ok_info:
                assert list(got_info) == list(want_info)
            for with_mask in (False, True):
                want, got = np.full(h * w * depth, 0x5A, types[dt]), np.full(h * w * depth, 0x5A, types[dt])
                want_m, got_m = np.full(h * w, 7, np.uint8), np.full(h * w, 7, np.uint8)
                ok = lerc.lerc_decode(src, len(b), int(with_mask), want_m.ctypes.data if with_mask else None, depth, w,
                                      h, 1, dt, want.ctypes.data) == 0
                assert (lib.aq_lerc_decode(src, len(b), depth, w, h, dt, got.ctypes.data,
                                           got_m.ctypes.data if with_mask else None) == 1) == ok
                if ok:
                    decoded += 1
                    np.testing.assert_array_equal(got, want)
                    np.testing.assert_array_equal(got_m, want_m)
    assert decoded > 80
