"""The device loader's Zstandard TIFFs (compression 50000: csrc/zstd_decode.cc)
against libtiff 4.5.0 and libzstd 1.5.4.

The JAX package's native loader reads a TIFF whole through libtiff's RGBA
interface (native/src/tileloader.cc: TIFFReadRGBAImageOriented at
ORIENTATION_TOPLEFT), whose tif_zstd.c hands each strip or tile to
ZSTD_decompressStream; the port decodes the same segments with its own
Zstandard decoder inside its TIFF reader. Every case goes through both, the
port's ``decode_image`` and ``native_tile_batches`` on the CPU against the JAX
package's, byte for byte (tolerance 0), and is probed on the route stated for
it; none goes to PIL (the parent's route for 50000).

Files come from the system's libtiff (``libtiff_file``: its ZSTD encoder at
several levels, with Predictor 2, planar, tiled, big-endian), and from frames
libzstd writes here through ctypes with the options libtiff does not set (the
content size, the content checksum), laid in strips: several frames in a
strip, skippable frames before and after, a dictionary ID, a window over
libzstd's limit, a reserved bit, raw and RLE blocks, strips cut short and a
checksum that differs. The decoder alone is held to libzstd's
ZSTD_decompressStream (as tif_zstd.c calls it) and ZSTD_decompress (as
tif_lerc.c does) through ctypes.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import pytest

from aquaculture_tpu_torch.data import jpeg_plain, native_loader
from test_torch_tiff import PREFIX, _tiles, image
from torch_jax_native import jax_native_loader
from torch_tiff_writer import TAG_ZSTD_LEVEL, blocks, libtiff, libtiff_file, tiff_bytes

ROUTE_NAMES = {jpeg_plain.TIFF_RASTER: "tiff", jpeg_plain.TIFF_JPEG: "tiff_jpeg",
               jpeg_plain.TIFF_PIL: "pil", jpeg_plain.TIFF_SKIP: "skipped"}
H, W = 50, 70
VP, SZ = ctypes.c_void_p, ctypes.c_size_t


class _In(ctypes.Structure):
    _fields_ = [("src", VP), ("size", SZ), ("pos", SZ)]


class _Out(ctypes.Structure):
    _fields_ = [("dst", VP), ("size", SZ), ("pos", SZ)]


def _libzstd():
    try:
        z = ctypes.CDLL("libzstd.so.1")
    except OSError:
        return None
    z.ZSTD_createCCtx.restype = VP
    z.ZSTD_CCtx_setParameter.argtypes = [VP, ctypes.c_int, ctypes.c_int]
    z.ZSTD_CCtx_setParameter.restype = SZ
    z.ZSTD_compress2.argtypes = [VP, VP, SZ, VP, SZ]
    z.ZSTD_compress2.restype = SZ
    z.ZSTD_isError.argtypes = [SZ]
    z.ZSTD_createDStream.restype = VP
    z.ZSTD_initDStream.argtypes = [VP]
    z.ZSTD_decompressStream.argtypes = [VP, ctypes.POINTER(_Out), ctypes.POINTER(_In)]
    z.ZSTD_decompressStream.restype = SZ
    z.ZSTD_decompress.argtypes = [VP, SZ, VP, SZ]
    z.ZSTD_decompress.restype = SZ
    return z


@pytest.fixture(scope="module")
def jn():
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jn


@pytest.fixture(scope="module")
def lt():
    if libtiff() is None or _libzstd() is None:
        pytest.skip("no libtiff.so.6 or libzstd.so.1 here")
    return True


def frame(data: bytes, *, level: int = 3, checksum: bool = False, content_size: bool = False) -> bytes:
    """One Zstandard frame of data from libzstd (ZSTD_compress2)."""
    z = _libzstd()
    cctx = z.ZSTD_createCCtx()
    for param, value in ((100, level), (200, int(content_size)), (201, int(checksum))):
        z.ZSTD_CCtx_setParameter(cctx, param, value)  # compressionLevel, contentSizeFlag, checksumFlag
    out = ctypes.create_string_buffer(len(data) + 1024)
    n = z.ZSTD_compress2(cctx, out, len(out), data, len(data))
    assert not z.ZSTD_isError(n)
    return out.raw[:n]


def skippable(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 + nibble, len(payload)) + payload


def _libtiff(path, px, *, rps=16, tile=None, planar=False, extra=None, mode="w") -> None:
    spp = px.shape[2]
    tags = {256: W, 257: H, 258: 8 * px.dtype.itemsize, 259: 50000, 262: 2 if spp >= 3 else 1, 277: spp,
            284: 2 if planar else 1}
    tags.update({322: tile[0], 323: tile[1]} if tile else {278: rps})
    tags.update(extra or {})
    segs = blocks(px, tile=tile, rps=rps, planar=planar)
    assert libtiff_file(path, tags, [np.ascontiguousarray(b).tobytes() for b in segs], tiled=bool(tile), mode=mode)


def _laid(path, px, encode, *, rps=16, extra=None) -> None:
    """Strips of px through encode(list of strips' bytes) -> segments."""
    spp = px.shape[2]
    segs = encode([np.ascontiguousarray(b).tobytes() for b in blocks(px, rps=rps)])
    tags = {256: (3, [W]), 257: (3, [H]), 258: (3, [8] * spp), 259: (3, [50000]), 262: (3, [2 if spp >= 3 else 1]),
            277: (3, [spp]), 278: (3, [rps])}
    tags.update(extra or {})
    with open(path, "wb") as f:
        f.write(tiff_bytes(segs, tags))


def _each(fn, only=None):
    """fn(i, strip) on every strip (or strip only)."""
    return lambda strips: [fn(i, s) if only is None or i == only else frame(s) for i, s in enumerate(strips)]


def _header_edit(edit):
    """A libtiff-like frame (no content size) with its header edited."""
    def fn(i, s):
        f = bytearray(frame(s))
        return bytes(edit(f))
    return fn


def _with_dict_id(f):
    f[4] |= 1  # a one-byte dictionary ID after the window descriptor
    return f[:6] + b"\x07" + f[6:]


def _window_2_28(f):
    f[5] = 18 << 3  # window log 28 > ZSTD_WINDOWLOG_LIMIT_DEFAULT
    return f


def _reserved(f):
    f[4] |= 0x08
    return f


def _block_type_3(f):
    at = 6  # the first block header after magic, FHD and the window descriptor
    f[at] |= 6
    return f


def _cut_at(seed: int):
    def fn(i, s):
        f = frame(s)
        return f[:int(np.random.default_rng(seed + i).integers(0, len(f)))]
    return fn


CASES = {
    # libtiff's encoder
    "libtiff_rgb8": (lambda p: _libtiff(p, image(1, H, W)), "tiff"),
    "libtiff_rgb8_level19": (lambda p: _libtiff(p, image(2, H, W), extra={TAG_ZSTD_LEVEL: 19}), "tiff"),
    "libtiff_rgb8_level1": (lambda p: _libtiff(p, image(3, H, W), extra={TAG_ZSTD_LEVEL: 1}), "tiff"),
    "libtiff_grey16_predictor": (lambda p: _libtiff(p, image(4, H, W, 1).astype(np.uint16) * 257,
                                                    extra={317: 2}), "tiff"),
    "libtiff_rgb8_predictor": (lambda p: _libtiff(p, image(5, H, W), extra={317: 2}), "tiff"),
    "libtiff_rgb8_planar": (lambda p: _libtiff(p, image(6, H, W), planar=True), "tiff"),
    "libtiff_rgb8_tiles": (lambda p: _libtiff(p, image(7, H, W), tile=(32, 32)), "tiff"),
    "libtiff_rgb16_mm": (lambda p: _libtiff(p, image(8, H, W).astype(np.uint16) * 255, mode="wb"), "tiff"),
    "libtiff_rgba8_unassociated": (lambda p: _libtiff(p, image(9, H, W, 4), extra={338: [2]}), "tiff"),
    "libtiff_rgb8_orientation2": (lambda p: _libtiff(p, image(10, H, W), extra={274: 2}), "tiff"),
    # frames libtiff does not write
    "content_size": (lambda p: _laid(p, image(11, H, W), _each(lambda i, s: frame(s, content_size=True))), "tiff"),
    "content_size_taller_last": (lambda p: _laid(p, image(12, H, W), lambda st: [
        frame(s if i < 3 else s + s[:8 * W * 3], content_size=True) for i, s in enumerate(st)]), "tiff"),
    "checksum": (lambda p: _laid(p, image(13, H, W), _each(lambda i, s: frame(s, checksum=True))), "tiff"),
    "checksum_wrong": (lambda p: _laid(p, image(14, H, W), _each(
        lambda i, s: frame(s, checksum=True)[:-1] + b"\x00", only=1)), "tiff"),
    "two_frames": (lambda p: _laid(p, image(15, H, W), _each(
        lambda i, s: frame(s[:len(s) // 2]) + frame(s[len(s) // 2:]), only=1)), "tiff"),
    "one_frame_then_another": (lambda p: _laid(p, image(16, H, W), _each(
        lambda i, s: frame(s) + frame(b"more"))), "tiff"),
    "skippable_first": (lambda p: _laid(p, image(17, H, W), _each(
        lambda i, s: skippable(b"note") + frame(s), only=2)), "tiff"),
    "skippable_after": (lambda p: _laid(p, image(18, H, W), _each(
        lambda i, s: frame(s) + skippable(b"note", 15))), "tiff"),
    "dictionary_id": (lambda p: _laid(p, image(19, H, W), _each(_header_edit(_with_dict_id), only=1)), "tiff"),
    "window_over_the_limit": (lambda p: _laid(p, image(20, H, W), _each(_header_edit(_window_2_28), only=2)), "tiff"),
    "reserved_bit": (lambda p: _laid(p, image(21, H, W), _each(_header_edit(_reserved), only=1)), "tiff"),
    "reserved_block_type": (lambda p: _laid(p, image(22, H, W), _each(_header_edit(_block_type_3), only=3)), "tiff"),
    "first_strip_refused": (lambda p: _laid(p, image(23, H, W), _each(_header_edit(_reserved), only=0)), "tiff"),
    "raw_blocks_cut": (lambda p: _laid(p, np.random.default_rng(24).integers(0, 256, (H, W, 3), dtype=np.uint8),
                                       _each(lambda i, s: frame(s, level=1)[:len(s) // 2], only=1)), "tiff"),
    "rle_blocks": (lambda p: _laid(p, np.full((H, W, 3), 77, np.uint8), _each(lambda i, s: frame(s))), "tiff"),
    "empty_strip": (lambda p: _laid(p, image(25, H, W), _each(lambda i, s: b"", only=2)), "tiff"),
    "not_zstd": (lambda p: _laid(p, image(26, H, W), _each(lambda i, s: b"\x28\xb5\x2f\xfc" + s[:40], only=1)), "tiff"),
    **{f"cut_{seed}": (lambda p, seed=seed: _laid(p, image(27 + seed, H, W), _each(_cut_at(seed))), "tiff")
       for seed in range(3)},
    "refused_predictor_3": (lambda p: _laid(p, image(31, H, W), _each(lambda i, s: frame(s)),
                                            extra={317: (3, [3])}), "skipped"),
}


def write_case(name: str, d) -> str:
    path = d / f"{PREFIX}_{list(CASES).index(name)}_0_0.tif"
    CASES[name][0](path)
    return str(path)


@pytest.mark.parametrize("name", list(CASES))
def test_zstd_tiff_gives_libtiffs_pixels(name, tmp_path, jn, lt):
    """decode_image and native_tile_batches on the CPU == the JAX native
    loader's pixels and tiles through libtiff and libzstd, byte for byte (or
    both skip the file), probed on the route stated; none goes to PIL."""
    path = write_case(name, tmp_path)
    assert ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])] == CASES[name][1]
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


# ---------------------------------------------------------------- the decoder alone

def _streams(rng, n: int):
    """Seeded streams: frames at several levels with and without a content
    size and checksum, several frames, skippable frames, then cut, bytes
    appended or a header or checksum byte changed."""
    for _ in range(n):
        size = int(rng.integers(1, 30000))
        kind = int(rng.integers(0, 3))
        raw = (image(int(rng.integers(0, 999)), max(1, size // 210), 70).tobytes() if kind == 0
               else (np.cumsum(rng.integers(-3, 4, size)) % 256).astype(np.uint8).tobytes() if kind == 1
               else rng.integers(0, 256, size).astype(np.uint8).tobytes())
        checksum = bool(rng.integers(0, 2))
        s = frame(raw, level=int(rng.choice([-5, 1, 3, 19])), checksum=checksum,
                  content_size=bool(rng.integers(0, 2)))
        if rng.random() < 0.2:
            s += frame(raw[::-1][:500])
        if rng.random() < 0.15:
            s = skippable(b"x" * int(rng.integers(0, 9)), int(rng.integers(0, 16))) + s
        for m in range(4):
            t = bytearray(s)
            if m == 1:
                t = t[:int(rng.integers(0, len(t) + 1))]
            elif m == 2:
                t += rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
            elif m == 3:
                at = int(rng.choice([4, 5, len(t) - 1])) if checksum else int(rng.choice([4, 5]))
                t[at] ^= 1 << int(rng.integers(0, 8))
            yield raw, bytes(t)


@pytest.mark.parametrize("seed", range(2))
def test_decoder_equals_libzstd(seed, lt):
    """aq_tiff_codec(50000) == tif_zstd.c's loop over ZSTD_decompressStream
    into a prefilled buffer (the same success and the same bytes, those left
    by a failure included), and aq_zstd_decompress == ZSTD_decompress (the
    same success and bytes), on seeded streams."""
    lib, z = native_loader.build(), _libzstd()
    lib.aq_zstd_decompress.argtypes = [VP, ctypes.c_long, VP, ctypes.c_long]
    lib.aq_zstd_decompress.restype = ctypes.c_long
    ds = z.ZSTD_createDStream()
    rng = np.random.default_rng(seed)
    full = 0
    for raw, s in _streams(rng, 30):
        src = ctypes.create_string_buffer(s, max(1, len(s)))
        occ = max(1, len(raw) + int(rng.choice([0, 0, -1, -9, 7, -len(raw) // 2])))
        pre = rng.integers(0, 256, occ).astype(np.uint8)
        want, got = pre.copy(), pre.copy()
        z.ZSTD_initDStream(ds)
        ib, ob = _In(ctypes.cast(src, VP), len(s), 0), _Out(want.ctypes.data, occ, 0)
        ok = True
        while True:
            r = z.ZSTD_decompressStream(ds, ctypes.byref(ob), ctypes.byref(ib))
            if z.ZSTD_isError(r):
                ok = False
                break
            if not (r != 0 and ib.pos < ib.size and ob.pos < ob.size):
                break
        ok = ok and ob.pos == occ
        full += ok
        assert (lib.aq_tiff_codec(50000, ctypes.cast(src, VP), len(s), got.ctypes.data, occ) == 1) == ok
        np.testing.assert_array_equal(got, want)
        cap = int(rng.choice([len(raw), len(raw) + 600, max(1, len(raw) - 3)]))
        a, b = np.zeros(cap, np.uint8), np.zeros(cap, np.uint8)
        n = z.ZSTD_decompress(a.ctypes.data, cap, src, len(s))
        m = lib.aq_zstd_decompress(ctypes.cast(src, VP), len(s), b.ctypes.data, cap)
        if z.ZSTD_isError(n):
            assert m == -1
        else:
            assert m == n and a[:n].tobytes() == b[:n].tobytes()
    assert full > 20
