"""The device loader's NeXT, ThunderScan, PixarLog and SGILog TIFFs
(csrc/tiff_legacy.cc) against libtiff 4.5.0.

The JAX package's native loader reads a TIFF whole through libtiff's RGBA
interface (native/src/tileloader.cc: TIFFReadRGBAImageOriented at
ORIENTATION_TOPLEFT); the port decodes the same strips and tiles with its
own codecs inside its TIFF reader. Every case goes through both, the port's
``decode_image`` and ``native_tile_batches`` on the CPU against the JAX
package's, byte for byte (tolerance 0), and takes the route stated for it.

PixarLog and SGILog files come from the system's libtiff itself
(``libtiff_file``: its PixarLog encoder at 8 and 16 bits on 1 to 4 samples,
its LogL, LogLuv and LogLuv24 encoders from 16-bit Luv), and from streams
built here (PixarLog words zlib-compressed at several levels, LogLuv24
pixels covering every (u, v) cell); NeXT and ThunderScan, which libtiff
does not encode, from opcodes written here (literal rows and spans, runs,
raw pixels, deltas). Strips and tiles, both byte orders, the depths and
layouts libtiff refuses, and segments damaged on purpose: cut short, a
flipped byte, data past the row, a failing first segment against a
failing later one.
"""

from __future__ import annotations

import hashlib
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from aquaculture_tpu_torch.data import jpeg_plain, native_loader
from test_torch_tiff import PREFIX, _tiles, image
from torch_jax_native import jax_native_loader
from torch_tiff_writer import (TAG_PIXARLOGDATAFMT, TAG_SGILOGDATAFMT, TAG_SGILOGENCODE, blocks, libtiff,
                               libtiff_file, next_row, pack_samples, thunder_row, write_legacy_fixtures)

ROUTE_NAMES = {jpeg_plain.TIFF_RASTER: "tiff", jpeg_plain.TIFF_JPEG: "tiff_jpeg",
               jpeg_plain.TIFF_PIL: "pil", jpeg_plain.TIFF_SKIP: "skipped"}
FIXTURES = Path(__file__).resolve().parent / "data" / "torch_tiff"
H, W = 40, 51  # neither a multiple of a strip nor of a byte


@pytest.fixture(scope="module")
def jn():
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jn


@pytest.fixture(scope="module")
def lt():
    if libtiff() is None:
        pytest.skip("no libtiff.so.6 here")
    return True


def _cut(k: int, fn):
    """Segments with segment k replaced by fn(segment)."""
    return lambda segs: [fn(s) if i == k else s for i, s in enumerate(segs)]


def _flip(seed: int):
    """One seeded byte of a seeded segment flipped."""
    def damage(segs):
        rng = np.random.default_rng(seed)
        i = int(rng.integers(0, len(segs)))
        s = bytearray(segs[i])
        at = int(rng.integers(2, len(s)))
        s[at] ^= int(rng.integers(1, 256))
        return [bytes(s) if k == i else x for k, x in enumerate(segs)]
    return damage


def _file(path, tags, segs, *, raw=True, tiled=False, mode="w") -> None:
    assert libtiff_file(path, tags, segs, raw=raw, tiled=tiled, mode=mode)


# ---------------------------------------------------------------- NeXT

def _next_px(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 4, (H, W))
    px[:, 12:33] = 2
    px[7] = 3
    return px


def _next(path, *, modes=("literal", "span", "runs"), bps=2, ph=1, rps=16, damage=None, mode="w", extra=None):
    px = _next_px()
    segs = [b"".join(next_row(px[r], modes[r % len(modes)]) for r in range(y, min(y + rps, H)))
            for y in range(0, H, rps)]
    if damage:
        segs = damage(segs)
    tags = {256: W, 257: H, 258: bps, 259: 32766, 262: ph, 277: 1, 278: rps}
    tags.update(extra or {})
    _file(path, tags, segs, mode=mode)


def _next_tiles(path, *, w=64, tw=32, th=16):
    """Tiles of runs, padded with grey 0. NeXT's rows are the image's
    scanline even in a tile (a tile whose bytes are not a whole number of
    them fails), its runs the tile's width."""
    px = np.tile(_next_px(1), 2)[:, :w]
    segs = [b"".join(next_row(r, "runs") for r in t[..., 0]) for t in blocks(px[..., None], tile=(tw, th))]
    _file(path, {256: w, 257: H, 258: 2, 259: 32766, 262: 1, 277: 1, 322: tw, 323: th}, segs, tiled=True)


# ---------------------------------------------------------------- ThunderScan

def _thunder_px(seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    px = np.clip(np.cumsum(rng.integers(-1, 2, (H, W)), axis=1) + 8, 0, 15)
    px[:, 20:35] = 5
    px[5] = rng.integers(0, 16, W)
    return px


def _thunder(path, *, bps=4, ph=1, rps=16, damage=None, mode="w", rows=None):
    px = _thunder_px()
    segs = [b"".join(thunder_row(px[r]) for r in range(y, min(y + rps, H))) for y in range(0, H, rps)]
    if rows is not None:  # hand-written codes, the same for every row
        segs = [rows * min(rps, H - y) for y in range(0, H, rps)]
    if damage:
        segs = damage(segs)
    _file(path, {256: W, 257: H, 258: bps, 259: 32809, 262: ph, 277: 1, 278: rps}, segs, mode=mode)


# ---------------------------------------------------------------- PixarLog

def _pixar(path, *, spp=3, bits=8, rps=16, tile=None, planar=False, mode="w", extra=None, seed=3):
    """Through libtiff's PixarLog encoder (PIXARLOGDATAFMT_8BIT or 16BIT)."""
    px = image(seed, H, 70, spp).astype(np.uint16 if bits == 16 else np.uint8)
    if bits == 16:
        px = px * 257 + np.random.default_rng(seed).integers(0, 257, px.shape).astype(np.uint16)
    tags = {256: 70, 257: H, 259: 32909, 262: 1 if spp < 3 else 2, 277: spp, 284: 2 if planar else 1,
            TAG_PIXARLOGDATAFMT: 4 if bits == 16 else 0, 278: rps}
    if spp in (2, 4):
        tags[338] = [2]
    if tile:
        tags[322], tags[323] = tile
    tags.update(extra or {})
    segs = [np.ascontiguousarray(b).tobytes() for b in blocks(px, tile=tile, rps=rps, planar=planar)]
    _file(path, tags, segs, raw=False, tiled=tile is not None, mode=mode)


def _pixar_words(rows: np.ndarray, stride: int, order: str) -> bytes:
    """PixarLog's horizontally differenced 11-bit words of rows of codes."""
    d = rows.copy()
    d[:, stride:] = (rows[:, stride:] - rows[:, :-stride]) & 0x7FF
    return d.astype(order + "u2").tobytes()


def _pixar_raw(path, *, level=6, damage=None, order="<", stream_rows=16, bits=8, extra=None):
    """RGB strips of 16 rows as zlib streams built here (stream_rows rows of
    words each), written raw."""
    rng = np.random.default_rng(5)
    codes = np.clip(np.cumsum(rng.integers(-40, 41, (H, 30 * 3)), axis=1) + 1000, 0, 2047)
    segs = [zlib.compress(_pixar_words(codes[y:y + stream_rows], 3, order), level) for y in range(0, H, 16)]
    if damage:
        segs = damage(segs)
    tags = {256: 30, 257: H, 258: bits, 259: 32909, 262: 2, 277: 3, 278: 16, 284: 1}
    tags.update(extra or {})
    _file(path, tags, segs, mode="wb" if order == ">" else "w")


# ---------------------------------------------------------------- SGILog

def _luv_px(seed: int = 7) -> tuple:
    rng = np.random.default_rng(seed)
    lum = np.clip(np.cumsum(rng.integers(-300, 301, (H, W)), axis=1) + 15000, 0, 32767).astype(np.int16)
    lum[:, :4] = 0
    lum[3] = -lum[3]
    lum[4, 5:9] = 32767
    u = (np.clip(rng.normal(0.2, 0.05, (H, W)), 0.0, 0.62) * 32768).astype(np.int16)
    v = (np.clip(rng.normal(0.47, 0.05, (H, W)), 0.0, 0.6) * 32768).astype(np.int16)
    return lum, np.stack([lum, u, v], -1)


def _sgilog(path, *, kind="l16", rps=12, tile=None, mode="w", fmt=1, extra=None):
    """Through libtiff's LogL / LogLuv / LogLuv24 encoder from 16-bit data
    (SGILOGDATAFMT_16BIT, no dithering)."""
    lum, luv = _luv_px()
    px = lum[..., None] if kind == "l16" else luv
    if kind == "luv24":  # LogLuv24's ten bits of luminance take L16 from 3314 to 7410
        px = np.concatenate([(px[..., :1] // 8 + 3400).astype(np.int16), px[..., 1:]], -1)
    if fmt == 0:
        px = px.astype(np.float32) / 32768
    tags = {256: W, 257: H, 259: 34677 if kind == "luv24" else 34676, 262: 32844 if kind == "l16" else 32845,
            277: px.shape[2], 284: 1, TAG_SGILOGDATAFMT: fmt, TAG_SGILOGENCODE: 0, 278: rps}
    if tile:
        tags[322], tags[323] = tile
    tags.update(extra or {})
    segs = [np.ascontiguousarray(b).tobytes() for b in blocks(px, tile=tile, rps=rps)]
    _file(path, tags, segs, raw=False, tiled=tile is not None, mode=mode)


def _sgilog_raw(path, *, kind="luv24", damage=None, rps=12, extra=None):
    """Strips written here: LogLuv24's packed pixels (every (u, v) cell and
    ten-bit luminance, cell indices past the table among them), or LogL16
    and LogLuv32 byte planes of literals and runs."""
    n = H * W
    if kind == "luv24":
        packed = ((np.arange(n) * 13 % 1024) << 14 | (np.arange(n) * 7 % 16384)).astype(np.uint32)
        data = np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], -1).astype(np.uint8)
        rows = data.reshape(H, W * 3)
        segs = [rows[y:y + rps].tobytes() for y in range(0, H, rps)]
    else:
        planes = 2 if kind == "l16" else 4
        rng = np.random.default_rng(8)
        segs = []
        for y in range(0, H, rps):
            out = bytearray()
            for _ in range(min(rps, H - y)):
                for p in range(planes):  # each plane: a run, then literals
                    b = rng.integers(0, 256, W - 10)
                    out += bytes([128 + 10 - 2, int(rng.integers(60, 70)) if p == 0 else int(rng.integers(0, 256))])
                    for k in range(0, len(b), 100):
                        chunk = b[k:k + 100]
                        out += bytes([len(chunk)]) + bytes(int(x) for x in chunk)
            segs.append(bytes(out))
    if damage:
        segs = damage(segs)
    tags = {256: W, 257: H, 258: 16, 259: 34677 if kind == "luv24" else 34676,
            262: 32844 if kind == "l16" else 32845, 277: 1 if kind == "l16" else 3, 278: rps, 284: 1, 339: 2}
    tags.update(extra or {})
    _file(path, tags, segs)


# name: (writer(path), route)
CASES = {
    # NeXT: each opcode, mixed, tiles, both byte orders, FillOrder 2
    "next_literal": (lambda p: _next(p, modes=("literal",)), "tiff"),
    "next_span": (lambda p: _next(p, modes=("span",)), "tiff"),
    "next_runs": (lambda p: _next(p, modes=("runs",)), "tiff"),
    "next_mixed_white": (lambda p: _next(p, ph=0), "tiff"),
    "next_mm": (lambda p: _next(p, modes=("runs", "literal"), mode="wb"), "tiff"),
    "next_one_strip": (lambda p: _next(p, rps=H), "tiff"),
    "next_fillorder_2": (lambda p: _next(p, extra={266: 2}), "tiff"),
    "next_tiles": (_next_tiles, "tiff"),
    "next_tiles_fractional": (lambda p: _next_tiles(p, w=W, tw=16, th=16), "tiff"),
    **{f"next_refused_{b}bit": (lambda p, b=b: _next(p, bps=b, modes=("literal",)), "skipped") for b in (1, 4, 8)},
    # NeXT damaged: the first segment failing against a later one
    **{f"next_{name}_{k}": (lambda p, k=k, fn=fn: _next(p, damage=_cut(k, fn)), "tiff")
       for k in (0, 1) for name, fn in (
           ("cut_half", lambda s: s[:len(s) // 2]), ("cut_to_a_row", lambda s: s[:2 * (len(s) // 16)]),
           ("span_past_row", lambda s: bytes([0x40, 0, 10, 0, 20]) + bytes(20) + s),
           ("runs_past_row", lambda s: bytes([0xC0 | 63] * 4) + s), ("one_byte", lambda s: b"\x00"))},
    **{f"next_flip_{seed}": (lambda p, seed=seed: _next(p, damage=_flip(seed)), "tiff") for seed in range(3)},
    # ThunderScan
    "thunder": (_thunder, "tiff"),
    "thunder_white_mm": (lambda p: _thunder(p, ph=0, mode="wb"), "tiff"),
    "thunder_one_strip": (lambda p: _thunder(p, rps=H), "tiff"),
    **{f"thunder_codes_{i}": (lambda p, c=c: _thunder(p, rows=c), "tiff") for i, c in enumerate((
        bytes([0xC3, 0x03, 0xC7, 0x05, 0xC1, 0x02] * 4) + bytes([0xC9] * 3),   # raw pixels and runs
        bytes([0xC3, 0x00, 0xC7, 0x04, 0x00, 0xC1] * 5) + bytes([0x3F]),        # empty runs, odd starts
        bytes([0xC8, 0x40 | 1 << 4 | 3 << 2 | 2, 0x80 | 3 << 3 | 5] * 9),        # deltas and skips
        bytes([0xCF, 0x40 | 0x15, 0x80 | 0x3F] * 20)))},                          # deltas past 15 and below 0
    **{f"thunder_refused_{b}bit": (lambda p, b=b: _thunder(p, bps=b), "skipped") for b in (2, 8)},
    **{f"thunder_{name}_{k}": (lambda p, k=k, fn=fn: _thunder(p, damage=_cut(k, fn)), "tiff")
       for k in (0, 1) for name, fn in (
           ("cut_half", lambda s: s[:len(s) // 2]), ("too_much", lambda s: s + b"\xc1\xc2"),
           ("run_too_long", lambda s: bytes([0x3F]) + s), ("xor", lambda s: bytes(x ^ 0x55 for x in s)))},
    # PixarLog through libtiff: 1 to 4 samples (strides 1 and 2 take the
    # other loop), 8 and 16 bits, both byte orders
    **{f"pixar_{spp}x{bits}_{mode}": (lambda p, spp=spp, bits=bits, mode=mode: _pixar(p, spp=spp, bits=bits,
                                                                                          mode=mode), "tiff")
       for spp in (1, 2, 3, 4) for bits in (8, 16) for mode in ("w", "wb")},
    "pixar_tiles": (lambda p: _pixar(p, tile=(32, 16), extra={278: H}), "tiff"),
    "pixar_tiles_16": (lambda p: _pixar(p, tile=(32, 16), bits=16, spp=1, extra={278: H}), "tiff"),
    "pixar_planar": (lambda p: _pixar(p, planar=True), "tiff"),
    "pixar_one_strip": (lambda p: _pixar(p, rps=H), "tiff"),
    "pixar_predictor_2": (lambda p: _pixar(p, extra={317: 2}), "tiff"),
    "pixar_predictor_2_mm16": (lambda p: _pixar(p, bits=16, mode="wb", extra={317: 2}), "tiff"),
    "pixar_refused_signed": (lambda p: _pixar_raw(p, extra={339: 2}), "skipped"),
    "pixar_refused_12bit": (lambda p: _pixar_raw(p, extra={258: 12}), "skipped"),
    "pixar_refused_4bit": (lambda p: _pixar_raw(p, extra={258: 4}), "skipped"),
    "pixarfilm_32908": (lambda p: _pixar_raw(p, extra={259: 32908}), "tiff"),
    # PixarLog streams built here: levels, byte orders, the stream's size
    "pixar_raw": (_pixar_raw, "tiff"),
    "pixar_raw_mm": (lambda p: _pixar_raw(p, order=">"), "tiff"),
    "pixar_raw_16": (lambda p: _pixar_raw(p, bits=16), "tiff"),
    "pixar_raw_stored": (lambda p: _pixar_raw(p, level=0), "tiff"),
    "pixar_raw_level_1": (lambda p: _pixar_raw(p, level=1), "tiff"),
    "pixar_raw_longer_stream": (lambda p: _pixar_raw(p, stream_rows=20), "tiff"),
    "pixar_raw_shorter_stream": (lambda p: _pixar_raw(p, stream_rows=10), "tiff"),
    **{f"pixar_{name}_{k}": (lambda p, k=k, fn=fn, lv=lv: _pixar_raw(p, level=lv, damage=_cut(k, fn)), "tiff")
       for k in (0, 1) for name, fn, lv in (
           ("cut_half", lambda s: s[:len(s) // 2], 6), ("cut_in_checksum", lambda s: s[:-2], 6),
           ("no_checksum", lambda s: s[:-4], 6), ("cut_past_checksum", lambda s: s[:-5], 6),
           ("bad_checksum", lambda s: s[:-4] + b"\0\0\0\0", 6), ("trailing", lambda s: s + b"garbage!", 6),
           ("preset_dictionary", lambda s: bytes([s[0], s[1] ^ 0x20]) + s[2:], 6),
           ("stored_cut", lambda s: s[:-5], 0), ("flip_middle", lambda s: s[:len(s) // 2] + bytes(
               [s[len(s) // 2] ^ 0xFF]) + s[len(s) // 2 + 1:], 6))},
    **{f"pixar_flip_{seed}": (lambda p, seed=seed: _pixar_raw(p, damage=_flip(seed)), "tiff") for seed in range(4)},
    # SGILog through libtiff: LogL, LogLuv, LogLuv24; strips, tiles, orders
    **{f"sgilog_{kind}_{name}": (lambda p, kind=kind, kw=kw: _sgilog(p, kind=kind, **kw), "tiff")
       for kind in ("l16", "luv32", "luv24")
       for name, kw in (("strips", {}), ("mm", dict(mode="wb")), ("tiles", dict(tile=(32, 16))),
                        ("one_strip", dict(rps=H)))},
    "sgilog_luv32_from_float": (lambda p: _sgilog(p, kind="luv32", fmt=0), "tiff"),
    "sgilog_refused_logl_in_sgilog24": (lambda p: _sgilog(p, extra={259: 34677}), "skipped"),
    "sgilog_refused_minisblack": (lambda p: _sgilog_raw(p, kind="l16", extra={262: 1}), "skipped"),
    "sgilog_refused_logl_two_samples": (lambda p: _sgilog_raw(p, kind="l16", extra={277: 2}), "skipped"),
    # SGILog written here, damaged
    "sgilog_luv24_every_cell": (_sgilog_raw, "tiff"),
    "sgilog_l16_planes": (lambda p: _sgilog_raw(p, kind="l16"), "tiff"),
    "sgilog_luv32_planes": (lambda p: _sgilog_raw(p, kind="luv32"), "tiff"),
    **{f"sgilog_{kind}_{name}_{k}": (lambda p, kind=kind, k=k, fn=fn: _sgilog_raw(p, kind=kind, damage=_cut(k, fn)),
                                     "tiff")
       for kind in ("l16", "luv32", "luv24") for k in (0, 1) for name, fn in (
           ("cut_half", lambda s: s[:len(s) // 2]), ("cut_one", lambda s: s[:-1]),
           ("run_at_end", lambda s: s[:len(s) // 3] + b"\x90"))},
    **{f"sgilog_{kind}_flip_{seed}": (lambda p, kind=kind, seed=seed: _sgilog_raw(p, kind=kind, damage=_flip(seed)),
                                      "tiff") for kind in ("l16", "luv32") for seed in range(2)},
}


def write_case(name: str, d) -> str:
    path = d / f"{PREFIX}_{list(CASES).index(name)}_0_0.tif"
    CASES[name][0](path)
    return str(path)


@pytest.mark.parametrize("name", list(CASES))
def test_legacy_tiff_gives_libtiffs_pixels(name, tmp_path, jn, lt):
    """decode_image and native_tile_batches on the CPU == the JAX native
    loader's pixels and tiles through libtiff, byte for byte (or both skip
    the file), and the file takes the route stated for it."""
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
    tiles = _tiles(native_loader.native_tile_batches([path], batch_size=2, tile=64, device="cpu", counts=counts))
    assert tiles == _tiles(jn.native_tile_batches([path], batch_size=2, tile=64))
    assert counts["tiff" if want is not None else "skipped"] == 1 and counts["pil"] == 0


def _grey(path) -> np.ndarray:
    return native_loader.decode_image(path, "cpu").numpy()[..., 0]


def test_clean_files_give_their_pixels(tmp_path, lt):
    """The writers' clean files decode to the pixels they hold: NeXT's
    opcodes and ThunderScan's codes to their 2- and 4-bit greys, LogL to
    libtiff's gamma-2 grey of its luminance."""
    for name in ("next_literal", "next_span", "next_runs"):
        np.testing.assert_array_equal(_grey(write_case(name, tmp_path)), _next_px() * 85, err_msg=name)
    np.testing.assert_array_equal(_grey(write_case("thunder", tmp_path)), _thunder_px() * 17)
    lum = _luv_px()[0].astype(np.int64)
    le = lum & 0x7FFF
    y = np.where(le == 0, 0.0, np.exp(np.log(2) / 256 * (le + 0.5) - np.log(2) * 64))
    y = np.where(lum < 0, -y, y)
    want = np.where(y <= 0, 0, np.where(y >= 1, 255, (256 * np.sqrt(np.clip(y, 0, 1))).astype(np.int64)))
    assert np.abs(_grey(write_case("sgilog_l16_strips", tmp_path)).astype(np.int64) - want).max() <= 1


def test_legacy_tiffs_in_a_corpus_take_the_tiff_route(tmp_path, jn, lt):
    """native_tile_batches over one file of each codec, damaged ones among
    them, gives the JAX native loader's tiles as a multiset; every file
    counts as "tiff", none goes to PIL (the parent's PIL route raised on
    each), and the run reaches its end."""
    names = ["next_mixed_white", "next_cut_half_1", "thunder", "thunder_cut_half_0", "pixar_3x8_w",
             "pixar_1x16_wb", "pixar_no_checksum_1", "sgilog_l16_strips", "sgilog_luv32_tiles",
             "sgilog_luv24_mm", "sgilog_luv32_cut_half_1"]
    paths = [write_case(n, tmp_path) for n in names]
    counts = {}
    got = _tiles(native_loader.native_tile_batches(paths, batch_size=4, tile=32, device="cpu", counts=counts))
    want = _tiles(jn.native_tile_batches(paths, batch_size=4, tile=32))
    assert got == want and sum(got.values()) > len(paths)
    assert counts == {"device": 0, "tiff": len(paths), "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 0}


# ---------------------------------------------------------------- the card's fixtures

def test_card_fixtures_hold_libtiffs_pixels(jn):
    """tests/data/torch_tiff/pixels.json holds, for each committed file,
    the sha256 of libtiff's RGB pixels (the JAX package's native loader)
    and the route (the reader's, or PIL's for associated alpha and CMYK in
    LZMA and JPEG); the port gives the same pixels. chip_smoke.py
    holds the card host's decode to the same digests."""
    table = json.loads((FIXTURES / "pixels.json").read_text())
    assert table and all((FIXTURES / name).stat().st_size < 32 * 1024 for name in table)
    for name, row in table.items():
        path = str(FIXTURES / name)
        want = jn.decode_image(path)
        assert want is not None and list(want.shape) == row["shape"], name
        assert hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest() == row["sha256"], name
        assert ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])] == row["route"] in ("tiff", "pil")
        got = native_loader.decode_image(path, "cpu").numpy()
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == row["sha256"], name


def test_card_fixtures_are_the_writers(tmp_path, lt):
    """The committed fixtures are write_legacy_fixtures' files, byte for
    byte: libtiff's encoders, jbigkit's and the opcodes written here."""
    written = write_legacy_fixtures(str(tmp_path))
    table = json.loads((FIXTURES / "pixels.json").read_text())
    assert sorted(Path(p).name for p in written.values()) == sorted(table)
    for path in written.values():
        assert Path(path).read_bytes() == (FIXTURES / Path(path).name).read_bytes(), path


def test_pack_samples_of_two_bits():
    """next_row's literal rows pack four 2-bit pixels a byte, MSB first."""
    row = np.array([3, 0, 1, 2, 2])
    assert pack_samples(row[None], 2, "<") == bytes([0b11000110, 0b10000000])
    assert next_row(row, "literal") == b"\0" + bytes([0b11000110, 0b10000000])


@pytest.mark.parametrize("seed", range(2))
def test_pixarlog_inflate_stops_where_zlib_does(seed):
    """aq_tiff_codec(32909): PixarLog's inflate alone (INFLATE_ZLIB) on
    seeded zlib streams of each strategy and level, cut short, with flipped
    bytes or bytes appended, into buffers of other sizes == zlib's own
    decompressobj().decompress(data, occ): the same success (occ bytes out,
    no error on the way to the next byte it would write) and the same
    bytes."""
    import ctypes

    lib = native_loader.build()
    rng = np.random.default_rng(seed)
    agreed = 0
    for _ in range(60):
        n = int(rng.integers(1, 3000))
        raw = (np.cumsum(rng.integers(-3, 4, n)) % 256 if rng.random() < 0.5 else rng.integers(0, 256, n))
        strategy = int(rng.choice([zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED, zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE]))
        co = zlib.compressobj(int(rng.choice([0, 1, 6, 9])), zlib.DEFLATED, 15, 9, strategy)
        stream = co.compress(raw.astype(np.uint8).tobytes()) + co.flush()
        for _ in range(5):
            s = bytearray(stream)
            m = int(rng.integers(0, 4))
            if m == 0:
                s = s[:int(rng.integers(0, len(s) + 1))]
            elif m == 1:
                s[int(rng.integers(0, len(s)))] ^= int(rng.integers(1, 256))
            elif m == 2:
                s += rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
            occ = max(1, n + int(rng.choice([0, -1, -5, 3, -n // 2])))
            try:
                want = zlib.decompressobj().decompress(bytes(s), occ)
            except zlib.error:
                want = b""
            out = np.full(occ, 0xAB, np.uint8)
            src = ctypes.create_string_buffer(bytes(s), len(s))
            ok = lib.aq_tiff_codec(32909, ctypes.cast(src, ctypes.c_void_p), len(s), out.ctypes.data, occ)
            assert ok == (len(want) == occ)
            if ok:
                agreed += 1
                assert out.tobytes() == want
    assert agreed > 100
