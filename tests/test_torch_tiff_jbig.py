"""The device loader's JBIG-compressed TIFFs (compression 34661,
csrc/jbig_decode.cc) against libtiff 4.5.0 and jbigkit 2.1.

The JAX package's native loader reads a TIFF whole through libtiff's RGBA
interface, whose tif_jbig.c reverses each byte's bits (at FillOrder 1),
lets jbg_newlen take a NEWLEN marker's height into the BIH and hands the
strip to jbigkit's jbg_dec_in; the port decodes the same BIE with its own
decoder. Every case goes through both, the port's ``decode_image`` and
``native_tile_batches`` on the CPU against the JAX package's, byte for byte
(tolerance 0), and takes the route stated for it.

BIEs come from libtiff's own JBIG encoder (``libtiff_file``: TPBON, the
three-line template, stripes of 35ths of the image) and from jbigkit's
(``jbig_encoder``: stripe heights, the two-line template, no typical
prediction, the orders, SDRST, AT moves on periodic patterns, a NEWLEN
after a taller BIH, a COMMENT), written into TIFFs byte by byte at either
FillOrder and byte order. Damaged BIEs: cut short, flipped bytes, markers
inserted, a BIE another size than its strip. The decoder alone is also
held to libjbig's jbg_dec_in on seeded damaged BIEs. BIEs of several
resolution layers or planes stay on the PIL route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest

from aquaculture_tpu_torch.data import jpeg_plain, native_loader
from test_torch_tiff import PREFIX, _tiles
from torch_jax_native import jax_native_loader
from torch_tiff_writer import jbig_encoder, libtiff, libtiff_file, reverse_bits, tiff_bytes

ROUTE_NAMES = {jpeg_plain.TIFF_RASTER: "tiff", jpeg_plain.TIFF_JPEG: "tiff_jpeg",
               jpeg_plain.TIFF_PIL: "pil", jpeg_plain.TIFF_SKIP: "skipped"}
H, W = 200, 256
LRLTWO, VLENGTH, TPBON, SDRST = 0x40, 0x20, 0x08, 0x200
DEFAULT = 0x1C  # TPBON | TPDON | DPON, jbigkit's and libtiff's


@pytest.fixture(scope="module")
def jn():
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jn


@pytest.fixture(scope="module")
def enc():
    e = jbig_encoder()
    if e is None or libtiff() is None:
        pytest.skip("no C compiler with libjbig, or no libtiff.so.6, here")
    return e


def _bits(seed: int = 0, h: int = H, w: int = W) -> np.ndarray:
    """Diagonal hatching with noise, blank lines and repeated lines (for
    typical prediction)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    b = (((xx // 7 + yy // 5) % 3 == 0) | (rng.random((h, w)) < 0.03)).astype(np.uint8)
    b[h // 4:h // 4 + 10] = 0
    b[h // 2:h // 2 + 4] = b[h // 2 - 1]
    return b


def _periodic(period: int, h: int = 256, w: int = 512) -> np.ndarray:
    """Random rows repeated every `period` pixels: jbigkit's encoder moves
    the AT pixel to tx = period."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.random.default_rng(period).integers(0, 2, (h, period)).astype(np.uint8)[yy, xx % period]


def _wrap(path, bie: bytes, h: int = H, w: int = W, *, fillorder=1, order="<", extra=None, segments=None) -> None:
    """A TIFF of one strip holding the BIE as libtiff stores it: each
    byte's bits reversed at FillOrder 1."""
    seg = reverse_bits(bie) if fillorder == 1 else bie
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [1]), 259: (3, [34661]), 262: (3, [0]), 277: (3, [1]),
            278: (3, [h])}
    if fillorder == 2:
        tags[266] = (3, [2])
    tags.update(extra or {})
    path.write_bytes(tiff_bytes(segments or [seg], tags, order=order))


def _libtiff(path, bits, *, mode="w", ph=0, extra=None) -> None:
    h, w = bits.shape
    tags = {256: w, 257: h, 258: 1, 259: 34661, 262: ph, 277: 1, 278: h}
    tags.update(extra or {})
    assert libtiff_file(path, tags, [np.packbits(bits, axis=1).tobytes()], mode=mode)


def _jbig(path, e, *, bits=None, damage=None, wrap=None, **kw) -> None:
    bits = _bits() if bits is None else bits
    bie = e(bits, **kw)
    if damage:
        bie = damage(bie)
    _wrap(path, bie, *bits.shape, **(wrap or {}))


def _flip(seed: int, start: int = 20):
    def damage(bie):
        rng = np.random.default_rng(seed)
        b = bytearray(bie)
        for _ in range(1 + seed % 3):
            b[int(rng.integers(start, len(b)))] ^= int(rng.integers(1, 256))
        return bytes(b)
    return damage


def _insert(marker: bytes, frac: float = 0.5):
    """marker bytes inserted just before the SDNORM nearest frac of the way
    through the BIE."""
    def damage(bie):
        at = bie.find(b"\xff\x02", int(len(bie) * frac))
        return bie[:at] + marker + bie[at:]
    return damage


def _bih(index: int, value: int):
    def damage(bie):
        b = bytearray(bie)
        b[index] = value
        return bytes(b)
    return damage


# name: (writer(path, enc), route)
CASES = {
    # libtiff's encoder
    "libtiff": (lambda p, e: _libtiff(p, _bits()), "tiff"),
    "libtiff_mm": (lambda p, e: _libtiff(p, _bits(1), mode="wb"), "tiff"),
    "libtiff_min_is_black": (lambda p, e: _libtiff(p, _bits(2), ph=1), "tiff"),
    "libtiff_odd_size": (lambda p, e: _libtiff(p, _bits(3, 77, 101)), "tiff"),
    "libtiff_fillorder_2": (lambda p, e: _libtiff(p, _bits(4), extra={266: 2}), "tiff"),
    "libtiff_one_row": (lambda p, e: _libtiff(p, _bits(5, 1, 300)), "tiff"),
    # jbigkit's encoder: stripes, templates, prediction, orders
    **{f"stripes_{l0}": (lambda p, e, l0=l0: _jbig(p, e, l0=l0), "tiff") for l0 in (1, 3, 16, 128, H)},
    "lrltwo": (lambda p, e: _jbig(p, e, options=DEFAULT | LRLTWO), "tiff"),
    "no_typical_prediction": (lambda p, e: _jbig(p, e, options=0x14), "tiff"),
    "no_options": (lambda p, e: _jbig(p, e, options=0), "tiff"),
    "lrltwo_no_tpbon": (lambda p, e: _jbig(p, e, options=LRLTWO), "tiff"),
    **{f"order_{o}": (lambda p, e, o=o: _jbig(p, e, order=o), "tiff") for o in (0, 2, 4, 6, 8, 0x0B)},
    "sdrst": (lambda p, e: _jbig(p, e, options=DEFAULT | SDRST, l0=8), "tiff"),
    "sdrst_lrltwo": (lambda p, e: _jbig(p, e, options=DEFAULT | LRLTWO | SDRST, l0=8), "tiff"),
    "mx_0": (lambda p, e: _jbig(p, e, mx=0), "tiff"),
    # AT moves inside h1 (tx < 8) and from the row's bytes (tx >= 8), in
    # both templates
    **{f"at_{period}_{name}": (lambda p, e, period=period, opt=opt: _jbig(
        p, e, bits=_periodic(period), mx=32, l0=32, options=opt), "tiff")
       for period in (6, 12) for name, opt in (("three_line", DEFAULT), ("two_line", DEFAULT | LRLTWO),
                                               ("two_line_sdrst", DEFAULT | LRLTWO | SDRST))},
    "at_17_mx_127": (lambda p, e: _jbig(p, e, bits=_periodic(17), mx=127, l0=16), "tiff"),
    # NEWLEN (jbg_newlen takes it into the BIH), COMMENT
    "newlen": (lambda p, e: _jbig(p, e, options=DEFAULT | VLENGTH, yd1=H + 40), "tiff"),
    "newlen_without_vlength": (lambda p, e: _jbig(p, e, yd1=H + 40), "tiff"),
    "newlen_short_stripes": (lambda p, e: _jbig(p, e, options=DEFAULT | VLENGTH, yd1=H + 9, l0=7), "tiff"),
    "comment": (lambda p, e: _jbig(p, e, comment=b"a comment " * 40), "tiff"),
    "newlen_and_comment": (lambda p, e: _jbig(p, e, options=DEFAULT | VLENGTH, yd1=H + 3, comment=b"x"), "tiff"),
    # byte and bit orders
    "fillorder_2": (lambda p, e: _jbig(p, e, wrap=dict(fillorder=2)), "tiff"),
    "big_endian": (lambda p, e: _jbig(p, e, wrap=dict(order=">")), "tiff"),
    # a BIE of another size than its strip: fewer bytes keep the rest of
    # the strip, more fail
    "bie_shorter_than_strip": (lambda p, e: _wrap(p, e(_bits(6)[:150]), H, W), "tiff"),
    "bie_taller_than_strip": (lambda p, e: _wrap(p, e(_bits(7)), 150, W), "tiff"),
    "bie_narrower_than_strip": (lambda p, e: _wrap(p, e(_bits(8)[:, :200]), H, W), "tiff"),
    # tiles: JBIGSetupDecode counts strips from RowsPerStrip (one, here),
    # and tif_jbig.c has no tile decoder (a zeroed raster); a RowsPerStrip
    # that makes two strips is refused
    "one_tile": (lambda p, e: p.write_bytes(tiff_bytes([reverse_bits(e(_bits(10)))], {
        256: (3, [W]), 257: (3, [H]), 258: (3, [1]), 259: (3, [34661]), 262: (3, [0]), 277: (3, [1]),
        322: (3, [W]), 323: (3, [208])}, tiled=True)), "tiff"),
    "two_tiles": (lambda p, e: p.write_bytes(tiff_bytes([reverse_bits(e(_bits(11)[:, :128])),
                                                         reverse_bits(e(_bits(11)[:, 128:]))], {
        256: (3, [W]), 257: (3, [H]), 258: (3, [1]), 259: (3, [34661]), 262: (3, [0]), 277: (3, [1]),
        322: (3, [128]), 323: (3, [208])}, tiled=True)), "tiff"),
    "tiles_rows_per_strip_100": (lambda p, e: p.write_bytes(tiff_bytes([reverse_bits(e(_bits(12)))], {
        256: (3, [W]), 257: (3, [H]), 258: (3, [1]), 259: (3, [34661]), 262: (3, [0]), 277: (3, [1]),
        278: (3, [100]), 322: (3, [W]), 323: (3, [208])}, tiled=True)), "skipped"),
    # refusals
    "two_strips": (lambda p, e: _wrap(p, b"", extra={278: (3, [100])}, segments=[
        reverse_bits(e(_bits(9)[:100])), reverse_bits(e(_bits(9)[100:]))]), "skipped"),
    "order_smid_alone": (lambda p, e: _jbig(p, e, damage=_bih(18, 0x01)), "tiff"),
    "bih_padding": (lambda p, e: _jbig(p, e, damage=_bih(3, 1)), "tiff"),
    "bih_no_planes": (lambda p, e: _jbig(p, e, damage=_bih(2, 0)), "tiff"),
    "bih_dl_1": (lambda p, e: _jbig(p, e, damage=_bih(0, 1)), "tiff"),
    "private_dp_table_missing": (lambda p, e: _jbig(p, e, damage=_bih(19, 0x1E)), "tiff"),
    # damaged
    **{f"cut_{name}": (lambda p, e, fn=fn: _jbig(p, e, damage=fn), "tiff") for name, fn in (
        ("half", lambda b: b[:len(b) // 2]), ("bih_only", lambda b: b[:20]), ("in_bih", lambda b: b[:19]),
        ("last_byte", lambda b: b[:-1]), ("last_marker", lambda b: b[:-2]))},
    **{f"flip_{seed}": (lambda p, e, seed=seed: _jbig(p, e, damage=_flip(seed)), "tiff") for seed in range(6)},
    **{f"flip_lrltwo_at_{seed}": (lambda p, e, seed=seed: _jbig(
        p, e, bits=_periodic(9), mx=32, l0=32, options=DEFAULT | LRLTWO, damage=_flip(seed)), "tiff")
       for seed in range(2)},
    "abort": (lambda p, e: _jbig(p, e, damage=_insert(b"\xff\x04")), "tiff"),
    "reserved_marker": (lambda p, e: _jbig(p, e, damage=_insert(b"\xff\x01")), "tiff"),
    "unknown_marker": (lambda p, e: _jbig(p, e, damage=_insert(b"\xff\x99")), "tiff"),
    "stuffing_between_stripes": (lambda p, e: _jbig(p, e, damage=_insert(b"\xff\x02\xff\x00", 0.3)), "tiff"),
    "comment_past_the_end": (lambda p, e: _jbig(p, e, damage=lambda b: b + b"\xff\x07\x00\x00\x10\x00abc"), "tiff"),
    "newlen_taller": (lambda p, e: _jbig(p, e, options=DEFAULT | VLENGTH, damage=_insert(
        b"\xff\x05\x00\x00\x01\x00", 0.9)), "tiff"),
    "atmove_refused": (lambda p, e: _jbig(p, e, damage=lambda b: b[:20] + b"\xff\x06\0\0\0\x02\x09\x01" + b[20:]),
                       "tiff"),
    # BIEs of several layers or planes: not decoded here
    "layers_2": (lambda p, e: _jbig(p, e, layers=2), "pil"),
    "planes_2_in_bih": (lambda p, e: _jbig(p, e, damage=_bih(2, 2)), "pil"),
}


def write_case(name: str, d, e) -> str:
    path = d / f"{PREFIX}_{list(CASES).index(name)}_0_0.tif"
    CASES[name][0](path, e)
    return str(path)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1] != "pil"])
def test_jbig_tiff_gives_libtiffs_pixels(name, tmp_path, jn, enc):
    """decode_image and native_tile_batches on the CPU == the JAX native
    loader's pixels and tiles through libtiff and jbigkit, byte for byte
    (or both skip the file), and the file takes the route stated for it."""
    path = write_case(name, tmp_path, enc)
    assert ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])] == CASES[name][1]
    want = jn.decode_image(path)
    got = native_loader.decode_image(path, "cpu")
    if want is None:
        assert got is None
    else:
        assert got is not None
        np.testing.assert_array_equal(got.numpy(), want)
    counts = {}
    tiles = _tiles(native_loader.native_tile_batches([path], batch_size=2, tile=128, device="cpu", counts=counts))
    assert tiles == _tiles(jn.native_tile_batches([path], batch_size=2, tile=128))
    assert counts["tiff" if want is not None else "skipped"] == 1 and counts["pil"] == 0


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1] == "pil"])
def test_layered_jbig_keeps_the_pil_route(name, tmp_path, enc):
    """A BIE with differential layers or several planes (which libtiff
    never writes) is routed to PIL by its BIH, not decoded here."""
    path = write_case(name, tmp_path, enc)
    assert ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])] == "pil"


def test_clean_jbig_gives_its_bits(tmp_path, enc):
    """Clean BIEs decode to their images: min-is-white, 1 black."""
    for name, bits in (("libtiff", _bits()), ("sdrst_lrltwo", _bits()), ("at_12_two_line", _periodic(12)),
                       ("newlen", _bits())):
        got = native_loader.decode_image(write_case(name, tmp_path, enc), "cpu").numpy()[..., 0]
        np.testing.assert_array_equal(got, np.where(bits == 1, 0, 255), err_msg=name)


def _jbg_dec(lib, bie: bytes, occ: int):
    """libjbig's own decode of a BIE as tif_jbig.c runs it: jbg_newlen,
    jbg_dec_in, then the image if it fits occ bytes; None where libtiff's
    decode fails."""
    state = ctypes.create_string_buffer(4096)
    buf = ctypes.create_string_buffer(bie, len(bie))
    lib.jbg_dec_init(state)
    lib.jbg_newlen(buf, ctypes.c_size_t(len(bie)))
    try:
        if lib.jbg_dec_in(state, buf, ctypes.c_size_t(len(bie)), None) != 0:
            return None
        n = lib.jbg_dec_getsize(state)
        return ctypes.string_at(lib.jbg_dec_getimage(state, 0), n) if n <= occ else None
    finally:
        lib.jbg_dec_free(state)


@pytest.mark.parametrize("seed", range(4))
def test_decoder_equals_jbigkit(seed, enc):
    """aq_tiff_codec(34661) on seeded BIEs and damaged copies of them (cut,
    flipped, markers inserted, bytes appended) == libjbig's jbg_dec_in:
    the same success, the same image, and nothing past it written. BIHs a
    flip gave several layers or planes are left out (not decoded here)."""
    try:
        jbig = ctypes.CDLL("libjbig.so.0")
    except OSError:
        pytest.skip("no libjbig.so.0 here")
    jbig.jbg_dec_getimage.restype = ctypes.c_void_p
    jbig.jbg_dec_getsize.restype = ctypes.c_ulong
    lib = native_loader.build()
    rng = np.random.default_rng(seed)
    decoded = 0
    for _ in range(40):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 130))
        if rng.random() < 0.5:
            bits = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        else:
            period = int(rng.integers(3, 20))
            yy, xx = np.mgrid[0:h, 0:w]
            bits = rng.integers(0, 2, (h, period)).astype(np.uint8)[yy, xx % period]
        options = int(rng.choice([0, TPBON, DEFAULT, LRLTWO, DEFAULT | LRLTWO, VLENGTH, DEFAULT | SDRST]))
        bie = enc(bits, order=int(rng.choice([0, 2, 3, 4, 6, 8])), options=options, l0=int(rng.integers(0, 20)),
                  mx=int(rng.choice([0, 8, 32, 127])), yd1=h + int(rng.integers(1, 9)) if options == VLENGTH else 0)
        occ = ((w + 7) // 8) * h + int(rng.choice([0, 4, -2]))
        for _ in range(5):
            b = bytearray(bie)
            m = int(rng.integers(0, 5))
            if m == 0:
                b = b[:int(rng.integers(0, len(b) + 1))]
            elif m == 1:
                b[int(rng.integers(20, len(b)))] ^= int(rng.integers(1, 256))
            elif m == 2:
                at = int(rng.integers(20, len(b) + 1))
                b[at:at] = bytes([0xFF, int(rng.integers(0, 9))])
            elif m == 3:
                b += rng.integers(0, 256, int(rng.integers(1, 10))).astype(np.uint8).tobytes()
            if len(b) >= 20 and (b[1] != 0 or b[2] != 1):
                continue
            occ = max(occ, 1)
            want = _jbg_dec(jbig, bytes(b), occ)
            out = np.full(occ, 0xAB, np.uint8)
            src = ctypes.create_string_buffer(bytes(b), len(b))
            ok = lib.aq_tiff_codec(34661, ctypes.cast(src, ctypes.c_void_p), len(b), out.ctypes.data, occ)
            assert ok == (want is not None)
            if want is not None:
                decoded += 1
                assert out[:len(want)].tobytes() == want and (out[len(want):] == 0xAB).all()
    assert decoded > 20


def test_jbig_tiffs_in_a_corpus_take_the_tiff_route(tmp_path, jn, enc):
    """native_tile_batches over libtiff's and jbigkit's BIEs, damaged ones
    among them, gives the JAX native loader's tiles as a multiset; every
    file counts as "tiff", none goes to PIL (the parent's PIL route raised
    on each), and the run reaches its end."""
    names = ["libtiff", "lrltwo", "at_12_three_line", "newlen", "sdrst", "cut_half", "flip_1",
             "bie_shorter_than_strip"]
    paths = [write_case(n, tmp_path, enc) for n in names]
    counts = {}
    got = _tiles(native_loader.native_tile_batches(paths, batch_size=4, tile=128, device="cpu", counts=counts))
    want = _tiles(jn.native_tile_batches(paths, batch_size=4, tile=128))
    assert got == want and sum(got.values()) > len(paths)
    assert counts == {"device": 0, "tiff": len(paths), "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 0}
