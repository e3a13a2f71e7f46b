"""The device loader's WebP-compressed TIFFs (compression 50001) against
libtiff and libwebp.

The JAX package's native loader reads a TIFF whole through libtiff's RGBA
interface (native/src/tileloader.cc: TIFFReadRGBAImageOriented at
ORIENTATION_TOPLEFT), whose tif_webp.c hands each strip or tile to
libwebp's incremental decoder; the port decodes the same segments with its
own codec (csrc/webp_decode.cc) inside its TIFF reader. Every case here
goes through both, the port's ``decode_image`` on the CPU against the JAX
package's, byte for byte (tolerance 0), and takes the route stated for it.

The segments come from PIL's WebP encoder (lossy at several qualities and
methods, lossless, RGBA, small palettes for the colour-indexing transform's
bundling), from libwebp's own WebPConfig through a small C helper
(``webp_encoder``: the simple loop filter, filter level 0, sharpness,
2/4/8 token partitions, one segment or four, ALPH raw or compressed at
several qualities) and from ALPH chunks built here with each prediction
filter. Strips (the last one shorter) and 256 and 512 px tiles, 3 and 4
samples under each ExtraSamples value, the layouts libtiff refuses or
reads oddly, and segments damaged on purpose: cut short, a flipped byte,
not WebP, empty, past the end of the file, streams of another size.
"""

from __future__ import annotations

import ctypes
import struct
from collections import Counter

import numpy as np
import pytest
from PIL import Image

from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain, native_loader
from test_torch_tiff import PREFIX, image, write_case as write_tiff_case
from torch_jax_native import jax_native_loader
from torch_tiff_writer import tiff_bytes, webp_encoder, webp_layout, webp_pil, webp_with_alph

ROUTE_NAMES = {jpeg_plain.TIFF_RASTER: "tiff", jpeg_plain.TIFF_JPEG: "tiff_jpeg",
               jpeg_plain.TIFF_PIL: "pil", jpeg_plain.TIFF_SKIP: "skipped"}
H, W = 120, 170  # neither a multiple of 16


@pytest.fixture(scope="module")
def jn():
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jn


@pytest.fixture(scope="module")
def enc():
    e = webp_encoder()
    if e is None:
        pytest.skip("no C compiler with libwebp here")
    return e


def _rgba(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """An RGBA image whose alpha has runs of opaque and translucent pixels."""
    px = image(seed, h, w, 4)
    opaque = (np.arange(w)[None] // 9 + np.arange(h)[:, None] // 7) % 3 == 0
    px[..., 3] = np.where(opaque, 255, px[..., 3])
    return px


def _palette(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return pal[(np.arange(W)[None] // 5 + np.arange(H)[:, None] // 3 + rng.integers(0, 2, (H, W))) % n]


def _file(segs, tags, *, extra=None, drop=(), **kw) -> bytes:
    tags = dict(tags)
    tags.update(extra or {})
    for t in drop:
        tags.pop(t, None)
    return tiff_bytes(segs, tags, **kw)


def _pil(**kw):
    return lambda b: webp_pil(np.ascontiguousarray(b), **kw)


def _tool(enc, **kw):
    return lambda b: enc(b, **kw)


def _damaged(px, encode, damage, *, rps=37) -> bytes:
    segs, tags = webp_layout(px, encode, rps=rps)
    return _file(damage(segs), tags)


def _retag_count(data: bytes, index: int, value: int, tag: int = 279) -> bytes:
    """Rewrite one entry of a classic little-endian file's StripByteCounts
    (or StripOffsets, tag 273)."""
    data = bytearray(data)
    ifd = struct.unpack("<I", data[4:8])[0]
    for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * k
        t, typ, count = struct.unpack("<HHI", data[e:e + 8])
        if t == tag:
            at = struct.unpack("<I", data[e + 8:e + 12])[0] if count * 4 > 4 else e + 8
            data[at + 4 * index:at + 4 * index + 4] = struct.pack("<I", value)
            return bytes(data)
    raise AssertionError(f"no tag {tag}")


def _flip(seed: int):
    """Segments with one seeded byte flipped in a seeded segment."""
    def damage(segs):
        rng = np.random.default_rng(seed)
        i = int(rng.integers(0, len(segs)))
        s = bytearray(segs[i])
        at = int(rng.integers(12, len(s)))
        s[at] ^= int(rng.integers(1, 256))
        return [bytes(s) if k == i else x for k, x in enumerate(segs)]
    return damage


def _other_size(dh: int, dw: int):
    """The second strip's stream dh rows and dw columns off its strip's."""
    def damage(segs, px):
        block = px[37:74]
        h, w = block.shape[:2]
        grown = np.zeros((h + max(dh, 0), w + max(dw, 0), block.shape[2]), np.uint8)
        grown[:h, :w] = block
        segs = list(segs)
        segs[1] = webp_pil(np.ascontiguousarray(grown[:h + dh, :w + dw]), quality=85)
        return segs
    return damage


# name: (writer(enc) -> TIFF bytes, route)
CASES = {
    # PIL's encoder, strips of 37 rows (the last 9)
    "lossy_q10_m0": (lambda e: _file(*webp_layout(image(1, H, W), _pil(quality=10, method=0), rps=37)), "tiff"),
    "lossy_q50_m4": (lambda e: _file(*webp_layout(image(2, H, W), _pil(quality=50, method=4), rps=37)), "tiff"),
    "lossy_q90_m6": (lambda e: _file(*webp_layout(image(3, H, W), _pil(quality=90, method=6), rps=37)), "tiff"),
    "lossy_q100_m2": (lambda e: _file(*webp_layout(image(4, H, W), _pil(quality=100, method=2), rps=37)), "tiff"),
    "lossless_m0": (lambda e: _file(*webp_layout(image(5, H, W), _pil(lossless=True, method=0), rps=37)), "tiff"),
    "lossless_m3": (lambda e: _file(*webp_layout(image(6, H, W), _pil(lossless=True, method=3), rps=37)), "tiff"),
    "lossless_m6_one_strip": (lambda e: _file(*webp_layout(image(7, H, W), _pil(lossless=True, method=6), rps=H)),
                              "tiff"),
    # colour indexing: 2, 4 and 16 colours bundle 8, 4 and 2 pixels a byte
    "palette_2": (lambda e: _file(*webp_layout(_palette(2, 8), _pil(lossless=True), rps=37)), "tiff"),
    "palette_4": (lambda e: _file(*webp_layout(_palette(4, 9), _pil(lossless=True), rps=37)), "tiff"),
    "palette_16": (lambda e: _file(*webp_layout(_palette(16, 10), _pil(lossless=True), rps=37)), "tiff"),
    "palette_200": (lambda e: _file(*webp_layout(_palette(200, 11), _pil(lossless=True), rps=37)), "tiff"),
    # RGBA, unassociated alpha (ExtraSamples 2)
    "rgba_lossy": (lambda e: _file(*webp_layout(_rgba(12), _pil(quality=70), rps=37)), "tiff"),
    "rgba_lossless": (lambda e: _file(*webp_layout(_rgba(13), _pil(lossless=True), rps=37)), "tiff"),
    # libwebp's coding tools through WebPConfig
    "simple_filter": (lambda e: _file(*webp_layout(image(14, H, W), _tool(e, filter_type=0, filter_strength=50))),
                      "tiff"),
    "filter_level_0": (lambda e: _file(*webp_layout(image(15, H, W), _tool(e, filter_strength=0))), "tiff"),
    "sharpness_7": (lambda e: _file(*webp_layout(image(16, H, W), _tool(e, filter_strength=100, sharpness=7))),
                    "tiff"),
    "partitions_2": (lambda e: _file(*webp_layout(image(17, H, W), _tool(e, partitions=1))), "tiff"),
    "partitions_4": (lambda e: _file(*webp_layout(image(18, H, W), _tool(e, partitions=2))), "tiff"),
    "partitions_8": (lambda e: _file(*webp_layout(image(19, H, W), _tool(e, partitions=3, quality=95))), "tiff"),
    "segments_1": (lambda e: _file(*webp_layout(image(20, H, W), _tool(e, segments=1))), "tiff"),
    "segments_4_q30": (lambda e: _file(*webp_layout(image(21, H, W), _tool(e, segments=4, quality=30))), "tiff"),
    "alph_raw": (lambda e: _file(*webp_layout(_rgba(22), _tool(e, alpha_compression=0))), "tiff"),
    "alph_lossless_best": (lambda e: _file(*webp_layout(_rgba(23), _tool(e, alpha_filtering=2))), "tiff"),
    "alph_quality_30": (lambda e: _file(*webp_layout(_rgba(24), _tool(e, alpha_quality=30))), "tiff"),
    # ALPH built here: each prediction filter, raw and VP8L-coded, with
    # libwebp's pre-processing bit (no dithering at strength 0)
    **{f"alph_m{m}_filter{f}": (
        lambda e, m=m, f=f: _file(*webp_layout(_rgba(25 + f), lambda b: webp_with_alph(
            np.ascontiguousarray(b[..., :3]), np.ascontiguousarray(b[..., 3]), method=m, filt=f, pre=f & 1),
            rps=37)), "tiff") for m in (0, 1) for f in (1, 2, 3)},
    # tiles, ragged at the image's edges
    "tiles_256_lossy": (lambda e: _file(*webp_layout(image(30, 300, 380), _pil(quality=75), tile=(256, 256)),
                                        tiled=True), "tiff"),
    "tiles_512_lossless": (lambda e: _file(*webp_layout(image(31, 530, 300), _pil(lossless=True, method=1),
                                                        tile=(512, 512)), tiled=True), "tiff"),
    "tiles_256_rgba": (lambda e: _file(*webp_layout(_rgba(32, 270, 260), _pil(quality=60), tile=(256, 256)),
                                       tiled=True), "tiff"),
    # four samples under each ExtraSamples value, and none; three samples
    # from a stream with alpha; four from one without
    "rgba_extrasamples_0": (lambda e: _file(*webp_layout(_rgba(33), _pil(quality=70)), extra={338: (3, [0])}), "tiff"),
    "rgba_extrasamples_1": (lambda e: _file(*webp_layout(_rgba(34), _pil(quality=70)), extra={338: (3, [1])}), "tiff"),
    "rgba_no_extrasamples": (lambda e: _file(*webp_layout(_rgba(35), _pil(lossless=True)), drop=(338,)), "tiff"),
    "rgb_tags_stream_with_alpha": (lambda e: _file(*webp_layout(_rgba(36), _pil(quality=70)), drop=(338,),
                                                   extra={277: (3, [3]), 258: (3, [8] * 3)}), "tiff"),
    "rgba_tags_stream_without_alpha": (lambda e: _file(*webp_layout(image(37, H, W), _pil(quality=70)),
                                                       extra={277: (3, [4]), 258: (3, [8] * 4), 338: (3, [2])}),
                                       "tiff"),
    # layouts libtiff refuses or reads oddly
    "refused_one_sample": (lambda e: _file(*webp_layout(image(38, H, W), _pil(lossless=True)),
                                           extra={277: (3, [1]), 258: (3, [8]), 262: (3, [1])}), "skipped"),
    "refused_16bit_signed": (lambda e: _file(*webp_layout(image(39, H, W), _pil(quality=70)),
                                             extra={258: (3, [16] * 3), 339: (3, [2] * 3)}), "skipped"),
    "refused_wider_than_16383": (lambda e: _file(*webp_layout(np.zeros((2, 16400, 3), np.uint8),
                                                              lambda b: webp_pil(np.ascontiguousarray(b[:, :16383]),
                                                                                 lossless=True), rps=2)),
                                 "skipped"),
    "16bit_reads_black": (lambda e: _file(*webp_layout(image(40, H, W), _pil(quality=70)),
                                          extra={258: (3, [16] * 3)}), "tiff"),
    "planar_segments": (lambda e: _file(*webp_layout(image(41, H, W), _pil(quality=70), rps=36),
                                        extra={284: (3, [2])}), "tiff"),
    "signed_8bit": (lambda e: _file(*webp_layout(image(42, H, W), _pil(quality=70)), extra={339: (3, [2] * 3)}),
                    "tiff"),
    # damaged segments
    "cut_lossy_half": (lambda e: _damaged(image(43, H, W), _pil(quality=80),
                                          lambda s: [x[:len(x) // 2] if k == 1 else x for k, x in enumerate(s)]),
                       "tiff"),
    "cut_lossless_80": (lambda e: _damaged(image(44, H, W), _pil(lossless=True), lambda s: [
        x[:len(x) * 4 // 5] if k == 2 else x for k, x in enumerate(s)], rps=60), "tiff"),
    "cut_alpha_in_vp8": (lambda e: _damaged(_rgba(45), _pil(quality=80), lambda s: [
        x[:len(x) - 40] if k == 1 else x for k, x in enumerate(s)]), "tiff"),
    "cut_first_header": (lambda e: _damaged(image(46, H, W), _pil(quality=80),
                                            lambda s: [s[0][:30]] + s[1:]), "tiff"),
    "cut_first_partition": (lambda e: _damaged(image(47, H, W), _tool(e, partitions=2),
                                               lambda s: [s[0][:len(s[0]) - 100]] + s[1:]), "tiff"),
    **{f"flip_{seed}": (lambda e, seed=seed: _damaged(_rgba(48) if seed % 2 else image(48, H, W),
                                                      _pil(quality=75) if seed % 3 else _pil(lossless=True),
                                                      _flip(seed)), "tiff") for seed in range(6)},
    "not_webp": (lambda e: _damaged(image(49, H, W), _pil(quality=80),
                                    lambda s: [s[0], b"RIFF not a webp stream at all"] + s[2:]), "tiff"),
    "empty_second": (lambda e: _retag_count(_damaged(image(50, H, W), _pil(quality=80), lambda s: s), 1, 0), "tiff"),
    "offset_past_end": (lambda e: _retag_count(_damaged(image(51, H, W), _pil(quality=80), lambda s: s), 2,
                                               10 ** 7, tag=273), "tiff"),
    "count_shorter_than_stream": (lambda e: _retag_count(
        _damaged(image(52, H, W), _pil(lossless=True), lambda s: s), 1, 300), "tiff"),
    "trailing_bytes": (lambda e: _damaged(image(53, H, W), _pil(quality=80),
                                          lambda s: [x + bytes(range(100)) for x in s]), "tiff"),
    **{f"stream_{name}": (lambda e, dh=dh, dw=dw: (lambda px: _damaged(px, _pil(quality=85), lambda s: _other_size(
        dh, dw)(s, px)))(image(54, H, W)), "tiff")
       for name, dh, dw in (("shorter", -5, 0), ("taller", 5, 0), ("narrower", 0, -9), ("wider", 0, 9))},
}


def write_case(name: str, d, enc) -> str:
    path = d / f"{PREFIX}_{list(CASES).index(name)}_0_0.tif"
    path.write_bytes(CASES[name][0](enc))
    return str(path)


@pytest.mark.parametrize("name", list(CASES))
def test_webp_tiff_gives_libtiffs_pixels(name, tmp_path, jn, enc):
    """decode_image on the CPU == the JAX native loader's pixels through
    libtiff and libwebp, byte for byte (or both skip the file), and the
    file takes the route stated for it."""
    path = write_case(name, tmp_path, enc)
    assert ROUTE_NAMES[int(native_loader.probe(path)[jpeg_plain.T_ROUTE])] == CASES[name][1]
    want = jn.decode_image(path)
    got = native_loader.decode_image(path, "cpu")
    if want is None:
        assert got is None
        return
    assert got is not None
    np.testing.assert_array_equal(got.numpy(), want)


def test_webp_codec_alone_gives_the_stream():
    """aq_tiff_codec(50001) on one lossless stream gives its pixels, RGB and
    RGBA; a stream cut short does not fill the segment."""
    px = image(60, 40, 56, 4)
    stream = webp_pil(px, lossless=True)
    lib = native_loader.build()
    for ch in (3, 4):
        out = np.zeros(px[..., :ch].size, np.uint8)
        buf = ctypes.create_string_buffer(stream, len(stream))
        assert lib.aq_tiff_codec(50001, ctypes.cast(buf, ctypes.c_void_p), len(stream), out.ctypes.data, out.size) == 1
        np.testing.assert_array_equal(out.reshape(40, 56, ch), px[..., :ch])
    out = np.zeros(px.size, np.uint8)
    cut = stream[:len(stream) // 2]
    buf = ctypes.create_string_buffer(cut, len(cut))
    assert lib.aq_tiff_codec(50001, ctypes.cast(buf, ctypes.c_void_p), len(cut), out.ctypes.data, out.size) == 0


def _tiles(batches) -> Counter:
    out = Counter()
    for b in batches:
        images = b.images.numpy() if hasattr(b.images, "numpy") else np.asarray(b.images)
        for img, ok in zip(images, np.asarray(b.valid)):
            if ok:
                out[img.tobytes()] += 1
    return out


def test_webp_tiffs_in_a_corpus_take_the_tiff_route(tmp_path, jn, enc):
    """native_tile_batches over JPEG, a Deflate TIFF, lossy, lossless and
    RGBA WebP TIFFs and a damaged one gives the JAX native loader's tiles as
    a multiset; the WebP files count as "tiff", none goes to PIL, and the
    run reaches its end (the parent's PIL route raised on the first)."""
    names = ["lossy_q50_m4", "lossless_m3", "rgba_lossy", "tiles_256_lossy", "cut_lossy_half"]
    paths = [write_case(n, tmp_path, enc) for n in names]
    paths.append(write_tiff_case("pil_deflate", tmp_path))
    jpg = tmp_path / f"{PREFIX}_900_0_0.jpg"
    Image.fromarray(image(61, 256, 384)).save(jpg, quality=90)
    paths.append(str(jpg))
    launches = jpeg_cuda.decode_launches
    counts = {}
    got = _tiles(native_loader.native_tile_batches(paths, batch_size=4, tile=128, device="cpu", counts=counts))
    want = _tiles(jn.native_tile_batches(paths, batch_size=4, tile=128))
    assert got == want and sum(got.values()) > len(paths)
    assert counts == {"device": 1, "tiff": 6, "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 0}
    assert jpeg_cuda.decode_launches == launches
