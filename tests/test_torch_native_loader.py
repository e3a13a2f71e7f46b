"""The port's device tile loader (data/native_loader.py) against the JAX
package's native loader (data/native_loader.py over native/libaquatile.so).

On the CPU the loader runs the host entropy decode and the plain versions
of its kernels, so its tiles can be held to libjpeg-turbo's byte for byte
(tolerance 0): the same tile keys and bytes as the JAX package's
``native_tile_batches`` on a mixed corpus (1024 and 2048 px JPEG rasters,
progressive ones, a TIFF, a TIFF named .jpg, a corrupt .jpg), at full size
and at every N/8 of the tile; ``decode_image_scaled`` and the tile
batches at every N/8 for each sampling, restart intervals and an odd size,
and for progressive (spectral selection alone, and with successive
approximation) and multi-scan sequential files. The JAX loader's tile
order varies from run to run, so the comparison is by tile key; the
port's order is the Python loader's. Also: the JPEG processes added since
(RGB-coded; luma sampled 4x1, 4x2, 3x1 and 1x4; arithmetic sequential
with restarts and arithmetic progressive; progressive files whose scans
stop short, which libjpeg smooths: DC and AC, AC only, DC only) at full
size and every N/8; files routed and counted by content (TIFF to PIL with
libtiff's pixels, JPEGs that libjpeg refuses and the corrupt file skipped,
as the JAX loader skips them), routed rasters no larger than a slot
zero-padded into it, an early close that does not hang,
``detect_files(use_native=True)`` and ``detect_files(decode_scale=True)``
against the JAX package's, and the accuracy harness on the device loader.
"""

import struct
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data import jpeg_cuda, loader as tloader, native_loader
from aquaculture_tpu_torch.pipeline import PipelineStats, detect_files
from torch_jax_native import (FEED_FIXTURES, FIXTURES, fixture_image, jax_native_loader, libjpeg_writer,
                              write_feed_fixtures, write_jpeg)

REPO = Path(__file__).resolve().parent.parent
PREFIX = "ORTHOIMAGERY.ORTHOPHOTOS2019"


def aerial(rng, h, w):
    coarse = rng.integers(0, 255, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    img = img + rng.integers(-10, 11, (h, w, 3), dtype=np.int16)
    img[200:400, 300:600] = 235
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Tile-codec-named files: JPEG rasters of 2048 (4:2:0) and 1024 px
    (4:4:4, restart intervals), a 1000 x 750 JPEG, a TIFF, a TIFF named
    .jpg, a corrupt .jpg, a 1000 x 750 TIFF, progressive JPEGs of 1024 and
    1000 x 750 px and, apart, an LZW TIFF of 1000 x 750; and the JAX native
    loader
    (``jax_native_loader``: None if it does not build here)."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    files = {}

    def save(key, name, h, w, **kw):
        p = d / f"{PREFIX}_{name}"
        Image.fromarray(aerial(rng, h, w)).save(p, **kw)
        files[key] = str(p)

    save("raster", "1_0_0.jpg", 2048, 2048, quality=90)
    save("tile444", "2_1024_0.jpg", 1024, 1024, quality=85, subsampling=0)
    save("restart", "3_0_1024.jpeg", 1024, 1024, quality=90, restart_marker_blocks=9)
    save("small", "4_0_0.jpg", 750, 1000, quality=90)
    save("tiff", "5_0_0.tif", 1024, 2048)
    save("tiff_as_jpg", "6_0_0.jpg", 1024, 1024, format="TIFF")
    save("progressive", "7_0_0.jpg", 1024, 1024, quality=90, progressive=True)
    save("small_tiff", "9_0_0.tif", 750, 1000)
    save("small_progressive", "10_0_0.jpg", 750, 1000, quality=90, progressive=True)
    save("small_tiff_lzw", "11_0_0.tif", 750, 1000, compression="tiff_lzw")
    corrupt = d / f"{PREFIX}_8_0_0.jpg"
    # a JFIF header and then no marker: neither decoder finds a frame
    junk = np.random.default_rng(0).integers(0, 255, 4000, dtype=np.uint8).tobytes()  # no 0xFF byte
    corrupt.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00" + junk)
    files["corrupt"] = str(corrupt)
    return files, jax_native_loader()


MIXED = ("raster", "tile444", "restart", "small", "tiff", "tiff_as_jpg", "corrupt", "small_tiff", "progressive",
         "small_progressive")


def _key(s):
    return (s.year, s.bbox_ind, s.x_offset, s.y_offset, s.layer)


def _by_key(batches):
    out = {}
    for b in batches:
        images = b.images.numpy() if isinstance(b.images, torch.Tensor) else b.images
        for img, spec, v in zip(images, b.specs, b.valid):
            if v:
                out[_key(spec)] = img.copy()
    return out


@pytest.mark.parametrize("out_tile", [0, 128, 256, 384, 512, 640, 768, 896])
def test_native_tile_batches_equal_jax_native_loader(corpus, out_tile):
    files, jn = corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    paths = [files[k] for k in MIXED]
    counts = {}
    batches = list(native_loader.native_tile_batches(paths, batch_size=3, tile=1024, out_tile=out_tile,
                                                     device="cpu", counts=counts))
    got = _by_key(batches)
    want = _by_key(jn.native_tile_batches(paths, batch_size=3, tile=1024, out_tile=out_tile))
    assert sorted(got) == sorted(want) and len(got) == 4 + 1 + 1 + 1 + 2 + 1 + 1 + 1 + 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    eff = out_tile or 1024
    assert all(b.images.shape == (3, eff, eff, 3) and b.images.dtype == torch.uint8 for b in batches)
    # files in path order, each raster's tiles x-major; the tail batch padded with zeros
    assert [_key(s)[1:4] for b in batches for s in b.specs if s][:5] == [
        (1, 0, 0), (1, 0, 1024), (1, 1024, 0), (1, 1024, 1024), (2, 1024, 0)]
    tail = batches[-1]
    assert tail.valid.tolist() == [True, False, False] and (tail.images[1:] == 0).all()
    assert counts == {"device": 6, "tiff": 0 if out_tile else 3, "tiff_jpeg": 0, "pil": 0,
                      "pil_resize": 3 if out_tile else 0, "skipped": 1}


@pytest.mark.parametrize("out_tile", [0, 640])
def test_routed_rasters_no_larger_than_a_slot_are_zero_padded(corpus, out_tile):
    """Two TIFFs of 1000 x 750 (625 x 469 at 5/8), through the TIFF reader
    at full size and PIL's resize at 5/8, fill one zero-padded slot each,
    as in the Python loader's batches."""
    files, _ = corpus
    paths = [files["small_tiff"], files["small_tiff_lzw"]]
    counts = {}
    got = list(native_loader.native_tile_batches(paths, batch_size=2, tile=1024, out_tile=out_tile,
                                                 device="cpu", counts=counts))
    want = list(tloader.tile_batches(paths, batch_size=2, tile=1024, out_tile=out_tile, decode_threads=1))
    assert len(got) == len(want) == 1
    eff = out_tile or 1024
    assert got[0].images.shape == (2, eff, eff, 3) and torch.equal(got[0].images, want[0].images)
    assert [_key(s) for s in got[0].specs] == [_key(s) for s in want[0].specs]
    assert counts == {"device": 0, "tiff": 0 if out_tile else 2, "tiff_jpeg": 0, "pil": 0,
                      "pil_resize": 2 if out_tile else 0, "skipped": 0}


def test_full_size_tiles_equal_the_python_loader(corpus):
    """At 8/8 the device loader's batches are the Python loader's, batch
    for batch, where both slice the same grid."""
    files, _ = corpus
    paths = [files[k] for k in ("raster", "tile444", "restart", "tiff")]
    got = list(native_loader.native_tile_batches(paths, batch_size=4, tile=1024, device="cpu"))
    want = list(tloader.tile_batches(paths, batch_size=4, tile=1024, decode_threads=1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert torch.equal(g.images, w.images)
        assert [_key(s) if s else None for s in g.specs] == [_key(s) if s else None for s in w.specs]
        np.testing.assert_array_equal(g.valid, w.valid)


def _unfinished_progressive(path: str, out: Path) -> str:
    """The first five scans of a PIL progressive JPEG (jpeg_simple_progression:
    DC and AC bands with their low bits still to come), then EOI: an
    interrupted progressive download."""
    data = Path(path).read_bytes()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    out.write_bytes(data[:sos[5]] + b"\xff\xd9")
    return str(out)


def test_interrupted_progressive_jpeg_takes_the_device_route_and_is_counted(corpus, tmp_path):
    """A progressive JPEG whose scans leave AC coefficients 1..9 short of
    their last bits (an interrupted download): the entropy decoder smooths
    its blocks as libjpeg-turbo 2.1.5's jdcoefct.c does, so it takes the
    device route and is counted there, and its tile equals the JAX native
    loader's (PIL's newer libjpeg-turbo smooths otherwise)."""
    files, jn = corpus
    path = _unfinished_progressive(files["progressive"], tmp_path / f"{PREFIX}_12_0_0.jpg")
    meta = native_loader.probe(path)
    assert meta[0] == native_loader.KIND_BASELINE and meta[1:3].tolist() == [1024, 1024]
    counts = {}
    (batch,) = native_loader.native_tile_batches([path, files["corrupt"]], batch_size=2, tile=1024,
                                                 device="cpu", counts=counts)
    assert counts == {"device": 1, "tiff": 0, "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 1}
    assert batch.valid.tolist() == [True, False]
    if jn is not None:
        np.testing.assert_array_equal(batch.images[0].numpy(), jn.decode_image(path))
    assert native_loader.decode_image(files["corrupt"], "cpu") is None


def test_progressive_sizes_reach_the_metadata(corpus):
    """A progressive JPEG's frame size is read from its SOF2, so
    decode_image_scaled takes libjpeg's scale: 640 px from 1024 at target
    640, not the full size."""
    files, jn = corpus
    path = files["progressive"]
    meta = native_loader.probe(path)
    assert meta[0] == native_loader.KIND_BASELINE and meta[1:3].tolist() == [1024, 1024]
    got = native_loader.decode_image_scaled(path, 640, "cpu")
    assert tuple(got.shape) == (640, 640, 3)
    if jn is not None:
        np.testing.assert_array_equal(got.numpy(), jn.decode_image_scaled(path, 640))


def test_decode_image_equals_jax(corpus):
    files, jn = corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    for key in ("raster", "small", "tiff", "progressive", "small_progressive"):
        np.testing.assert_array_equal(native_loader.decode_image(files[key], "cpu").numpy(),
                                      jn.decode_image(files[key]))
    for key, target in (("tile444", 640), ("small", 625), ("tiff", 640), ("tile444", 384),
                        ("small_progressive", 250), ("progressive", 896)):
        np.testing.assert_array_equal(native_loader.decode_image_scaled(files[key], target, "cpu").numpy(),
                                      jn.decode_image_scaled(files[key], target))


@pytest.mark.parametrize("img", [384, 512])
def test_detect_files_decode_scale_takes_the_device_loader(corpus, img):
    """detect_files(decode_scale=True) at 3/8 and 4/8 of 1024 px tiles
    takes the device loader by default, as the JAX package takes its
    native loader: its tiles are the JAX native loader's, and its rows
    the JAX package's detect_files (f32, the n model at seed 7) within
    the f32 serving programs' tolerance (boxes within a pixel after
    truncation, confidences 1e-5)."""
    from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
    from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
    from aquaculture_tpu.pipeline import detect_files as jax_detect_files
    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    files, jn = corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    paths = [files["raster"], files["progressive"]]
    got = _by_key(native_loader.native_tile_batches(paths, batch_size=5, tile=1024, out_tile=img, device="cpu"))
    want = _by_key(jn.native_tile_batches(paths, batch_size=5, tile=1024, out_tile=img))
    assert sorted(got) == sorted(want) and len(got) == 5
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jmodel, jparams = jax_init("n", num_classes=5, seed=7)
    model, params = yolov5_init("n", num_classes=5, seed=7)
    load_jax_params(model, params)
    kw = dict(img_size=img, conf_threshold=3e-5, max_detections=50, dtype="float32")
    jb, jc, jk, jspecs, jstats = jax_detect_files(paths, jmodel, jmodel.fuse(jparams), JaxDetectConfig(**kw),
                                                  batch_size=5, decode_scale=True)
    jpeg_cuda.decode_launches = 0
    tb, tc, tk, tspecs, stats = detect_files(paths, model, DetectConfig(**kw), batch_size=5, device="cpu",
                                             decode_scale=True)
    assert stats.loader == "device" and stats.tiles == 5 and jstats.tiles == 5
    assert stats.files == {"device": 2, "tiff": 0, "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 0}
    assert jpeg_cuda.decode_launches == 0  # the CPU path never touches the kernel

    def rows(b, c, k, specs):
        order = sorted(range(len(c)), key=lambda i: (_key(specs[i]), -c[i], tuple(b[i])))
        return [(_key(specs[i]), b[i], c[i], k[i]) for i in order]

    g, w = rows(tb, tc, tk, tspecs), rows(jb, jc, jk, jspecs)
    assert len(g) == len(w) > 0
    for (gs, gb, gc, gk), (ws, wb, wc, wk) in zip(g, w):
        assert gs == ws and gk == wk
        assert np.abs(gb - wb).max() <= 1 and abs(gc - wc) <= 1e-5
    if not torch.cuda.is_available():  # no CPU fallback for a CUDA request
        with pytest.raises(RuntimeError, match="device='cpu'"):
            native_loader.native_tile_batches([files["tile444"]], device="cuda")


# (name, (height, width), PIL save options, "gray", "440" through OpenCV, or
# (libjpeg writer mode, restart rows, luma sampling; None for grey))
SCALE_CASES = (
    ("420", (512, 1024), dict(quality=90)),
    ("422", (512, 1024), dict(quality=90, subsampling=1)),
    ("440", (512, 1024), "440"),
    ("444", (512, 1024), dict(quality=85, subsampling=0)),
    ("gray", (512, 1024), "gray"),
    ("restart", (512, 1024), dict(quality=90, restart_marker_blocks=11)),
    ("1000x750", (750, 1000), dict(quality=90)),
    ("progressive", (512, 1024), dict(quality=90, progressive=True)),
    ("spectral", (512, 1024), ("spectral", 0, (2, 2))),
    ("spectral_422_restart", (512, 1024), ("spectral", 1, (2, 1))),
    ("multiscan", (512, 1024), ("multiscan", 0, (2, 2))),
    ("multiscan_gray", (512, 1024), ("multiscan", 0, None)),
)
EVERY_SCALE = ("420", "422", "440", "444", "gray", "restart", "1000x750")
PROGRESSIVE = ("progressive", "spectral", "spectral_422_restart", "multiscan", "multiscan_gray")


@pytest.fixture(scope="module")
def scale_corpus(tmp_path_factory):
    """One JPEG per case of ``SCALE_CASES``: 1024 x 512 rasters (two 512 px
    tiles) and a 1000 x 750 one; the progressive and multi-scan files
    through libjpeg's own encoder (``torch_jax_native.WRITER``; absent if
    it does not build here); and the JAX native loader."""
    d = tmp_path_factory.mktemp("scales")
    rng = np.random.default_rng(15)
    writer = libjpeg_writer(d)
    files = {}
    for i, (name, (h, w), how) in enumerate(SCALE_CASES):
        img = aerial(rng, h, w)
        p = d / f"{PREFIX}_{i + 1}_0_0.jpg"
        if how == "gray":
            Image.fromarray(img[..., 1]).save(p, quality=90)
        elif how == "440":
            cv2.imwrite(str(p), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
        elif isinstance(how, tuple):
            if writer is None:
                continue
            mode, restart_rows, luma = how
            write_jpeg(writer, img if luma else img[..., 1], p, mode, 90, restart_rows, luma or (1, 1))
        else:
            Image.fromarray(img).save(p, **how)
        files[name] = str(p)
    return files, jax_native_loader()


def _scale_case(scale_corpus, name):
    files, jn = scale_corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    if name not in files:
        pytest.skip("the libjpeg writer does not build here")
    return files[name], jn


def _equal_jax_at(path, jn, scale, tile=None):
    """decode_image_scaled and native_tile_batches at scale/8 against the
    JAX native loader: tiles of ``tile`` px (default 512, and 1024 for the
    1000 x 750 raster), out_tile its scale/8."""
    w, h = native_loader.probe(path)[1:3].tolist()
    if scale == 8:
        got, want = native_loader.decode_image(path, "cpu").numpy(), jn.decode_image(path)
    else:
        target = max(w, h) * scale // 8
        got = native_loader.decode_image_scaled(path, target, "cpu").numpy()
        want = jn.decode_image_scaled(path, target)
    assert got.shape == want.shape == (-(-h * scale // 8), -(-w * scale // 8), 3)
    np.testing.assert_array_equal(got, want)
    tile = tile or (1024 if w == 1000 else 512)
    out_tile = 0 if scale == 8 else tile * scale // 8
    counts = {}
    got = _by_key(native_loader.native_tile_batches([path], batch_size=2, tile=tile, out_tile=out_tile, device="cpu",
                                                    counts=counts))
    want = _by_key(jn.native_tile_batches([path], batch_size=2, tile=tile, out_tile=out_tile))
    assert sorted(got) == sorted(want) and len(got) == len(native_loader.tile_grid(w, h, tile))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert counts["device"] == 1


@pytest.mark.parametrize("scale", range(1, 8))
@pytest.mark.parametrize("name", EVERY_SCALE)
def test_every_scale_equals_jax_native_loader(scale_corpus, name, scale):
    """Each sampling, restart intervals and an odd size at every proper
    N/8: the whole image (``decode_image_scaled``) and the tile batches
    equal the JAX native loader's, byte for byte."""
    _equal_jax_at(*_scale_case(scale_corpus, name), scale)


@pytest.mark.parametrize("scale", [8, 5, 4])
@pytest.mark.parametrize("name", PROGRESSIVE)
def test_progressive_and_multi_scan_equal_jax_native_loader(scale_corpus, name, scale):
    """Progressive JPEG by spectral selection alone (4:2:0, and 4:2:2 with
    a restart interval) and with successive approximation (PIL's
    progressive=True), and sequential JPEG in one scan per component, go
    through the entropy decoder and the kernel's plain version, equal to
    the JAX native loader at 8/8, 5/8 and 4/8."""
    path, jn = _scale_case(scale_corpus, name)
    meta = native_loader.probe(path)
    assert meta[0] == native_loader.KIND_BASELINE
    assert meta[12] == (0xC0 if name.startswith("multiscan") else 0xC2)
    _equal_jax_at(path, jn, scale)


def _hand_made(kind: str, path: Path) -> str:
    """An 8 x 8 grey JPEG of flat 128, written byte by byte: "12bit"
    (extended sequential at 12 bits) or "lossless" (SOF3, predictor 1),
    every difference coded as category 0 by a one-code Huffman table."""
    def seg(m, body):
        return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body

    dc = seg(0xC4, bytes([0x00, 1] + [0] * 15 + [0]))
    if kind == "12bit":
        body = (seg(0xDB, bytes([0] + [1] * 64)) + dc + seg(0xC4, bytes([0x10, 1] + [0] * 15 + [0])) +
                seg(0xC1, bytes([12]) + struct.pack(">HH", 8, 8) + bytes([1, 1, 0x11, 0])) +
                seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0])) + b"\x00")
    else:
        body = (dc + seg(0xC3, bytes([8]) + struct.pack(">HH", 8, 8) + bytes([1, 1, 0x11, 0])) +
                seg(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + b"\x00" * 8)
    path.write_bytes(b"\xff\xd8" + body + b"\xff\xd9")
    return str(path)


def test_other_jpeg_processes_keep_their_route(corpus, tmp_path):
    """Arithmetic coding, CMYK, 12-bit and lossless JPEG are routed by
    their markers as the JAX native loader's libjpeg-turbo 2.1.5 takes
    them: arithmetic to the device route, equal to the JAX loader; CMYK,
    12-bit and lossless refused (kind REFUSED, with the frame's size and
    SOF), so decode_image and decode_image_scaled give None, as the JAX
    loader does, and nothing raises (the 12-bit file raised PIL's error)."""
    files, jn = corpus
    writer = libjpeg_writer(tmp_path)
    img = aerial(np.random.default_rng(4), 96, 128)
    paths = {"12bit": _hand_made("12bit", tmp_path / "p12.jpg"),
             "lossless": _hand_made("lossless", tmp_path / "ll.jpg")}
    Image.fromarray(np.concatenate([img, img[..., :1]], -1), "CMYK").save(tmp_path / "cmyk.jpg", quality=90)
    paths["cmyk"] = str(tmp_path / "cmyk.jpg")
    if writer is not None:
        paths["arith"] = write_jpeg(writer, img, tmp_path / "arith.jpg", "arith")
    sizes = {"12bit": [8, 8], "lossless": [8, 8], "cmyk": [128, 96], "arith": [128, 96]}
    sofs = {"12bit": 0xC1, "lossless": 0xC3, "cmyk": 0xC0, "arith": 0xC9}
    for name, path in paths.items():
        meta = native_loader.probe(path)
        kind = native_loader.KIND_BASELINE if name == "arith" else native_loader.KIND_REFUSED
        assert meta[0] == kind and meta[1:3].tolist() == sizes[name], name
        assert meta[12] == sofs[name], name
    for name in ("12bit", "lossless", "cmyk"):
        assert native_loader.decode_image(paths[name], "cpu") is None, name
        assert native_loader.decode_image_scaled(paths[name], 4, "cpu") is None, name
    if jn is None:
        return
    for name in ("12bit", "lossless", "cmyk"):
        assert jn.decode_image(paths[name]) is None, name
    if "arith" in paths:
        np.testing.assert_array_equal(native_loader.decode_image(paths["arith"], "cpu").numpy(),
                                      jn.decode_image(paths["arith"]))


def _hierarchical(path: str, out: Path) -> str:
    """A baseline JPEG with its SOF0 made SOF5 (differential sequential,
    hierarchical): a process libjpeg-turbo refuses."""
    data = bytearray(Path(path).read_bytes())
    data[data.index(b"\xff\xc0") + 1] = 0xC5
    out.write_bytes(bytes(data))
    return str(out)


@pytest.mark.parametrize("out_tile", [0, 128])
def test_refused_jpegs_are_skipped_in_a_mixed_corpus(tmp_path, out_tile):
    """One good 256 px JPEG tile beside 12-bit, CMYK, lossless and
    hierarchical JPEGs (which libjpeg-turbo 2.1.5 refuses) and a TIFF, at
    256 px tiles: the device loader serves the JAX native loader's tiles,
    valid masks at full size, counts the four JPEGs skipped and only the
    file that is not a JPEG under the TIFF reader (PIL's resize at scale),
    and raises nothing."""
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    rng = np.random.default_rng(6)
    good = tmp_path / f"{PREFIX}_1_0_0.jpg"
    Image.fromarray(aerial(rng, 256, 256)).save(good, quality=90)
    cmyk = tmp_path / f"{PREFIX}_3_0_0.jpg"
    Image.fromarray(np.concatenate([aerial(rng, 96, 128)] * 2, -1)[..., :4], "CMYK").save(cmyk, quality=90)
    tiff = tmp_path / f"{PREFIX}_6_0_0.tif"
    Image.fromarray(aerial(rng, 256, 256)).save(tiff)
    paths = [str(good), _hand_made("12bit", tmp_path / f"{PREFIX}_2_0_0.jpg"), str(cmyk),
             _hand_made("lossless", tmp_path / f"{PREFIX}_4_0_0.jpg"),
             _hierarchical(str(good), tmp_path / f"{PREFIX}_5_0_0.jpg"), str(tiff)]
    def masks(batches):
        return [b.valid.tolist() for b in batches]

    # the good tile and the 12-bit file: one batch, one valid slot in both
    pair = dict(batch_size=4, tile=256, out_tile=out_tile)
    assert masks(native_loader.native_tile_batches(paths[:2], device="cpu", **pair)) == \
        masks(jn.native_tile_batches(paths[:2], **pair)) == [[True, False, False, False]]
    counts = {}
    got = list(native_loader.native_tile_batches(paths, batch_size=4, tile=256, out_tile=out_tile, device="cpu",
                                                 counts=counts))
    want = list(jn.native_tile_batches(paths, batch_size=4, tile=256, out_tile=out_tile))
    g, w = _by_key(got), _by_key(want)
    assert sorted(g) == sorted(w) and len(g) == 2
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    # the JAX loader's batches hold its tiles as its threads finish them
    assert masks(got) == [[True, True, False, False]] and sum(map(sum, masks(want))) == 2
    non_jpeg = sum(Path(p).read_bytes()[:2] != b"\xff\xd8" for p in paths)
    assert counts["skipped"] == 4 and counts["device"] == 1
    assert counts["tiff"] + counts["pil_resize"] == non_jpeg == 1 and counts["pil"] == 0


# The JPEG processes the device loader took on from PIL and from refusal:
# RGB-coded (PIL's keep_rgb, Adobe transform 0), luma sampled 4x1 (OpenCV's
# 4:1:1), 4x2, 3x1 and 1x4, arithmetic sequential with restarts and
# progressive, and progressive files interrupted (DC and AC short, AC
# short, DC alone), which libjpeg smooths: 384 x 256 each, the files of
# tests/data/torch_jpeg/ (torch_jax_native.FEED_FIXTURES) and three more
NEW_PROCESSES = ("rgb", "luma41", "luma42", *FEED_FIXTURES)


@pytest.fixture(scope="module")
def process_corpus(tmp_path_factory):
    """One JPEG per name of ``NEW_PROCESSES``, and the JAX native loader."""
    d = tmp_path_factory.mktemp("processes")
    files = {name: str(FIXTURES / f"{name}.jpg") for name in FEED_FIXTURES}
    img = fixture_image(20)
    Image.fromarray(img).save(d / "rgb.jpg", quality=90, keep_rgb=True, subsampling=0)
    cv2.imwrite(str(d / "luma41.jpg"), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    files.update(rgb=str(d / "rgb.jpg"), luma41=str(d / "luma41.jpg"))
    writer = libjpeg_writer(d)
    if writer is not None:
        files["luma42"] = write_jpeg(writer, img, d / "luma42.jpg", "plain", 90, 0, (4, 2))
    return files, jax_native_loader()


@pytest.mark.parametrize("scale", range(1, 9))
@pytest.mark.parametrize("name", NEW_PROCESSES)
def test_new_processes_equal_jax_native_loader_at_every_scale(process_corpus, name, scale):
    """Each new process through the entropy decoder and the kernel's plain
    version: decode_image (8/8), decode_image_scaled and
    native_tile_batches of 1024 px tiles at out_tile 128 N equal the JAX
    native loader byte for byte."""
    path, jn = _scale_case(process_corpus, name)
    assert native_loader.probe(path)[0] == native_loader.KIND_BASELINE
    _equal_jax_at(path, jn, scale, tile=1024)


def _segments(data: bytes) -> list:
    """(offset, marker, length) of each marker segment up to the first SOS."""
    out, i = [], 2
    while i < len(data):
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        out.append((i, m, n))
        if m == 0xDA:
            return out
        i += 2 + n
    return out


# JPEGs whose markers or data libjpeg-turbo reads in a way of its own, each
# by how it is made from a 160 x 120 4:2:0 file of the libjpeg writer
# ("plain" one scan, "simple" progressive, both with a restart every row):
# the DHTs dropped (the standard tables of jdhuff.c), a DC table no scan
# uses with a category past 15 (refused only where used), the data cut inside a
# scan or inside a table's values between scans (zeros and fake EOIs read
# on), cut inside that table's counts or length (refused: fake EOIs make
# its counts too many), a scan after a one-scan file and a reserved marker
# (refused)
ODD_JPEGS = ("no_tables", "unused_bad_table", "cut_in_scan_40", "cut_in_scan_90", "progressive_cut_70",
             "progressive_cut_in_values", "progressive_cut_in_counts", "progressive_cut_in_length", "second_scan",
             "reserved_marker")
REFUSED_ODD = ("progressive_cut_in_counts", "progressive_cut_in_length", "second_scan", "reserved_marker")


@pytest.fixture(scope="module")
def odd_jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("odd")
    writer = libjpeg_writer(d)
    if writer is None:
        return None, None
    img = aerial(np.random.default_rng(8), 120, 160)
    plain = Path(write_jpeg(writer, img, d / "plain.jpg", "plain", 90, 1)).read_bytes()
    prog = Path(write_jpeg(writer, img, d / "prog.jpg", "simple", 90, 1)).read_bytes()
    sos = [i for i, m, _ in _segments(plain) if m == 0xDA][0]
    eoi = plain.rindex(b"\xff\xd9")
    later_dht = [i for i in range(sos, len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xC4][-1]
    made = {
        "no_tables": plain[:2] + b"".join(plain[i:i + 2 + n] for i, m, n in _segments(plain)[:-1] if m != 0xC4)
        + plain[sos:],
        "unused_bad_table": plain[:2] + b"\xff\xc4\x00\x14\x03\x01" + bytes(15) + b"\x10" + plain[2:],
        "cut_in_scan_40": plain[:sos + (eoi - sos) * 2 // 5],
        "cut_in_scan_90": plain[:sos + (eoi - sos) * 9 // 10],
        "progressive_cut_70": prog[:len(prog) * 7 // 10],
        "progressive_cut_in_values": prog[:later_dht + 25],
        "progressive_cut_in_counts": prog[:later_dht + 10],
        "progressive_cut_in_length": prog[:later_dht + 3],
        "second_scan": plain[:eoi] + plain[sos:],
        "reserved_marker": plain[:2] + b"\xff\xf1\x00\x04ab" + plain[2:],
    }
    files = {}
    for name, data in made.items():
        (d / f"{name}.jpg").write_bytes(data)
        files[name] = str(d / f"{name}.jpg")
    return files, jax_native_loader()


@pytest.mark.parametrize("name", ODD_JPEGS)
def test_odd_jpegs_decode_or_skip_as_the_jax_native_loader(odd_jpegs, name):
    """Each file decodes to the JAX native loader's bytes at 8/8 and 4/8,
    through decode_image, decode_image_scaled and native_tile_batches, or
    is skipped where that loader's libjpeg refuses it."""
    files, jn = odd_jpegs
    if files is None or jn is None:
        pytest.skip("the libjpeg writer or native/libaquatile.so does not build here")
    path = files[name]
    want = jn.decode_image(path)
    if name in REFUSED_ODD:
        assert want is None and native_loader.decode_image(path, "cpu") is None
        counts = {}
        assert list(native_loader.native_tile_batches([path], tile=256, device="cpu", counts=counts)) == []
        assert counts["skipped"] == 1
        return
    np.testing.assert_array_equal(native_loader.decode_image(path, "cpu").numpy(), want)
    np.testing.assert_array_equal(native_loader.decode_image_scaled(path, 80, "cpu").numpy(),
                                  jn.decode_image_scaled(path, 80))
    got = _by_key(native_loader.native_tile_batches([path], batch_size=1, tile=256, device="cpu"))
    np.testing.assert_array_equal(next(iter(got.values()))[:120, :160], want)


def test_feed_fixtures_are_the_writers(tmp_path):
    """tests/data/torch_jpeg/ holds what torch_jax_native.write_feed_fixtures
    writes, byte for byte (chip_smoke.py reads them on a machine without
    libjpeg)."""
    writer = libjpeg_writer(tmp_path)
    if writer is None:
        pytest.skip("the libjpeg writer does not build here")
    for name, path in write_feed_fixtures(writer, tmp_path).items():
        assert Path(path).read_bytes() == (FIXTURES / f"{name}.jpg").read_bytes(), name


# TIFFs where libtiff's RGBA interface and PIL's convert("RGB") part:
# unassociated alpha, 16-bit grey, orientations 5-8 (300 x 200 stored)
TIFF_CASES = ("rgba_unassociated", "grey16", "orient5", "orient6", "orient7", "orient8")


@pytest.fixture(scope="module")
def tiff_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiffs")
    rng = np.random.default_rng(9)
    rgb = aerial(rng, 200, 300)
    files = {}
    for i, name in enumerate(TIFF_CASES):
        p = d / f"{PREFIX}_{i + 1}_0_0.tif"
        if name == "rgba_unassociated":
            Image.fromarray(np.dstack([rgb, rng.integers(0, 256, (200, 300), dtype=np.uint8)])).save(p)
        elif name == "grey16":
            Image.fromarray(rng.integers(0, 65536, (200, 300), dtype=np.uint16)).save(p)
        else:
            Image.fromarray(rgb).save(p, tiffinfo={274: int(name[-1])})
        files[name] = str(p)
    return files, jax_native_loader()


@pytest.mark.parametrize("name", TIFF_CASES)
def test_tiffs_take_libtiffs_pixels_at_full_size(tiff_corpus, name):
    """decode_image and native_tile_batches (256 px tiles) give the JAX
    native loader's libtiff pixels: alpha premultiplied, 16-bit grey's high
    byte, orientations 5-8 flipped and not transposed. The Python loader
    still gives PIL's convert("RGB"), unchanged."""
    files, jn = tiff_corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    path = files[name]
    want = jn.decode_image(path)
    np.testing.assert_array_equal(native_loader.decode_image(path, "cpu").numpy(), want)
    np.testing.assert_array_equal(native_loader.decode_image_scaled(path, 100, "cpu").numpy(), want)
    counts = {}
    got = _by_key(native_loader.native_tile_batches([path], batch_size=2, tile=256, device="cpu", counts=counts))
    ref = _by_key(jn.native_tile_batches([path], batch_size=2, tile=256))
    assert sorted(got) == sorted(ref) and counts == {"device": 0, "tiff": 1, "tiff_jpeg": 0, "pil": 0,
                                                     "pil_resize": 0, "skipped": 0}
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    (batch,) = tloader.tile_batches([path], batch_size=1, tile=512, decode_threads=1)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert not np.array_equal(pil, want)  # the case is one where the two decoders part
    np.testing.assert_array_equal(np.asarray(batch.images[0])[:pil.shape[0], :pil.shape[1]], pil)


def test_early_close_does_not_hang(corpus):
    """A consumer that stops after one batch closes the generator: the
    loader's threads stop and join though files remain."""
    files, _ = corpus
    paths = [files["raster"]] * 40
    gen = native_loader.native_tile_batches(paths, batch_size=2, tile=1024, n_threads=3, queue_depth=2,
                                            device="cpu")
    next(gen)
    closer = threading.Thread(target=gen.close)
    t0 = time.perf_counter()
    closer.start()
    closer.join(timeout=60)
    assert not closer.is_alive() and time.perf_counter() - t0 < 60


def test_failed_gxx_build_raises_with_its_output(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_entropy.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native_loader, "SOURCE", str(bad))
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_loader.available()


def test_detect_files_use_native_matches_jax(corpus):
    """Both packages' detect_files(use_native=True) on the same JPEG
    rasters (f32, the n model of tests/test_torch_pipeline.py at seed 7):
    the same tiles reach both models, so the rows agree as the f32 serving
    programs do (boxes within a pixel after truncation, confidences 1e-5)."""
    from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
    from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
    from aquaculture_tpu.pipeline import detect_files as jax_detect_files
    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    files, jn = corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    paths = [files["raster"], files["restart"]]
    jmodel, jparams = jax_init("n", num_classes=5, seed=7)
    model, params = yolov5_init("n", num_classes=5, seed=7)
    load_jax_params(model, params)
    kw = dict(img_size=128, conf_threshold=3e-5, max_detections=50, dtype="float32")
    jb, jc, jk, jspecs, _ = jax_detect_files(paths, jmodel, jmodel.fuse(jparams), JaxDetectConfig(**kw),
                                             batch_size=5, use_native=True)
    jpeg_cuda.decode_launches = 0
    tb, tc, tk, tspecs, stats = detect_files(paths, model, DetectConfig(**kw), batch_size=5, device="cpu",
                                             use_native=True)
    assert isinstance(stats, PipelineStats) and stats.loader == "device" and stats.tiles == 5
    assert stats.files == {"device": 2, "tiff": 0, "tiff_jpeg": 0, "pil": 0, "pil_resize": 0, "skipped": 0}
    assert jpeg_cuda.decode_launches == 0  # the CPU path never touches the kernel

    def rows(b, c, k, specs):
        order = sorted(range(len(c)), key=lambda i: (_key(specs[i]), -c[i], tuple(b[i])))
        return [(_key(specs[i]), b[i], c[i], k[i]) for i in order]

    got, want = rows(tb, tc, tk, tspecs), rows(jb, jc, jk, jspecs)
    assert len(got) == len(want) > 0
    for (gs, gb, gc, gk), (ws, wb, wc, wk) in zip(got, want):
        assert gs == ws and gk == wk
        assert np.abs(gb - wb).max() <= 1 and abs(gc - wc) <= 1e-5


def test_accuracy_harness_on_the_device_loader(tmp_path):
    """eval/accuracy.detections_by_image with use_native True and False on
    the trained fixture's rendered world (f32, 160 px): the device loader's
    pixels are PIL's at 8/8, so the detections are equal, row for row."""
    import sys

    from aquaculture_tpu_torch.eval import accuracy

    sys.path.insert(0, str(REPO / "examples"))
    from end_to_end_demo import render_world

    img_dir, _ = render_world(str(tmp_path), n_images=3, seed=0)
    paths = sorted(str(p) for p in Path(img_dir).iterdir())
    model = accuracy.load_checkpoint_f32(str(REPO / "tests" / "data" / "demo_ckpt_n160"), "n", 2)
    cfg = DetectConfig(img_size=160, conf_threshold=1e-3, dtype="float32")
    got = accuracy.detections_by_image(paths, model, cfg, batch_size=2, device="cpu", use_native=True)
    want = accuracy.detections_by_image(paths, model, cfg, batch_size=2, device="cpu", use_native=False)
    assert sorted(got) == sorted(want) and len(got) == 3 and sum(len(v[0]) for v in want.values()) > 0
    for stem in want:
        for g, w in zip(got[stem], want[stem]):
            np.testing.assert_array_equal(g, w)
