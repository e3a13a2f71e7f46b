"""The port's device tile loader (data/native_loader.py) against the JAX
package's native loader (data/native_loader.py over native/libaquatile.so).

On the CPU the loader runs the host entropy decode and the plain versions
of its kernels, so its tiles can be held to libjpeg-turbo's byte for byte
(tolerance 0): the same tile keys and bytes as the JAX package's
``native_tile_batches`` on a mixed corpus (1024 and 2048 px JPEG rasters,
a TIFF, a TIFF named .jpg, a corrupt .jpg), at full size and at 5/8
(640 px from 1024). The JAX loader's tile order varies from run to run, so
the comparison is by tile key; the port's order is the Python loader's.
Also: files routed and counted by content (TIFF and progressive JPEG to
PIL, the corrupt file skipped), routed rasters no larger than a slot
zero-padded into it at 8/8 and 5/8, 3/8 refused with a pointer to the
ROADMAP, an early close that does not hang, ``detect_files(use_native=True)``
against the JAX package's, and the accuracy harness on the device loader.
"""

import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data import jpeg_cuda, loader as tloader, native_loader
from aquaculture_tpu_torch.pipeline import PipelineStats, detect_files

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
    .jpg, a corrupt .jpg, a 1000 x 750 TIFF and, apart, progressive JPEGs of
    1024 and 1000 x 750 px; and the JAX native
    loader (built with make as tests/test_native.py builds it; None if that
    build fails)."""
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
    corrupt = d / f"{PREFIX}_8_0_0.jpg"
    # a JFIF header and then no marker: neither decoder finds a frame
    junk = np.random.default_rng(0).integers(0, 255, 4000, dtype=np.uint8).tobytes()  # no 0xFF byte
    corrupt.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00" + junk)
    files["corrupt"] = str(corrupt)
    jax_native = None
    if not (REPO / "native" / "libaquatile.so").exists():
        subprocess.run(["make", "-C", str(REPO / "native")], capture_output=True)
    if (REPO / "native" / "libaquatile.so").exists():
        from aquaculture_tpu.data import native_loader as jn

        jax_native = jn if jn.available() else None
    return files, jax_native


MIXED = ("raster", "tile444", "restart", "small", "tiff", "tiff_as_jpg", "corrupt", "small_tiff")


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


@pytest.mark.parametrize("out_tile", [0, 640])
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
    assert sorted(got) == sorted(want) and len(got) == 4 + 1 + 1 + 1 + 2 + 1 + 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    eff = out_tile or 1024
    assert all(b.images.shape == (3, eff, eff, 3) and b.images.dtype == torch.uint8 for b in batches)
    # files in path order, each raster's tiles x-major; the tail batch padded with zeros
    assert [_key(s)[1:4] for b in batches for s in b.specs if s][:5] == [
        (1, 0, 0), (1, 0, 1024), (1, 1024, 0), (1, 1024, 1024), (2, 1024, 0)]
    tail = batches[-1]
    assert tail.valid.tolist() == [True, True, False] and (tail.images[2:] == 0).all()
    assert counts == {"device": 4, "pil": 0 if out_tile else 3, "pil_resize": 3 if out_tile else 0, "skipped": 1}


@pytest.mark.parametrize("out_tile", [0, 640])
def test_routed_rasters_no_larger_than_a_slot_are_zero_padded(corpus, out_tile):
    """A TIFF and a progressive JPEG of 1000 x 750 (625 x 469 at 5/8) fill
    one zero-padded slot each, as in the Python loader's batches."""
    files, _ = corpus
    paths = [files["small_tiff"], files["small_progressive"]]
    counts = {}
    got = list(native_loader.native_tile_batches(paths, batch_size=2, tile=1024, out_tile=out_tile,
                                                 device="cpu", counts=counts))
    want = list(tloader.tile_batches(paths, batch_size=2, tile=1024, out_tile=out_tile, decode_threads=1))
    assert len(got) == len(want) == 1
    eff = out_tile or 1024
    assert got[0].images.shape == (2, eff, eff, 3) and torch.equal(got[0].images, want[0].images)
    assert [_key(s) for s in got[0].specs] == [_key(s) for s in want[0].specs]
    assert counts == {"device": 0, "pil": 0 if out_tile else 2, "pil_resize": 2 if out_tile else 0, "skipped": 0}


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


def test_progressive_jpeg_is_routed_to_pil_and_counted(corpus):
    files, jn = corpus
    path = files["progressive"]
    assert native_loader.probe(path)[0] == native_loader.KIND_OTHER_JPEG  # SOF2, from the header
    counts = {}
    (batch,) = native_loader.native_tile_batches([path, files["corrupt"]], batch_size=2, tile=1024,
                                                 device="cpu", counts=counts)
    assert counts == {"device": 0, "pil": 1, "pil_resize": 0, "skipped": 1}
    np.testing.assert_array_equal(batch.images[0].numpy(), np.asarray(Image.open(path).convert("RGB")))
    if jn is not None:
        np.testing.assert_array_equal(batch.images[0].numpy(), jn.decode_image(path))
    assert native_loader.decode_image(files["corrupt"], "cpu") is None


def test_decode_image_equals_jax(corpus):
    files, jn = corpus
    if jn is None:
        pytest.skip("native/libaquatile.so does not build here")
    for key in ("raster", "small", "tiff"):
        np.testing.assert_array_equal(native_loader.decode_image(files[key], "cpu").numpy(),
                                      jn.decode_image(files[key]))
    for key, target in (("tile444", 640), ("small", 625), ("tiff", 640)):
        np.testing.assert_array_equal(native_loader.decode_image_scaled(files[key], target, "cpu").numpy(),
                                      jn.decode_image_scaled(files[key], target))


def test_scale_3_8_raises_and_detect_files_takes_the_python_loader(corpus):
    files, _ = corpus
    with pytest.raises(ValueError, match="3/8 is still to port.*ROADMAP"):
        native_loader.native_tile_batches([files["tile444"]], batch_size=1, tile=1024, out_tile=384, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        native_loader.decode_image_scaled(files["tile444"], 384, "cpu")
    assert not native_loader.supports_scale(384, 1024) and native_loader.supports_scale(640, 1024)
    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    model = load_jax_params(*yolov5_init("n", num_classes=2))
    *_, stats = detect_files([files["tile444"]], model, DetectConfig(img_size=384, conf_threshold=1e-5),
                             batch_size=1, device="cpu", decode_scale=True)
    assert stats.loader == "python" and stats.tiles == 1 and stats.files == {}
    if not torch.cuda.is_available():  # no CPU fallback for a CUDA request
        with pytest.raises(RuntimeError, match="device='cpu'"):
            native_loader.native_tile_batches([files["tile444"]], device="cuda")


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
    assert stats.files == {"device": 2, "pil": 0, "pil_resize": 0, "skipped": 0}
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
