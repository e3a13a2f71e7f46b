"""The port's file loader (data/loader.py) against the JAX package's loaders.

Overlap tiling (stride), the sequential and threaded decode pools and
decode-at-scale (out_tile) give the same uint8 batches, validity masks and
TileSpecs as the JAX package's Python loader: tolerance 0, the same PIL
decode and resize on the same files.

The port's Python loader is also held byte for byte against the JAX
package's native loader (native/libaquatile.so) where the two read the
same pixels: TIFF rasters, decoded in full, and decoded at scale, where
the native loader routes by content (a TIFF named .jpg too) to the PIL
resize the port runs. The port's own device loader (data/native_loader.py)
is held against the JAX native loader in tests/test_torch_native_loader.py.
"""

import numpy as np
import pytest
from PIL import Image

from aquaculture_tpu.data import loader as jloader
from aquaculture_tpu.pipeline import detect_files as jax_detect_files
from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data import loader as tloader
from aquaculture_tpu_torch.pipeline import detect_files
from torch_jax_native import jax_native_loader



def _spec_key(s):
    return None if s is None else (s.name, s.year, s.bbox_ind, s.x_offset, s.y_offset, s.layer)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.images.numpy().dtype == w.images.dtype == np.uint8
        np.testing.assert_array_equal(g.images.numpy(), w.images)
        np.testing.assert_array_equal(g.valid, w.valid)
        assert [_spec_key(s) for s in g.specs] == [_spec_key(s) for s in w.specs]


@pytest.fixture(scope="module")
def rasters(tmp_path_factory):
    """Two 2048 px rasters (a JPEG and a TIFF), a 1024 px JPEG tile and a
    small PNG, named with the tile codec."""
    d = tmp_path_factory.mktemp("rasters")
    rng = np.random.default_rng(8)
    out = {}
    for name, shape in (("ORTHOIMAGERY.ORTHOPHOTOS2019_3_0_0.jpeg", (2048, 2048)),
                        ("ORTHOIMAGERY.ORTHOPHOTOS2019_4_6144_2048.tif", (2048, 1536)),
                        ("ORTHOIMAGERY.ORTHOPHOTOS2019_5_1024_0.jpg", (1024, 1024)),
                        ("plain.png", (300, 200))):
        img = rng.integers(0, 255, (*shape, 3), dtype=np.uint8)
        img[100:400, 200:500] = 230
        Image.fromarray(img).save(d / name)
        out[name.rsplit(".", 1)[1]] = str(d / name)
    return out


@pytest.mark.parametrize("stride,decode_threads,out_tile", [
    (768, 1, 0),     # overlap serving, sequential decode
    (512, 0, 0),     # overlap serving, auto pool
    (0, 3, 640),     # decode-at-scale at 5/8, threaded
    (0, 1, 256),     # decode-at-scale at 2/8
    (1024, 2, 640),  # a stride equal to the tile is the hard grid
])
def test_tile_batches_match_jax(rasters, stride, decode_threads, out_tile):
    paths = [rasters[k] for k in ("jpeg", "tif", "jpg", "png")]
    kw = dict(batch_size=4, tile=1024, stride=stride, decode_threads=decode_threads, out_tile=out_tile)
    want = list(jloader.tile_batches(paths, **kw))
    got = list(tloader.tile_batches(paths, **kw))
    assert_batches_equal(got, want)
    if out_tile:
        assert got[0].images.shape[1:] == (out_tile, out_tile, 3)
    # overlapped: 3 x 3 tiles of the 2048 px square, 2 x 3 of the 1536 px wide
    # one; on the hard grid 2 x 2 and 1 x 2; plus one each for the small files
    n_tiles = sum(int(b.valid.sum()) for b in got)
    assert n_tiles == (9 + 6 if 0 < stride < 1024 else 4 + 2) + 2


@pytest.mark.parametrize("kw,match", [
    (dict(stride=768, out_tile=640), "overlap"),
    (dict(out_tile=600), "N/8"),
    (dict(out_tile=1024), "N/8"),
])
def test_bad_scale_or_stride_raises_as_jax(rasters, kw, match):
    with pytest.raises(ValueError, match=match):
        list(jloader.tile_batches([rasters["jpeg"]], batch_size=2, tile=1024, **kw))
    with pytest.raises(ValueError, match=match):
        list(tloader.tile_batches([rasters["jpeg"]], batch_size=2, tile=1024, **kw))


@pytest.mark.parametrize("img,kw", [(1280, dict(decode_scale=True)), (600, dict(decode_scale=True)),
                                    (256, dict(decode_scale=True, stride=768))])
def test_detect_files_refuses_what_jax_refuses(rasters, img, kw):
    from aquaculture_tpu_torch.models.yolov5 import YoloV5

    with pytest.raises(ValueError, match="decode_scale"):
        jax_detect_files([rasters["jpeg"]], None, None, JaxDetectConfig(img_size=img), use_native=False, **kw)
    with pytest.raises(ValueError, match="decode_scale"):
        detect_files([rasters["jpeg"]], YoloV5("n", 2), DetectConfig(img_size=img), device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native loader over native/libaquatile.so, built
    with make if it is missing (``torch_jax_native.jax_native_loader``)."""
    jn = jax_native_loader()
    if jn is None:
        pytest.skip("libaquatile.so does not build or load here")
    return jn


def _by_spec(batches):
    out = {}
    for b in batches:
        images = b.images.numpy() if hasattr(b.images, "numpy") else b.images
        for img, spec, v in zip(images, b.specs, b.valid):
            if v:
                out[_spec_key(spec)] = img.copy()
    return out


@pytest.mark.parametrize("out_tile", [0, 512])
def test_python_loader_equals_jax_native_loader_on_tiff(jax_native, rasters, tmp_path, out_tile):
    """TIFF rasters, one of them named .jpg: the native loader decodes TIFF
    losslessly as PIL does, and in scaled mode routes files by content to
    the PIL resize, so its tiles are the port's byte for byte."""
    disguised = tmp_path / "ORTHOIMAGERY.ORTHOPHOTOS2019_6_0_0.jpg"
    Image.open(rasters["tif"]).save(disguised, format="TIFF")
    assert disguised.read_bytes()[:2] in (b"II", b"MM")
    paths = [rasters["tif"], str(disguised)]
    want = _by_spec(jax_native.native_tile_batches(paths, batch_size=3, tile=1024, out_tile=out_tile))
    got = _by_spec(tloader.tile_batches(paths, batch_size=3, tile=1024, out_tile=out_tile))
    assert set(got) == set(want) and len(got) == 4
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape == ((out_tile or 1024), (out_tile or 1024), 3)


def test_detect_files_names_the_python_loader(rasters):
    """use_native=False serves decode-at-scale through the Python loader
    (by default a JPEG takes the device loader at every N/8) and
    ``stats.loader`` names it."""
    from aquaculture_tpu_torch.models.weights import load_jax_params
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    model = load_jax_params(*yolov5_init("n", num_classes=2))
    *_, stats = detect_files([rasters["jpg"]], model, DetectConfig(img_size=128, conf_threshold=1e-5),
                             batch_size=1, device="cpu", decode_scale=True, use_native=False)
    assert stats.loader == "python" and stats.tiles == 1 and stats.detections > 0
