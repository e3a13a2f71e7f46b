"""The port's object-store corpus transport (data/store.py, the loader's
store path, ``detect_files(store=)`` and ``run_pipeline(store=)``) against
its own file path and the JAX package's store path, on the CPU.

Tolerances: tiles, batches and specs are exact (the same decoder and the
same tiling code); detection tables of a store run and a file run of the
port are exact (the same pixels through the same program).
"""

import io
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu.data import loader as jax_loader
from aquaculture_tpu.data.geotiff import read_image_bytes as jax_read_image_bytes
from aquaculture_tpu.data import store as jax_store
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch.cli.pod import resolve_source
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data import loader
from aquaculture_tpu_torch.data.geotiff import read_image, read_image_bytes
from aquaculture_tpu_torch.data.store import BlobStore, GcsBlobStore, LocalBlobStore, MemoryBlobStore
from aquaculture_tpu_torch.geo import polygon as tpoly
from aquaculture_tpu_torch.models.weights import load_jax_params
from aquaculture_tpu_torch.models.yolov5 import yolov5_init
from aquaculture_tpu_torch.pipeline import detect_files, run_pipeline

from test_torch_post import assert_frames_equal


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _jpeg_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _corpus(tmp_path, sizes, seed, prefix="shard0/", encode=_png_bytes, ext="png"):
    """The same images as files under tmp_path and as blobs under prefix in
    a MemoryBlobStore; returns (paths, store, keys)."""
    rng = np.random.default_rng(seed)
    store, paths = MemoryBlobStore(), []
    for i, (h, w) in enumerate(sizes):
        arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        arr[h // 4 : h // 2, w // 4 : w // 2] = 230  # structure for the detector
        name = f"ORTHOIMAGERY.ORTHOPHOTOS{2014 + i}_{i}_0_0.{ext}"
        data = encode(arr)
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
        store.put(prefix + name, data)
    return paths, store, store.list(prefix)


def test_memory_store_roundtrip_and_list():
    s = MemoryBlobStore()
    s.put("corpus/a.png", b"1")
    s.put("corpus/b.png", b"2")
    s.put("other/c.png", b"3")
    assert s.exists("corpus/a.png") and not s.exists("corpus/z.png")
    assert s.list("corpus/") == ["corpus/a.png", "corpus/b.png"]
    assert s.list() == ["corpus/a.png", "corpus/b.png", "other/c.png"]
    assert s.get("corpus/b.png") == b"2"
    assert s.get_count == 1
    assert isinstance(s, BlobStore) and isinstance(LocalBlobStore("."), BlobStore)


def test_local_store_roundtrip_and_list_as_jax(tmp_path):
    """Keys are store-relative; the port's and the JAX package's local
    stores list the same keys over the same tree."""
    s = LocalBlobStore(str(tmp_path))
    s.put("corpus/a.png", b"abc")
    s.put("corpus/deep/b.png", b"d")
    s.put("c.png", b"e")
    assert s.exists("corpus/a.png") and s.get("corpus/a.png") == b"abc"
    assert s.list() == ["c.png", "corpus/a.png", "corpus/deep/b.png"]
    assert s.list("corpus/") == ["corpus/a.png", "corpus/deep/b.png"]
    assert os.path.exists(tmp_path / "corpus" / "a.png")
    j = jax_store.LocalBlobStore(str(tmp_path))
    assert s.list() == j.list() and s.list("corpus/") == j.list("corpus/")


@pytest.mark.parametrize("encode,ext", [(_png_bytes, "png"), (_jpeg_bytes, "jpeg")])
def test_read_image_bytes_equals_read_image(tmp_path, encode, ext):
    arr = np.random.default_rng(5).integers(0, 255, (40, 56, 3), dtype=np.uint8)
    (tmp_path / f"a.{ext}").write_bytes(encode(arr))
    data = (tmp_path / f"a.{ext}").read_bytes()
    got = read_image_bytes(data)
    np.testing.assert_array_equal(got, read_image(str(tmp_path / f"a.{ext}")))
    np.testing.assert_array_equal(got, jax_read_image_bytes(data))


@pytest.mark.parametrize("tile,stride,out_tile", [
    (512, 0, 0),      # hard grid; a 1024 px raster splits into 4 tiles
    (512, 384, 0),    # overlap serving: tiles step by 384 px
    (512, 0, 256),    # decode-at-scale
])
def test_iter_tiles_from_store_matches_files_and_jax(tmp_path, tile, stride, out_tile):
    """Store tiles equal file tiles pixel for pixel, with equal specs, and
    equal the JAX package's store path on the same blobs."""
    paths, store, keys = _corpus(tmp_path, [(512, 512), (1024, 1024)], seed=0)
    got_f = list(loader.iter_tiles_from_files(paths, tile=tile, stride=stride, out_tile=out_tile))
    got_s = list(loader.iter_tiles_from_store(store, keys, tile=tile, fetch_threads=2, stride=stride,
                                              out_tile=out_tile))
    want = list(jax_loader.iter_tiles_from_store(store, keys, tile=tile, fetch_threads=2, stride=stride,
                                                 out_tile=out_tile))
    assert len(got_f) == len(got_s) == len(want) > 2
    for (af, sf), (as_, ss), (aj, sj) in zip(got_f, got_s, want):
        np.testing.assert_array_equal(af, as_)
        np.testing.assert_array_equal(as_, aj)
        assert sf == ss and (ss.year, ss.bbox_ind, ss.x_offset, ss.y_offset, ss.layer) == (
            sj.year, sj.bbox_ind, sj.x_offset, sj.y_offset, sj.layer)
    assert store.get_count == 2 * len(keys)


def test_tile_batches_from_store_matches_files_and_jax(tmp_path):
    """Three 256 px tiles in batches of 2: the padded tail batch too."""
    paths, store, keys = _corpus(tmp_path, [(256, 256)] * 3, seed=1, prefix="")
    bf = list(loader.tile_batches(paths, batch_size=2, tile=256))
    bs = list(loader.tile_batches_from_store(store, keys, batch_size=2, tile=256))
    bj = list(jax_loader.tile_batches_from_store(store, keys, batch_size=2, tile=256))
    assert len(bf) == len(bs) == len(bj) == 2
    for x, y, z in zip(bf, bs, bj):
        assert isinstance(y.images, torch.Tensor) and y.images.dtype == torch.uint8
        np.testing.assert_array_equal(x.images.numpy(), y.images.numpy())
        np.testing.assert_array_equal(y.images.numpy(), z.images)
        np.testing.assert_array_equal(x.valid, y.valid)
        np.testing.assert_array_equal(y.valid, z.valid)
        assert x.specs == y.specs
        assert [s and s.name for s in y.specs] == [s and s.name for s in z.specs]


def test_store_fetch_error_propagates():
    class Broken(MemoryBlobStore):
        def get(self, key):
            raise IOError("boom")

    s = Broken()
    s.put("a.png", b"x")
    with pytest.raises(IOError, match="boom"):
        list(loader.iter_tiles_from_store(s, ["a.png"]))
    with pytest.raises(IOError, match="boom"):
        list(loader.tile_batches_from_store(s, ["a.png"], batch_size=1))
    assert list(loader.iter_tiles_from_store(s, [])) == []


def _fake_gcs(monkeypatch, bucket_name):
    """A fake google.cloud.storage module over a dict (the JAX package's
    test does the same): no network, no SDK."""
    blobs = {}

    class FakeBlob:
        def __init__(self, name):
            self.name = name

        def exists(self):
            return self.name in blobs

        def upload_from_string(self, data):
            blobs[self.name] = bytes(data)

        def download_as_bytes(self):
            return blobs[self.name]

    class FakeBucket:
        def blob(self, key):
            return FakeBlob(key)

        def list_blobs(self, prefix=""):
            return [FakeBlob(k) for k in sorted(blobs) if k.startswith(prefix)]

    class FakeClient:
        def get_bucket(self, name):
            assert name == bucket_name
            return FakeBucket()

    fake_gc = types.ModuleType("google.cloud")
    fake_gc.storage = types.SimpleNamespace(Client=FakeClient)
    fake_google = types.ModuleType("google")
    fake_google.cloud = fake_gc
    monkeypatch.setitem(sys.modules, "google", fake_google)
    monkeypatch.setitem(sys.modules, "google.cloud", fake_gc)
    return blobs


def test_gcs_store_contract_via_fake_module(monkeypatch, tmp_path):
    """GcsBlobStore maps the protocol onto the google-cloud-storage surface,
    and tiles stream from it as from a file."""
    blobs = _fake_gcs(monkeypatch, "corpus-bucket")
    s = GcsBlobStore("corpus-bucket")
    assert not s.exists("tiles/a.jpeg")
    s.put("tiles/b.jpeg", b"de")
    s.put("other/c.jpeg", b"f")
    assert s.exists("tiles/b.jpeg") and s.get("tiles/b.jpeg") == b"de"
    assert s.list("tiles/") == ["tiles/b.jpeg"] and s.list() == ["other/c.jpeg", "tiles/b.jpeg"]
    paths, mem, keys = _corpus(tmp_path, [(256, 256)], seed=2, prefix="tiles/")
    s.put(keys[0], mem.get(keys[0]))
    (t, spec), = loader.iter_tiles_from_store(s, [keys[0]], tile=256)
    np.testing.assert_array_equal(t, read_image(paths[0]))
    assert blobs[keys[0]] == mem.get(keys[0]) and spec.year == 2014


def test_gcs_store_without_sdk_raises_jax_packages_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "google.cloud", None)  # no SDK importable
    with pytest.raises(ImportError) as got:
        GcsBlobStore("b")
    with pytest.raises(ImportError) as want:
        jax_store.GcsBlobStore("b")
    assert str(got.value) == str(want.value)


def test_resolve_source_store_dir_and_glob(tmp_path):
    """cli.pod's --source forms: 'store:ROOT::PREFIX' lists image keys under
    the prefix (other files skipped), a directory and a glob list files."""
    root = tmp_path / "root"
    ls = LocalBlobStore(str(root))
    for k in ("tiles/ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.jpeg", "tiles/notes.txt",
              "other/ORTHOIMAGERY.ORTHOPHOTOS2014_1_0_0.png"):
        ls.put(k, b"x")
    store, keys = resolve_source(f"store:{root}::tiles/")
    assert isinstance(store, LocalBlobStore) and keys == ["tiles/ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.jpeg"]
    assert resolve_source(str(root / "other")) == (None, [str(root / "other" / "ORTHOIMAGERY.ORTHOPHOTOS2014_1_0_0.png")])
    assert resolve_source(str(root / "tiles" / "*.jpeg"))[1] == [str(root / keys[0])]


@pytest.fixture(scope="module")
def model():
    return load_jax_params(*yolov5_init("n", num_classes=5, seed=0))


def test_detect_files_store_equals_files(tmp_path, model):
    """The same detection tables from (store, keys) as from files, and the
    store run reads no file (its blobs are fetched once each)."""
    paths, store, keys = _corpus(tmp_path, [(512, 512), (512, 512), (1024, 512)], seed=3, prefix="tiles/")
    cfg = DetectConfig(img_size=128, conf_threshold=1e-5)
    b1, c1, k1, s1, st1 = detect_files(paths, model, cfg, batch_size=2, tile=512, device="cpu")
    for p in paths:
        os.remove(p)
    b2, c2, k2, s2, st2 = detect_files(keys, model, cfg, batch_size=2, tile=512, device="cpu", store=store)
    assert st1.tiles == st2.tiles == 4 and len(b1) > 0
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(k1, k2)
    assert s1 == s2 and store.get_count == len(keys)


def test_run_pipeline_store_equals_files(tmp_path, model):
    paths, store, keys = _corpus(tmp_path, [(1024, 1024)] * 2, seed=4, prefix="c/")
    dl = tgf.GeoFrame({"d": [0, 1]}, geometry=[tpoly.box(0, 0, 1200, 1200), tpoly.box(1200, 0, 2400, 1200)],
                      crs=3857)
    cfg = DetectConfig(img_size=128, conf_threshold=1e-5)
    want, _ = run_pipeline(paths, model, dl, cfg, batch_size=2, device="cpu")
    got, stats = run_pipeline(keys, model, dl, cfg, batch_size=2, device="cpu", store=store)
    assert stats.tiles == 2 and len(got) > 0
    assert_frames_equal(got, want)
