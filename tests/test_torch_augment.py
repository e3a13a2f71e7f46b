"""The port's training augmentation and dataset against the JAX package on the
same seeds: flips, mosaic, affine and HSV jitter exact (same numpy draws,
same OpenCV calls), and ``DetectionDataset.epoch`` on a rendered world with
labels and masks exact and images within 1/255 (the base resize is the
port's antialiased bilinear where the JAX package runs jax.image.resize;
the two agree to float rounding, which can move a truncated uint8 by one)."""

import os

import numpy as np
import pytest

from aquaculture_tpu.config import TrainConfig as JaxTrainConfig
from aquaculture_tpu.train import augment as jax_aug
from aquaculture_tpu.train import dataset as jax_ds
from aquaculture_tpu_torch.config import TrainConfig
from aquaculture_tpu_torch.train import augment, dataset


def _sample(rng, size=96, n=5):
    img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    cxy = rng.uniform(5, size - 5, (n, 2))
    wh = rng.uniform(4, size / 3, (n, 2))
    boxes = np.concatenate([rng.integers(0, 3, (n, 1)), cxy, wh], 1)
    return img, boxes


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_exact(seed):
    img, _ = _sample(np.random.default_rng(seed))
    want = jax_aug.hsv_augment(img, np.random.default_rng(seed + 10))
    got = augment.hsv_augment(img, np.random.default_rng(seed + 10))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fliplr,flipud", [(1.0, 0.0), (0.0, 1.0), (0.5, 0.5)])
def test_flip_exact(fliplr, flipud):
    img, boxes = _sample(np.random.default_rng(3))
    for s in range(4):
        _same(augment.flip_augment(img, boxes, np.random.default_rng(s), fliplr, flipud),
              jax_aug.flip_augment(img, boxes, np.random.default_rng(s), fliplr, flipud))


def test_mosaic_exact():
    rng = np.random.default_rng(4)
    pairs = [_sample(rng, size=int(rng.integers(40, 90)), n=int(rng.integers(0, 4))) for _ in range(4)]
    imgs, boxes = [p[0] for p in pairs], [p[1] for p in pairs]
    for s in range(3):
        _same(augment.mosaic4(imgs, boxes, 64, np.random.default_rng(s)),
              jax_aug.mosaic4(imgs, boxes, 64, np.random.default_rng(s)))


@pytest.mark.parametrize("scale,translate", [(0.5, 0.1), (0.0, 0.0), (0.9, 0.3)])
def test_affine_exact(scale, translate):
    img, boxes = _sample(np.random.default_rng(5), size=128, n=12)
    for s in range(3):
        got = augment.random_affine(img, boxes, 80, np.random.default_rng(s), scale, translate)
        want = jax_aug.random_affine(img, boxes, 80, np.random.default_rng(s), scale, translate)
        _same(got, want)


@pytest.mark.parametrize("mosaic_p", [1.0, 0.0])
def test_augment_sample_exact(mosaic_p):
    base = [_sample(np.random.default_rng(10 + i), size=64) for i in range(6)]
    for s in range(3):
        outs = []
        for mod in (augment, jax_aug):
            rng = np.random.default_rng(s)
            pick = lambda: base[int(rng.integers(len(base)))]
            outs.append(mod.augment_sample(pick, 64, rng, mosaic_p=mosaic_p))
        _same(*outs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The demo's rendered world: 8 tiles of 1024 px with YOLO labels, plus
    one image without a label file and one non-square image."""
    import sys

    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    from end_to_end_demo import render_world

    d = tmp_path_factory.mktemp("world")
    img_dir, lab_dir = render_world(str(d), n_images=8, seed=3)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (300, 200, 3), dtype=np.uint8)).save(os.path.join(img_dir, "extra.png"))
    Image.fromarray(rng.integers(0, 255, (96, 160, 3), dtype=np.uint8)).save(os.path.join(img_dir, "wide.jpg"))
    with open(os.path.join(lab_dir, "wide.txt"), "w") as f:
        f.write("1 0.5 0.5 0.25 0.5\n0 0.1 0.2 0.1 0.1\n")
    return img_dir, lab_dir


def test_find_pairs_and_load_sample_exact(world):
    img_dir, lab_dir = world
    pairs = dataset.find_pairs(img_dir)
    assert pairs == jax_ds.find_pairs(img_dir) and len(pairs) == 10
    assert sum(lp is None for _, lp in pairs) == 1
    for ip, lp in pairs:
        _same(dataset.load_sample(ip, lp), jax_ds.load_sample(ip, lp))


def test_resize_within_float_rounding_of_jax(world):
    """The base resize against jax.image.resize, down (a 1024 px tile to
    64 px) and up (a 300 x 240 crop to 450 x 360): within 1e-3 of 255
    before truncation."""
    import jax.image

    tile = dataset.read_image(dataset.find_pairs(world[0])[0][0])
    for src, (h, w) in ((tile, (64, 64)), (tile[:300, :240], (450, 360))):
        want = np.asarray(jax.image.resize(src.astype(np.float32), (h, w, 3), method="bilinear"))
        got = dataset.resize_bilinear(src, h, w)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-3 * 255


@pytest.mark.parametrize("augmented", [False, True])
def test_dataset_epoch_matches_jax(world, augmented, monkeypatch):
    """Two batches of epoch 0 at 64 px, batch 4, labels and masks exact.
    Without augmentation the images are within 1/255 (the two resizes);
    with it, given the JAX package's resize, they are exact: the draws, the
    mosaic, the affine and the HSV jitter are the same (HSV would turn one
    uint8 level from the resize into up to three). The port's batches are
    the same for 1 and 3 feed threads."""
    img_dir, lab_dir = world
    if augmented:
        import jax.image

        monkeypatch.setattr(dataset, "resize_bilinear", lambda img, h, w: np.asarray(
            jax.image.resize(img.astype(np.float32), (h, w, 3), method="bilinear")))
    kw = dict(img_size=64, batch_size=4, max_boxes_per_image=12)
    want = list(jax_ds.DetectionDataset(img_dir, lab_dir, JaxTrainConfig(**kw), augment=augmented, seed=5).epoch(0))
    runs = [list(dataset.DetectionDataset(img_dir, lab_dir, TrainConfig(feed_threads=t, **kw), augment=augmented,
                                          seed=5).epoch(0)) for t in (1, 3)]
    assert len(want) == len(runs[0]) == len(runs[1]) == 2
    for w, g, g3 in zip(want, *runs):
        assert {k: (v.shape, v.dtype) for k, v in g.items()} == {k: (v.shape, v.dtype) for k, v in w.items()}
        np.testing.assert_array_equal(g["label_mask"], w["label_mask"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert float(np.abs(g["images"] - w["images"]).max()) <= (0.0 if augmented else 1 / 255 + 1e-7)
        assert g["label_mask"].sum() > 0
        for k in g:
            np.testing.assert_array_equal(g3[k], g[k])
