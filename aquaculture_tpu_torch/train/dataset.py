"""Detection training dataset: YOLO-format image/label folders -> batches.

Counterpart of aquaculture_tpu/train/dataset.py: images/*.jpg (jpeg, png,
tif) + labels/*.txt rows ``class cx cy w h`` normalized -> fixed-shape
batch dicts {images (B, S, S, 3) f32 in [0, 1], labels (B, M, 5) pixel,
label_mask (B, M)} as numpy arrays, with host-side augmentation in a
thread pool and a prefetch thread. Each sample draws from its own
``SeedSequence([seed, epoch, step, slot])``, so batches are identical for
any thread count and equal to the JAX package's.

The base resize is the port's serving operator (antialiased bilinear,
``F.interpolate``; pipeline.preprocess) where the JAX package uses
jax.image.resize: training and serving see the same pixels.
"""

from __future__ import annotations

import glob
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aquaculture_tpu_torch.config import TrainConfig
from aquaculture_tpu_torch.data.geotiff import read_image
from aquaculture_tpu_torch.data.loader import prefetch
from aquaculture_tpu_torch.train.augment import augment_sample


def find_pairs(images_dir: str, labels_dir: Optional[str] = None) -> List[Tuple[str, Optional[str]]]:
    """(image_path, label_path_or_None) pairs; labels default to the
    ultralytics sibling convention images/ -> labels/ with .txt stems."""
    if labels_dir is None:
        labels_dir = os.path.join(os.path.dirname(images_dir.rstrip("/")), "labels")
    pairs = []
    for ext in ("jpg", "jpeg", "png", "tif"):
        for p in sorted(glob.glob(os.path.join(images_dir, f"*.{ext}"))):
            stem = os.path.splitext(os.path.basename(p))[0]
            lp = os.path.join(labels_dir, stem + ".txt")
            pairs.append((p, lp if os.path.exists(lp) else None))
    return pairs


def load_sample(img_path: str, label_path: Optional[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 image, (N, 5) [cls, cx, cy, w, h] pixel boxes)."""
    img = read_image(img_path)
    h, w = img.shape[:2]
    if label_path is None:
        return img, np.zeros((0, 5))
    rows = np.loadtxt(label_path, ndmin=2)
    if rows.size == 0:
        return img, np.zeros((0, 5))
    boxes = rows[:, :5].astype(np.float64).copy()
    boxes[:, 1] *= w
    boxes[:, 2] *= h
    boxes[:, 3] *= w
    boxes[:, 4] *= h
    return img, boxes


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (nh, nw, 3) in [0, 255], antialiased
    bilinear (half-pixel centres), the serving resize."""
    x = torch.from_numpy(np.array(img, dtype=np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).numpy()


class DetectionDataset:
    """Epoch iterator with augmentation and fixed-shape padding."""

    def __init__(
        self,
        images_dir: str,
        labels_dir: Optional[str] = None,
        cfg: TrainConfig = TrainConfig(),
        augment: bool = True,
        seed: int = 0,
    ):
        self.pairs = find_pairs(images_dir, labels_dir)
        if not self.pairs:
            raise FileNotFoundError(f"no images under {images_dir}")
        self.cfg = cfg
        self.augment = augment
        self.seed = seed
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._resized_cache: Dict[Tuple[int, int], Tuple[np.ndarray, float]] = {}
        # One byte budget (TrainConfig.cache_gb) for both caches: past it,
        # samples are decoded and resized per use instead of stored.
        self._cache_budget = int(max(cfg.cache_gb, 0.0) * (1 << 30))
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()  # the feed threads share the budget

    def _maybe_cache(self, cache: dict, key, value) -> None:
        size = sum(a.nbytes for a in value if isinstance(a, np.ndarray))
        with self._cache_lock:
            if key not in cache and self._cache_bytes + size <= self._cache_budget:
                cache[key] = value
                self._cache_bytes += size

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def steps_per_epoch(self) -> int:
        return max(len(self.pairs) // self.cfg.batch_size, 1)

    def _get(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(i)
        if hit is None:
            hit = load_sample(*self.pairs[i])
            self._maybe_cache(self._cache, i, hit)
        img, boxes = hit
        return img, boxes.copy()

    def _make_sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        s = self.cfg.img_size
        if self.augment:
            pick = lambda: self._resized(int(rng.integers(len(self.pairs))), s)
            return augment_sample(
                pick, s, rng,
                mosaic_p=self.cfg.mosaic, scale=self.cfg.scale,
                translate=self.cfg.translate,
                hsv=(self.cfg.hsv_h, self.cfg.hsv_s, self.cfg.hsv_v),
                fliplr=self.cfg.fliplr, flipud=self.cfg.flipud,
            )
        return self._resized(int(rng.integers(len(self.pairs))), s)

    def _resized(self, i: int, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """Base sample at training resolution: the longer side resized to s,
        clipped, truncated to uint8 and padded with 114 to s x s; boxes
        scaled. Resized images are cached per (index, size)."""
        key = (i, s)
        hit = self._resized_cache.get(key)
        if hit is None:
            img, _ = self._get(i)
            h, w = img.shape[:2]
            if (h, w) != (s, s):
                g = s / max(h, w)
                nh, nw = int(round(h * g)), int(round(w * g))
                img = np.clip(resize_bilinear(img, nh, nw), 0, 255).astype(np.uint8)
                img = np.pad(img, ((0, s - nh), (0, s - nw), (0, 0)), constant_values=114)
            else:
                g = 1.0
            hit = (img, g)
            self._maybe_cache(self._resized_cache, key, hit)
        img, g = hit
        _, boxes = self._get(i)
        boxes[:, 1:5] *= g
        return img.copy(), boxes

    def epoch(self, epoch_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of fixed-shape batches, prefetched. Samples are made on
        ``cfg.feed_threads`` threads (0 = cores capped at 8)."""
        cfg = self.cfg
        workers = cfg.feed_threads or min(os.cpu_count() or 1, 8)

        def make(step: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch_index, step, b]))
            return self._make_sample(rng)

        def assemble(samples) -> Dict[str, np.ndarray]:
            images = np.zeros((cfg.batch_size, cfg.img_size, cfg.img_size, 3), np.float32)
            labels = np.zeros((cfg.batch_size, cfg.max_boxes_per_image, 5), np.float32)
            mask = np.zeros((cfg.batch_size, cfg.max_boxes_per_image), bool)
            for b, (img, boxes) in enumerate(samples):
                images[b] = img.astype(np.float32) / 255.0
                n = min(len(boxes), cfg.max_boxes_per_image)
                if n:
                    labels[b, :n] = boxes[:n]
                    mask[b, :n] = True
            return {"images": images, "labels": labels, "label_mask": mask}

        def gen():
            if workers > 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for step in range(self.steps_per_epoch):
                        samples = list(pool.map(make, [step] * cfg.batch_size, range(cfg.batch_size)))
                        yield assemble(samples)
            else:
                for step in range(self.steps_per_epoch):
                    yield assemble([make(step, b) for b in range(cfg.batch_size)])

        return prefetch(gen(), depth=2)
