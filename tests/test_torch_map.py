"""The port's mAP evaluator (aquaculture_tpu_torch/eval/map.py) against the
JAX package's, tolerance 0: seeded random worlds with forced IoU ties and
score ties, and the hand-checkable cases of tests/test_map.py through both."""

import numpy as np
import pytest

from aquaculture_tpu.eval import map as jax_map
from aquaculture_tpu_torch.eval import map as torch_map


def _world(seed: int, n_images: int = 6, num_classes: int = 3):
    """Per image: ground truths with exact duplicates (equal best IoUs for
    one detection, the COCOeval tie-break), detections copied from them,
    shifted by whole pixels, or random, with repeated confidences."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for i in range(n_images):
        m = int(rng.integers(0, 7))
        xy = rng.integers(0, 200, (m, 2)).astype(float)
        wh = rng.integers(8, 60, (m, 2)).astype(float)
        gb = np.concatenate([xy, xy + wh], 1)
        gk = rng.integers(0, num_classes, m)
        if m >= 2:
            gb[1], gk[1] = gb[0], gk[0]  # two equal ground truths
        src = gb[rng.integers(0, m, int(rng.integers(0, 9)))] if m else np.zeros((0, 4))
        shift = rng.integers(-4, 5, (len(src), 1)).astype(float) * rng.integers(0, 2, (len(src), 1))
        noise = np.concatenate([rng.integers(0, 200, (3, 2)), rng.integers(210, 300, (3, 2))], 1).astype(float)
        db = np.concatenate([src + shift, noise]) if i % 3 else np.zeros((0, 4))
        dk = rng.integers(0, num_classes, len(db))
        dk[: len(src)] = gk[rng.integers(0, m, len(src))] if m and i % 3 else dk[: len(src)]
        dc = rng.choice([0.9, 0.5, 0.5, 0.3, 0.1], len(db))  # score ties
        dets.append((db, dc, dk))
        gts.append((gb, gk))
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluate_map_equals_jax(seed):
    dets, gts = _world(seed)
    want = jax_map.evaluate_map(dets, gts, num_classes=3)
    got = torch_map.evaluate_map(dets, gts, num_classes=3)
    assert got == want
    assert 0 < got["map"] < got["map50"] <= 1


def test_match_image_tie_break_equals_jax():
    """The first detection has IoU 90/110 with both ground truths: the
    last one wins, so the second detection, whose only candidate at 0.5 is
    the first ground truth (IoU 80/120), still matches."""
    gb = np.asarray([[0, 0, 10, 10], [2, 0, 12, 10]], float)
    db = np.asarray([[1, 0, 11, 10], [-2, 0, 8, 10]], float)
    k = np.zeros(2, int)
    want = jax_map.match_image(db, k, gb, k)
    got = torch_map.match_image(db, k, gb, k)
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].tolist() == [True, True]


def _case(name):
    """The cases of tests/test_map.py: (function of a module, expected)."""
    gt1 = (np.asarray([[0, 0, 10, 10]], float), np.asarray([0]))
    if name == "perfect":
        gt = (np.asarray([[0, 0, 10, 10], [20, 20, 30, 30]], float), np.asarray([0, 1]))
        det = (gt[0].copy(), np.asarray([0.9, 0.8]), gt[1].copy())
        return lambda m: m.evaluate_map([det], [gt], num_classes=2), {"map50": 1.0, "map": 1.0}
    if name == "wrong_class":
        det = (gt1[0].copy(), np.asarray([0.9]), np.asarray([1]))
        return lambda m: m.evaluate_map([det], [gt1], num_classes=2), {"map50": 0.0}
    if name == "half_recall":
        gt = (np.asarray([[0, 0, 10, 10], [50, 50, 60, 60]], float), np.asarray([0, 0]))
        det = (np.asarray([[0, 0, 10, 10]], float), np.asarray([0.9]), np.asarray([0]))
        return lambda m: m.evaluate_map([det], [gt], num_classes=1), {"map50": 51 / 101}
    if name == "duplicate_is_fp":
        det = np.asarray([[0, 0, 10, 10], [0.5, 0.5, 10, 10]], float)
        return (lambda m: {"tp": m.match_image(det, np.asarray([0, 0]), gt1[0], gt1[1], [0.5])[:, 0].tolist()},
                {"tp": [True, False]})
    if name == "iou_sweep":
        det = (np.asarray([[1, 1, 11, 11]], float), np.asarray([0.9]), np.asarray([0]))
        return lambda m: m.evaluate_map([det], [gt1], num_classes=1), {"map50": 1.0}
    if name == "ap_order_invariance":
        rng = np.random.default_rng(0)
        tp, conf = rng.random((50, 10)) > 0.5, rng.random(50)
        perm = rng.permutation(50)
        return (lambda m: {"ap": m.average_precision(tp, conf, n_gt=30).tolist(),
                           "ap_perm": m.average_precision(tp[perm], conf[perm], n_gt=30).tolist()}, {})
    raise ValueError(name)


@pytest.mark.parametrize("name", ["perfect", "wrong_class", "half_recall", "duplicate_is_fp", "iou_sweep",
                                  "ap_order_invariance"])
def test_map_cases_match_jax(name):
    fn, expected = _case(name)
    got, want = fn(torch_map), fn(jax_map)
    assert got == want
    for k, v in expected.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    if name == "iou_sweep":
        assert 0 < got["map"] < 1.0
    if name == "ap_order_invariance":
        np.testing.assert_allclose(got["ap"], got["ap_perm"])
