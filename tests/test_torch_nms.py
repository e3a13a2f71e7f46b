"""PyTorch port NMS (aquaculture_tpu_torch.ops.nms) against the JAX package.

The suppression is exact: every comparison of keep flags and validity masks
is elementwise equality; det rows agree to 1e-5 (the same f32 arithmetic on
the same candidates)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.ops.nms_pallas import greedy_suppress_pallas
from aquaculture_tpu_torch.ops import nms as tnms

# the JAX package's ops/__init__ re-exports a function named `nms`
jnms = importlib.import_module("aquaculture_tpu.ops.nms")


def _random_sorted_boxes(rng, b, k, size=640.0):
    cx = rng.uniform(50, size - 50, (b, k))
    cy = rng.uniform(50, size - 50, (b, k))
    w = rng.uniform(10, 120, (b, k))
    h = rng.uniform(10, 120, (b, k))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1).astype(np.float32)
    return boxes, rng.random((b, k)) > 0.1


@jax.jit
def _xla_suppress(boxes, valid):
    return jax.vmap(lambda b, v: jnms._greedy_suppress(jnms._iou_matrix(b), v, 0.45))(boxes, valid)


def _jax_xla_suppress(boxes, valid):
    return np.asarray(_xla_suppress(jnp.asarray(boxes), jnp.asarray(valid)))


def _plain(boxes, valid):
    return tnms.greedy_suppress_plain(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45).numpy()


def test_iou_matrix_matches_jax():
    boxes, _ = _random_sorted_boxes(np.random.default_rng(0), 1, 200)
    want = np.asarray(jnms._iou_matrix(jnp.asarray(boxes[0])))
    got = tnms._iou_matrix(torch.from_numpy(boxes[0])).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [128, 256, 640])
def test_plain_suppress_matches_xla_and_pallas(k):
    boxes, valid = _random_sorted_boxes(np.random.default_rng(k), 3, k)
    got = _plain(boxes, valid)
    np.testing.assert_array_equal(got, _jax_xla_suppress(boxes, valid))
    pallas = greedy_suppress_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.45, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("k", [1, 300])
def test_plain_suppress_odd_k_matches_xla(k):
    boxes, valid = _random_sorted_boxes(np.random.default_rng(k), 2, k)
    np.testing.assert_array_equal(_plain(boxes, valid), _jax_xla_suppress(boxes, valid))


def test_plain_suppress_invalid_stay_suppressed():
    boxes, valid = _random_sorted_boxes(np.random.default_rng(1), 1, 128)
    valid[0, :64] = False
    keep = _plain(boxes, valid)
    assert not keep[0, :64].any()
    np.testing.assert_array_equal(keep, _jax_xla_suppress(boxes, valid))


def test_plain_suppress_identical_keeps_first():
    boxes = np.tile(np.asarray([10.0, 10.0, 50.0, 50.0], np.float32), (1, 128, 1))
    keep = _plain(boxes, np.ones((1, 128), bool))
    assert keep[0, 0] and not keep[0, 1:].any()


def _boundary_pairs(n_pairs, steps):
    """Pairs (base, base shifted right by d): IoU = (100 - d) / (100 + d),
    with d a few float32 ulps either side of the IoU = 0.45 shift. Pairs
    are stacked 300 px apart in y only, so x keeps d's full precision."""
    d0 = np.float32(100.0 * 0.55 / 1.45)
    boxes = np.zeros((1, 2 * n_pairs, 4), np.float32)
    for p in range(n_pairs):
        oy = np.float32(300 * p)
        d = d0
        for _ in range(abs(steps[p])):
            d = np.nextafter(d, np.float32(np.inf if steps[p] > 0 else -np.inf))
        boxes[0, 2 * p] = [0, oy, 100, oy + 100]
        boxes[0, 2 * p + 1] = [d, oy, np.float32(100) + d, oy + np.float32(100)]
    return boxes


def test_plain_suppress_boundary_pairs_match():
    steps = np.arange(-32, 32)  # 64 pairs -> K = 128
    boxes = _boundary_pairs(len(steps), steps)
    iou = tnms._iou_matrix(torch.from_numpy(boxes[0])).numpy()
    pair_iou = np.array([iou[2 * p, 2 * p + 1] for p in range(len(steps))])
    # the pairs straddle the threshold: one IoU equals float32(0.45) (kept:
    # the test is strict), others sit 1 ulp above and below it
    thr = np.float32(0.45)
    assert np.abs(pair_iou - thr).max() < 1e-5
    assert (pair_iou == thr).any()
    assert (pair_iou == np.nextafter(thr, np.float32(1))).any()
    assert (pair_iou == np.nextafter(thr, np.float32(0))).any()
    valid = np.ones(boxes.shape[:2], bool)
    got = _plain(boxes, valid)
    np.testing.assert_array_equal(got, _jax_xla_suppress(boxes, valid))
    pallas = greedy_suppress_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.45, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def _random_preds(rng, b, n, nc):
    return np.concatenate(
        [
            np.stack(
                [
                    rng.uniform(50, 590, (b, n)),
                    rng.uniform(50, 590, (b, n)),
                    rng.uniform(10, 120, (b, n)),
                    rng.uniform(10, 120, (b, n)),
                    rng.uniform(0, 1, (b, n)),
                ],
                axis=-1,
            ),
            rng.dirichlet(np.ones(nc), (b, n)),
        ],
        axis=-1,
    ).astype(np.float32)


def _tie_heavy_preds(rng, b, n, nc):
    """Scores from a handful of bf16-representable levels: thousands of
    exact ties in the candidate pool."""
    p = _random_preds(rng, b, n, nc)
    p[..., 4] = rng.choice(np.asarray([0.5, 0.625, 0.75, 1.0], np.float32), (b, n))
    cls = np.zeros((b, n, nc), np.float32)
    idx = rng.integers(0, nc, (b, n))
    np.put_along_axis(cls, idx[..., None], rng.choice(np.asarray([0.5, 0.75], np.float32), (b, n))[..., None], -1)
    p[..., 5:] = cls
    return p


def _compare_batched(preds, **kw):
    det_j, val_j = jax.jit(functools.partial(jnms.batched_nms, backend="xla", **kw))(jnp.asarray(preds))
    det_t, val_t = tnms.batched_nms(torch.from_numpy(preds), **kw)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), atol=1e-5, rtol=0)
    return val_t.numpy()


@pytest.mark.parametrize("class_agnostic", [False, True])
def test_batched_nms_matches_jax_random(class_agnostic):
    preds = _random_preds(np.random.default_rng(3), 2, 300, 5)
    val = _compare_batched(preds, conf_thresh=0.1, max_det=100, pre_topk=256,
                           class_agnostic=class_agnostic)
    assert val.sum() > 0


@pytest.mark.parametrize("class_agnostic", [False, True])
def test_batched_nms_matches_jax_tie_heavy_two_stage(class_agnostic):
    # 25,200 rows (P5 @ 640) with k = 1024: the reference takes its exact
    # two-stage top-k, and bf16-like scores tie by the thousand
    n, k = 25_200, 1024
    assert n >= jnms._TWO_STAGE_RATIO * k and n > jnms._TWO_STAGE_BLOCK
    preds = _tie_heavy_preds(np.random.default_rng(11), 2, n, 5)
    val = _compare_batched(preds, conf_thresh=0.25, max_det=300, pre_topk=k,
                           class_agnostic=class_agnostic)
    assert val.sum() > 0


def test_select_topk_matches_lax_order_on_ties():
    rng = np.random.default_rng(5)
    score = rng.choice(np.asarray([-1.0, 0.25, 0.5, 0.75], np.float32), 25_200)
    vals_j, idx_j = jnms._select_topk(jnp.asarray(score), 1024, False)
    vals_t, idx_t = tnms._select_topk(torch.from_numpy(score), 1024)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


def test_batched_nms_rejects_unknown_backend():
    preds = torch.from_numpy(_random_preds(np.random.default_rng(0), 1, 16, 2))
    with pytest.raises(ValueError, match="backend"):
        tnms.batched_nms(preds, backend="pallas")
