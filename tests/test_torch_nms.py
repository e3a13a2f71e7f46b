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


def _threshold(iou_thresh):
    """(mid, tie_up) of csrc/nms_suppress.cu: RN(q) > thr exactly when
    q > mid, or q == mid and tie_up; mid is halfway from thr to the next
    float (2^128 above FLT_MAX)."""
    t = np.float32(iou_thresh)
    nxt = np.nextafter(t, np.float32(np.inf))
    up = 2.0**128 if (np.isinf(nxt) and np.isfinite(t)) else float(nxt)
    return 0.5 * (float(t) + up), bool((nxt.view(np.uint32) & 1) == 0)


def _above(inter, uni, mid, tie_up):
    """The kernel's division-free decision RN(iou) > thr for f32 inter and
    union, compared in float64, where mid * den is exact."""
    pos = uni > 0
    num = np.where(pos, inter, np.float32(0)).astype(np.float64)
    den = np.where(pos, np.maximum(uni, np.float32(1e-9)), np.float32(1)).astype(np.float64)
    rhs = mid * den
    return (num > rhs) | (tie_up & (num == rhs))


def _iou_above(bx, area, g, j, thr):
    """IoU(g, j) > thr over index arrays as the CUDA kernel decides it: the
    reference's f32 inter and union, g first, then the division-free test."""
    w = np.maximum(np.minimum(bx[g, 2], bx[j, 2]) - np.maximum(bx[g, 0], bx[j, 0]), np.float32(0))
    h = np.maximum(np.minimum(bx[g, 3], bx[j, 3]) - np.maximum(bx[g, 1], bx[j, 1]), np.float32(0))
    inter = w * h
    return _above(inter, (area[g] + area[j]) - inter, *thr)


def _blocked_suppress(boxes, valid, iou_thresh=0.45):
    """numpy emulation of csrc/nms_suppress.cu: 32-candidate words, the
    alive bitset, in-block row words, then per word with an alive bit the
    32-step greedy chain on bits (the kept word and its table of kept
    boxes), and the kept boxes clearing every later live candidate."""
    thr = _threshold(iou_thresh)
    b, k, _ = boxes.shape
    words = -(-k // 32)
    lanes = np.arange(32)
    keep = np.zeros((b, k), bool)
    for n in range(b):
        bx = np.zeros((32 * words, 4), np.float32)  # rows past K: zero boxes
        bx[:k] = boxes[n]
        area = np.maximum(bx[:, 2] - bx[:, 0], np.float32(0)) * np.maximum(bx[:, 3] - bx[:, 1], np.float32(0))
        v = np.zeros(32 * words, bool)
        v[:k] = valid[n]
        alive = [int((v[32 * u : 32 * u + 32].astype(np.int64) << lanes).sum()) for u in range(words)]
        rows = np.zeros(32 * words, np.int64)
        for u in range(words):
            if alive[u] == 0:
                continue
            g, c = np.meshgrid(32 * u + lanes, 32 * u + lanes, indexing="ij")
            above = _iou_above(bx, area, g, c, thr) & (c > g)
            rows[32 * u : 32 * u + 32] = (above.astype(np.int64) << lanes).sum(axis=1)
        kept = [0] * words
        for t in range(words):
            if alive[t] == 0:
                continue
            removed, kw = ~alive[t] & 0xFFFFFFFF, 0
            for i in range(32):  # the chain on bits
                if not (removed >> i) & 1:
                    kw |= 1 << i
                    removed |= int(rows[32 * t + i])
            kept[t] = kw
            g = 32 * t + lanes[(kw >> lanes) & 1 == 1]  # the kept table
            for u in range(t + 1, words):  # later live candidates
                if alive[u] == 0:
                    continue
                j = 32 * u + lanes[(alive[u] >> lanes) & 1 == 1]
                sup = _iou_above(bx, area, g[:, None], j[None, :], thr).any(axis=0)
                alive[u] &= ~int((np.int64(1) << (j[sup] - 32 * u)).sum())
        keep[n] = np.concatenate([(w >> lanes) & 1 == 1 for w in kept])[:k]
    return keep


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.7, 0.3, 0.0, 1.0, -0.25])
def test_division_free_decision_matches_f32_division(thr):
    """The kernel's iou > thr without a division equals RN(inter / den) > thr
    on random pairs and on quotients a few ulps either side of thr."""
    rng = np.random.default_rng(int(abs(thr) * 100))
    t = np.float32(thr)
    den = rng.uniform(1e-3, 1e6, 200_000).astype(np.float32)
    inter = np.concatenate([
        (den * rng.uniform(0, 1.2, den.size)).astype(np.float32),
        (den.astype(np.float64) * float(t)).astype(np.float32),
    ])
    den = np.concatenate([den, den])
    steps = rng.integers(-3, 4, inter.size)
    for s in (-1, 1):
        m = np.sign(steps) == s
        for _ in range(3):
            inter[m & (np.abs(steps) > _)] = np.nextafter(
                inter[m & (np.abs(steps) > _)], np.float32(s * np.inf))
    inter = np.abs(inter)
    uni = den  # uni > 0 here, so den = max(uni, 1e-9) = uni
    with np.errstate(all="ignore"):
        want = (inter / den) > t
    got = _above(inter, uni, *_threshold(t))
    np.testing.assert_array_equal(got, want)
    assert want.any() or t >= 1.0
    # union <= 0: iou is 0
    zero = _above(np.float32([0.5]), np.float32([0.0]), *_threshold(t))
    assert zero[0] == (np.float32(0) > t)


@pytest.mark.parametrize("t_units, tie_up", [(3, True), (2, False)])
def test_division_free_decision_ties_round_to_even(t_units, tie_up):
    """A quotient exactly halfway between a subnormal thr and the next float
    rounds to the even one; the decision follows it."""
    t = np.float32(t_units * 2.0**-149)
    mid, up = _threshold(t)
    assert up == tie_up
    den = np.float32(2.0**100)
    inter = np.float32(mid * 2.0**100)  # exact: mid has few bits here
    assert float(inter) / float(den) == mid
    with np.errstate(all="ignore"):
        want = (np.float32(inter) / den) > t
    assert bool(want) == tie_up
    assert bool(_above(np.float32([inter]), np.float32([den]), mid, up)[0]) == tie_up


@pytest.mark.parametrize("k", [1, 31, 32, 33, 300, 1000, 1024])
@pytest.mark.parametrize("suite", ["random", "identical", "boundary", "boundary_straddle",
                                   "class_offset", "partly_invalid"])
def test_blocked_suppress_matches_plain_and_xla(suite, k):
    """The CUDA kernel's algorithm, emulated, gives the exact keep masks of
    the port's plain version and the JAX package's XLA suppression on the
    card's exactness suites (chip_smoke.suite_inputs); boundary_straddle
    puts threshold pairs across the 32-candidate word edges."""
    import chip_smoke

    boxes, valid = chip_smoke.suite_inputs(suite, 2, k, seed=k)
    got = _blocked_suppress(boxes, valid)
    np.testing.assert_array_equal(got, _plain(boxes, valid))
    np.testing.assert_array_equal(got, _jax_xla_suppress(boxes, valid))
    if suite == "boundary_straddle" and k >= 64:
        # the pairs (31, 32) and (63, 64) sit at the threshold
        iou = tnms._iou_matrix(torch.from_numpy(boxes[0])).numpy()
        assert abs(iou[31, 32] - np.float32(0.45)) < 1e-5
        assert abs(iou[63, 64] - np.float32(0.45)) < 1e-5


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
