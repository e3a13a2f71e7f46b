"""PyTorch port blocks (aquaculture_tpu_torch.models.layers) against the JAX
package's layers, in float32. Tolerance atol = rtol = 1e-4: the two
frameworks sum the same products in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aquaculture_tpu.models import layers as JL
from aquaculture_tpu_torch.models import layers as TL
from aquaculture_tpu_torch.models.weights import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # channels_last view


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _fused(tree):
    """A JAX init tree with random BN statistics, fused by the JAX package."""
    rng = np.random.default_rng(1)

    def perturb(t):
        if isinstance(t, dict):
            if "bn" in t:
                c = t["bn"]["scale"].shape[0]
                t = {**t, "bn": {
                    "scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                    "bias": jnp.asarray(rng.standard_normal(c), jnp.float32),
                    "mean": jnp.asarray(rng.standard_normal(c) * 0.1, jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32),
                }}
                return t
            return {k: perturb(v) for k, v in t.items()}
        if isinstance(t, list):
            return [perturb(v) for v in t]
        return t

    return JL.tree_map_fuse(perturb(tree))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("stride,padding", [(1, None), (2, None), (1, [(1, 0), (1, 0)])])
def test_conv_block_matches_jax(stride, padding):
    rng = np.random.default_rng(0)
    p = _fused(JL.conv_init(rng, 8, 12, 3))
    x = rng.standard_normal((2, 16, 16, 8), dtype=np.float32)
    want, _ = JL.conv_block(jnp.asarray(x), p, stride, padding)
    block = load_jax_params(TL.ConvBlock(8, 12, 3), _np_tree(p))
    pad = None if padding is None else tuple(map(tuple, padding))
    with torch.no_grad():
        got = block(_nchw(x), stride, pad)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shortcut", [True, False])
def test_c3_matches_jax(shortcut):
    rng = np.random.default_rng(2)
    p = _fused(JL.c3_init(rng, 16, 16, 2))
    x = rng.standard_normal((2, 12, 12, 16), dtype=np.float32)
    want, _ = JL.c3(jnp.asarray(x), p, shortcut)
    block = load_jax_params(TL.C3(16, 16, 2), _np_tree(p))
    with torch.no_grad():
        got = block(_nchw(x), shortcut)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_sppf_matches_jax():
    rng = np.random.default_rng(3)
    p = _fused(JL.sppf_init(rng, 16, 24))
    # negative inputs everywhere: the pool's padding must be -inf, not 0
    x = -np.abs(rng.standard_normal((2, 9, 9, 16), dtype=np.float32)) - 4.0
    want, _ = JL.sppf(jnp.asarray(x), p)
    block = load_jax_params(TL.SPPF(16, 24), _np_tree(p))
    with torch.no_grad():
        got = block(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    pooled = TL.max_pool(_nchw(x))
    np.testing.assert_array_equal(_nhwc(pooled), np.asarray(JL.max_pool(jnp.asarray(x))))


def test_space_to_depth_and_upsample_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 8, 6, 5), dtype=np.float32)
    np.testing.assert_array_equal(
        _nhwc(TL.space_to_depth2(_nchw(x))), np.asarray(JL.space_to_depth2(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _nhwc(TL.upsample2x(_nchw(x))), np.asarray(JL.upsample2x(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_fuse_conv_bn_matches_jax(dtype):
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((3, 3, 4, 6)).astype(dtype), "bn": {
        "scale": rng.uniform(0.5, 1.5, 6).astype(dtype),
        "bias": rng.standard_normal(6).astype(dtype),
        "mean": (rng.standard_normal(6) * 0.1).astype(dtype),
        "var": rng.uniform(0.5, 2.0, 6).astype(dtype),
    }}
    want = JL.fuse_conv_bn(_jnp_tree(p))
    got = TL.fuse_conv_bn(p)
    for k in ("w", "b"):
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_allclose(got[k].astype(np.float32), np.asarray(want[k], np.float32),
                                   rtol=1e-3 if dtype == np.float16 else 1e-6, atol=0)


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_s2d_reparams_match_jax_and_are_exact():
    rng = np.random.default_rng(6)
    w6 = rng.standard_normal((6, 6, 3, 8)).astype(np.float32)
    w3 = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    s6, s3 = TL.stem_weights_to_s2d(w6), TL.down_weights_to_s2d(w3)
    np.testing.assert_array_equal(s6, np.asarray(JL.stem_weights_to_s2d(jnp.asarray(w6))))
    np.testing.assert_array_equal(s3, np.asarray(JL.down_weights_to_s2d(jnp.asarray(w3))))
    # the reparametrized convs compute the original ones
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    oihw = lambda w: torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # noqa: E731
    np.testing.assert_allclose(
        TL.conv2d(TL.space_to_depth2(x), oihw(s6), 1, ((1, 1), (1, 1))).numpy(),
        TL.conv2d(x, oihw(w6), 2, ((2, 2), (2, 2))).numpy(), **TOL)
    y = torch.from_numpy(rng.standard_normal((2, 8, 16, 16)).astype(np.float32))
    np.testing.assert_allclose(
        TL.conv2d(TL.space_to_depth2(y), oihw(s3), 1, ((1, 0), (1, 0))).numpy(),
        TL.conv2d(y, oihw(w3), 2).numpy(), **TOL)
