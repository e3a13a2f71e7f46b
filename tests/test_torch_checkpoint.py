"""The port's jax-free checkpoint reader against the JAX package's, and the
port's forward on the committed trained fixture (n, 2 classes, 160 px,
float16 leaves) against the JAX package's.

The fixture's box sizes reach 4x its largest anchor (~1,500 px), where f32
rounding grows with the value: the JAX package and the port sit about
equally far from a float64 forward of the same weights (0.011 and 0.015 px
on w/h at 160 px). So w/h take a relative tolerance of 1e-4 on top of the
1e-3 px used for centres."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from aquaculture_tpu.utils import checkpoint as jck
from aquaculture_tpu_torch.models.weights import load_jax_params
from aquaculture_tpu_torch.models.yolov5 import YoloV5
from aquaculture_tpu_torch.utils import checkpoint as tck

FIXTURE = str(Path(__file__).parent / "data" / "demo_ckpt_n160")


def _same_tree(a, b, path=""):
    assert type(a) is type(b) or (not isinstance(a, (dict, list)) and not isinstance(b, (dict, list))), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    else:
        assert isinstance(a, np.ndarray), path
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)


def test_reader_matches_jax_reader():
    got = tck.load_params(FIXTURE)
    _same_tree(got, jck.load_params(FIXTURE))
    assert tck.load_metadata(FIXTURE) == jck.load_metadata(FIXTURE)
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(got)
    assert len(leaves) == 291 and {a.dtype for a in leaves} == {np.dtype(np.float16)}


def test_fixture_forward_matches_jax_at_160():
    meta = tck.load_metadata(FIXTURE)
    variant, nc = meta["variant"], int(meta["num_classes"])
    jmodel = JaxYoloV5(variant=variant, num_classes=nc)
    jparams = jmodel.fuse(jck.load_params(FIXTURE))  # folds BN in float16
    model = load_jax_params(YoloV5(variant, nc), tck.load_params(FIXTURE))
    x = np.random.default_rng(0).random((2, 160, 160, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 2:4], want[..., 2:4], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-5, rtol=0)
    assert want[..., 4].max() > 0.5  # a trained model: confident detections
