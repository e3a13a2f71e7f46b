"""The port's serving-accuracy harness (aquaculture_tpu_torch/eval/accuracy.py)
against the JAX package's, on the CPU: the trained fixture
tests/data/demo_ckpt_n160 on a rendered 12-image world (seed 0) at 160 px,
one table per package, every serving option that changes the arithmetic.

Tolerances (mAP), from readings:
- f32: 0. Both packages find the same rows and the same ranks in float32,
  and the evaluator is the same numpy code (read: 0 on both metrics).
- the bf16 rows and everything served in bf16 (int8, TTA, multi-label,
  top-k 512): 0.04. bf16 rounds after other summation orders in each
  framework, at 160 px one model pixel is 6.4 tile pixels, and a
  calibration scale moves with the bf16 statistics, so the tables differ
  by up to 0.025 (read: bf16 0.012, int8_mixed 0.025 on mAP@.5:.95,
  int8_safe 0.006, TTA 0.011, multi-label 0.009, top-k 512 0.012).
Then the port's own rows are held to tests/test_accuracy.py's bounds.
"""

import os
import sys

import jax
import numpy as np
import pytest

from aquaculture_tpu.eval import accuracy as jax_accuracy
from aquaculture_tpu_torch.eval import accuracy
from aquaculture_tpu_torch.models.quantize import fused_tree
from aquaculture_tpu_torch.models.weights import flatten_tree

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "demo_ckpt_n160")
CONFIGS = ("bf16", "f32", "int8_mixed", "int8_safe", "tta", "multi_label", "topk512")
TABLE_TOL = {"f32": 0.0}
BF16_TOL = 0.04


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from end_to_end_demo import render_world

    return render_world(str(tmp_path_factory.mktemp("accworld")), n_images=12, seed=0)


@pytest.fixture(scope="module")
def tables(world):
    img_dir, lab_dir = world
    want = jax_accuracy.serving_accuracy_table(img_dir, lab_dir, FIXTURE, variant="n", num_classes=2,
                                               img_size=160, configs=CONFIGS)
    got = accuracy.serving_accuracy_table(img_dir, lab_dir, FIXTURE, img_size=160, configs=CONFIGS,
                                          device="cpu")
    return {r.name: r for r in want}, {r.name: r for r in got}


@pytest.mark.parametrize("config", CONFIGS)
def test_table_row_matches_jax(tables, config):
    want, got = tables[0][config], tables[1][config]
    tol = TABLE_TOL.get(config, BF16_TOL)
    assert abs(got.map50 - want.map50) <= tol, (got, want)
    assert abs(got.map - want.map) <= tol, (got, want)


BOUNDS = {
    "fixture_is_trained": lambda t: t["bf16"].map50 >= 0.5,
    "int8_mixed_within_0.05": lambda t: abs(t["int8_mixed"].map50 - t["bf16"].map50) <= 0.05,
    "int8_safe_within_0.05_and_0.03": lambda t: (abs(t["int8_safe"].map50 - t["bf16"].map50) <= 0.05
                                                  and abs(t["int8_safe"].map - t["bf16"].map) <= 0.03),
    "topk512_within_0.02": lambda t: (abs(t["topk512"].map50 - t["bf16"].map50) <= 0.02
                                       and abs(t["topk512"].map - t["bf16"].map) <= 0.02),
    "multi_label_not_catastrophic": lambda t: t["multi_label"].map50 - t["bf16"].map50 >= -0.05,
}


@pytest.mark.parametrize("bound", sorted(BOUNDS))
def test_port_rows_hold_test_accuracy_bounds(tables, bound):
    assert BOUNDS[bound](tables[1]), {k: (r.map50, r.map) for k, r in tables[1].items()}


def test_serving_configs_and_checkpoint_match_jax(world):
    """The default row set is the JAX package's; the upcast-then-fuse load
    gives the JAX package's fused float32 tree (rtol 1e-6: jnp and numpy
    round the BN fold's square root and division alike but for an ulp),
    and the ground truths are read identically."""
    assert accuracy.SERVING_CONFIGS == jax_accuracy.SERVING_CONFIGS
    _, jparams = jax_accuracy.load_checkpoint_f32(FIXTURE, "n", 2)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
    got = flatten_tree(fused_tree(accuracy.load_checkpoint_f32(FIXTURE, "n", 2)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7 * float(np.abs(want[k]).max()), err_msg=k)
    _, lab_dir = world
    for (gs, gb, gk), (ws, wb, wk) in zip(accuracy.load_world_ground_truths(lab_dir),
                                          jax_accuracy.load_world_ground_truths(lab_dir), strict=True):
        assert gs == ws
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gk, wk)


def test_world_map_rejects_unmatched_detection_stems(monkeypatch, tmp_path):
    """A detection stem with no ground-truth label file raises, as in the
    JAX package (tests/test_accuracy.py)."""
    lab = tmp_path / "labels"
    lab.mkdir()
    (lab / "ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.txt").write_text("0 0.5 0.5 0.1 0.1\n")
    monkeypatch.setattr(accuracy, "detections_by_image", lambda *a, **k: {
        "ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0": (np.zeros((0, 4)), np.zeros(0), np.zeros(0, int)),
        "ORTHOIMAGERY.ORTHOPHOTOS2014_1_512_0": (np.zeros((1, 4)), np.ones(1), np.zeros(1, int)),
    })
    with pytest.raises(ValueError, match="no ground-truth"):
        accuracy.world_map(["unused"], str(lab), model=None, cfg=None, device="cpu")


def test_unknown_serving_config_raises(world):
    img_dir, lab_dir = world
    with pytest.raises(ValueError, match="unknown serving config"):
        accuracy.serving_accuracy_table(img_dir, lab_dir, FIXTURE, configs=("fp8",), device="cpu")
