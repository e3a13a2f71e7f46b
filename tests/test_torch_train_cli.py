"""The port's training CLI against the JAX package's on the demo's rendered
world (n, 64 px, batch 2, one epoch of 4 steps, no augmentation).

Both CLIs train in bf16 by default (TrainConfig.compute_dtype). At this
size two bf16 runs cannot be compared leaf by leaf: on the same init and
batch, either package's bf16 gradients are as far from its own f32
gradients as the magnitude of the gradients themselves (the head bias
gradient 0.96 and 0.85 of its magnitude off, JAX and port), because
BatchNorm over 2 images of 2x2 to 32x32 maps turns the bf16 rounding of
every activation into an O(1) change of the small gradient sums. So the
value comparison runs both CLIs with compute_dtype float32 on the same
batches. Even in f32, single leaves may differ by O(1) of their size after
a few steps: the gradient of a max pool jumps where two candidates of a
window are within the forward's rounding (1e-5 relative here), so the
packages route it to different elements (seen on SPPF's cv1 at 128 px;
the float64 port sides with JAX there), and BN over 2x2 maps amplifies
rounding. Measured on this fixture: the worst leaf 1.8% of its magnitude,
the whole momentum tree 1.7e-3 in relative L2. The bounds are LEAF_TOL per
leaf and TREE_TOL per tree, well clear of both; a wiring fault (schedule,
groups, data, dtype) moves whole groups of leaves by O(1). The bf16 default
run of the port is held to the JAX package's files in keys, shapes, dtypes,
treedef and metadata, and is served through both packages' cli.detect;
tests/test_torch_train.py holds the bf16 arithmetic itself to the JAX
package's, block by block and over one training forward and loss of n at
256 px, where BatchNorm is well conditioned."""

import dataclasses
import json
import os
import shutil
import sys

import jax.image
import numpy as np
import pytest
import torch

from aquaculture_tpu.cli import detect as jax_detect
from aquaculture_tpu.cli import train as jax_train
from aquaculture_tpu_torch.cli import detect as torch_detect
from aquaculture_tpu_torch.cli import train as torch_train
from aquaculture_tpu_torch.models.weights import flatten_tree
from aquaculture_tpu_torch.train import dataset as torch_dataset
from aquaculture_tpu_torch.utils.checkpoint import load_metadata, load_params, save_params

LEAF_TOL = 5e-2
TREE_TOL = 1e-2


def _args(variant="n", img=64, epochs=1):
    return ["--variant", variant, "--num-classes", "2", "--img", str(img), "--batch", "2",
            "--epochs", str(epochs), "--no-augment", "--seed", "0"]


ARGS = _args()


def _xyxy(r):
    cx, cy, w, h = r
    return (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)


def _iou(a, b):
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0)
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def _f32(module):
    """module.TrainConfig with compute_dtype float32 as its default."""
    cls = module.TrainConfig
    return lambda **kw: dataclasses.replace(cls(**kw), compute_dtype="float32")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    from end_to_end_demo import render_world

    d = tmp_path_factory.mktemp("train")
    img_dir, _ = render_world(str(d), n_images=8, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "TrainConfig", _f32(jax_train))
        mp.setattr(torch_train, "TrainConfig", _f32(torch_train))
        # the same batches: the JAX package's resize in the port's dataset
        # (tests/test_torch_augment.py bounds the two resizes by 1/255)
        mp.setattr(torch_dataset, "resize_bilinear", lambda img, h, w: np.asarray(
            jax.image.resize(img.astype(np.float32), (h, w, 3), method="bilinear")))
        logged = []
        mp.setattr(jax_train, "log_info", lambda msg, *a: logged.append((msg, a)))
        jax_train.main(["--images", img_dir, "--out", str(d / "jax")] + ARGS)
        stats = torch_train.main(["--images", img_dir, "--out", str(d / "torch"), "--device", "cpu"] + ARGS)
    bf16 = torch_train.main(["--images", img_dir, "--out", str(d / "torch_bf16"), "--device", "cpu"] + ARGS)
    jax_loss = [a[2] for msg, a in logged if msg.startswith("epoch")]
    return d, img_dir, {**stats, "jax_losses": jax_loss}, bf16


def _files(path):
    spec = json.loads(open(os.path.join(path, "treedef.json")).read())
    with np.load(os.path.join(path, "params.npz")) as z:
        return spec, z.files, {k: z[k] for k in z.files}


@pytest.mark.parametrize("sub", ["last", "state"])
def test_checkpoints_match_jax(trained, sub):
    """f32: the same files and last-step loss (rtol 1e-4, after three
    updates), leaves and trees
    within LEAF_TOL and TREE_TOL. bf16 (the default): the same files,
    finite values."""
    d, _, stats, bf16 = trained
    js, jorder, jarr = _files(d / "jax" / sub)
    for run, name in ((stats, "torch"), (bf16, "torch_bf16")):
        assert run["step"] == 4 and len(run["epochs"]) == 1
        assert np.isfinite([run["epochs"][0][k] for k in ("total", "box", "obj", "cls")]).all()
        ts, torder, tarr = _files(d / name / sub)
        assert ts == js and torder == jorder  # treedef, metadata and npz order
        err, norm = {}, {}
        for k in jorder:
            assert tarr[k].shape == jarr[k].shape and tarr[k].dtype == jarr[k].dtype, k
            assert np.isfinite(tarr[k]).all(), k
            if jarr[k].dtype == np.int32:
                assert int(tarr[k]) == int(jarr[k]) == 4, k
            elif name == "torch":
                scale = float(np.abs(jarr[k]).max())
                assert float(np.abs(tarr[k] - jarr[k]).max()) <= LEAF_TOL * scale + 1e-9, k
                part = k.split("/")[0] if sub == "state" else sub
                err[part] = err.get(part, 0.0) + float(((tarr[k].astype(np.float64) - jarr[k]) ** 2).sum())
                norm[part] = norm.get(part, 0.0) + float((jarr[k].astype(np.float64) ** 2).sum())
        for part in err:
            assert (err[part] / norm[part]) ** 0.5 <= TREE_TOL, part
    assert stats["epochs"][0]["total"] == pytest.approx(stats["jax_losses"][0], rel=1e-4)
    if sub == "last":
        assert load_metadata(str(d / "torch_bf16" / sub)) == {"epoch": 1, "variant": "n", "num_classes": 2,
                                                              "img_size": 64}


def test_trained_checkpoint_serves_through_both_packages(trained):
    """The port's bf16 last/ through the port's cli.detect and the JAX
    package's: the same label files with well-formed rows, row counts
    within 5%; the two packages' loaders give the same f32 predictions
    from it (rtol 1e-4 of the largest). After 4 steps the confidences are
    flat (all near 2e-4), so which rows rank first is decided by rounding
    and rows are not matched one to one. And the JAX package's last/
    serves through the port's cli.detect."""
    import jax.numpy as jnp

    d, img_dir, _, _ = trained
    args = ["--source", img_dir, "--img", "64", "--conf", "1e-5", "--batch", "4"]
    ckpt = str(d / "torch_bf16" / "last")
    jax_detect.main(args + ["--weights", ckpt, "--out", str(d / "det_jax")])
    stats = torch_detect.main(args + ["--weights", ckpt, "--out", str(d / "det_torch"), "--device", "cpu"])
    assert stats.tiles == 8
    names = sorted(os.listdir(d / "det_jax"))
    assert names == sorted(os.listdir(d / "det_torch")) and len(names) == 8
    counts = np.zeros(2)
    for name in names:
        for i, sub in enumerate(("det_torch", "det_jax")):
            rows = np.loadtxt(d / sub / name, ndmin=2)
            assert rows.shape[1] == 6 and len(rows) and np.isfinite(rows).all()
            assert set(rows[:, 0]) <= {0.0, 1.0} and (rows[:, 5] > 0).all()
            counts[i] += len(rows)
    assert abs(counts[0] - counts[1]) <= 0.05 * counts[1]
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    jmodel, jparams = jax_detect.load_model(ckpt, "n", 2)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        got = torch_detect.load_model(ckpt, "n", 2)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    s2 = torch_detect.main(["--source", img_dir, "--img", "64", "--conf", "1e-5", "--weights",
                            str(d / "jax" / "last"), "--out", str(d / "det_torch2"), "--device", "cpu"])
    assert s2.tiles == 8 and s2.detections > 0


def test_port_resumes_from_jax_state(trained):
    """--resume on the JAX package's out/ continues at its epoch and step."""
    d, img_dir, _, _ = trained
    out = d / "resume"
    shutil.copytree(d / "jax", out)
    stats = torch_train.main(["--images", img_dir, "--out", str(out), "--device", "cpu", "--resume"]
                             + _args(epochs=2))
    assert [e["epoch"] for e in stats["epochs"]] == [2] and stats["step"] == 8
    state = load_params(str(out / "state"))
    assert int(state["step"]) == int(state["opt_step"]) == 8
    assert load_metadata(str(out / "state")) == {"epoch": 2}


def test_p6_trains_on_the_port(tmp_path, trained):
    """n6 (four levels) trains through the same CLI; its state tree has the
    JAX package's P6 keys and shapes."""
    from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5

    img_dir = trained[1]
    stats = torch_train.main(["--images", img_dir, "--out", str(tmp_path), "--device", "cpu"]
                             + _args("n6", img=128))
    assert stats["img"] == 128 and stats["step"] == 4 and np.isfinite(stats["epochs"][0]["total"])
    want = {k: np.asarray(v).shape for k, v in flatten_tree(JaxYoloV5("n6", 2).init(0)).items()}
    got = {k: v.shape for k, v in flatten_tree(load_params(str(tmp_path / "last"))).items()}
    assert got == want


@pytest.mark.parametrize("layout", ["ckpt_dir", "state_dict_pt", "full_model_pt"])
def test_warm_start_loads_the_unfused_tree(trained, tmp_path, layout):
    """--weights as the JAX package's cli.train takes it: the trained fixture
    directory, or an ultralytics .pt written from it (state dict, or the
    object-pickled full model). The training model holds the JAX reader's
    tree leaf for leaf (float32, exact) and the file's anchors; one epoch
    trains from it."""
    from aquaculture_tpu.models.export import export_full_model_pt, export_ultralytics_pt
    from aquaculture_tpu.models.weights import load_pretrained as jax_load_pretrained
    from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
    from aquaculture_tpu.utils import checkpoint as jax_ckpt
    from aquaculture_tpu_torch.models.weights import to_tree, train_state

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "demo_ckpt_n160")
    weights, anchors = fixture, None
    want = jax_ckpt.load_params(fixture)
    if layout != "ckpt_dir":
        weights = str(tmp_path / "w.pt")
        export = export_ultralytics_pt if layout == "state_dict_pt" else export_full_model_pt
        export(JaxYoloV5("n", 2), want, weights)
        want, anchors = jax_load_pretrained(JaxYoloV5("n", 2), weights)
        assert anchors is not None
    model = torch_train.build_model(weights, "n", 2, seed=0)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    got = flatten_tree(to_tree(train_state(model)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32), err_msg=k)
    assert model.anchor_table == (anchors or JaxYoloV5("n", 2).anchor_table)
    stats = torch_train.main(["--images", trained[1], "--out", str(tmp_path / "o"), "--device", "cpu",
                              "--weights", weights] + ARGS)
    assert stats["step"] == 4 and np.isfinite(stats["epochs"][0]["total"])


def test_cli_refuses_fused_weights(trained, tmp_path):
    """A BN-folded checkpoint cannot warm-start training (SystemExit, as in
    the JAX package); --mesh and a missing GPU: tests/test_torch_isolation.py."""
    base = ["--images", trained[1], "--out", str(tmp_path / "o"), "--device", "cpu"] + ARGS
    from aquaculture_tpu_torch.models.yolov5 import yolov5_init

    model, params = yolov5_init("n", 2)
    save_params(str(tmp_path / "fused"), model.fuse(params), metadata={"variant": "n", "num_classes": 2})
    with pytest.raises(SystemExit, match="FUSED"):
        torch_train.main(base + ["--weights", str(tmp_path / "fused")])
    assert not os.path.exists(tmp_path / "o")


def test_cli_img_defaults_follow_the_family(trained, tmp_path, monkeypatch):
    """--img defaults to 1280 for *6 variants and 640 otherwise, as in the
    JAX package's cli.train (the dataset is stopped before any step)."""
    seen = []

    class Stop(Exception):
        pass

    def fake_dataset(images, labels, cfg, augment, seed):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(torch_train, "DetectionDataset", fake_dataset)
    for variant in ("n6", "n"):
        with pytest.raises(Stop):
            torch_train.main(["--images", trained[1], "--out", str(tmp_path), "--device", "cpu",
                              "--variant", variant, "--remat"])
    assert [c.img_size for c in seen] == [1280, 640]
    assert all(c.remat and c.compute_dtype == "bfloat16" for c in seen)
