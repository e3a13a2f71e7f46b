"""The port's ``.pt`` writers (models/export.py, cli/export.py) against the
JAX package's: the state-dict files of n and n6 and the full-model pickle
are byte-identical for the same tree, the port's reader
(``weights.read_pt_state_dict``) reads each back to an equal state dict,
cli.export resolves the checkpoint's metadata and checks ``--names`` as
the JAX CLI does, and on an f32 checkpoint ``cli.detect --weights x.pt``
emits the labels of ``--weights CKPT``."""

import glob
import os
import time
import zipfile

import numpy as np
import pytest
from PIL import Image

from aquaculture_tpu.cli import export as jax_cli_export
from aquaculture_tpu.models import export as jexport
from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu_torch.cli import detect as cli_detect
from aquaculture_tpu_torch.cli import export as cli_export
from aquaculture_tpu_torch.models import export
from aquaculture_tpu_torch.models.weights import read_pt_state_dict
from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
from aquaculture_tpu_torch.utils.checkpoint import save_params


@pytest.fixture(scope="module")
def jax_n():
    """The JAX package's n (2 classes, seed 0) and its unfused tree."""
    return jax_init("n", num_classes=2, seed=0)


class _StoppedClock:
    """zipfile's view of the time module with the clock stopped: both
    packages' writers stamp each zip entry with the wall-clock time, so
    their files are byte-identical within one stamp."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return 1_700_000_000.0


@pytest.fixture
def stopped_clock(monkeypatch):
    monkeypatch.setattr(zipfile, "time", _StoppedClock())


def _tree(jax_n, variant):
    # n: the JAX package's own tree; n6: the port's numpy init (the writers
    # only read the tree, so both take the same one)
    return jax_n[1] if variant == "n" else yolov5_init("n6", 2, seed=0)[1]


def _assert_reads_back(path, sd):
    got = read_pt_state_dict(path)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("variant", ["n", "n6"])
def test_state_dict_pt_byte_identical(jax_n, variant, tmp_path, stopped_clock):
    tree = _tree(jax_n, variant)
    jpath, path = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jsd = jexport.export_ultralytics_pt(JaxYoloV5(variant, 2), tree, jpath)
    sd = export.export_ultralytics_pt(YoloV5(variant, 2), tree, path)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert list(sd) == list(jsd)
    assert sum(k.endswith("anchors") for k in sd) == 1
    _assert_reads_back(path, sd)


def test_full_model_pt_byte_identical(jax_n, tmp_path, stopped_clock):
    tree = jax_n[1]
    jpath, path = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jexport.export_full_model_pt(JaxYoloV5("n", 2), tree, jpath, names=["circle", "square"])
    export.export_full_model_pt(YoloV5("n", 2), tree, path, names=["circle", "square"])
    assert open(path, "rb").read() == open(jpath, "rb").read()
    _assert_reads_back(path, export.state_dict_from_params(YoloV5("n", 2), tree))
    with pytest.raises(ValueError, match="training-layout tree"):
        export.full_model_graph(YoloV5("n", 2), YoloV5("n", 2).fuse(tree))


def test_int8_and_fused_trees_are_refused(jax_n):
    tree = jax_n[1]
    with pytest.raises(ValueError, match="stem_s2d"):
        export.state_dict_from_params(YoloV5("n", 2), YoloV5("n", 2).fuse(tree))
    with pytest.raises(ValueError, match="int8-quantized"):
        export.state_dict_from_params(YoloV5("n", 2), {**tree, "b0": {"wq": tree["b0"]["w"]}})


def test_cli_export_metadata_upcast_and_names(jax_n, tmp_path, stopped_clock):
    """The checkpoint's metadata wins over the defaults (n, 2 classes here,
    not m and 5), float16 leaves are upcast to f32, the files equal the JAX
    CLI's, and a --names count other than the classes' is refused."""
    half = {k: v for k, v in jax_n[1].items()}
    half["b2"] = {**half["b2"], "cv1": {**half["b2"]["cv1"], "w": np.asarray(half["b2"]["cv1"]["w"], np.float16)}}
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, half, {"variant": "n", "num_classes": 2})
    for argv in ([], ["--full-model", "--names", "circle,square"]):
        out, jout = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
        cli_export.main(["--ckpt", ckpt, "--out", out, *argv])
        jax_cli_export.main(["--ckpt", ckpt, "--out", jout, *argv])
        assert open(out, "rb").read() == open(jout, "rb").read(), argv
    sd = read_pt_state_dict(out)
    assert sd["model.2.cv1.conv.weight"].dtype == np.float32
    assert sd["model.24.m.0.weight"].shape[0] == 3 * (5 + 2)
    with pytest.raises(SystemExit, match="--names has 3 entries but the model has 2 classes"):
        cli_export.main(["--ckpt", ckpt, "--out", str(tmp_path / "x.pt"), "--full-model", "--names", "a,b,c"])
    assert not os.path.exists(tmp_path / "x.pt")


def test_cli_detect_pt_equals_checkpoint(jax_n, tmp_path):
    """An f32 checkpoint and its exported .pt serve the same labels."""
    ckpt, pt = str(tmp_path / "ckpt"), str(tmp_path / "x.pt")
    save_params(ckpt, jax_n[1], {"variant": "n", "num_classes": 2})
    cli_export.main(["--ckpt", ckpt, "--out", pt])
    src = tmp_path / "tiles"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (1024, 1024, 3), np.uint8), "RGB").save(
            src / f"ORTHOIMAGERY.ORTHOPHOTOS2014_{i}_0_0.jpeg")
    common = ["--source", str(src), "--variant", "n", "--num-classes", "2", "--img", "160", "--conf", "1e-5",
              "--batch", "2", "--device", "cpu"]
    cli_detect.main(common + ["--weights", ckpt, "--out", str(tmp_path / "ckpt_labels")])
    cli_detect.main(common + ["--weights", pt, "--out", str(tmp_path / "pt_labels")])
    a = sorted(glob.glob(str(tmp_path / "ckpt_labels" / "*.txt")))
    b = sorted(glob.glob(str(tmp_path / "pt_labels" / "*.txt")))
    assert len(a) == 2 and [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    for x, y in zip(a, b):
        assert open(x).read() == open(y).read(), os.path.basename(x)
