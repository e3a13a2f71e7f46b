"""The port's ultralytics .pt reader against the JAX package's.

The committed trained fixture (tests/data/demo_ckpt_n160: n, 2 classes,
float16 leaves) is written two ways by the JAX package's torch-free writers:
a state-dict .pt (export_ultralytics_pt) and an attempt_load-style
full-model .pt (export_full_model_pt). The port's tree must equal the JAX
reader's leaf for leaf (tolerance 0), anchors included, and the port's f32
forward after load_jax_params must match the JAX model that cli.detect's
load_model builds from the same file, at the reassociation tolerance of
tests/test_torch_checkpoint.py (1e-3 px on centres, 1e-3 px + 1e-4
relative on w/h, 1e-5 on scores). The port reads every file through one
restricted unpickler that runs nothing the file names."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu.cli.detect import load_model as jax_load_model
from aquaculture_tpu.models.export import export_full_model_pt, export_ultralytics_pt
from aquaculture_tpu.models.weights import load_pretrained as jax_load_pretrained
from aquaculture_tpu.models.weights import load_torch_checkpoint
from aquaculture_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from aquaculture_tpu.utils import checkpoint as jck
from aquaculture_tpu_torch.cli import detect as torch_cli
from aquaculture_tpu_torch.models.weights import flatten_tree, load_pretrained, read_pt_state_dict
from aquaculture_tpu_torch.models.yolov5 import YoloV5

FIXTURE = str(Path(__file__).parent / "data" / "demo_ckpt_n160")
LAYOUTS = ("state_dict", "full_model")


@pytest.fixture(scope="module")
def pt_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt")
    params = jck.load_params(FIXTURE)
    model = JaxYoloV5("n", 2)
    files = {"state_dict": str(d / "sd.pt"), "full_model": str(d / "full.pt")}
    export_ultralytics_pt(model, params, files["state_dict"])
    export_full_model_pt(model, params, files["full_model"])
    return files


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tree_and_anchors_equal_jax_reader(pt_files, layout):
    want, want_anchors = jax_load_pretrained(JaxYoloV5("n", 2), pt_files[layout])
    got, got_anchors = load_pretrained(YoloV5("n", 2), pt_files[layout])
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    got = flatten_tree(got)
    assert sorted(got) == sorted(want) and len(got) == 291
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_anchors is not None and got_anchors == want_anchors


@pytest.mark.parametrize("layout", LAYOUTS)
def test_f32_forward_matches_jax_load_model(pt_files, layout):
    jmodel, jparams = jax_load_model(pt_files[layout], "n", 2)
    model = torch_cli.load_model(pt_files[layout], "n", 2).eval()
    x = np.random.default_rng(0).random((2, 160, 160, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 2:4], want[..., 2:4], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-5, rtol=0)
    assert want[..., 4].max() > 0.5


def _state_dict(dtype):
    rng = np.random.default_rng(5)
    return {
        "model.0.conv.weight": torch.from_numpy(rng.standard_normal((4, 3, 3, 3), np.float32)).to(dtype),
        "model.0.bn.running_var": torch.from_numpy(rng.random(4, np.float32)).to(dtype),
        "model.0.bn.num_batches_tracked": torch.tensor(7),  # 0-d int64, as BatchNorm saves it
        # a strided view (float32: .to keeps it): the reader honours
        # storage offset and strides
        "model.24.anchors": torch.arange(40, dtype=torch.float32)[4:].reshape(3, 3, 4)[..., ::2].to(dtype),
    }


def test_bf16_storages_read_exactly(tmp_path):
    sd = _state_dict(torch.bfloat16)
    path = str(tmp_path / "bf16.pt")
    torch.save({"epoch": 3, **sd}, path)
    got = read_pt_state_dict(path)
    want = load_torch_checkpoint(path)  # the JAX package's reader (torch.load here)
    assert list(got) == list(sd) == list(want)
    for k, t in sd.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], t.float().numpy())
        np.testing.assert_array_equal(got[k], want[k])


def test_unreadable_storage_type_raises(tmp_path):
    path = str(tmp_path / "complex.pt")
    torch.save({"model.0.conv.weight": torch.zeros((2, 2), dtype=torch.complex64)}, path)
    with pytest.raises(ValueError, match="unsupported torch storage type.*ComplexFloatStorage"):
        read_pt_state_dict(path)


def test_tensor_outside_its_storage_raises(tmp_path):
    """A file whose tensor reaches past its storage (here: the storage cut
    short) raises instead of reading memory beyond it."""
    import zipfile

    good, bad = str(tmp_path / "good.pt"), str(tmp_path / "bad.pt")
    torch.save({"model.0.conv.weight": torch.zeros((4, 3, 3, 3))}, good)
    with zipfile.ZipFile(good) as src, zipfile.ZipFile(bad, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            dst.writestr(item, data[:64] if "/data/" in item.filename else data)
    assert read_pt_state_dict(good)["model.0.conv.weight"].shape == (4, 3, 3, 3)
    with pytest.raises(ValueError, match="outside its 16-element storage"):
        read_pt_state_dict(bad)


class _RunsCode:
    """Pickles as a call of exec: a reader that resolves globals runs it."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (exec, (f"open({self.marker!r}, 'w').write('ran')",))


def test_reader_runs_nothing_the_file_names(tmp_path):
    marker = str(tmp_path / "ran.txt")
    sd = _state_dict(torch.float32)
    path = str(tmp_path / "evil.pt")
    torch.save({**sd, "payload": _RunsCode(marker)}, path)
    got = read_pt_state_dict(path)
    assert not os.path.exists(marker)
    assert list(got) == list(sd)


def test_cli_detect_takes_pt_weights(tmp_path):
    """--weights x.pt gives the labels of --weights CKPT_DIR when the
    directory holds the same f32 tree (the fixture upcast to f32 and
    exported): one bridge, load_jax_params, serves both formats."""
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jck.load_params(FIXTURE))
    ckpt = str(tmp_path / "ckpt32")
    jck.save_params(ckpt, params, metadata={"variant": "n", "num_classes": 2})
    pt = str(tmp_path / "w.pt")
    export_ultralytics_pt(JaxYoloV5("n", 2), params, pt)
    src = tmp_path / "tiles"
    src.mkdir()
    img = np.full((1024, 1024, 3), 70, np.uint8)
    for cx, cy, r in ((300, 300, 30), (600, 420, 36), (520, 700, 24)):
        img[cy - r: cy + r, cx - r: cx - r + 6] = 235
        img[cy - r: cy + r, cx + r - 6: cx + r] = 235
        img[cy - r: cy - r + 6, cx - r: cx + r] = 235
        img[cy + r - 6: cy + r, cx - r: cx + r] = 235
    Image.fromarray(img).save(src / "ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.png")
    common = ["--source", str(src), "--img", "160", "--conf", "0.05", "--device", "cpu"]
    torch_cli.main(common + ["--weights", pt, "--variant", "n", "--num-classes", "2",
                             "--out", str(tmp_path / "from_pt")])
    torch_cli.main(common + ["--weights", ckpt, "--out", str(tmp_path / "from_dir")])
    names = sorted(os.listdir(tmp_path / "from_pt"))
    assert names == sorted(os.listdir(tmp_path / "from_dir")) == ["ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.txt"]
    text = (tmp_path / "from_pt" / names[0]).read_text()
    assert text == (tmp_path / "from_dir" / names[0]).read_text()
    assert len(text.splitlines()) >= 1
