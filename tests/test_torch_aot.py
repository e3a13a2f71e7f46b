"""The port's AOT serving artifact (models/aot.py, cli/aot.py, cli.detect
--aot) against the live serving program and the JAX package's artifact.

The exported program must be the serving computation ``make_infer_fn``
runs (rows ``torch.equal`` after a save/load round trip, in f32, int8_safe
and TTA with multi-label), agree with the JAX package's own artifact within
the port's f32 bar (boxes 1e-3 px, confidence 1e-4, the same classes and
validity), carry no weights, and refuse what it cannot serve. Everything on
the CPU (``device="cpu"``) at the JAX package's test size: n, 160 px, 256 px
tiles, batch 2."""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
from aquaculture_tpu.models import aot as jaot
from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu_torch.cli import aot as cli_aot
from aquaculture_tpu_torch.cli import detect as cli_detect
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.models import aot
from aquaculture_tpu_torch.models.quantize import quantize_model, serving_int8_safe_skip
from aquaculture_tpu_torch.models.weights import load_jax_params
from aquaculture_tpu_torch.models.yolov5 import DEFAULT_ANCHORS, YoloV5, yolov5_init
from aquaculture_tpu_torch.pipeline import make_infer_fn
from aquaculture_tpu_torch.utils.checkpoint import save_params

F32 = dict(img_size=160, conf_threshold=3e-5, dtype="float32")


@pytest.fixture(scope="module")
def jax_n():
    """The JAX package's n (2 classes, seed 0) and its unfused tree."""
    return jax_init("n", num_classes=2, seed=0)


def port_model(params, variant="n", anchors=None):
    return load_jax_params(YoloV5(variant, 2, anchors=anchors), params)


def tiles(seed=0, b=2, t=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, t, t, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def f32_artifact(jax_n, tmp_path_factory):
    """The f32 serving program of the JAX fixture's weights, saved."""
    blob, meta = aot.export_serving(port_model(jax_n[1]), DetectConfig(**F32), batch_size=2, tile=256,
                                    device="cpu")
    path = str(tmp_path_factory.mktemp("aot") / "serving_f32.aqt")
    aot.save_aot(path, blob, meta)
    return path


@pytest.fixture(scope="module")
def f32_program(f32_artifact):
    return aot.load_aot(f32_artifact)


def _int8_model(params):
    model = port_model(params)
    calib = torch.from_numpy(np.random.default_rng(1).random((2, 160, 160, 3), dtype=np.float32))
    return quantize_model(model, calib, skip=serving_int8_safe_skip("n"))


@pytest.mark.parametrize("case", ["f32", "int8_safe", "tta_multi_label"])
def test_artifact_rows_equal_live(case, jax_n, f32_artifact, tmp_path):
    params = jax_n[1]
    if case == "f32":
        path, cfg, model = f32_artifact, DetectConfig(**F32), port_model(params)
    else:
        if case == "int8_safe":
            model, cfg = _int8_model(params), DetectConfig(img_size=160, conf_threshold=1e-5)
        else:
            model = port_model(params)
            cfg = DetectConfig(img_size=160, conf_threshold=1e-5, augment=True, multi_label=True)
        blob, meta = aot.export_serving(model, cfg, batch_size=2, tile=256, device="cpu")
        assert meta["quantized"] is (case == "int8_safe")
        assert meta["augment"] is meta["multi_label"] is (case == "tta_multi_label")
        path = str(tmp_path / "serving.aqt")
        aot.save_aot(path, blob, meta)
    got = aot.read_meta(path)
    assert (got["variant"], got["num_classes"], got["batch_size"], got["tile"], got["device"]) == \
        ("n", 2, 2, 256, "cpu")
    assert got["torch_version"] == torch.__version__ and got["params"]["n_leaves"] > 0

    fn, _ = aot.serving_fn(path, model, device="cpu")
    x = tiles()
    det_a, val_a = fn(x)
    det_l, val_l = make_infer_fn(model, cfg, tile=256, device="cpu")(x)
    assert torch.equal(det_a, det_l) and torch.equal(val_a, val_l)
    assert int(val_a.sum()) > 0


def test_artifact_agrees_with_the_jax_artifact(jax_n, f32_artifact, tmp_path):
    """The same tiles and weights through the JAX package's own artifact
    (jax.export on the CPU): the port's f32 bar."""
    jmodel, params = jax_n
    fused = jmodel.fuse(params)
    blob, meta = jaot.export_serving(jmodel, fused, JaxDetectConfig(**F32), batch_size=2, tile=256)
    jpath = str(tmp_path / "serving.aqx")
    jaot.save_aot(jpath, blob, meta)
    jfn, _ = jaot.serving_fn(jpath, fused)
    x = tiles(seed=2)
    det_j, val_j = (np.asarray(a) for a in jfn(fused, x.numpy()))
    fn, _ = aot.serving_fn(f32_artifact, port_model(params), device="cpu")
    det_t, val_t = (a.numpy() for a in fn(x))
    np.testing.assert_array_equal(val_t, val_j)
    assert val_j.sum() > 0
    np.testing.assert_allclose(det_t[..., :4], det_j[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(det_t[..., 4], det_j[..., 4], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(det_t[..., 5], det_j[..., 5])

    # each package refuses the other's artifact
    with pytest.raises(ValueError, match="JAX-package AOT artifact"):
        aot.read_meta(jpath)
    with pytest.raises(ValueError, match="not an aquaculture_tpu AOT artifact"):
        jaot.read_meta(f32_artifact)


def test_artifact_refusals(jax_n, f32_program, tmp_path):
    params = jax_n[1]
    program, meta = f32_program
    # another structure: s has other widths
    other = load_jax_params(*yolov5_init("s", 2))
    with pytest.raises(ValueError, match="does not match the artifact"):
        aot.serving_fn_loaded(program, meta, other, device="cpu")
    # another precision: the same model placed in bf16 is another structure
    with pytest.raises(ValueError, match="does not match the artifact"):
        aot.serving_fn_loaded(program, {**meta, "dtype": "bfloat16"}, port_model(params), device="cpu")
    # the same structure with evolved anchors, and a ragged table
    evolved = tuple(tuple((w * 1.5, h * 0.75) for (w, h) in lvl) for lvl in DEFAULT_ANCHORS)
    with pytest.raises(ValueError, match="anchor table mismatch"):
        aot.serving_fn_loaded(program, meta, port_model(params, anchors=evolved), device="cpu")
    ragged = tuple(tuple(lvl) + ((99.0, 99.0),) for lvl in DEFAULT_ANCHORS)
    with pytest.raises(ValueError, match="anchor table mismatch"):
        aot.serving_fn_loaded(program, meta, port_model(params), device="cpu", anchors=ragged)
    # an artifact traced for another device type
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        aot.serving_fn_loaded(program, {**meta, "device": "cuda"}, port_model(params), device="cpu")
    # not an artifact, truncated, corrupt metadata
    for name, raw, match in (("bad", b"nope", "not an aquaculture_tpu_torch AOT artifact"),
                             ("trunc", b"AQT1", "truncated"),
                             ("corrupt", b"AQT1" + (7).to_bytes(4, "little") + b"not-js{", "corrupt")):
        p = tmp_path / name
        p.write_bytes(raw)
        with pytest.raises(ValueError, match=match):
            aot.read_meta(str(p))


def test_artifact_holds_no_weights(jax_n, f32_artifact, f32_program):
    """The file is the graph and the metadata: far smaller than the f32
    weights it serves, and no tensor of the program's state or constants
    is weight-sized."""
    model = port_model(jax_n[1])
    weight_bytes = sum(t.numel() * t.element_size() for _, t in aot.serving_tensors(model))
    assert weight_bytes > 7_000_000
    assert os.path.getsize(f32_artifact) < weight_bytes / 4
    program, _ = f32_program
    assert not program.state_dict
    assert all(c.numel() <= 64 for c in program.constants.values())
    assert program.example_inputs is None


def test_the_registered_op_is_one_node_of_the_program(f32_program):
    program, _ = f32_program
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum("aquaculture_tpu_torch.nms_suppress" in t for t in targets) == 1, \
        [t for t in targets if "nms" in t]


@pytest.fixture(scope="module")
def tile_dir(tmp_path_factory):
    src = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(3)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (1024, 1024, 3), np.uint8), "RGB").save(
            src / f"ORTHOIMAGERY.ORTHOPHOTOS2014_{i}_0_0.jpeg")
    return src


def test_cli_detect_serves_from_artifact(jax_n, tile_dir, tmp_path, capsys):
    """cli.aot export -> describe -> warmup -> cli.detect --aot emits the
    label files of the live cli.detect byte for byte; the --aot refusals."""
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, jax_n[1], {"variant": "n", "num_classes": 2})
    prog = str(tmp_path / "serving.aqt")
    meta = cli_aot.main(["export", "--weights", ckpt, "--batch", "2", "--img", "160", "--conf", "1e-5",
                         "--out", prog, "--device", "cpu"])
    assert (meta["variant"], meta["num_classes"], meta["tile"], meta["device"]) == ("n", 2, 1024, "cpu")
    capsys.readouterr()
    cli_aot.main(["describe", "--program", prog])
    assert '"kind": "aquaculture_tpu_torch.serving"' in capsys.readouterr().out
    assert cli_aot.main(["warmup", "--program", prog, "--weights", ckpt, "--device", "cpu"]) > 0

    common = ["--weights", ckpt, "--source", str(tile_dir / "*.jpeg"), "--device", "cpu"]
    cli_detect.main(common + ["--aot", prog, "--out", str(tmp_path / "aot_labels")])
    cli_detect.main(common + ["--img", "160", "--conf", "1e-5", "--batch", "2",
                              "--out", str(tmp_path / "live_labels")])
    aot_files = sorted(glob.glob(str(tmp_path / "aot_labels" / "*.txt")))
    live_files = sorted(glob.glob(str(tmp_path / "live_labels" / "*.txt")))
    assert len(aot_files) == 3
    assert [os.path.basename(p) for p in aot_files] == [os.path.basename(p) for p in live_files]
    for a, b in zip(aot_files, live_files):
        assert open(a).read() == open(b).read(), os.path.basename(a)

    # the refusals: flags the fixed program cannot honour, an int8 artifact
    # without --int8, an artifact traced for another device type
    with open(prog, "rb") as f:
        head = aot._read_header(f, prog)
        body = f.read()
    for name, m in (("int8", {**head, "quantized": True}), ("cuda", {**head, "device": "cuda"})):
        aot.save_aot(str(tmp_path / f"{name}.aqt"), body, m)
    out = ["--out", str(tmp_path / "refused")]
    for extra, match in ((["--aot", prog, "--decode-scale"], "--decode-scale cannot be combined"),
                         (["--aot", prog, "--pre-topk", "512"], "--pre-topk cannot be combined"),
                         (["--aot", str(tmp_path / "int8.aqt")], "is an int8 artifact"),
                         (["--aot", str(tmp_path / "cuda.aqt")], "exported for --device cuda")):
        with pytest.raises(SystemExit, match=match):
            cli_detect.main(common + extra + out)
    assert not os.path.exists(tmp_path / "refused")


def test_op_dispatches_cpu_tensors_to_the_plain_version():
    from aquaculture_tpu_torch.ops import nms

    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 600, (3, 64, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 80, (3, 64, 2)).astype(np.float32)], -1))
    valid = torch.from_numpy(rng.random((3, 64)) > 0.2)
    want = nms.greedy_suppress_plain(boxes, valid, 0.45)
    assert torch.equal(torch.ops.aquaculture_tpu_torch.nms_suppress(boxes, valid, 0.45), want)
    assert torch.equal(nms.greedy_suppress(boxes, valid, 0.45), want)
    assert torch._C._dispatch_has_kernel_for_dispatch_key("aquaculture_tpu_torch::nms_suppress", "CPU")


def test_op_cuda_registration_routes_to_the_kernel(monkeypatch):
    """The CUDA registration is the wrapper of the hand-written kernel,
    which launches or raises: given CPU tensors it raises, uncaught."""
    from aquaculture_tpu_torch.ops import nms, nms_cuda

    assert torch._C._dispatch_has_kernel_for_dispatch_key("aquaculture_tpu_torch::nms_suppress", "CUDA")
    boxes, valid = torch.zeros((1, 8, 4)), torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        nms._suppress_cuda(boxes, valid, 0.45)
    calls = []
    monkeypatch.setattr(nms_cuda, "greedy_suppress_cuda",
                        lambda b, v, t: calls.append((b.shape, v.shape, t)) or torch.ones_like(v))
    assert nms._suppress_cuda(boxes, valid, 0.45).all()
    assert calls == [((1, 8, 4), (1, 8), 0.45)]
