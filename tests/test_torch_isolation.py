"""The PyTorch port stands alone: it and chip_smoke.py import nothing of JAX
or of the JAX package, and the CUDA wrapper refuses CPU tensors instead of
computing on them.

tests/conftest.py imports jax into every test process, so the import check
runs in a fresh interpreter."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from aquaculture_tpu_torch.ops import nms_cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "aquaculture_tpu_torch"


def _port_sources():
    scripts = [ROOT / "scripts" / n
               for n in ("nms_suppress_ab.py", "serving_ab.py", "train_step_ab.py", "int_mm_probe.py",
                         "torch_aot_coldstart.py", "plan_sweep.py", "tiff_feed_ab.py")]
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + scripts


def test_port_and_chip_smoke_load_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np, torch
        import aquaculture_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        from aquaculture_tpu_torch.models.weights import load_jax_params
        from aquaculture_tpu_torch.models.yolov5 import yolov5_init
        from aquaculture_tpu_torch.ops.nms import batched_nms
        model = load_jax_params(*yolov5_init("n", num_classes=2))
        x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32))
        with torch.no_grad():
            det, valid = batched_nms(model(x), conf_thresh=1e-6)
        assert det.shape == (1, 300, 6) and valid.any()
        # one aq-pipeline run: detect, geocode, dedup, areas, land filter
        import os, tempfile
        from PIL import Image
        from aquaculture_tpu_torch import frame as gf
        from aquaculture_tpu_torch.config import DetectConfig
        from aquaculture_tpu_torch.geo import polygon as P
        from aquaculture_tpu_torch.pipeline import run_pipeline
        d = tempfile.mkdtemp()
        path = os.path.join(d, "ORTHOIMAGERY.ORTHOPHOTOS2014_1_2560_0.png")
        Image.fromarray(np.random.default_rng(1).integers(0, 255, (1024, 1024, 3), dtype=np.uint8)).save(path)
        boxes = gf.GeoFrame({"d": [0, 1]}, geometry=[P.box(0, 0, 1200, 1200), P.box(600, 0, 1800, 1200)],
                            crs=3857)
        land = gf.GeoFrame({"n": [0]}, geometry=[P.box(1000, 1100, 2000, 2000)], crs=3857).to_crs(4326)
        out, stats = run_pipeline([path], model, boxes, DetectConfig(img_size=128, conf_threshold=1e-6),
                                  batch_size=1, land=land, device="cpu")
        assert len(out) and stats.land_filter == "exact", (len(out), stats)
        assert stats.stage_rows["dedup"] < stats.stage_rows["geocode"]
        assert stats.stage_rows["land_filter"] < stats.stage_rows["areas"]
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_sources_import_no_jax_package():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "aquaculture_tpu"), f"{path}: imports {n}"


def test_cuda_wrapper_refuses_cpu_tensors():
    boxes = torch.zeros((1, 8, 4))
    valid = torch.ones((1, 8), dtype=torch.bool)
    before = nms_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        nms_cuda.greedy_suppress_cuda(boxes, valid, 0.45)
    assert nms_cuda.launches == before
    assert nms_cuda._lib is None  # nothing was built or loaded


def test_kernel_source_and_build_flags():
    src = (PORT / "csrc" / "nms_suppress.cu").read_text()
    assert "aquaculture_tpu/ops/nms_pallas.py:33" in src
    assert "arch=compute_90a,code=sm_90a" in nms_cuda.NVCC_FLAGS
    assert "-fmad=false" in nms_cuda.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in nms_cuda.NVCC_FLAGS)
    # one definition of the K cap, the wrapper's, and it takes the whole
    # P5 pool at 640 px
    assert src.count("kMaxK =") == 1
    assert f"kMaxK = {nms_cuda.MAX_K};" in src
    assert nms_cuda.MAX_K >= 25_200
    # the build goes where .gitignore keeps it out of commits
    ignored = (ROOT / ".gitignore").read_text().split()
    assert os.path.relpath(nms_cuda.BUILD_DIR, ROOT) + "/" in ignored


def test_serving_options_load_no_jax():
    """The P6 family, TTA, multi-label and feature-map NMS, the letterbox,
    and the loader's overlap and decode-at-scale paths, run in a fresh
    interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np, torch
        from PIL import Image
        from aquaculture_tpu_torch.config import DetectConfig
        from aquaculture_tpu_torch.models.weights import load_jax_params
        from aquaculture_tpu_torch.models.yolov5 import yolov5_init
        from aquaculture_tpu_torch.ops.letterbox import letterbox, unletterbox_boxes
        from aquaculture_tpu_torch.ops.nms import batched_nms, batched_nms_feats
        from aquaculture_tpu_torch.ops.tta import tta_predict
        from aquaculture_tpu_torch.pipeline import detect_files
        model = load_jax_params(*yolov5_init("n6", num_classes=2))
        x = torch.from_numpy(np.random.default_rng(0).random((1, 128, 128, 3), dtype=np.float32))
        with torch.no_grad():
            det, valid = batched_nms(tta_predict(model, x), conf_thresh=1e-6, multi_label=True)
            fdet, fvalid = batched_nms_feats(model.features(x), model.anchor_table, model.strides, 1e-6)
        assert valid.any() and fvalid.any()
        img, gain, pad = letterbox(torch.zeros((90, 120, 3), dtype=torch.uint8), 64)
        assert img.shape == (64, 64, 3) and unletterbox_boxes(det[0, :, :4], gain, pad).shape == (300, 4)
        d = tempfile.mkdtemp()
        path = os.path.join(d, "ORTHOIMAGERY.ORTHOPHOTOS2014_1_0_0.jpeg")
        Image.fromarray(np.random.default_rng(1).integers(0, 255, (2048, 1024, 3), dtype=np.uint8)).save(path)
        cfg = DetectConfig(img_size=128, conf_threshold=1e-6)
        *_, s1 = detect_files([path], model, cfg, batch_size=4, device="cpu", stride=768)
        *_, s2 = detect_files([path], model, cfg, batch_size=4, device="cpu", decode_scale=True, decode_threads=1)
        assert (s1.tiles, s2.tiles, s1.loader, s2.loader) == (3, 2, "python", "device"), (s1, s2)
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_training_loads_no_jax():
    """One train step of the port (remat on) and one augmented
    dataset batch, in a fresh interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np, torch
        from PIL import Image
        from aquaculture_tpu_torch.config import TrainConfig
        from aquaculture_tpu_torch.models.weights import load_train_params
        from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
        from aquaculture_tpu_torch.train.dataset import DetectionDataset
        from aquaculture_tpu_torch.train.trainer import init_train_state, make_train_step
        d = tempfile.mkdtemp()
        os.makedirs(os.path.join(d, "images")); os.makedirs(os.path.join(d, "labels"))
        for i in range(2):
            Image.fromarray(np.random.default_rng(i).integers(0, 255, (96, 96, 3), dtype=np.uint8)).save(
                os.path.join(d, "images", f"t{i}.jpg"))
            open(os.path.join(d, "labels", f"t{i}.txt"), "w").write("1 0.5 0.5 0.3 0.3\\n")
        cfg = TrainConfig(img_size=64, batch_size=2, remat=True)
        batch = next(iter(DetectionDataset(os.path.join(d, "images"), None, cfg, augment=True).epoch(0)))
        model = load_train_params(YoloV5("n", 2, trainable=True), yolov5_init("n", 2)[1])
        state = init_train_state(model)
        m = make_train_step(model, cfg, 1)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert torch.isfinite(m["total"]) and state.step == 1, m
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_int8_and_accuracy_load_no_jax():
    """int8 PTQ (calibrate, quantize, the int8 forward through both conv
    routes), cli.detect --int8 and the accuracy harness on a rendered
    world, in a fresh interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np, torch
        sys.path.insert(0, "examples")
        from end_to_end_demo import render_world
        from aquaculture_tpu_torch.cli import detect as cli_detect
        from aquaculture_tpu_torch.config import DetectConfig
        from aquaculture_tpu_torch.eval.accuracy import load_checkpoint_f32, world_map
        from aquaculture_tpu_torch.eval.map import evaluate_map
        from aquaculture_tpu_torch.models import layers
        from aquaculture_tpu_torch.models.quantize import quantize_model
        from aquaculture_tpu_torch.ops import int8_conv
        model = load_checkpoint_f32("tests/data/demo_ckpt_n160", "n", 2)
        x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32))
        q = quantize_model(model, x)
        assert isinstance(q.b5, layers.QConvBlock)
        with torch.no_grad():
            plain = q(x)
            layers.int8_conv2d = int8_conv.int8_conv2d_mm
            assert torch.equal(q(x), plain)
        d = tempfile.mkdtemp()
        img_dir, lab_dir = render_world(d, n_images=2, seed=0)
        cli_detect.main(["--source", img_dir, "--out", os.path.join(d, "lab"), "--weights",
                         "tests/data/demo_ckpt_n160", "--img", "64", "--int8", "--device", "cpu"])
        paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
        m = world_map(paths, lab_dir, model, DetectConfig(img_size=160, conf_threshold=1e-3), device="cpu")
        assert m["map50"] > 0, m
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_cluster_and_evaluate_load_no_jax():
    """cli.cluster, cli.evaluate (a 2-fold sweep) and the Figure-3 sweep on
    a small world, in a fresh interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np, pandas as pd
        from aquaculture_tpu_torch import frame as gf
        from aquaculture_tpu_torch.cli import cluster as cli_cluster, evaluate as cli_evaluate
        from aquaculture_tpu_torch.geo import polygon as P
        from aquaculture_tpu_torch.results import stats_at_thresholds
        rng = np.random.default_rng(0)
        xy = np.concatenate([rng.normal(0, 15, (12, 2)) + c for c in ((0, 0), (400, 0), (0, 400))])
        n = len(xy)
        det = gf.GeoFrame({"year": [2014] * n, "type": ["circle_farm"] * n, "det_conf": rng.uniform(0.7, 1, n),
                           "image": [f"i{k % 4}" for k in range(n)]},
                          geometry=[P.box(5e5 + x, 5.3e6 + y, 5e5 + x + 8, 5.3e6 + y + 8) for x, y in xy], crs=3857)
        lab = det.iloc[::2].drop(columns=["det_conf"])
        lab.crs = 3857
        d = tempfile.mkdtemp()
        det.to_file(os.path.join(d, "det.geojson")); lab.to_file(os.path.join(d, "lab.geojson"))
        pd.DataFrame({"image": [f"i{k}" for k in range(4)], "bucket": [0, 1, 0, 1]}).to_csv(
            os.path.join(d, "images.csv"), index=False)
        fac = cli_cluster.main(["--detections", os.path.join(d, "det.geojson"), "--out",
                                os.path.join(d, "fac.geojson"), "--device", "cpu"])
        assert len(fac) == 3, fac
        res, test, _ = cli_evaluate.main(["--detections", os.path.join(d, "det.geojson"), "--labels",
                                          os.path.join(d, "lab.geojson"), "--images", os.path.join(d, "images.csv"),
                                          "--out", os.path.join(d, "folds.csv"), "--folds", "2", "--device", "cpu"])
        assert len(res) == 4 and test.shape == (2, 2), (res, test)
        assert len(stats_at_thresholds(lab, det)) == 100
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_train_cli_refuses_mesh_and_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    """--mesh 4 without a world of 4 processes (no torchrun environment)
    is refused before anything is read or written."""
    from aquaculture_tpu_torch.cli import train as cli_train

    with pytest.raises(SystemExit, match="needs 4 processes"):
        cli_train.main(["--images", str(tmp_path), "--out", str(tmp_path / "o"), "--device", "cpu",
                        "--mesh", "4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_train.main(["--images", str(tmp_path), "--out", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_multi_process_loads_no_jax():
    """The store, the pod runner and cli.pod (one process, store source),
    and a one-rank 1x1 mesh's train step and sharded serving, in a fresh
    interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import io, os, sys, tempfile
        import numpy as np, torch
        import torch.distributed as dist
        from PIL import Image
        from aquaculture_tpu_torch.cli import pod as cli_pod
        from aquaculture_tpu_torch.config import DetectConfig, TrainConfig
        from aquaculture_tpu_torch.data.store import LocalBlobStore
        from aquaculture_tpu_torch.models.weights import load_jax_params, load_train_params
        from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
        from aquaculture_tpu_torch.parallel.mesh import make_mesh, shard_batch
        from aquaculture_tpu_torch.parallel.sharded import full_state_tree, sharded_infer_fn, sharded_train_step
        from aquaculture_tpu_torch.train.trainer import init_train_state
        d = tempfile.mkdtemp()
        store = LocalBlobStore(os.path.join(d, "root"))
        for i in range(2):
            buf = io.BytesIO()
            Image.fromarray(np.random.default_rng(i).integers(0, 255, (256, 256, 3), dtype=np.uint8)).save(
                buf, format="PNG")
            store.put(f"tiles/ORTHOIMAGERY.ORTHOPHOTOS2014_{i}_0_0.png", buf.getvalue())
        with open(os.path.join(d, "b.csv"), "w") as f:
            f.write("geometry\\n" + "".join(f'"POLYGON (({x} 0, {x + 300} 0, {x + 300} 300, {x} 300, {x} 0))"\\n'
                                            for x in (0, 300)))
        det, stats = cli_pod.main(["--source", f"store:{os.path.join(d, 'root')}::tiles/", "--download-bboxes",
                                   os.path.join(d, "b.csv"), "--out", os.path.join(d, "o.geojson"), "--variant",
                                   "n", "--img", "64", "--conf", "1e-6", "--batch", "2", "--device", "cpu"])
        assert stats.tiles == 2 and os.path.exists(os.path.join(d, "o.geojson")), stats
        dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
        mesh = make_mesh(1, 1)
        model = load_train_params(YoloV5("n", 2, trainable=True), yolov5_init("n", 2)[1])
        step, state = sharded_train_step(model, TrainConfig(img_size=64, batch_size=2), mesh, 1,
                                         init_train_state(model))
        batch = {"images": np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32),
                 "labels": np.asarray([[[0, 20, 20, 10, 10]], [[1, 30, 30, 12, 8]]], np.float32),
                 "label_mask": np.ones((2, 1), bool)}
        m = step(state, shard_batch(batch, mesh, "cpu"))
        assert torch.isfinite(m["total"]) and int(full_state_tree(state)["step"]) == 1, m
        infer = sharded_infer_fn(load_jax_params(*yolov5_init("n", 2)), mesh,
                                 DetectConfig(img_size=64, conf_threshold=1e-6), tile=128, device="cpu")
        det, valid = infer(torch.zeros((2, 128, 128, 3), dtype=torch.uint8))
        assert det.shape[0] == 2, det.shape
        dist.destroy_process_group()
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_jax_facility_pickle_loads_without_jax(tmp_path):
    """A facility pickle that the JAX package wrote loads in the port (its
    classes resolve to the port's), and one port bootstrap and one boolean
    overlay run on it, in a fresh interpreter, without importing
    aquaculture_tpu or jax."""
    from aquaculture_tpu import frame as jgf
    from aquaculture_tpu.geo import polygon as jpoly
    from aquaculture_tpu.tonnage.facility import AquaFacility
    from aquaculture_tpu.tonnage.periods import map_year_to_image_pass

    geoms = [jpoly.box(10.0 + 12 * i, 10.0, 18.0 + 12 * i, 18.0) for i in range(6)]
    preds = jgf.GeoFrame({"image": ["ORTHOIMAGERY.ORTHOPHOTOS2013_0_0_0.jpeg"] * 6, "year": [2013] * 6,
                          "det_conf": [0.9] * 6, "type": ["circle_farm"] * 6, "area": [50.0] * 6,
                          "area_var": [0.0] * 6, "min_area": [50.0] * 6, "max_area": [50.0] * 6},
                         geometry=geoms, crs=3857)
    boxes = jgf.GeoFrame({"bbox_ind": [0], "x_offset": [0], "y_offset": [0], "year": [2013], "image_file": ["a"]},
                         geometry=[jpoly.box(0, 0, 1200, 1200)], crs=3857)
    fac = AquaFacility(preds, boxes, map_year_to_image_pass, min_cluster_size=5)
    fac.compute_min_max_cages()
    fac.final_facilities["cage_depth"] = 12.0
    fac.save(str(tmp_path / "jax.pkl"))
    code = textwrap.dedent(f"""
        import sys
        import pandas as pd
        from aquaculture_tpu_torch.geo import polygon as P
        from aquaculture_tpu_torch.tonnage.bootstrap import compute_facility_tonnage_estimates
        from aquaculture_tpu_torch.tonnage.facility import AquaFacility, load_AquaFacility
        fac = load_AquaFacility({str(tmp_path / "jax.pkl")!r})
        assert type(fac) is AquaFacility and len(fac.final_facilities) == 1
        assert type(fac.final_facilities["circle_farm_geoms"].iloc[0]) is P.MultiPolygon
        errs = pd.DataFrame({{"pass": ["2013-2015"], "farm_type": ["circle_farm"], "model_error_mean": [0.0],
                             "model_error_sd": [5.0]}})
        pft = pd.DataFrame({{"pass": ["2013-2015"], "Factor Stocking density": [12.0],
                            "Standard deviation Stocking density": [1.0], "Factor Annual harvest frequency": [0.6],
                            "Standard deviation Annual harvest frequency": [0.05]}})
        est = compute_facility_tonnage_estimates(fac.final_facilities, pft, "pass", 5.0, fac.preds, errs, 0.8,
                                                 K=200, device="cpu")
        assert float(est.loc["2013-2015", "tonnage"]) > 0
        star = P.Polygon([(0, 0), (4, 1), (2, 2), (4, 3), (0, 4)])
        assert P.union(star, P.Polygon([(1, -1), (3, -1), (3, 5), (1, 5)])).area > star.area
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_tooling_loads_no_jax():
    """models.aot (export, save, load, serve one batch), models.export and
    cli.export (a .pt written and read back), cli.aot describe and
    utils.profiler (one trace), in a fresh interpreter, load no JAX
    module."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import numpy as np, torch
        from aquaculture_tpu_torch.cli import aot as cli_aot, export as cli_export
        from aquaculture_tpu_torch.config import DetectConfig
        from aquaculture_tpu_torch.models import aot
        from aquaculture_tpu_torch.models.export import export_full_model_pt
        from aquaculture_tpu_torch.models.weights import load_jax_params, read_pt_state_dict
        from aquaculture_tpu_torch.models.yolov5 import YoloV5, yolov5_init
        from aquaculture_tpu_torch.utils.checkpoint import save_params
        from aquaculture_tpu_torch.utils.profiler import annotate, maybe_trace
        d = tempfile.mkdtemp()
        model, params = yolov5_init("n", 2)
        save_params(os.path.join(d, "ck"), params, {"variant": "n", "num_classes": 2})
        cli_export.main(["--ckpt", os.path.join(d, "ck"), "--out", os.path.join(d, "x.pt")])
        assert len(read_pt_state_dict(os.path.join(d, "x.pt"))) == 349
        export_full_model_pt(YoloV5("n", 2), params, os.path.join(d, "full.pt"))
        m = load_jax_params(model, params)
        blob, meta = aot.export_serving(m, DetectConfig(img_size=64, conf_threshold=1e-6), batch_size=1,
                                        tile=128, device="cpu")
        path = os.path.join(d, "s.aqt")
        aot.save_aot(path, blob, meta)
        cli_aot.main(["describe", "--program", path])
        fn, _ = aot.serving_fn(path, m, device="cpu")
        with maybe_trace(os.path.join(d, "tr")), annotate("serve"):
            det, valid = fn(torch.zeros((1, 128, 128, 3), dtype=torch.uint8))
        assert det.shape == (1, 300, 6) and len(os.listdir(os.path.join(d, "tr"))) == 1
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_plan_surface_and_cxx_sweep_load_no_jax():
    """models.plan and cli.plan (a plan and its JSON), the package surface
    (every re-export of geo, data, post, eval, ops, train, models and the
    root), geo.boxes, data.blank, and the C++ sweep (built from
    csrc/booleanop.cc, one overlay on each engine), in a fresh
    interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import contextlib, io, json, sys
        import numpy as np
        import aquaculture_tpu_torch as root
        from aquaculture_tpu_torch import data, eval, geo, models, ops, post, train
        from aquaculture_tpu_torch.cli import plan as cli_plan
        from aquaculture_tpu_torch.data import blank
        from aquaculture_tpu_torch.geo import boolean, boxes, native_boolean, polygon as P
        from aquaculture_tpu_torch.models.plan import recommend_serving, recommend_training
        assert recommend_serving().variant == "mt" and recommend_training().batch == 128
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_plan.main(["--train", "--json"])
        assert json.loads(out.getvalue())["compute_dtype"] == "bfloat16"
        for pkg in (root, data, eval, geo, models, ops, post, train):
            for name in pkg.__all__:
                getattr(pkg, name)
        assert boxes.box_iou(np.array([[0, 0, 2, 2.0]]), np.array([[1, 1, 3, 3.0]]))[0, 0] > 0
        assert blank.is_blank(np.zeros((8, 8, 3), np.uint8))
        native_boolean.build()
        a, b = P.Polygon(np.array([(0, 0), (4, 0), (2, 3)], float)), P.box(1, 1, 5, 5)
        got = {}
        for engine in boolean.SWEEP_ENGINES:
            with boolean.using_sweep_engine(engine):
                got[engine] = boolean.boolean_op(a, b, "union").area
        assert got["c++"] == got["python"] > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_acquisition_and_figures_load_no_jax():
    """cli.acquire's four subcommands (the download injected, the WMS on
    127.0.0.1, local .asc grids, .shp linework) and cli.figures --device
    cpu, in a fresh interpreter, load no JAX module."""
    code = textwrap.dedent("""
        import io, os, sys, tempfile, zipfile
        import numpy as np, pandas as pd
        from PIL import Image
        import chip_smoke
        from aquaculture_tpu_torch import frame as gf
        from aquaculture_tpu_torch.acquire import shapefiles
        from aquaculture_tpu_torch.cli import acquire, figures
        from aquaculture_tpu_torch.geo import crs as C, polygon as P
        from aquaculture_tpu_torch.geo.shapefile import write_shapefile
        d = tempfile.mkdtemp()
        def fetch(url):
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as z:
                z.writestr("x.txt", url)
            return buf.getvalue()
        shapefiles._default_fetch = fetch
        acquire.main(["shapefiles", "--out", d])
        def tiff(layer, bbox, size):
            buf = io.BytesIO()
            Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(buf, format="TIFF")
            return buf.getvalue()
        coast = os.path.join(d, "coast.geojson")
        gf.GeoFrame({"n": [0]}, geometry=[P.box(1, 1, 2000, 1000)], crs=3857).to_file(coast)
        with chip_smoke.loopback_only(), chip_smoke.WmsLoopback(tiff) as wms:
            acquire.main(["wms", "--coast", coast, "--years", "2014", "--store", d, "--url", wms.url,
                          "--bboxes-out", os.path.join(d, "wanted_bboxes.csv")])
        assert len(os.listdir(os.path.join(d, "coastal_french_data", "tifs"))) == 2
        asc = os.path.join(d, "F4.asc")
        with open(asc, "w") as f:
            f.write("ncols 2\\nnrows 1\\nxllcorner 4\\nyllcorner 43\\ncellsize 0.5\\n-3 -4\\n")
        acquire.main(["bathymetry", "--out", os.path.join(d, "b.tif"), "--asc", asc])
        ring = [(5.0, 43.0), (5.2, 43.0), (5.2, 43.2), (5.0, 43.2)]
        write_shapefile(os.path.join(d, "coastline.shp"), gf.GeoFrame({"n": [0]}, geometry=[P.Polygon(ring)], crs=4326))
        write_shapefile(os.path.join(d, "country.shp"),
                        gf.GeoFrame({"n": [0]}, geometry=[P.box(4.9, 42.9, 5.3, 43.3)], crs=4326))
        acquire.main(["landfilter", "--coastline", os.path.join(d, "coastline.shp"), "--country",
                      os.path.join(d, "country.dbf"), "--out", os.path.join(d, "land.geojson")])
        assert list(gf.read_file(os.path.join(d, "land.geojson"))["kind"]) == ["primary"]
        cages = [P.box(560_000 + 16 * i, 5_330_000, 560_010 + 16 * i, 5_330_010) for i in range(6)]
        det = gf.GeoFrame({"year": [2014] * 6, "type": ["circle_farm"] * 6, "det_conf": np.linspace(0.5, 0.9, 6),
                           "image": ["ORTHOIMAGERY.ORTHOPHOTOS2014_0_0_0.jpeg"] * 6}, geometry=cages, crs=3857)
        det.to_file(os.path.join(d, "det.geojson"))
        det.iloc[:4].to_file(os.path.join(d, "labels.geojson"))
        gf.GeoFrame({"pass": ["2013-2015"]}, geometry=[P.Point(560_040, 5_330_005)], crs=3857).to_file(
            os.path.join(d, "fac.geojson"))
        lon, lat = C.transform(3857, 4326, np.array([560_040.0]), np.array([5_330_005.0]))
        pd.DataFrame({"lon": lon, "lat": lat}).to_csv(os.path.join(d, "tru.csv"), index=False)
        figures.main(["--detections", os.path.join(d, "det.geojson"), "--labels", os.path.join(d, "labels.geojson"),
                      "--facilities", os.path.join(d, "fac.geojson"), "--trujillo", os.path.join(d, "tru.csv"),
                      "--out-dir", os.path.join(d, "fig"), "--device", "cpu"])
        assert sorted(os.listdir(os.path.join(d, "fig"))) == ["facility_map_2013-2015.png",
                                                              "performance_across_confidence.pdf"]
        import shutil; shutil.rmtree(d)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_reaches_nothing_in_native():
    """The port keeps its own copies: no source names a path into the JAX
    package's native/ directory or its library."""
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                text = node.value
                assert "libaquatile" not in text and "native/" not in text and text != "native", \
                    f"{path}: {text[:80]!r}"


def test_k_cap_error_names_the_p6_limit():
    """Above MAX_K the wrapper refuses and says why: the whole P6 pool at
    1280 px (102,000 rows) lies beyond it, and there the plain version's
    K x K IoU matrix would need 41.6 GB per image."""
    k = 102_000
    assert k > nms_cuda.MAX_K and round(k * k * 4 / 1e9, 1) == 41.6
    boxes = torch.zeros((1, k, 4))
    valid = torch.ones((1, k), dtype=torch.bool)
    # the check sits after the device checks, so run it on a CPU stand-in
    # that claims to be a CUDA tensor
    class _Cuda(torch.Tensor):
        is_cuda = True

    with pytest.raises(ValueError, match=r"102,000-row P6 pool at 1280 px.*41\.6 GB"):
        nms_cuda.greedy_suppress_cuda(boxes.as_subclass(_Cuda), valid.as_subclass(_Cuda), 0.45)
    assert nms_cuda._lib is None


def test_port_decodes_jpeg_without_libjpeg_or_libtiff():
    """The device loader parses JPEG itself: no source under csrc/ includes
    jpeglib.h or tiffio.h, and no build flag of the port links -ljpeg or
    -ltiff (the card's machine has neither library)."""
    from aquaculture_tpu_torch.data import native_loader
    from aquaculture_tpu_torch.geo import native_boolean

    sources = sorted((PORT / "csrc").glob("*.c*"))
    assert {p.name for p in sources} >= {"jpeg_entropy.cc", "jpeg_decode.cu"}
    for path in sources:
        text = path.read_text()
        for header in ("jpeglib.h", "tiffio.h", "jpeglib", "tiffio"):
            assert f"<{header}" not in text and f'"{header}' not in text, f"{path.name} includes {header}"
    flags = (*native_loader.CXX_FLAGS, *native_boolean.CXX_FLAGS, *nms_cuda.NVCC_FLAGS)
    assert not any(f.startswith(("-ljpeg", "-ltiff")) or f in ("jpeg", "tiff") for f in flags), flags
