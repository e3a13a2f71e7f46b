"""The port's profiler and stage timer (utils/profiler.py, utils/timer.py)
and ``--profile`` on cli.detect and cli.pipeline, on the CPU.

A profiled run writes one parseable Chrome-trace JSON holding the wrapped
region's span, the serving ops (convolutions, the registered suppression
operator) and leaves the rows as they are; ``maybe_trace(None)`` is a
no-op; ``StageTimer`` counts as the JAX package's does."""

import glob
import json
import os
import sys
import time

import numpy as np
import pytest

from aquaculture_tpu.models.yolov5 import yolov5_init as jax_init
from aquaculture_tpu.utils.timer import StageTimer as JaxStageTimer
from aquaculture_tpu_torch.cli import detect as cli_detect
from aquaculture_tpu_torch.cli import pipeline as cli_pipeline
from aquaculture_tpu_torch.utils import profiler
from aquaculture_tpu_torch.utils.checkpoint import save_params
from aquaculture_tpu_torch.utils.timer import StageTimer


@pytest.fixture(scope="module")
def jax_n():
    """The JAX package's n (2 classes, seed 0) and its unfused tree."""
    return jax_init("n", num_classes=2, seed=0)


@pytest.fixture(scope="module")
def world(jax_n, tmp_path_factory):
    """Four rendered tiles with their download boxes, and the JAX
    fixture's weights as a checkpoint."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from end_to_end_demo import render_world

    out = str(tmp_path_factory.mktemp("world"))
    img_dir, _ = render_world(out, n_images=4, seed=0)
    ckpt = os.path.join(out, "ckpt")
    save_params(ckpt, jax_n[1], {"variant": "n", "num_classes": 2})
    return {"images": img_dir, "bboxes": os.path.join(out, "wanted_bboxes.csv"), "ckpt": ckpt}


def _trace(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _names(events):
    return {e["name"] for e in events}


def test_cli_detect_profile_writes_a_trace(world, tmp_path):
    common = ["--source", world["images"], "--weights", world["ckpt"], "--img", "160", "--conf", "1e-5",
              "--batch", "2", "--device", "cpu"]
    logdir = str(tmp_path / "prof")
    profiled = cli_detect.main(common + ["--out", str(tmp_path / "a"), "--profile", logdir])
    plain = cli_detect.main(common + ["--out", str(tmp_path / "b")])
    events = _trace(logdir)
    names = _names(events)
    assert "detect_files" in names
    assert any(n.startswith("aten::conv") for n in names)
    # the registered suppression operator, once per batch (4 tiles, batch 2)
    assert sum(e["name"] == "aquaculture_tpu_torch::nms_suppress" for e in events) == 2
    region = next(e for e in events if e["name"] == "detect_files")
    convs = [e for e in events if e["name"].startswith("aten::conv")]
    assert all(region["ts"] <= e["ts"] <= region["ts"] + region["dur"] for e in convs)
    assert profiled.tiles == plain.tiles == 4 and profiled.detections == plain.detections
    for a in sorted(glob.glob(str(tmp_path / "a" / "*.txt"))):
        assert open(a).read() == open(str(tmp_path / "b" / os.path.basename(a))).read()


def test_cli_pipeline_profile_writes_a_trace(world, tmp_path):
    logdir = str(tmp_path / "prof")
    det, stats = cli_pipeline.main([
        "--source", world["images"], "--download-bboxes", world["bboxes"], "--out",
        str(tmp_path / "det.geojson"), "--weights", world["ckpt"], "--img", "160", "--conf", "1e-4",
        "--batch", "2", "--device", "cpu", "--profile", logdir])
    assert stats.tiles == 4 and len(det) > 0
    names = _names(_trace(logdir))
    assert {"run_pipeline", "aquaculture_tpu_torch::nms_suppress"} <= names
    assert any(n.startswith("aten::conv") for n in names)


def test_maybe_trace_none_is_a_no_op(tmp_path):
    ctx = profiler.maybe_trace(None)
    with ctx, profiler.annotate("outer"), profiler.annotate("inner"):
        x = 1 + 1
    assert x == 2 and not os.listdir(tmp_path)
    with profiler.maybe_trace(str(tmp_path / "t")), profiler.annotate("span"):
        pass
    assert "span" in _names(_trace(str(tmp_path / "t")))


def _drive(timer_cls, clock, monkeypatch):
    """One sequence of stages on a scripted clock -> (seconds, items,
    rates, report)."""
    ticks = iter(clock)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    t = timer_cls()
    with t.stage("decode", items=10):
        pass
    with t.stage("decode", items=30):
        pass
    with t.stage("infer"):
        pass
    with pytest.raises(RuntimeError):
        with t.stage("fail", items=1):
            raise RuntimeError("boom")
    monkeypatch.undo()
    return t.seconds, t.items, (t.rate("decode"), t.rate("infer"), t.rate("missing")), t.report()


def test_stage_timer_mirrors_the_jax_package(monkeypatch):
    clock = [0.0, 0.25, 1.0, 1.5, 2.0, 2.0, 3.0, 3.125]
    got = _drive(StageTimer, clock, monkeypatch)
    want = _drive(JaxStageTimer, clock, monkeypatch)
    assert got == want
    seconds, items, rates, report = got
    assert items == {"decode": 40, "infer": 0, "fail": 1}
    assert seconds == {"decode": 0.75, "infer": 0.0, "fail": 0.125}
    assert rates == (40 / 0.75, 0.0, 0.0)
    assert report == "decode: 0.75s (53.3/s) | fail: 0.12s (8.0/s) | infer: 0.00s"
    # the real clock: stages accumulate and survive exceptions
    t = StageTimer()
    with t.stage("s", items=2):
        time.sleep(0.01)
    assert t.seconds["s"] >= 0.01 and t.rate("s") == 2 / t.seconds["s"]
