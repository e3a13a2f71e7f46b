"""The port's pod runner (parallel/pod.py, cli.pod) against the JAX package's
and against itself across process counts, on the CPU.

- Host code (corpus shards, the fingerprint, chunk manifests, the layer
  budget): equal to the JAX package's, exactly; each package resumes the
  other's manifests.
- One process, f32, the committed trained fixture at 160 px on a rendered
  4-tile world, against the JAX ``run_pod_pipeline``: the same rows,
  images and classes, pixel boxes within 1 px (np.trunc of boxes that
  differ by reassociation), meter columns within 1e-6 relative and
  confidences within 1e-5.
- Two gloo ranks against one process, the corpus chosen so that each
  rank's batches are the 1-process run's batches (4 one-tile files, batch
  2): equal integer boxes, classes and tile ids (images), confidences
  within 1e-6, for files, ``store:`` streaming, ``--overlap``, checkpoints
  and their resume, and cli.pod's GeoJSON.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from aquaculture_tpu.cli.detect import load_model as jax_load_model
from aquaculture_tpu.cli.geocode import load_download_bboxes as jax_load_bboxes
from aquaculture_tpu.config import DetectConfig as JaxDetectConfig
from aquaculture_tpu.data.filenames import TileSpec as JaxTileSpec
from aquaculture_tpu.data.store import LocalBlobStore as JaxLocalBlobStore
from aquaculture_tpu.parallel import pod as jax_pod
from aquaculture_tpu_torch import frame as tgf
from aquaculture_tpu_torch import pipeline as tpipeline
from aquaculture_tpu_torch.cli import pod as cli_pod
from aquaculture_tpu_torch.cli.detect import load_model
from aquaculture_tpu_torch.cli.geocode import load_download_bboxes
from aquaculture_tpu_torch.config import DetectConfig
from aquaculture_tpu_torch.data.filenames import TileSpec
from aquaculture_tpu_torch.data.store import LocalBlobStore
from aquaculture_tpu_torch.parallel import pod

import torch_dist_workers as workers
from test_torch_post import assert_frames_equal

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "demo_ckpt_n160")
KW = dict(img_size=160, conf_threshold=0.05, dtype="float32")
PX = ["xmin", "ymin", "xmax", "ymax"]
METERS = ["xmin_m", "xmax_m", "ymin_m", "ymax_m"]


# ---------------------------------------------------------------------------
# host code against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,hosts", [(0, 1), (1, 3), (2, 4), (10, 3), (7, 7), (17, 5)])
def test_shard_corpus_matches_jax(n, hosts):
    paths = [f"p{i}" for i in range(n)]
    shards = [pod.shard_corpus(paths, hosts, h) for h in range(hosts)]
    assert shards == [jax_pod.shard_corpus(paths, hosts, h) for h in range(hosts)]
    assert [p for s in shards for p in s] == paths  # contiguous, complete, ordered
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


@pytest.mark.parametrize("overlap", [0, 256])
@pytest.mark.parametrize("with_cfg", [False, True])
def test_corpus_fingerprint_matches_jax(overlap, with_cfg):
    paths = [f"tiles/ORTHOIMAGERY.ORTHOPHOTOS2014_{i}_0_0.jpeg" for i in range(5)]
    cfg, jcfg = (DetectConfig(conf_threshold=0.05), JaxDetectConfig(conf_threshold=0.05)) if with_cfg else (None, None)
    if with_cfg:
        assert repr(cfg) == repr(jcfg)
    got = pod._corpus_fingerprint(paths, 3, cfg, overlap=overlap)
    assert got == jax_pod._corpus_fingerprint(paths, 3, jcfg, overlap=overlap)
    assert got != pod._corpus_fingerprint(paths, 2, cfg, overlap=overlap)


def _tables(seed, n, spec_cls):
    rng = np.random.default_rng(seed)
    specs = [spec_cls(year=2014 + i % 2, bbox_ind=i, x_offset=1024 * i, y_offset=512, layer=f"L{i}é")
             for i in range(n)]
    return (rng.uniform(0, 1024, (n, 4)), rng.uniform(0, 1, n), rng.integers(0, 5, n), specs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chunk_manifests_interchange(tmp_path, writer):
    """A chunk manifest written by one package's _append_chunk is read by
    the other's _load_progress as by its own: the same keys, dtypes and
    values."""
    w, r = (jax_pod, pod) if writer == "jax" else (pod, jax_pod)
    spec_cls = JaxTileSpec if writer == "jax" else TileSpec
    for idx, n in enumerate((3, 0, 2)):
        b, c, k, specs = _tables(idx, n, spec_cls)
        w._append_chunk(str(tmp_path), 1, idx, "fp", [f"k{idx}_{j}" for j in range(n)], b, c, k, specs)
    assert sorted(os.listdir(tmp_path)) == [f"pod_host1_chunk00000{i}.npz" for i in range(3)]
    assert pod._chunk_files(str(tmp_path), 1) == jax_pod._chunk_files(str(tmp_path), 1)
    got, want = r._load_progress(str(tmp_path), 1, "fp"), w._load_progress(str(tmp_path), 1, "fp")
    assert got[0] == want[0] and len(got[0]) == 5
    for g, x in zip(got[1:], want[1:]):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_array_equal(g, x)
    assert got[5].tolist() == ["L0é", "L1é", "L2é", "L0é", "L1é"]
    rows = [(s.year, s.bbox_ind, s.x_offset, s.y_offset, s.layer) for s in pod._rows_to_specs(got[4], got[5])]
    assert rows == [(s.year, s.bbox_ind, s.x_offset, s.y_offset, s.layer)
                    for s in jax_pod._rows_to_specs(want[4], want[5])]


def test_fingerprint_mismatch_raises_as_jax(tmp_path):
    b, c, k, specs = _tables(0, 2, TileSpec)
    pod._append_chunk(str(tmp_path), 0, 0, "a" * 40, ["x", "y"], b, c, k, specs)
    with pytest.raises(RuntimeError) as got:
        pod._load_progress(str(tmp_path), 0, "b" * 40)
    with pytest.raises(RuntimeError) as want:
        jax_pod._load_progress(str(tmp_path), 0, "b" * 40)
    assert str(got.value) == str(want.value)
    assert "different corpus, host count, or detection config" in str(got.value)


def test_layer_budget_raises():
    """The spec-table gather carries layers as 96-byte utf-8 rows; a longer
    layer raises instead of being truncated (possibly mid-code-point)."""
    assert pod._LAYER_BYTES == jax_pod._LAYER_BYTES == 96
    ok = TileSpec(2014, 0, 0, 0, layer="é" * 48)  # 96 bytes
    enc = pod._encode_layers([ok])
    assert bytes(enc[0]).decode("utf-8") == ok.layer
    with pytest.raises(ValueError, match="96-byte gather budget"):
        pod._encode_layers([ok, TileSpec(2014, 0, 0, 0, layer="é" * 48 + "x")])


def test_one_process_gather_is_the_identity_and_init_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert pod.init_distributed() == (0, 1) and (pod.process_index(), pod.process_count()) == (0, 1)
    b, c, k, t = np.arange(8.0).reshape(2, 4), np.asarray([0.5, 0.6]), np.asarray([0, 1]), np.asarray([10, 11])
    out = pod.gather_detection_tables(b, c, k, t)
    assert all(x is y for x, y in zip(out, (b, c, k, t)))


def test_devices_and_no_cpu_fallback(tmp_path, monkeypatch):
    """The CPU only when asked for; CUDA without a GPU raises, in cli.pod
    before anything is loaded or written."""
    assert pod.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        pod.local_device("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_pod.main(["--source", str(tmp_path), "--download-bboxes", "x.csv", "--out", str(tmp_path / "o.geojson")])
    assert not os.path.exists(tmp_path / "o.geojson")


@pytest.mark.parametrize("fn", ["shard_batch", "shard_local_batch"])
def test_shard_functions_have_no_cpu_default(fn):
    """A library caller that leaves out the device gets a TypeError, not
    CPU tensors; with the device named, the rows land there."""
    from aquaculture_tpu_torch.parallel import mesh

    batch = {"x": np.arange(8.0).reshape(4, 2)}
    with pytest.raises(TypeError, match="device"):
        getattr(mesh, fn)(batch, None)
    out = getattr(mesh, fn)(batch, None, "cpu")
    assert out["x"].device == torch.device("cpu") and out["x"].shape == (4, 2)


# ---------------------------------------------------------------------------
# the runner: one process against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A rendered 4-tile world (one 1024 px JPEG tile per download box), as
    files and as blobs under ``tiles/`` of a local store."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from end_to_end_demo import render_world

    out = tmp_path_factory.mktemp("pod_world")
    img_dir, _ = render_world(str(out), n_images=4, seed=0)
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    root = str(out / "store")
    store = LocalBlobStore(root)
    for p in paths:
        with open(p, "rb") as f:
            store.put("tiles/" + os.path.basename(p), f.read())
    return {"dir": str(out), "paths": paths, "root": root, "keys": store.list("tiles/"),
            "bboxes": os.path.join(str(out), "wanted_bboxes.csv")}


@pytest.fixture(scope="module")
def one_process(corpus):
    """The port's single-process run over files, and the JAX package's over
    the same blobs (its store path takes the Python loader, as the port),
    with checkpoints every 2 tiles."""
    ckpt = os.path.join(corpus["dir"], "jax_ckpt")
    jmodel, jparams = jax_load_model(FIXTURE, "n", 2)
    want, _ = jax_pod.run_pod_pipeline(corpus["keys"], jmodel, jparams, jax_load_bboxes(corpus["bboxes"]),
                                       JaxDetectConfig(**KW), batch_size=2, store=JaxLocalBlobStore(corpus["root"]),
                                       checkpoint_dir=ckpt, checkpoint_every=2)
    got, stats = pod.run_pod_pipeline(corpus["paths"], load_model(FIXTURE, "n", 2),
                                      load_download_bboxes(corpus["bboxes"]), DetectConfig(**KW), batch_size=2,
                                      device="cpu")
    return {"jax": want, "jax_ckpt": ckpt, "port": got, "stats": stats}


def assert_f32_rows_match(got, want, least=10):
    """The f32 bar of the module docstring."""
    assert len(got) == len(want) >= least and got.crs == want.crs == 4326
    assert list(got.columns) == list(want.columns) and list(got.dtypes) == list(want.dtypes)
    assert got["image"].tolist() == want["image"].tolist() and got["type"].tolist() == want["type"].tolist()
    assert np.abs(got[PX].to_numpy() - want[PX].to_numpy()).max() <= 1
    np.testing.assert_allclose(got[METERS].to_numpy(), want[METERS].to_numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["det_conf"], want["det_conf"], atol=1e-5, rtol=0)


def test_one_process_matches_jax(one_process):
    assert one_process["stats"].tiles == 4 and one_process["stats"].batches == 2
    assert_f32_rows_match(one_process["port"], one_process["jax"])


def test_port_resumes_jax_manifests_and_jax_the_ports(one_process, corpus, tmp_path):
    """The port resumes the JAX package's finished run from its manifests:
    nothing left to detect, and the frame is the JAX package's exactly; the
    JAX package resumes the port's likewise."""
    store = LocalBlobStore(corpus["root"])
    args = (corpus["keys"], load_model(FIXTURE, "n", 2), load_download_bboxes(corpus["bboxes"]), DetectConfig(**KW))
    got, stats = pod.run_pod_pipeline(*args, batch_size=2, store=store, checkpoint_dir=one_process["jax_ckpt"],
                                      checkpoint_every=2, device="cpu")
    assert stats.tiles == 0
    assert_frames_equal(got, one_process["jax"])
    ckpt = str(tmp_path / "port_ckpt")
    mine, stats = pod.run_pod_pipeline(*args, batch_size=2, store=store, checkpoint_dir=ckpt,
                                       checkpoint_every=2, device="cpu")
    assert stats.tiles == 4 and len(pod._chunk_files(ckpt, 0)) == 2
    jmodel, jparams = jax_load_model(FIXTURE, "n", 2)
    theirs, jstats = jax_pod.run_pod_pipeline(corpus["keys"], jmodel, jparams, jax_load_bboxes(corpus["bboxes"]),
                                              JaxDetectConfig(**KW), batch_size=2,
                                              store=JaxLocalBlobStore(corpus["root"]), checkpoint_dir=ckpt,
                                              checkpoint_every=2)
    assert jstats.tiles == 0
    assert_frames_equal(mine, theirs)


def test_checkpoint_resume_after_a_crash(corpus, one_process, tmp_path, monkeypatch):
    """A run that crashes in its second chunk resumes from the first chunk's
    manifest, detects only the rest, and ends equal to the uninterrupted
    run at the two-rank bar (one tile per chunk against its batches of 2);
    a third run has nothing to do and returns the resumed table exactly; a
    resume against another corpus raises instead of counting tiles twice
    (the port's twin of tests/test_pod.py's)."""
    model = load_model(FIXTURE, "n", 2)
    dl = load_download_bboxes(corpus["bboxes"])
    kw = dict(cfg=DetectConfig(**KW), batch_size=2, checkpoint_every=1, device="cpu",
              checkpoint_dir=str(tmp_path / "ckpt"))
    real, calls = tpipeline.detect_files, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated host crash")
        return real(*a, **k)

    monkeypatch.setattr(tpipeline, "detect_files", flaky)
    with pytest.raises(RuntimeError, match="simulated host crash"):
        pod.run_pod_pipeline(corpus["paths"], model, dl, **kw)
    monkeypatch.setattr(tpipeline, "detect_files", real)
    assert os.listdir(tmp_path / "ckpt") == ["pod_host0_chunk000000.npz"]
    resumed, stats = pod.run_pod_pipeline(corpus["paths"], model, dl, **kw)
    assert stats.tiles == 3
    assert_rows_equal(resumed, one_process["port"])
    again, stats = pod.run_pod_pipeline(corpus["paths"], model, dl, **kw)
    assert stats.tiles == 0
    assert_frames_equal(again, resumed)
    with pytest.raises(RuntimeError, match="different corpus, host count, or detection config"):
        pod.run_pod_pipeline(corpus["paths"][:3], model, dl, **kw)


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------

def _cli_args(corpus, out):
    return ["--source", f"store:{corpus['root']}::tiles/", "--download-bboxes", corpus["bboxes"], "--out", out,
            "--weights", FIXTURE, "--img", "160", "--conf", "0.05", "--batch", "2", "--overlap", "256",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    """Every two-rank run in one spawned gloo world: files, store
    streaming, overlap, checkpoints (one tile per chunk), their resume after
    rank 1 lost its last manifest, and cli.pod."""
    d = tmp_path_factory.mktemp("two_ranks")
    ckpt = str(d / "ckpt")
    runs = [
        {"name": "files", "paths": corpus["paths"]},
        {"name": "store", "paths": corpus["keys"], "store_root": corpus["root"]},
        {"name": "overlap", "paths": corpus["paths"], "overlap": 256},
        {"name": "ckpt", "paths": corpus["paths"], "checkpoint_dir": ckpt, "checkpoint_every": 1},
        {"name": "resume", "paths": corpus["paths"], "checkpoint_dir": ckpt, "checkpoint_every": 1,
         "drop_last_chunk_of": 1},
    ]
    job = str(d / "job.pkl")
    workers.dump({"weights": FIXTURE, "variant": "n", "num_classes": 2, "bboxes": corpus["bboxes"], "cfg": KW,
                   "batch": 2, "runs": runs, "cli": [_cli_args(corpus, str(d / "cli2.geojson"))]}, job)
    workers.spawn(workers.pod_runs, 2, str(d / "rdzv"), job, str(d))
    return {"dir": str(d), "ckpt": ckpt}


def _rank_stats(two_ranks, name):
    return [workers.read(os.path.join(two_ranks["dir"], f"{name}.{r}.pkl")) for r in range(2)]


def assert_rows_equal(got, want):
    """The two-rank bar of the module docstring."""
    assert len(got) == len(want) > 0 and list(got.columns) == list(want.columns)
    assert got["image"].tolist() == want["image"].tolist() and got["type"].tolist() == want["type"].tolist()
    np.testing.assert_array_equal(got[PX].to_numpy(), want[PX].to_numpy())
    np.testing.assert_allclose(got["det_conf"], want["det_conf"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[METERS].to_numpy(), want[METERS].to_numpy(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["files", "store", "overlap", "ckpt"])
def test_two_ranks_equal_one_process(two_ranks, one_process, corpus, name):
    """Each rank serves its 2 tiles (in one batch, or one per checkpoint
    chunk); rank 0's gathered frame
    equals the one-process frame row for row (overlap: after the cross-tile
    NMS of the gathered table, against one process's)."""
    got = tgf.GeoFrame(pd.read_pickle(os.path.join(two_ranks["dir"], f"{name}.frame.pkl")))
    want = one_process["port"]
    if name == "overlap":
        want, _ = pod.run_pod_pipeline(corpus["paths"], load_model(FIXTURE, "n", 2),
                                       load_download_bboxes(corpus["bboxes"]), DetectConfig(**KW), batch_size=2,
                                       overlap=256, device="cpu")
    assert_rows_equal(got, want)
    # one tile per chunk, and a batch per chunk, with checkpoints
    batches = 2 if name == "ckpt" else 1
    assert _rank_stats(two_ranks, name) == [{"tiles": 2, "batches": batches}] * 2
    if name == "ckpt":
        assert [len(pod._chunk_files(two_ranks["ckpt"], h)) for h in (0, 1)] == [2, 2]


def test_two_ranks_resume_serves_only_the_lost_chunk(two_ranks, one_process):
    """Rank 1's last manifest deleted: the rerun serves exactly that chunk's
    tile on rank 1, nothing on rank 0, and gives the same frame."""
    got = tgf.GeoFrame(pd.read_pickle(os.path.join(two_ranks["dir"], "resume.frame.pkl")))
    assert_rows_equal(got, one_process["port"])
    assert _rank_stats(two_ranks, "resume") == [{"tiles": 0, "batches": 0}, {"tiles": 1, "batches": 1}]


def test_two_rank_cli_pod_writes_the_one_process_geojson(two_ranks, corpus, tmp_path):
    """cli.pod (store source, --overlap, bf16 as served) on two ranks
    writes the GeoJSON one process writes, byte for byte."""
    det, stats = cli_pod.main(_cli_args(corpus, str(tmp_path / "cli1.geojson")))
    assert stats.tiles == 4 and len(det) > 0
    with open(tmp_path / "cli1.geojson", "rb") as f1, open(os.path.join(two_ranks["dir"], "cli2.geojson"), "rb") as f2:
        assert f1.read() == f2.read()
    assert [s["tiles"] for s in _rank_stats(two_ranks, "cli")] == [2, 2]
