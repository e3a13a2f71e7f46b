"""The port's package surface against the JAX package's.

- Every name that an ``__init__.py`` of the JAX package imports resolves in
  the port's namesake, in a fresh
  interpreter that loads no JAX module; the host-only modules and the
  packages above them load no torch.
- The host copies (geo.boxes, data.tiling's tile_offsets and
  tile_specs_for_image, data.blank) equal the JAX package's on seeded
  inputs; parallel.mesh.replicated is the whole batch on every rank.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from aquaculture_tpu.data import blank as jblank
from aquaculture_tpu.data import tiling as jtiling
from aquaculture_tpu.geo import boxes as jboxes
from aquaculture_tpu_torch.data import blank as tblank
from aquaculture_tpu_torch.data import tiling as ttiling
from aquaculture_tpu_torch.geo import boxes as tboxes
from aquaculture_tpu_torch.parallel import mesh as tmesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
# subpackages of the JAX package whose port is still queued
QUEUED = set()


def jax_exports() -> dict:
    """{port package: [names]} of every JAX ``__init__.py``: the names its
    ``from ... import`` statements bind and its public assignments."""
    out = {}
    for init in sorted((ROOT / "aquaculture_tpu").rglob("__init__.py")):
        rel = init.parent.relative_to(ROOT / "aquaculture_tpu")
        if rel.parts and rel.parts[0] in QUEUED:
            continue
        names = []
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom):
                names += [a.asname or a.name for a in node.names]
            elif isinstance(node, ast.Assign):
                names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        out[".".join(("aquaculture_tpu_torch",) + rel.parts)] = names
    return out


@pytest.fixture(scope="module")
def fresh_surface():
    """Resolve every JAX export in the port, in one fresh interpreter."""
    code = textwrap.dedent("""
        import importlib, json, sys
        host = {}
        for m in ("aquaculture_tpu_torch.geo.boxes", "aquaculture_tpu_torch.data.blank",
                  "aquaculture_tpu_torch.data.filenames", "aquaculture_tpu_torch.models.plan",
                  "aquaculture_tpu_torch.cli.plan", "aquaculture_tpu_torch.acquire",
                  "aquaculture_tpu_torch.cli.acquire"):
            importlib.import_module(m)
            host[m] = sorted(x for x in ("torch", "pandas") if x in sys.modules)
        wanted = json.loads(sys.argv[1])
        missing = []
        for pkg, names in wanted.items():
            mod = importlib.import_module(pkg)
            for n in names:
                value = getattr(mod, n, None)
                # a name that is also a submodule resolves to the submodule,
                # which holds the JAX export under the same name
                if value is None or (isinstance(value, type(sys)) and not hasattr(value, n)):
                    missing.append(pkg + "." + n)
            if hasattr(mod, "__all__"):
                assert set(names) <= set(mod.__all__) | {"__version__"}, (pkg, names, mod.__all__)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "aquaculture_tpu" or m.startswith("aquaculture_tpu."))
        print(json.dumps({"host": host, "missing": missing, "jax": bad}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(jax_exports())], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_jax_export_resolves_in_the_port(fresh_surface):
    assert len(jax_exports()) >= 13 and "aquaculture_tpu_torch.acquire" in jax_exports()
    assert fresh_surface["missing"] == []
    assert fresh_surface["jax"] == []


def test_names_of_submodules_resolve_to_the_submodules():
    """ops.nms and ops.letterbox stay the modules the port imports, in
    either import order; their functions sit inside under the same name."""
    code = textwrap.dedent("""
        import types
        from aquaculture_tpu_torch.ops import nms, letterbox
        import aquaculture_tpu_torch.ops as ops
        from aquaculture_tpu_torch.ops import batched_nms
        assert isinstance(nms, types.ModuleType) and isinstance(letterbox, types.ModuleType)
        assert ops.nms is nms and callable(nms.nms) and callable(letterbox.letterbox)
        assert batched_nms is nms.batched_nms
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr


def test_host_only_modules_load_no_torch_or_pandas(fresh_surface):
    assert fresh_surface["host"] == {m: [] for m in fresh_surface["host"]}


def test_boxes_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    lo = rng.uniform(-50, 50, (40, 2))
    a = np.concatenate([lo, lo + rng.uniform(-2, 30, (40, 2))], 1)  # some degenerate
    lo = rng.uniform(-50, 50, (25, 2))
    b = np.concatenate([lo, lo + rng.uniform(0, 30, (25, 2))], 1)
    b[0] = a[0]  # identical
    b[1] = [a[1, 2], a[1, 1], a[1, 2] + 5, a[1, 3]]  # touching edge
    for name in ("box_area", "cxcywh_to_xyxy", "xyxy_to_cxcywh"):
        np.testing.assert_array_equal(getattr(tboxes, name)(a), getattr(jboxes, name)(a))
    for name in ("box_iou", "pairwise_intersects"):
        np.testing.assert_array_equal(getattr(tboxes, name)(a, b), getattr(jboxes, name)(a, b))
    for name in ("box_intersection", "boxes_intersect"):
        np.testing.assert_array_equal(getattr(tboxes, name)(a[:25], b), getattr(jboxes, name)(a[:25], b))
    assert tboxes.pairwise_intersects(a, b)[1, 1]


@pytest.mark.parametrize("large,tile", [(6144, 1024), (4096, 1024), (2048, 512), (1000, 1024)])
def test_tile_offsets_and_specs_equal_the_jax_packages(large, tile):
    assert ttiling.tile_offsets(large, tile) == jtiling.tile_offsets(large, tile)
    got = ttiling.tile_specs_for_image(2014, 7, large, tile)
    want = jtiling.tile_specs_for_image(2014, 7, large, tile)
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    assert ttiling.tile_offsets() == jtiling.tile_offsets() and len(ttiling.tile_offsets()) == 36


def test_blank_detection_equals_the_jax_packages():
    rng = np.random.default_rng(3)
    images = [
        np.zeros((64, 64, 3), np.uint8), np.ones((64, 64, 3), np.uint8), np.full((64, 64, 3), 255, np.uint8),
        np.full((64, 64, 3), 251, np.uint8), np.full((64, 64), 252, np.uint8),
        rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 64, 4), dtype=np.uint8),
        rng.integers(0, 256, (48, 80), dtype=np.uint8),
    ]
    striped = rng.integers(0, 200, (64, 64, 3), dtype=np.uint8)
    striped[10] = 255
    images.append(striped)
    columned = rng.integers(0, 200, (64, 64, 3), dtype=np.uint8)
    columned[:, 63] = 252
    images.append(columned)
    for k, im in enumerate(images):
        assert tblank.is_blank(im) == jblank.is_blank(im), k
        assert tblank.is_partly_blank(im) == jblank.is_partly_blank(im), k
        assert tblank.blank_fraction(im) == jblank.blank_fraction(im), k
        assert tblank.blank_fraction(im, 128.0) == jblank.blank_fraction(im, 128.0), k
    assert [tblank.is_blank(im) for im in images[:5]] == [True] * 5
    assert tblank.is_partly_blank(striped) and tblank.is_partly_blank(columned)


def test_replicated_is_the_whole_batch_on_every_rank():
    assert tmesh.replicated() == slice(None) == tmesh.replicated(None)
    batch = np.arange(12)
    assert (batch[tmesh.replicated()] == batch).all()
    assert tmesh.batch_sharding(None, 12) == slice(0, 12)
