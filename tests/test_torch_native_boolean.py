"""The port's C++ overlay sweep (csrc/booleanop.cc through
geo/native_boolean.py) against its Python sweep and the JAX package's.

- The source is the JAX package's native/src/booleanop.cc byte for byte.
- On seeded random operand pairs (tests/test_boolean.py's generators) and
  the operand families of tests/test_torch_overlay.py, for all four
  operations: the "c++" and "python" engines give the same rings, vertex
  for vertex, with the same holes.
- Polygon count, hole count and area agree with the JAX package's sweep
  (tests/test_boolean.py's differential test).
- A source that does not compile raises with the compiler's message;
  concurrent builds of one source end in one loadable library.
- The engine is chosen, never fallen back to: AQUAGEO_NO_NATIVE=1 selects
  "python", an explicit setting wins, and an error in the C++ engine
  propagates.
"""

import os
import pathlib
import threading

import numpy as np
import pytest

from aquaculture_tpu.geo import boolean as jbool
from aquaculture_tpu.geo import polygon as jpoly
from aquaculture_tpu_torch.geo import boolean as tbool
from aquaculture_tpu_torch.geo import native_boolean as tnative
from aquaculture_tpu_torch.geo import polygon as tpoly

from test_torch_overlay import FAMILIES, OPS, _members, assert_same_rings, jax_python_sweep

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def random_pairs():
    """120 seeded operand pairs: stars, star x integer hull, integer hulls
    (tests/test_boolean.py's differential test's generators), simple
    operands only."""
    rng = np.random.default_rng(77)

    def star():
        n = rng.integers(3, 12)
        cx, cy = rng.uniform(-3, 3, 2)
        th = np.sort(rng.uniform(0, 2 * np.pi, 2 * n))
        r = rng.uniform(0.3, 3.0, 2 * n)
        return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)

    def hull():
        pts = np.unique(rng.integers(-4, 5, (12, 2)).astype(float), axis=0)
        if len(pts) < 3:
            return None
        c = pts.mean(0)
        return pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]

    def simple(xy):
        poly = tpoly.Polygon(xy)
        r = tpoly._close_ring(poly.exterior)
        n = len(r) - 1
        for i in range(n):
            for j in range(i + 2, n):
                if not (i == 0 and j == n - 1) and tpoly._segments_intersect(r[i], r[i + 1], r[j], r[j + 1]):
                    return False
        return not poly.is_empty

    out = []
    while len(out) < 120:
        kind = len(out) % 3
        a, b = (star(), star()) if kind == 0 else (star(), hull()) if kind == 1 else (hull(), hull())
        if a is None or b is None or not (simple(a) and simple(b)):
            continue
        out.append((a, b))
    return out


def _both_engines(a, b, op):
    with tbool.using_sweep_engine("c++"):
        got = tbool.boolean_op(a, b, op)
    with tbool.using_sweep_engine("python"):
        want = tbool.boolean_op(a, b, op)
    return got, want


def _stats(g):
    polys = _members(g)
    return len(polys), sum(len(p.holes) for p in polys), g.area


def test_source_is_the_jax_packages_byte_for_byte():
    assert (REPO / "aquaculture_tpu_torch" / "csrc" / "booleanop.cc").read_bytes() == \
        (REPO / "native" / "src" / "booleanop.cc").read_bytes()


@pytest.mark.parametrize("op", OPS)
def test_engines_give_the_same_rings_on_random_pairs(random_pairs, op):
    for k, (a, b) in enumerate(random_pairs):
        got, want = _both_engines(tpoly.Polygon(a), tpoly.Polygon(b), op)
        assert_same_rings(got, want)
        assert got.area == want.area, (op, k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engines_give_the_same_rings_on_the_operand_families(family):
    for k, (sa, sb) in enumerate(FAMILIES[family]()):
        for op in OPS:
            got, want = _both_engines(sa(tpoly), sb(tpoly), op)
            assert_same_rings(got, want)
            assert got.area == want.area, (family, op, k)


def test_counts_and_area_match_the_jax_packages_sweep(random_pairs):
    for k, (a, b) in enumerate(random_pairs[:60]):
        for op in OPS:
            with tbool.using_sweep_engine("c++"):
                n_p, h_p, a_p = _stats(tbool.boolean_op(tpoly.Polygon(a), tpoly.Polygon(b), op))
            with jax_python_sweep():
                n_j, h_j, a_j = _stats(jbool.boolean_op(jpoly.Polygon(a), jpoly.Polygon(b), op))
            tol = 1e-9 * max(tpoly.Polygon(a).area, tpoly.Polygon(b).area) + 1e-12
            assert (n_p, h_p) == (n_j, h_j), (k, op)
            assert abs(a_p - a_j) < tol, (k, op, a_p, a_j)
    ring = tpoly.Polygon(tpoly.box(0, 0, 20, 20).exterior, [tpoly.box(5, 5, 15, 15).exterior])
    other = tpoly.Polygon([(10, -2), (24, 10), (10, 22), (3, 10)])
    jring = jpoly.Polygon(jpoly.box(0, 0, 20, 20).exterior, [jpoly.box(5, 5, 15, 15).exterior])
    jother = jpoly.Polygon([(10, -2), (24, 10), (10, 22), (3, 10)])
    for op in OPS:
        with tbool.using_sweep_engine("c++"):
            got = tbool.boolean_op(ring, other, op)
        with jax_python_sweep():
            want = jbool.boolean_op(jring, jother, op)
        assert _stats(got)[:2] == _stats(want)[:2] and got.area == pytest.approx(want.area, abs=1e-9)


def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    bad = tmp_path / "broken.cc"
    bad.write_text('extern "C" int aq_bool_ncontours(void* h) { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        tnative.compile_library((str(bad),))
    assert not os.listdir(tmp_path / "build")  # no library, no temporary left behind


def test_concurrent_builds_end_in_one_library(tmp_path, monkeypatch):
    """Four builds of one source at once (as pytest workers or serving
    processes starting together): each writes its own temporary file and
    moves it into place, so every one returns the same loadable path."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    got, errors = [], []

    def build():
        try:
            got.append(tnative.compile_library())
        except Exception as e:  # noqa: BLE001 - a failed build is the finding
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(got)) == 1 and os.listdir(tmp_path) == [os.path.basename(got[0])]
    lib = tnative.load_library(got[0])
    assert lib.aq_bool_ncontours is not None


def test_the_engine_is_chosen_not_fallen_back_to(monkeypatch):
    monkeypatch.delenv("AQUAGEO_NO_NATIVE", raising=False)
    previous = tbool.set_sweep_engine(None)
    try:
        assert tbool.sweep_engine() == "c++"
        monkeypatch.setenv("AQUAGEO_NO_NATIVE", "1")
        assert tbool.sweep_engine() == "python"
        with tbool.using_sweep_engine("c++"):
            assert tbool.sweep_engine() == "c++"  # an explicit setting wins
        assert tbool.sweep_engine() == "python"
        with pytest.raises(ValueError, match="unknown sweep engine"):
            tbool.set_sweep_engine("native-or-python")

        a, b = tpoly.Polygon(np.array([(0, 0), (4, 0), (2, 3)], float)), tpoly.box(1, 1, 5, 5)

        def broken(*args, **kwargs):
            raise RuntimeError("the C++ engine failed")

        monkeypatch.setattr(tnative, "sweep_native", broken)
        tbool.boolean_op(a, b, "intersection")  # AQUAGEO_NO_NATIVE: the Python sweep, never the library
        monkeypatch.delenv("AQUAGEO_NO_NATIVE")
        with pytest.raises(RuntimeError, match="the C\\+\\+ engine failed"):
            tbool.boolean_op(a, b, "intersection")  # no fallback to the Python sweep
    finally:
        tbool.set_sweep_engine(previous)
