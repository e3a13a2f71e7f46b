"""The port's serving plan (models/plan.py, cli/plan.py) against the JAX
package's, and scripts/plan_sweep.py's CPU rehearsal.

- Over a grid of recommend_serving's arguments (the four booleans x the
  variant pin x img) and of recommend_training's, the fields that follow
  from the arguments alone are equal (the variant where .pt interop or a
  pin fixes it, img, overlap, TTA, decode-at-scale, batch 1 on the latency
  path, remat and the recipe), and so are the cases that raise.
- A field that rests on a speed measurement may differ only where the
  tables below name the H100 reading behind the difference; that reading
  stands in the plan's note and in PERF.md section 5.
- No number of the JAX plan's notes (TPU measurements) appears in a note
  of the port.
- cli.plan: the flag sets of tests/test_cli.py::test_plan_cli give the
  same exit codes and refusals in both packages.
"""

import io
import itertools
import json
import pathlib
import re
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from aquaculture_tpu import config as jconfig
from aquaculture_tpu.cli import plan as jcli
from aquaculture_tpu.models import plan as jplan
from aquaculture_tpu_torch import config as tconfig
from aquaculture_tpu_torch.cli import plan as tcli
from aquaculture_tpu_torch.models import plan as tplan
from aquaculture_tpu_torch.models import yolov5 as tyolo

ROOT = pathlib.Path(__file__).resolve().parent.parent
PERF = (ROOT / "PERF.md").read_text()

BOOLS = list(itertools.product((False, True), repeat=4))
PINS = (None, "n", "m", "mt", "m6", "zz")
IMGS = (None, 640, 1280)

# Measured fields of recommend_serving that differ from the JAX package's:
# (field, variant, img) -> the H100 reading behind the difference, as the
# plan's note and PERF.md section 5 ("Plan inputs") state it.
SERVING_DIFFERENCES = {
    # the smallest batch within 2% of the best tiles/s; the JAX plan's knee is 128
    ("batch", "mt", 640): "b192 2,186.6",
    ("batch", "m", 640): "b192 1,923.1",
    ("batch", "m6", 1280): "b64 515.0",
    # int8_safe below bf16 at b128, outside the call's spread; the JAX plan serves int8 there
    ("int8", "m", 640): "0.45x",
    ("int8", "m", 1280): "0.45x",
    ("int8", "m6", 1280): "0.42x",
}
# recommend_training: (field, variant) -> the reading
TRAINING_DIFFERENCES = {
    # one feed thread's cold img/s against the variant's b128 step img/s
    ("feed_cores", "mt"): "19.47 img/s",
    ("feed_cores", "m"): "19.47 img/s",
    ("feed_cores", "n"): "19.47 img/s",
    ("feed_cores", "m6"): "19.47 img/s",
}
# numbers that both packages' notes state as plan fields (scale jitter, mosaic)
FIELD_VALUES = {"0.3", "0.5"}


def _call(fn, **kw):
    try:
        return fn(**kw), None
    except ValueError as e:
        return None, str(e)


def _serving_cases():
    for pin in PINS:
        for img in IMGS:
            for lat, pt, bnd, ss in BOOLS:
                yield dict(img=img, latency_sensitive=lat, pt_interop=pt, boundary_accuracy=bnd,
                           scale_shifted=ss, variant=pin)


def _training_cases():
    for pin in PINS:
        for pt, small, mem in itertools.product((False, True), repeat=3):
            yield dict(pt_interop=pt, small_targets=small, memory_constrained=mem, variant=pin)


def serving_differences(kw):
    """{(field, variant, img)} where the port's plan differs from the JAX
    package's on a measured field, after asserting the argument-derived
    fields equal."""
    jp, je = _call(jplan.recommend_serving, **kw)
    tp, te = _call(tplan.recommend_serving, **kw)
    assert te == je, kw
    if je is not None:
        return set()
    for f in ("img_size", "overlap_px", "tta", "decode_scale"):
        assert getattr(tp, f) == getattr(jp, f), (f, kw)
    assert (tp.batch == 1) == (jp.batch == 1) == kw["latency_sensitive"], kw
    if kw["pt_interop"] or kw["variant"]:
        assert tp.variant == jp.variant, kw
    out = set()
    for f in ("variant", "batch", "int8"):
        if getattr(tp, f) != getattr(jp, f):
            key = (f, tp.variant, tp.img_size)
            assert key in SERVING_DIFFERENCES, (key, kw, getattr(tp, f), getattr(jp, f))
            assert any(SERVING_DIFFERENCES[key] in n for n in tp.notes), (key, tp.notes)
            out.add(key)
    return out


@pytest.mark.parametrize("img", IMGS)
@pytest.mark.parametrize("pin", PINS)
def test_serving_plan_matches_on_argument_derived_fields(pin, img):
    for lat, pt, bnd, ss in BOOLS:
        serving_differences(dict(img=img, latency_sensitive=lat, pt_interop=pt, boundary_accuracy=bnd,
                                 scale_shifted=ss, variant=pin))


def training_differences(kw):
    jp, je = _call(jplan.recommend_training, **kw)
    tp, te = _call(tplan.recommend_training, **kw)
    assert te == je, kw
    if je is not None:
        return set()
    for f in ("compute_dtype", "remat", "augment", "mosaic", "scale_jitter", "budget_multiplier"):
        assert getattr(tp, f) == getattr(jp, f), (f, kw)
    if kw["pt_interop"] or kw["variant"]:
        assert tp.variant == jp.variant, kw
    out = set()
    for f in ("variant", "batch", "feed_cores"):
        if getattr(tp, f) != getattr(jp, f):
            key = (f, tp.variant)
            assert key in TRAINING_DIFFERENCES, (key, kw, getattr(tp, f), getattr(jp, f))
            assert any(TRAINING_DIFFERENCES[key] in n for n in tp.notes), (key, tp.notes)
            out.add(key)
    return out


@pytest.mark.parametrize("pin", PINS)
def test_training_plan_matches_on_argument_derived_fields(pin):
    for pt, small, mem in itertools.product((False, True), repeat=3):
        training_differences(dict(pt_interop=pt, small_targets=small, memory_constrained=mem, variant=pin))


def test_every_named_difference_occurs_and_stands_in_perf_md():
    """No stale row: each difference the tables name occurs on the grid,
    and its reading is written in PERF.md."""
    seen = set().union(*(serving_differences(kw) for kw in _serving_cases()))
    assert seen == set(SERVING_DIFFERENCES)
    seen = set().union(*(training_differences(kw) for kw in _training_cases()))
    assert seen == set(TRAINING_DIFFERENCES)
    for reading in list(SERVING_DIFFERENCES.values()) + list(TRAINING_DIFFERENCES.values()):
        assert reading in PERF, reading


_NUMBER = re.compile(r"(?<![\w.])[+-]?\d[\d,]*(?:\.\d+)?(?:%|x\b)?")


def _notes(module):
    out = []
    for kw in _serving_cases():
        plan, _ = _call(module.recommend_serving, **kw)
        out += plan.notes if plan else []
    for kw in _training_cases():
        plan, _ = _call(module.recommend_training, **kw)
        out += plan.notes if plan else []
    return out


def test_no_tpu_number_in_the_port_notes():
    jax_numbers = {t.lstrip("+-") for n in _notes(jplan) for t in _NUMBER.findall(n)
                   if any(c in t for c in ".%x,")} - FIELD_VALUES
    assert {"450.6", "5.8%", "3.3%", "400.7", "364.4", "17.1"} <= jax_numbers
    port_notes = _notes(tplan)
    port_numbers = {t.lstrip("+-") for n in port_notes for t in _NUMBER.findall(n)}
    assert not jax_numbers & port_numbers, sorted(jax_numbers & port_numbers)
    # every note that states a speed names the card it was read on
    for n in port_notes:
        if re.search(r"\d (tiles/s|img/s|ms)\b", n):
            assert tplan.CARD in n, n
    assert "TPU" not in " ".join(port_notes) and tplan.CARD in PERF


def test_host_copies_equal_their_sources():
    assert sorted(tplan.VARIANTS) == sorted(tyolo.VARIANTS) == sorted(jplan.VARIANTS)
    assert tplan.IM_WIDTH == tconfig.IM_WIDTH == jconfig.IM_WIDTH


def test_measured_rules_follow_their_readings():
    """The derived constants are what the rules say they are."""
    assert tplan._BATCH_KNEE == {("mt", 640): 192, ("m", 640): 192, ("m6", 1280): 64}
    assert tplan._INT8_SAFE_WINS == set() and tplan._INT8_LOSES == {"mt", "m", "m6"}
    assert tplan._knee({1: 10.0, 2: 98.0, 4: 100.0}) == 2 and tplan._knee({1: 10.0, 2: 97.9, 4: 100.0}) == 4
    assert recommend_defaults() == (("mt", 192, False), ("mt", 128, 20))


def recommend_defaults():
    s, t = tplan.recommend_serving(), tplan.recommend_training()
    return (s.variant, s.batch, s.int8), (t.variant, t.batch, t.feed_cores)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with redirect_stdout(out), redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


CLI_FLAGS = [
    ["--json"], ["--pt-interop"], ["--scale-shifted", "--json"], ["--train", "--json"],
    ["--train", "--memory-constrained", "--small-targets", "--json"], ["--latency-sensitive"],
    ["--boundary-accuracy", "--json"], ["--variant", "m6", "--img", "640", "--boundary-accuracy"],
    ["--train", "--latency-sensitive"], ["--train", "--img", "640", "--scale-shifted"],
    ["--small-targets"], ["--memory-constrained", "--json"],
]


@pytest.mark.parametrize("argv", CLI_FLAGS, ids=" ".join)
def test_cli_plan_matches_exit_codes_and_refusals(argv):
    jcode, jout, jerr = _run(jcli.main, argv)
    tcode, tout, terr = _run(tcli.main, argv)
    assert tcode == jcode, (tcode, jcode, terr, jerr)
    if jcode:
        assert terr.splitlines()[-1] == jerr.splitlines()[-1]
        assert not tout
        return
    if "--json" in argv:
        t, j = json.loads(tout), json.loads(jout)
        assert set(t) == set(j)
        for f in ("img_size", "overlap_px", "tta", "decode_scale", "remat", "scale_jitter", "mosaic"):
            assert t.get(f) == j.get(f), f
    else:
        # the text form: one summary line of the same keys, then the notes
        assert [kv.split("=")[0] for kv in tout.splitlines()[0].split()] == \
            [kv.split("=")[0] for kv in jout.splitlines()[0].split()]
        assert all(line.startswith("  - ") for line in tout.splitlines()[1:])


def test_cli_plan_help_needs_no_torch():
    import subprocess

    code = ("import sys\nfrom aquaculture_tpu_torch.cli import plan\ntry:\n    plan.main(['--help'])\n"
            "except SystemExit:\n    pass\nprint('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "False", proc.stdout + proc.stderr


def test_plan_sweep_rehearses_serving_on_the_cpu(capsys):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import plan_sweep
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert plan_sweep.main(["--device", "cpu", "--only", "serving"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    serving = [r for r in rows if r.get("part") == "serving" and "batch" in r]
    sizes = plan_sweep.SIZES["cpu"]
    assert [(r["variant"], r["batch"]) for r in serving] == \
        [(v, b) for v in ("mt", "m") for b in sizes["batches"]] + [("m6", b) for b in sizes["batches6"]]
    for r in serving:
        assert r["device"] == "cpu" and r["card"] == "cpu" and r["fits"] and r["tiles_per_s"] > 0
        assert r["tiles_per_s_min"] <= r["tiles_per_s"] <= r["tiles_per_s_max"]
        assert r["img"] == (sizes["img6"] if r["variant"] == "m6" else sizes["img"])
    assert rows[-1]["parts"] == ["serving"]
    with pytest.raises(SystemExit):
        plan_sweep.main(["--device", "cpu", "--only", "serving,warp"])
