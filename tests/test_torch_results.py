"""The results layer of the port (aquaculture_tpu_torch.results: the
Figure-3 precision/recall sweep, the zero-label stratum's upper bound, the
figure styling) against the JAX package's on the CPU. Both sides run the
same numpy and pandas on the same inputs: equal with tolerance 0, NaN in
the same places."""

import numpy as np
import pandas as pd
import pytest

from aquaculture_tpu.results import performance as jperf
from aquaculture_tpu.results import upper_bound as jub
from aquaculture_tpu_torch import results as tresults
from aquaculture_tpu_torch.results import performance as tperf
from aquaculture_tpu_torch.results import style as tstyle
from aquaculture_tpu_torch.results import upper_bound as tub

from test_torch_eval import PACKAGES, world


@pytest.fixture(scope="module")
def worlds():
    return [world(G, P, seed=3) for G, P in PACKAGES]


def test_label_match_confidences_equal(worlds):
    (td, tl, _), (jd, jl, _) = worlds
    got = tperf.label_match_confidences(tl, td)
    want = jperf.label_match_confidences(jl, jd)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(want).any() and np.isfinite(want).any()
    # labels carrying their own det_conf column (the suffix collision)
    tl2, jl2 = tl.copy(), jl.copy()
    tl2["det_conf"] = jl2["det_conf"] = 0.5
    np.testing.assert_array_equal(tperf.label_match_confidences(tl2, td), jperf.label_match_confidences(jl2, jd))


@pytest.mark.parametrize("thresholds", [tuple(np.linspace(0, 1, 100)), (0.0, 0.785, 0.999, 1.0)])
def test_stats_at_thresholds_equal(worlds, thresholds):
    (td, tl, _), (jd, jl, _) = worlds
    got = tresults.stats_at_thresholds(tl, td, thresholds)
    want = jperf.stats_at_thresholds(jl, jd, thresholds)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_stats_at_thresholds_without_preds_equal(worlds):
    (td, tl, _), (jd, jl, _) = worlds
    none_t, none_j = td.iloc[:0].copy(), jd.iloc[:0].copy()
    none_t.crs = none_j.crs = td.crs
    got = tperf.stats_at_thresholds(tl, none_t)
    want = jperf.stats_at_thresholds(jl, none_j)
    assert want["precision"].isna().all()
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_false_positive_reduction_equal(worlds):
    (td, tl, _), (jd, jl, _) = worlds
    land = pd.Series(np.where(np.arange(len(td)) % 4 == 0, "land", "(0.8, 1.0]"), index=td.index)
    assert tperf.false_positive_reduction(td, tl, land) == jperf.false_positive_reduction(jd, jl, land)


@pytest.mark.parametrize("kw", [{}, {"K": 501, "seed": 3, "rates": (1e-6, 5e-5, 2e-4)}])
def test_upper_bound_simulation_equal(kw):
    got, want = tresults.upper_bound_simulation(**kw), jub.upper_bound_simulation(**kw)
    assert list(got) == list(want)
    pd.testing.assert_frame_equal(got.pop("rate_table"), want.pop("rate_table"), check_exact=True)
    assert got == want
    assert (tub.I_6, tub.S_6) == (jub.I_6, jub.S_6)


def test_precision_recall_figure(worlds, tmp_path):
    """The figure draws both panels from every stage given and writes the
    file; matplotlib is imported inside the function."""
    (td, tl, _), _ = worlds
    stats = tperf.stats_at_thresholds(tl, td)
    fig = tresults.plot_precision_recall_curves(stats, stats, stats, out_path=str(tmp_path / "fig3.png"))
    ax1, ax2 = fig.axes
    assert len(ax1.lines) == len(ax2.lines) == 3
    np.testing.assert_array_equal(ax2.lines[2].get_ydata(), stats["recall"].to_numpy())
    assert not ax1.spines["top"].get_visible() and ax1.get_xticklabels()[1].get_text() == "0.2"
    assert (tmp_path / "fig3.png").stat().st_size > 0
    tstyle.comma_yaxis(ax1)
    assert ax1.yaxis.get_major_formatter()(12345.0, 0) == "12,345"
