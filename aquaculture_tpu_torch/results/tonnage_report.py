"""Tonnage report: Figure-6 computations and the Trujillo comparison (a
copy of aquaculture_tpu/results/tonnage_report.py; the bootstrap runs on the
facility's device).

Port of tonnage_estimates.py (reference: src/Results/tonnage_estimates.py):
period tonnage with missing-imagery adjustment (facilities from a
comparison period outside the current period's imagery coverage are
imputed), the bounded within-1km-of-Trujillo tonnage, and the combined
model/HITL/FAO plot.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.tonnage.bootstrap import compute_facility_tonnage_estimates
from aquaculture_tpu_torch.tonnage.facility import (
    AquaFacility,
    compute_complete_period_tonnage_estimates,
    modify_cage_list_using_geometry,
)

# Period pairs used for missing-imagery adjustment — the reference's exact
# choices with its coverage rationale (tonnage_estimates.py:111-118):
# 2005-2009 compares FORWARD to 2010-2012 (period 0 has poor coverage), and
# every period from 2016 on compares back to 2010-2012 (2013-2018 coverage
# is incomplete).
PERIOD_COMPARISON = {
    "2000-2004": "2005-2009",
    "2005-2009": "2010-2012",
    "2010-2012": "2005-2009",
    "2013-2015": "2010-2012",
    "2016-2018": "2010-2012",
    "2019-2021": "2010-2012",
}

# Trujillo et al. literature anchors (tonnage_estimates.py:303-306)
TRUJILLO_TONNAGE_75 = 2008.0
TRUJILLO_TONNAGE_100 = 2678.0
TRUJILLO_NUM_CAGES = 1213


def compute_complete_tonnage_estimates(
    facility: AquaFacility,
    model_error_distributions: pd.DataFrame,
    period_factor_table: pd.DataFrame,
    min_cage_threshold: float,
    depth_dist_mixture_param: float,
    K: int = 10_000,
    period_comparison: Dict[str, str] = PERIOD_COMPARISON,
    seed: int = 0,
) -> pd.DataFrame:
    """Per-period tonnage with missing-imagery imputation
    (reference compute_complete_tonnage_estimates_for_plot, :72-126)."""
    out = []
    for period, compare in period_comparison.items():
        if period not in facility.annual_coverage:
            continue
        est = compute_complete_period_tonnage_estimates(
            facility,
            current_period=period,
            compare_period=compare,
            model_error_distributions=model_error_distributions,
            min_cage_threshold=min_cage_threshold,
            period_factor_table=period_factor_table,
            depth_dist_mixture_param=depth_dist_mixture_param,
            K=K,
            seed=seed,
        )
        out.append(est)
    return pd.concat(out).sort_index()


def compute_bounded_tonnage(
    facility: AquaFacility,
    model_error_distributions: pd.DataFrame,
    bound_geom: _poly.Geometry,
    sbound: str,
    period_factor_table: pd.DataFrame,
    min_cage_threshold: float,
    depth_dist_mixture_param: float,
    K: int = 10_000,
    seed: int = 0,
    bound_crs: int = 3857,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Tonnage restricted to cages inside/outside a geometry
    (reference compute_bounded_tonnage wiring, tonnage_estimates.py:290-300).

    ``bound_crs`` is the CRS ``bound_geom`` is expressed in; cage
    geometries are projected into it for the inside/outside test (the
    predictions frame may be in any CRS — a raw-coordinate intersect
    between e.g. 3857 meters and 4326 degrees never hits, which would
    silently empty every cage list)."""
    bounded = facility.final_facilities.copy()
    preds_df = facility.preds
    preds_geo = preds_df if preds_df.crs == bound_crs else preds_df.to_crs(bound_crs)
    preds_geo.crs = bound_crs
    for col in ("cage_ids", "cage_ids_max", "cage_ids_min"):
        if col not in bounded.columns:
            continue
        bounded[col] = [
            modify_cage_list_using_geometry(ids, bound_geom, preds_geo, sbound)
            for ids in bounded[col]
        ]
    # The reference drops facilities whose MIN selection is empty inside
    # the bound (tonnage_estimates.py:253-254), not whose random selection
    # is — the min list is the conservative existence test
    drop_col = "cage_ids_min" if "cage_ids_min" in bounded.columns else "cage_ids"
    bounded = bounded[bounded[drop_col].apply(len) > 0]
    if len(bounded) == 0:
        return bounded, pd.DataFrame({"tonnage": []})
    est = compute_facility_tonnage_estimates(
        facility_df=bounded,
        period_factor_table=period_factor_table,
        period_var=facility.time_group,
        min_cage_threshold=min_cage_threshold,
        preds_df=preds_df,
        model_error_distributions=model_error_distributions,
        depth_dist_mixture_param=depth_dist_mixture_param,
        K=K,
        seed=seed,
        device=facility.device,
    )
    return bounded, est


def trujillo_comparison(
    facility: AquaFacility,
    trujillo_1km_boxes: _poly.Geometry,
    model_error_distributions: pd.DataFrame,
    period_factor_table: pd.DataFrame,
    min_cage_threshold: float,
    depth_dist_mixture_param: float,
    compare_period: str = "2005-2009",
    K: int = 10_000,
    bound_crs: int = 3857,
) -> pd.DataFrame:
    """Predicted vs literature tonnage/cage-count near Trujillo facilities
    (reference trujillo_comparison, :303-320). ``trujillo_1km_boxes`` must
    be the union geometry in ``bound_crs`` (results.maps.trujillo_1km_boxes
    outputs 3857)."""
    bounded, est = compute_bounded_tonnage(
        facility,
        model_error_distributions,
        trujillo_1km_boxes,
        "inside",
        period_factor_table,
        min_cage_threshold,
        depth_dist_mixture_param,
        K=K,
        bound_crs=bound_crs,
    )
    pred_tonnage = float(est.loc[compare_period, "tonnage"]) if compare_period in est.index else 0.0
    n_cages = int(
        bounded.loc[bounded["pass"] == compare_period, "cage_ids"].apply(len).sum()
    ) if len(bounded) else 0
    return pd.DataFrame(
        {
            "Measure": ["Tonnage", "Number of cages"] * 3,
            "Source": ["Trujillo (75%)"] * 2 + ["Trujillo (100%)"] * 2 + ["Predicted"] * 2,
            "Value": [
                TRUJILLO_TONNAGE_75,
                TRUJILLO_NUM_CAGES,
                TRUJILLO_TONNAGE_100,
                TRUJILLO_NUM_CAGES,
                pred_tonnage,
                n_cages,
            ],
        }
    )


def combined_tonnage_plot(
    model_estimates: pd.DataFrame,
    hitl_estimates: Optional[pd.DataFrame] = None,
    fao_by_period: Optional[pd.Series] = None,
    out_path: Optional[str] = None,
):
    """Model vs HITL vs FAO per-period tonnage as the reference's grouped
    bar chart (reference combined_tonnage_plot, :136-198): one bar group
    per period with Model steelblue / HITL mediumseagreen / FAO salmon,
    ±1.96 sd error whiskers (capsize 5, capthick 0), 8 pt type,
    comma-formatted tonnes, top/right spines off."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from aquaculture_tpu_torch.results.style import (
        PAPER_FONTSIZE,
        comma_yaxis,
        stylize_axes,
    )

    fig, ax = plt.subplots(figsize=(5.67, 3))
    periods = list(model_estimates.index)
    x = np.arange(len(periods))
    series = [("Model", model_estimates, "steelblue")]
    if hitl_estimates is not None:
        series.append(("HITL", hitl_estimates, "mediumseagreen"))
    if fao_by_period is not None:
        series.append(("FAO statistics", fao_by_period.to_frame("tonnage"), "salmon"))
    offsets = (np.arange(len(series)) - (len(series) - 1) / 2) / (len(series) + 1.0)
    width = float(np.diff(offsets).mean()) if len(series) > 1 else 0.25

    for (label, df, color), off in zip(series, offsets):
        px = [periods.index(p) for p in df.index if p in periods]
        sub = df.loc[[periods[i] for i in px]]
        sd = sub.get("tonnage_sd", pd.Series(0.0, index=sub.index))
        ax.bar(
            np.asarray(px) + off, sub["tonnage"].values, width=width,
            label=label, color=color,
            yerr=1.96 * np.asarray(sd, float),
            error_kw=dict(ecolor=color, lw=1, capsize=5, capthick=0),
        )
    ax.set_xticks(x)
    ax.set_xticklabels(periods, fontsize=PAPER_FONTSIZE)
    ax.tick_params(labelsize=PAPER_FONTSIZE)
    ax.set_ylabel("Live weight - tonnes", fontsize=PAPER_FONTSIZE)
    comma_yaxis(ax)
    ax.legend(frameon=False, fontsize=PAPER_FONTSIZE)
    stylize_axes(ax)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=300, bbox_inches="tight")
    return fig
