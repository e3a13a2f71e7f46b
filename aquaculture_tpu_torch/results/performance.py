"""Precision/recall-vs-confidence curves (the reference's Figure 3; a copy
of aquaculture_tpu/results/performance.py, host numpy and pandas).

Port of ModelPerformance.py (reference: src/Results/ModelPerformance.py).
The reference recomputes the full spatial join for every one of 100
thresholds (:20-34); here the join happens ONCE — each prediction gets a TP
flag and each label the max confidence of its matching predictions — and
the sweep is a vectorized comparison, so the curve costs one join + O(T*N)
arithmetic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.eval.metrics import get_tp


def label_match_confidences(labels: "gf.GeoFrame", preds: "gf.GeoFrame") -> np.ndarray:
    """Per-label max det_conf over same-year same-type intersecting preds
    (-inf when unmatched)."""
    assert labels.crs == preds.crs
    if len(labels) == 0 or len(preds) == 0:
        return np.full(len(labels), -np.inf)
    joined = labels.sjoin(preds, how="left", predicate="intersects", lsuffix="query", rsuffix="key")
    ok = (
        joined["index_key"].notna()
        & (joined["year_query"] == joined["year_key"])
        & (joined["type_query"] == joined["type_key"])
    )
    # labels may themselves carry a det_conf column (suffix collision)
    conf_col = "det_conf_key" if "det_conf_key" in joined.columns else "det_conf"
    conf = joined[conf_col].where(ok, -np.inf)
    out = conf.groupby(level=0).max().reindex(labels.index, fill_value=-np.inf)
    return out.to_numpy(np.float64)


def stats_at_thresholds(
    labels: "gf.GeoFrame",
    preds: "gf.GeoFrame",
    thresholds: Sequence[float] = tuple(np.linspace(0, 1, 100)),
) -> pd.DataFrame:
    """precision(t), recall(t) over the threshold sweep, exact but with one
    spatial join (vs the reference's per-threshold joins)."""
    tp = get_tp(preds, labels).to_numpy() if len(preds) else np.zeros(0, bool)
    conf = preds["det_conf"].to_numpy(np.float64) if len(preds) else np.zeros(0)
    label_conf = label_match_confidences(labels, preds)

    rows = []
    for t in thresholds:
        sel = conf >= t
        n = int(sel.sum())
        precision = float(tp[sel].mean()) if n else np.nan
        recall = float((label_conf >= t).mean()) if len(label_conf) else np.nan
        rows.append({"threshold": float(t), "precision": precision, "recall": recall})
    return pd.DataFrame(rows)


def false_positive_reduction(
    sample_detections: "gf.GeoFrame", labels: "gf.GeoFrame", land_bucket: pd.Series
) -> dict:
    """FP share of raw detections and the fraction of FPs removed by the
    land filter (reference ModelPerformance.py:109-120)."""
    dets = sample_detections.copy()
    dets.crs = sample_detections.crs
    tp = get_tp(dets, labels).to_numpy()
    fp = ~tp
    on_land = land_bucket.to_numpy() == "land"
    total_fp = int(fp.sum())
    kept_fp = int((fp & ~on_land).sum())
    return {
        "fp_share_raw": float(fp.mean()) if len(dets) else np.nan,
        "fp_removed_by_land_filter": 1.0 - kept_fp / total_fp if total_fp else np.nan,
    }


def plot_precision_recall_curves(
    all_stats: pd.DataFrame,
    ocean_stats: Optional[pd.DataFrame] = None,
    cluster_stats: Optional[pd.DataFrame] = None,
    out_path: Optional[str] = None,
):
    """Two-panel Figure-3-style plot (precision | recall vs threshold)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from aquaculture_tpu_torch.results.style import PAPER_FONTSIZE, paper_ticks, stylize_axes

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(5.67, 2.5))
    # Reference stage styling (ModelPerformance.py:42-59): clustered model
    # darkred lw2.8, raw/ocean indianred lw0.8 (raw dashed), all alpha .6.
    stages = [
        (all_stats, "Object detection",
         {"linestyle": "--", "linewidth": 0.8, "alpha": 0.6, "color": "indianred"}),
        (ocean_stats, "Object detection\nand land filtering",
         {"linewidth": 0.8, "alpha": 0.6, "color": "indianred"}),
        (cluster_stats, "Model", {"linewidth": 2.8, "alpha": 0.6, "color": "darkred"}),
    ]
    for stats, label, kw in stages:
        if stats is None:
            continue
        ax1.plot(stats["threshold"], stats["precision"], label=label, **kw)
        ax2.plot(stats["threshold"], stats["recall"], **kw)
    ax1.set_xlabel("Model confidence threshold", fontsize=PAPER_FONTSIZE)
    ax1.set_ylabel("Precision", fontsize=PAPER_FONTSIZE)
    ax2.set_xlabel("Model confidence threshold", fontsize=PAPER_FONTSIZE)
    ax2.set_ylabel("Recall", fontsize=PAPER_FONTSIZE)
    ticks = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    for ax in (ax1, ax2):
        stylize_axes(ax)
        paper_ticks(ax, xticks=ticks, yticks=ticks)
    ax1.legend(frameon=False, fontsize=PAPER_FONTSIZE)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=300, bbox_inches="tight")
    return fig
