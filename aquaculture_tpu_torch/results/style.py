"""Shared paper-figure styling (the reference's presentation layer; a copy
of aquaculture_tpu/results/style.py).

The reference styles every figure with seaborn defaults plus a local
``stylize_axes`` helper (reference: src/utils.py:133-141 — top/right spines
off) and Myriad Pro at 8 pt (src/Results/ModelPerformance.py:60-80,
tonnage_estimates.py:184-198). Myriad Pro is a proprietary font not present
in this environment; figures fall back to the default sans-serif at the
same 8 pt geometry.
"""

from __future__ import annotations

PAPER_FONTSIZE = 8


def stylize_axes(ax) -> None:
    """Remove top and right spines (reference src/utils.py:133-141)."""
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)


def paper_ticks(ax, xticks=None, yticks=None) -> None:
    """Apply the reference's explicit tick sets + 8 pt tick labels
    (ModelPerformance.py:74-77)."""
    if xticks is not None:
        ax.set_xticks(xticks)
        ax.set_xticklabels([_fmt(t) for t in xticks])
    if yticks is not None:
        ax.set_yticks(yticks)
        ax.set_yticklabels([_fmt(t) for t in yticks])
    ax.tick_params(labelsize=PAPER_FONTSIZE)


def _fmt(t) -> str:
    f = float(t)
    return f"{f:g}"


def comma_yaxis(ax) -> None:
    """Thousands-separated y labels (tonnage_estimates.py:188)."""
    import matplotlib.ticker as mticker

    ax.get_yaxis().set_major_formatter(
        mticker.FuncFormatter(lambda v, p: format(int(v), ","))
    )
