"""True-positive matching and precision/recall (a copy of
aquaculture_tpu/eval/metrics.py; host, pandas).

Port of get_tp / get_stats_total (reference:
src/get_kfold_cluster_performance.py:123-145, 259-281): a query row is TP
when it intersects a key row of the same year and type.

Divergence note: the reference's truthiness test ``r['index_key'] and ...``
silently treats a key with positional index 0 as no-match; we use an
explicit not-null check instead (the statistically intended behavior).
"""

from __future__ import annotations

from typing import Dict

import pandas as pd

from aquaculture_tpu_torch import frame as gf


def get_tp(query: "gf.GeoFrame", key: "gf.GeoFrame") -> pd.Series:
    """Per-query boolean: intersects a same-year same-type key."""
    assert query.crs == key.crs, (query.crs, key.crs)
    if len(query) == 0:
        return pd.Series([], dtype=bool)
    if len(key) == 0:
        return pd.Series(False, index=query.index)
    joined = query.sjoin(key, how="left", predicate="intersects", lsuffix="query", rsuffix="key")
    matched = (
        joined["index_key"].notna()
        & (joined["year_query"] == joined["year_key"])
        & (joined["type_query"] == joined["type_key"])
    )
    joined["tp"] = matched
    return joined.groupby(level=0)["tp"].any().reindex(query.index, fill_value=False)


def get_stats_total(labels: "gf.GeoFrame", preds: "gf.GeoFrame") -> Dict[str, float]:
    """Population precision/recall assuming fully-labeled predictions
    (reference :259-281)."""
    if len(preds) == 0:
        precision = float("nan")
    else:
        precision = float(get_tp(preds, labels).mean())
    if len(labels) == 0:
        recall = float("nan")
    else:
        recall = float(get_tp(labels, preds).mean())
    return {"precision": precision, "recall": recall}
