"""Evaluation of the PyTorch port: detection mAP (map.py), the
serving-accuracy harness (accuracy.py), and the facility evaluation:
true-positive matching (metrics.py), the stratified k-fold grid search
(kfold.py), image strata (buckets.py) and dataset assembly (datasets.py)."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "metrics": ("get_stats_total", "get_tp"),
    "kfold": ("GridConfig", "get_fold_performance", "kfold_cluster_performance", "test_set_performance"),
})
