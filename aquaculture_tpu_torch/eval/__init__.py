"""Evaluation of the PyTorch port: detection mAP (map.py), the
serving-accuracy harness (accuracy.py), and the facility evaluation:
true-positive matching (metrics.py), the stratified k-fold grid search
(kfold.py), image strata (buckets.py) and dataset assembly (datasets.py)."""
