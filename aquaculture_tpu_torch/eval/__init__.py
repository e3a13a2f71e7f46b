"""Evaluation of the PyTorch port: detection mAP (map.py) and the
serving-accuracy harness (accuracy.py)."""
