"""Training of the detector: loss, grouped SGD, EMA, augmentation, dataset."""
