"""Training of the detector: loss, grouped SGD, EMA, augmentation, dataset."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "loss": ("yolo_loss",),
})
