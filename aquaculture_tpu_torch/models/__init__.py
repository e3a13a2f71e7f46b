"""Model zoo of the PyTorch port: the YOLOv5 detector family (models.aot,
models.export, models.quantize and models.weights hold the serving
artifact, the ``.pt`` writers, int8 PTQ and the weight bridges)."""

from aquaculture_tpu_torch.models.yolov5 import (  # noqa: F401
    VARIANTS,
    YoloV5,
    yolov5_init,
)
