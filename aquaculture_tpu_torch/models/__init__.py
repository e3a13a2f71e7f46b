"""Model zoo of the PyTorch port: the YOLOv5 detector family (models.aot,
models.export, models.quantize and models.weights hold the serving
artifact, the ``.pt`` writers, int8 PTQ and the weight bridges)."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "plan": ("ServingPlan", "TrainingPlan", "recommend_serving", "recommend_training"),
    "yolov5": ("VARIANTS", "YoloV5", "yolov5_init"),
})
