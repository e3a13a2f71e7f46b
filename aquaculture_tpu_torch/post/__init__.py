"""Host epilogue of the PyTorch port: geocode, download-box dedup, cage areas
and the land filter (numpy, host), and facility clustering (cluster.py, its
DBSCAN labels on the device)."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "geocode": ("geocode_detections", "pixels_to_mercator", "remove_land_detections", "yolo_norm_to_pixels"),
    "areas": ("cage_areas", "circle_areas", "square_areas"),
    "cluster": ("cluster_facilities", "dbscan", "predictions_cluster"),
    "dedup": ("deduplicate_download_boxes", "deduplicate_gdf_with_bboxes"),
})
