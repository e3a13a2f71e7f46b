"""Geometry of the PyTorch port: closed-form CRS transforms, geometry types,
WKT/GeoJSON IO, rectilinear region algebra, the boolean overlay engine
(Martinez-Rueda sweep, triangulation, buffers, linework), and rasterization
and vectorization (numpy, host)."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "crs": ("laea_forward", "laea_inverse", "mercator_forward", "mercator_inverse", "transform"),
    "boxes": ("box_area", "box_intersection", "box_iou", "boxes_intersect"),
    "boolean": ("boolean_op", "unary_union_tree", "union_area"),
})
