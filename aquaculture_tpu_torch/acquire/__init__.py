"""Data acquisition of the PyTorch port: WMS imagery download, bathymetry
merge, land filter (host code, copies of aquaculture_tpu/acquire).

Port of the reference's load_data layer (reference: src/load_data/) with
network and object-store access behind injectable protocols, so the
orchestration logic (coast tiling, blank probing, resumability, retry) is
testable offline and the production transports plug in unchanged. Names
are imported at first use (``_exports``).
"""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "wms": ("download_images_within_shape", "tile_shapefile"),
    "bathymetry": ("merge_asc_grids", "read_asc"),
    "landfilter": ("build_land_filter",),
})
