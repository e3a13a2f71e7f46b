"""Input pipeline of the PyTorch port: the tile filename codec, tile
slicing, blank detection, GeoTIFF reading, the loader and the object
store. Names are imported at first use (``_exports``), so the host-only
modules pull in no torch."""

from aquaculture_tpu_torch._exports import lazy_exports

lazy_exports(globals(), {
    "filenames": ("TileSpec", "decode_tile_name", "encode_tile_name"),
    "tiling": ("split_image", "tile_offsets", "tile_specs_for_image"),
    "blank": ("is_blank", "is_partly_blank", "blank_fraction"),
})
