"""Geometry of the PyTorch port: closed-form CRS transforms, geometry types,
WKT/GeoJSON IO, rectilinear region algebra and rasterization (numpy, host)."""
