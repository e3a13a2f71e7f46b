"""Geometry of the PyTorch port: closed-form CRS transforms, geometry types,
WKT/GeoJSON IO, rectilinear region algebra, the boolean overlay engine
(Martinez-Rueda sweep, triangulation, buffers, linework), and rasterization
and vectorization (numpy, host)."""
