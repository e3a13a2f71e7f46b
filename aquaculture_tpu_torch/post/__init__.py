"""Host epilogue of the PyTorch port: geocode, download-box dedup, cage areas
and the land filter (numpy, host), and facility clustering (cluster.py, its
DBSCAN labels on the device)."""
