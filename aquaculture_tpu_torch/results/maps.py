"""Facility maps: of aquaculture_tpu/results/maps.py (reference:
src/Results/FacilitiesMaps.py, src/plot_utils.py) the port has the Trujillo
1 km boxes that the tonnage report's comparison takes; the map figures
(matplotlib) come with a later slice.
"""

from __future__ import annotations

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.geo import polygon as _poly


TRUJILLO_PERIODS = ("2000-2004", "2005-2009", "2010-2012")
POST_TRUJILLO_PERIODS = ("2013-2015", "2016-2018", "2019-2021")


def trujillo_1km_boxes(
    trujillo: "gf.GeoFrame", half_size_m: float = 1000.0, box_crs: int = 3857
) -> "gf.GeoFrame":
    """"1 km" boxes around Trujillo points — the reference's box_size=1000
    means +/-1000 m, i.e. a 2 km-wide box (FacilitiesMaps.py:31-37,
    get_kfold_cluster_performance.py:66-70, tonnage_estimates.py:279-286
    all use box(p.x-1000, ..., p.x+1000)).

    box_crs picks which projection the box edges are drawn in: the
    evaluation strata were designed in EPSG:3857
    (get_kfold_cluster_performance.py:66-70 note) while FacilitiesMaps
    draws its boxes in EPSG:3035 (FacilitiesMaps.py:35-37) — pass 3035 for
    Figure-4 parity. Output is always EPSG:3857."""
    t = trujillo.to_crs(box_crs)
    boxes = [
        _poly.box(p.x - half_size_m, p.y - half_size_m, p.x + half_size_m, p.y + half_size_m)
        for p in t["geometry"]
    ]
    out = t.copy()
    out["geometry"] = boxes
    out.crs = box_crs
    return out.to_crs(3857)
