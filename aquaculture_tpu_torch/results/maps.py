"""Facility maps: known (Trujillo) vs newly-detected facilities per period.
A copy of aquaculture_tpu/results/maps.py in the PyTorch port.

Port of FacilitiesMaps.py + plot_utils.py (reference:
src/Results/FacilitiesMaps.py, src/plot_utils.py): classify each predicted
facility as known (within 1 km of a Trujillo location) or additional,
count unique locations via spatial dedup, render per-period matplotlib maps
(Basemap/folium replaced: matplotlib scatter + an optional self-contained
HTML map with no external tile dependency). The classifications are host
code on the overlay engine (``unary_union``, ``sjoin``); the plots import
matplotlib at their call and raise ``ImportError`` where it is missing;
``facility_map_html`` needs no matplotlib.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import pandas as pd

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


def _cage_bounds_boxes(facilities: "gf.GeoFrame"):
    """Per-facility bounds box of the union of its cage geometries
    (reference 'bounds' column, FacilitiesMaps.py:84-86)."""
    boxes = []
    for _, row in facilities.iterrows():
        geoms = [
            g
            for g in (row.get("circle_farm_geoms"), row.get("square_farm_geoms"))
            if g is not None and not getattr(g, "is_empty", True)
        ]
        if not geoms:
            boxes.append(_poly.EMPTY)
            continue
        u = _poly.unary_union(geoms)
        boxes.append(_poly.box(*u.bounds))
    return boxes


def true_positive_facilities(
    facilities: "gf.GeoFrame", cf_labels: "gf.GeoFrame", year_to_pass
) -> "gf.GeoFrame":
    """Facilities confirmed by a human label from the same period
    (reference get_true_facilities, FacilitiesMaps.py:64-94): bounds-box
    sjoin against labels, keep facility rows whose pass equals the label
    year's pass, dedup by facility_index. Geometry becomes the cage-extent
    bounds box.

    Pass the facility frame in its NATIVE CRS: the join boxes derive from
    the circle/square cage-geometry columns, which GeoFrame.to_crs (like
    geopandas) does NOT transform — a pre-reprojected frame would carry
    stale cage columns labeled with the new CRS and silently match
    nothing. Labels are reprojected here to the frame's CRS."""
    fac = facilities.copy()
    fac["geometry"] = _cage_bounds_boxes(facilities)
    fac.crs = facilities.crs
    lab = cf_labels.to_crs(fac.crs)
    joined = fac.sjoin(lab, how="left", predicate="intersects")
    year_col = "year_right" if "year_right" in joined.columns else "year"
    cf_pass = joined[year_col].map(
        lambda y: year_to_pass(int(y)) if pd.notna(y) else None
    )
    keep = joined[joined["pass"] == cf_pass]
    keep = keep.drop_duplicates("facility_index")
    cols = [c for c in ("geometry", "pass", "facility_index", "cage_ids") if c in keep.columns]
    out = gf.GeoFrame(pd.DataFrame(keep[cols]))
    out.crs = fac.crs
    return out


def classify_our_facilities(
    true_facilities: "gf.GeoFrame",
    trujillo_boxes: "gf.GeoFrame",
    trujillo_points: "gf.GeoFrame",
) -> "gf.GeoFrame":
    """The reference's Figure-4 classification (FacilitiesMaps.py:118-190):

    1. during the Trujillo study periods, OUR facilities outside every
       1 km box -> 'Additional facility' (geometry = bounds centroid);
    2. the Trujillo points themselves repeat per study period as
       'Known facility' rows carrying their published num_cages;
    3. post-Trujillo periods classify each of our facilities Known /
       Additional by box intersection.

    Returns the combined frame with columns [type, geometry, pass,
    num_cages] in EPSG:3857."""
    fac = true_facilities.to_crs(3857)
    fac["num_cages"] = [
        int(len(c)) if c is not None else 0 for c in fac.get("cage_ids", [[]] * len(fac))
    ]
    b3857 = trujillo_boxes.to_crs(3857)
    # geometry-only join target: the Trujillo frame's own columns
    # (num_cages etc.) must not suffix-collide with the facility columns
    boxes = gf.GeoFrame(
        {"trujillo_facility_index": np.arange(len(b3857))},
        geometry=list(b3857["geometry"]),
        crs=3857,
    )
    pts = trujillo_points.to_crs(3857)

    def _tag(frame):
        joined = frame.sjoin(boxes, how="left", predicate="intersects")
        hit = joined["index_right"].notna()
        # a facility intersecting ANY box counts as known (reference sorts
        # non-null first then drop-duplicates)
        known_ids = set(joined.loc[hit, "facility_index"])
        first = joined.drop_duplicates("facility_index").copy()
        first["type"] = [
            "Known facility" if fi in known_ids else "Additional facility"
            for fi in first["facility_index"]
        ]
        first["geometry"] = [g.centroid for g in first["geometry"]]
        return first

    parts = []
    during = fac[fac["pass"].isin(TRUJILLO_PERIODS)].copy()
    during.crs = fac.crs
    if len(during):
        tagged = _tag(during)
        add = tagged[tagged["type"] == "Additional facility"]
        parts.append(pd.DataFrame(add[["type", "geometry", "pass", "num_cages"]]))
    for period in TRUJILLO_PERIODS:
        known = pd.DataFrame(
            {
                "type": "Known facility",
                "geometry": list(pts["geometry"]),
                "pass": period,
                "num_cages": pts["num_cages"].to_numpy()
                if "num_cages" in pts.columns
                else 0,
            }
        )
        parts.append(known)
    post = fac[fac["pass"].isin(POST_TRUJILLO_PERIODS)].copy()
    post.crs = fac.crs
    if len(post):
        tagged = _tag(post)
        parts.append(pd.DataFrame(tagged[["type", "geometry", "pass", "num_cages"]]))
    out = gf.GeoFrame(pd.concat(parts, ignore_index=True))
    out.crs = 3857
    return out


def plot_combined_map(combined: "gf.GeoFrame", out_path: Optional[str] = None):
    """Figure-4 single-panel map (reference plot_map, FacilitiesMaps.py:
    191-233 collapsed-panel selection): original Trujillo facilities at
    2000-2004 plus every Additional facility; marker size by cage-count
    bin, red=known / blue=additional."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ll = combined.to_crs(4326)
    cage_bin = pd.cut(ll["num_cages"], [0, 50, 100, 500]).astype(str)
    size_fn = {"(0, 50]": 20, "(50, 100]": 90, "(100, 500]": 200}
    color_fn = {"Additional facility": "blue", "Known facility": "red"}
    sel = ((ll["type"] == "Known facility") & (ll["pass"] == "2000-2004")) | (
        ll["type"] == "Additional facility"
    )
    sub = ll[sel]
    fig, ax = plt.subplots(figsize=(4.5, 3.5))
    ax.scatter(
        [g.centroid.x for g in sub["geometry"]],
        [g.centroid.y for g in sub["geometry"]],
        c=[color_fn[t] for t in sub["type"]],
        s=[size_fn.get(b, 20) for b in cage_bin[sel]],
        alpha=0.6,
        linewidth=0,
    )
    from aquaculture_tpu_torch.results.style import PAPER_FONTSIZE, stylize_axes

    ax.set_xlabel("Longitude", fontsize=PAPER_FONTSIZE)
    ax.set_ylabel("Latitude", fontsize=PAPER_FONTSIZE)
    ax.tick_params(labelsize=PAPER_FONTSIZE)
    stylize_axes(ax)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=300, bbox_inches="tight")
    return fig


def classify_facilities(
    facilities: "gf.GeoFrame", trujillo_boxes: "gf.GeoFrame"
) -> "gf.GeoFrame":
    """Tag each facility 'known' (intersects a Trujillo 1 km box) or
    'additional' (reference classify_our_facilities)."""
    fac = facilities.to_crs(3857)
    fac.crs = 3857
    joined = fac.sjoin(trujillo_boxes.to_crs(3857), how="inner", predicate="intersects")
    known = set(joined.index)
    fac["status"] = ["known" if i in known else "additional" for i in fac.index]
    return fac


def unique_locations(facilities: "gf.GeoFrame", radius_m: float = 0.0) -> int:
    """Count spatially-unique facility locations across periods.

    Reference-exact semantics (count_unique_locations,
    FacilitiesMaps.py:97-114): facilities whose BOUNDS boxes intersect
    collapse, greedily in ascending row order — a facility is unique unless
    an earlier unique facility's box group already claimed it.

    radius_m optionally pads each bounds box (the reference operates on
    cage-extent boxes; pass a radius when the geometries are bare centroid
    points with no extent)."""
    f = facilities.to_crs(3857)
    n = len(f)
    if n == 0:
        return 0
    boxes = []
    for g in f["geometry"]:
        x0, y0, x1, y1 = g.bounds
        boxes.append(_poly.box(x0 - radius_m, y0 - radius_m, x1 + radius_m, y1 + radius_m))
    bf = gf.GeoFrame({"fid": np.arange(n)}, geometry=boxes, crs=3857)
    joined = bf.sjoin(bf, how="inner", predicate="intersects")
    groups = joined.groupby("fid_left")["fid_right"].apply(lambda x: sorted(set(x)))
    unique = 0
    nonunique: set = set()
    for left in groups.index:  # ascending, like the reference's groupby walk
        if left in nonunique:
            continue
        unique += 1
        nonunique.update(groups.loc[left])
    return unique


def plot_facility_map(
    facilities: "gf.GeoFrame",
    trujillo: Optional["gf.GeoFrame"] = None,
    period: Optional[str] = None,
    out_path: Optional[str] = None,
):
    """Per-period facility scatter in lon/lat (Figure-4 style)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fac = facilities
    if period is not None and "pass" in fac.columns:
        fac = fac[fac["pass"] == period]
        fac.crs = facilities.crs
    ll = fac.to_crs(4326)
    xs = [g.centroid.x for g in ll["geometry"]]
    ys = [g.centroid.y for g in ll["geometry"]]
    status = ll["status"] if "status" in ll.columns else pd.Series(["additional"] * len(ll))

    fig, ax = plt.subplots(figsize=(6, 4))
    for s, color, marker in (("known", "steelblue", "o"), ("additional", "darkred", "^")):
        sel = status.to_numpy() == s
        ax.scatter(
            np.asarray(xs)[sel], np.asarray(ys)[sel], c=color, marker=marker,
            s=18, alpha=0.7, label=s.capitalize(), edgecolors="none",
        )
    if trujillo is not None:
        tll = trujillo.to_crs(4326)
        ax.scatter(
            [g.centroid.x for g in tll["geometry"]],
            [g.centroid.y for g in tll["geometry"]],
            facecolors="none", edgecolors="gray", s=40, label="Trujillo et al.",
        )
    from aquaculture_tpu_torch.results.style import PAPER_FONTSIZE, stylize_axes

    ax.set_xlabel("Longitude", fontsize=PAPER_FONTSIZE)
    ax.set_ylabel("Latitude", fontsize=PAPER_FONTSIZE)
    ax.tick_params(labelsize=PAPER_FONTSIZE)
    stylize_axes(ax)
    if period:
        ax.set_title(period, fontsize=10)
    ax.legend(frameon=False, fontsize=PAPER_FONTSIZE)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=300, bbox_inches="tight")
    return fig


def facility_map_html(facilities: "gf.GeoFrame", out_path: str, group_col: str = "pass") -> None:
    """Self-contained interactive HTML map (folium replacement,
    reference plot_utils.plot_facility_map): an inline-SVG scatter with
    per-group toggles, no network tiles."""
    ll = facilities.to_crs(4326)
    pts = [(g.centroid.x, g.centroid.y) for g in ll["geometry"]]
    groups = ll[group_col].astype(str).tolist() if group_col in ll.columns else ["all"] * len(ll)
    data = [{"lon": x, "lat": y, "group": g} for (x, y), g in zip(pts, groups)]
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<style>body{{font-family:sans-serif}} .pt{{opacity:.7}}</style></head><body>
<div id="controls"></div><svg id="map" width="900" height="600" style="border:1px solid #ccc"></svg>
<script>
const data = {json.dumps(data)};
const lons = data.map(d=>d.lon), lats = data.map(d=>d.lat);
const pad = 0.05;
const minLon=Math.min(...lons)-pad, maxLon=Math.max(...lons)+pad;
const minLat=Math.min(...lats)-pad, maxLat=Math.max(...lats)+pad;
const svg=document.getElementById('map');
const W=900,H=600;
const groups=[...new Set(data.map(d=>d.group))].sort();
const colors=['#b22222','#4682b4','#2e8b57','#daa520','#6a5acd','#708090'];
const controls=document.getElementById('controls');
groups.forEach((g,i)=>{{
  const id='g'+i;
  controls.insertAdjacentHTML('beforeend',
    `<label style="margin-right:1em"><input type="checkbox" id="${{id}}" checked> <span style="color:${{colors[i%6]}}">&#9679;</span> ${{g}}</label>`);
  data.filter(d=>d.group===g).forEach(d=>{{
    const x=(d.lon-minLon)/(maxLon-minLon)*W;
    const y=H-(d.lat-minLat)/(maxLat-minLat)*H;
    svg.insertAdjacentHTML('beforeend',
      `<circle class="pt ${{id}}" cx="${{x}}" cy="${{y}}" r="3.5" fill="${{colors[i%6]}}"><title>${{g}} (${{d.lat.toFixed(4)}}, ${{d.lon.toFixed(4)}})</title></circle>`);
  }});
  document.getElementById(id).addEventListener('change',e=>{{
    document.querySelectorAll('.'+id).forEach(c=>c.style.display=e.target.checked?'':'none');
  }});
}});
</script></body></html>"""
    with open(out_path, "w") as f:
        f.write(html)
