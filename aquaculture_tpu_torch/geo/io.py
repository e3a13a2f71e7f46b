"""WKT and GeoJSON serialization for the geometry types.

Covers the formats the pipeline reads/writes: WKT polygon columns in
wanted_bboxes.csv (reference utils.py:37-43), GeoJSON feature collections
for detections/labels/facilities (reference geocode_results.py:265-271).
"""

from __future__ import annotations

import json
import re
from typing import List

import numpy as np

from aquaculture_tpu_torch.geo.polygon import (
    EMPTY,
    Empty,
    Geometry,
    LineString,
    MultiLineString,
    MultiPolygon,
    Point,
    Polygon,
)


# ---------------------------------------------------------------------------
# WKT
# ---------------------------------------------------------------------------

def _fmt_coord(x: float, y: float) -> str:
    return f"{x!r} {y!r}".replace("'", "")


def _ring_wkt(ring: np.ndarray) -> str:
    pts = list(ring) + [ring[0]]
    return "(" + ", ".join(f"{p[0]} {p[1]}" for p in pts) + ")"


def to_wkt(g: Geometry) -> str:
    if isinstance(g, Empty):
        return "GEOMETRYCOLLECTION EMPTY"
    if isinstance(g, Point):
        return f"POINT ({g.x} {g.y})"
    if isinstance(g, LineString):
        return "LINESTRING (" + ", ".join(f"{p[0]} {p[1]}" for p in g.coords) + ")"
    if isinstance(g, MultiLineString):
        parts = [
            "(" + ", ".join(f"{p[0]} {p[1]}" for p in l.coords) + ")" for l in g.geoms
        ]
        return "MULTILINESTRING (" + ", ".join(parts) + ")"
    if isinstance(g, Polygon):
        if g.is_empty:
            return "POLYGON EMPTY"
        rings = [_ring_wkt(g.exterior)] + [_ring_wkt(h) for h in g.holes]
        return "POLYGON (" + ", ".join(rings) + ")"
    if isinstance(g, MultiPolygon):
        if g.is_empty:
            return "MULTIPOLYGON EMPTY"
        polys = []
        for p in g.geoms:
            rings = [_ring_wkt(p.exterior)] + [_ring_wkt(h) for h in p.holes]
            polys.append("(" + ", ".join(rings) + ")")
        return "MULTIPOLYGON (" + ", ".join(polys) + ")"
    raise TypeError(f"Cannot serialize {type(g)} to WKT")


_NUM = r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?"


def _parse_ring_text(text: str) -> np.ndarray:
    pts = re.findall(rf"({_NUM})\s+({_NUM})", text)
    return np.array([[float(a), float(b)] for a, b in pts], dtype=np.float64)


def _split_top_level(text: str) -> List[str]:
    """Split a comma-separated list of parenthesized groups at depth 0."""
    parts, depth, start = [], 0, 0
    for i, c in enumerate(text):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return [p.strip() for p in parts if p.strip()]


def from_wkt(wkt: str) -> Geometry:
    s = wkt.strip()
    upper = s.upper()
    if "EMPTY" in upper:
        return EMPTY
    body_start = s.index("(")
    body = s[body_start + 1 : s.rindex(")")]
    if upper.startswith("POINT"):
        ring = _parse_ring_text(body)
        return Point(ring[0, 0], ring[0, 1])
    if upper.startswith("MULTILINESTRING"):
        return MultiLineString([_parse_ring_text(t) for t in _split_top_level(body)])
    if upper.startswith("LINESTRING"):
        return LineString(_parse_ring_text(body))
    if upper.startswith("MULTIPOLYGON"):
        polys = []
        for poly_text in _split_top_level(body):
            inner = poly_text.strip()
            inner = inner[1:-1] if inner.startswith("(") else inner
            rings = [_parse_ring_text(r) for r in _split_top_level(inner)]
            if rings and len(rings[0]) >= 3:
                polys.append(Polygon(rings[0], rings[1:]))
        return MultiPolygon(polys)
    if upper.startswith("POLYGON"):
        rings = [_parse_ring_text(r) for r in _split_top_level(body)]
        if not rings or len(rings[0]) < 3:
            return Polygon()
        return Polygon(rings[0], rings[1:])
    raise ValueError(f"Unsupported WKT: {s[:40]}...")


# ---------------------------------------------------------------------------
# GeoJSON
# ---------------------------------------------------------------------------

def geometry_to_geojson(g: Geometry) -> dict | None:
    if g is None or isinstance(g, Empty) or (hasattr(g, "is_empty") and g.is_empty):
        return None
    if isinstance(g, Point):
        return {"type": "Point", "coordinates": [g.x, g.y]}
    if isinstance(g, LineString):
        return {"type": "LineString", "coordinates": g.coords.tolist()}
    if isinstance(g, MultiLineString):
        return {
            "type": "MultiLineString",
            "coordinates": [l.coords.tolist() for l in g.geoms],
        }
    if isinstance(g, Polygon):
        coords = [np.vstack([g.exterior, g.exterior[:1]]).tolist()]
        for h in g.holes:
            coords.append(np.vstack([h, h[:1]]).tolist())
        return {"type": "Polygon", "coordinates": coords}
    if isinstance(g, MultiPolygon):
        coords = []
        for p in g.geoms:
            pc = [np.vstack([p.exterior, p.exterior[:1]]).tolist()]
            for h in p.holes:
                pc.append(np.vstack([h, h[:1]]).tolist())
            coords.append(pc)
        return {"type": "MultiPolygon", "coordinates": coords}
    raise TypeError(f"Cannot serialize {type(g)} to GeoJSON")


def geometry_from_geojson(obj: dict | None) -> Geometry:
    if obj is None:
        return EMPTY
    t = obj["type"]
    c = obj["coordinates"]
    if t == "Point":
        return Point(c[0], c[1])
    if t == "LineString":
        return LineString(c)
    if t == "MultiLineString":
        return MultiLineString(c)
    if t == "Polygon":
        if not c:
            return Polygon()
        return Polygon(c[0], c[1:])
    if t == "MultiPolygon":
        return MultiPolygon([Polygon(pc[0], pc[1:]) for pc in c if pc])
    if t == "MultiPoint":
        # Rare; represent as first point
        return Point(c[0][0], c[0][1])
    raise ValueError(f"Unsupported GeoJSON geometry type: {t}")


def read_feature_collection(path: str):
    """Read a GeoJSON file -> (list of property dicts, list of geometries, crs epsg)."""
    with open(path) as f:
        data = json.load(f)
    crs = 4326
    crs_obj = data.get("crs")
    if crs_obj:
        name = crs_obj.get("properties", {}).get("name", "")
        m = re.search(r"EPSG:+(\d+)", name)
        if m:
            crs = int(m.group(1))
    props, geoms = [], []
    for feat in data.get("features", []):
        props.append(feat.get("properties", {}) or {})
        geoms.append(geometry_from_geojson(feat.get("geometry")))
    return props, geoms, crs


def write_feature_collection(path: str, records: list, geometries: list, crs: int):
    feats = []
    for rec, geom in zip(records, geometries):
        feats.append(
            {
                "type": "Feature",
                "properties": {k: _json_safe(v) for k, v in rec.items()},
                "geometry": geometry_to_geojson(geom),
            }
        )
    data = {
        "type": "FeatureCollection",
        "crs": {"type": "name", "properties": {"name": f"urn:ogc:def:crs:EPSG::{crs}"}},
        "features": feats,
    }
    with open(path, "w") as f:
        json.dump(data, f)


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        # box to float BEFORE the NaN check below, or a numpy NaN sails
        # through as float('nan') and json.dump emits a bare NaN token
        # (invalid strict JSON)
        v = float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, float) and np.isnan(v):
        return None
    return v
