"""ESRI Shapefile read/write (no GDAL/fiona).
A copy of aquaculture_tpu/geo/shapefile.py in the PyTorch port.

The reference round-trips land-filter and shoreline data through .shp files
(reference: src/load_data/create_land_filter.py:129-137, geocode_results.py
land filter input). This implements the shapefile spec subset the pipeline
uses: Point(1), PolyLine(3), Polygon(5) shapes, .shp geometry + .dbf
attributes (C/N/F fields), and polygon ring orientation (clockwise exterior,
counter-clockwise holes per the spec).
"""

from __future__ import annotations

import datetime
import os
import struct
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.geo import polygon as _poly

SHAPE_NULL = 0
SHAPE_POINT = 1
SHAPE_POLYLINE = 3
SHAPE_POLYGON = 5


def _ring_is_clockwise(ring: np.ndarray) -> bool:
    x, y = ring[:, 0], ring[:, 1]
    return float(np.sum((np.roll(x, -1) - x) * (np.roll(y, -1) + y))) > 0


def _read_dbf(path: str) -> pd.DataFrame:
    with open(path, "rb") as f:
        data = f.read()
    n_records = struct.unpack_from("<I", data, 4)[0]
    header_size, record_size = struct.unpack_from("<HH", data, 8)
    fields = []
    off = 32
    while data[off] != 0x0D:
        name = data[off : off + 11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(data[off + 11])
        length = data[off + 16]
        decimals = data[off + 17]
        fields.append((name, ftype, length, decimals))
        off += 32

    records = []
    pos = header_size
    for _ in range(n_records):
        if data[pos : pos + 1] == b"*":  # deleted
            pos += record_size
            continue
        rec = {}
        p = pos + 1
        for name, ftype, length, decimals in fields:
            raw = data[p : p + length]
            p += length
            text = raw.decode("latin-1").strip()
            if ftype in ("N", "F"):
                if text == "":
                    rec[name] = None
                elif ftype == "N" and decimals == 0 and "." not in text:
                    try:
                        rec[name] = int(text)
                    except ValueError:
                        rec[name] = None
                else:
                    try:
                        rec[name] = float(text)
                    except ValueError:
                        rec[name] = None
            elif ftype == "L":
                rec[name] = text.upper() in ("T", "Y")
            else:
                rec[name] = text
        records.append(rec)
        pos += record_size
    return pd.DataFrame(records)


def _parse_polygon(parts: List[np.ndarray]) -> _poly.Geometry:
    """Rings -> (Multi)Polygon: clockwise = exterior, ccw = hole assigned to
    the exterior containing its first vertex."""
    exteriors = []
    holes = []
    for ring in parts:
        (exteriors if _ring_is_clockwise(ring) else holes).append(ring)
    if not exteriors:  # degenerate: treat all as exteriors
        exteriors, holes = parts, []
    polys: List[Tuple[np.ndarray, List[np.ndarray]]] = [(e, []) for e in exteriors]
    for h in holes:
        x, y = float(h[0, 0]), float(h[0, 1])
        for e, hs in polys:
            if _poly.Polygon(e).contains_point(x, y):
                hs.append(h)
                break
    geoms = [_poly.Polygon(e, hs) for e, hs in polys]
    return geoms[0] if len(geoms) == 1 else _poly.MultiPolygon(geoms)


def read_shapefile(path: str, crs: Optional[int] = None) -> "gf.GeoFrame":
    """Read a .shp(+.dbf) into a GeoFrame. `path` may omit the extension,
    or name any sibling of the pair (.shp/.dbf/.shx/.prj)."""
    base = (path[:-4]
            if path.lower().endswith((".shp", ".dbf", ".shx", ".prj"))
            else path)
    with open(base + ".shp", "rb") as f:
        data = f.read()

    geoms: List[_poly.Geometry] = []
    pos = 100  # skip header
    while pos < len(data):
        _, length = struct.unpack_from(">II", data, pos)
        rec = data[pos + 8 : pos + 8 + length * 2]
        pos += 8 + length * 2
        stype = struct.unpack_from("<I", rec, 0)[0]
        if stype == SHAPE_NULL:
            geoms.append(_poly.Empty())
        elif stype == SHAPE_POINT:
            x, y = struct.unpack_from("<dd", rec, 4)
            geoms.append(_poly.Point(x, y))
        elif stype in (SHAPE_POLYLINE, SHAPE_POLYGON):
            n_parts, n_points = struct.unpack_from("<II", rec, 36)
            part_idx = list(struct.unpack_from(f"<{n_parts}I", rec, 44))
            pts = np.frombuffer(rec, dtype="<f8", count=n_points * 2, offset=44 + 4 * n_parts)
            pts = pts.reshape(n_points, 2)
            bounds_idx = part_idx + [n_points]
            parts = [pts[bounds_idx[i] : bounds_idx[i + 1]] for i in range(n_parts)]
            if stype == SHAPE_POLYGON:
                geoms.append(_parse_polygon(parts))
            else:
                geoms.append(_poly.LineString(parts[0]) if n_parts == 1 else _poly.MultiLineString(parts))
        else:
            raise ValueError(f"unsupported shape type {stype}")

    attrs = pd.DataFrame(index=range(len(geoms)))
    if os.path.exists(base + ".dbf"):
        dbf = _read_dbf(base + ".dbf")
        if len(dbf) == len(geoms):
            attrs = dbf
    out = gf.GeoFrame(attrs, geometry=geoms, crs=crs)
    return out


def _polygon_records(g: _poly.Geometry) -> List[np.ndarray]:
    """Polygon/MultiPolygon -> rings with spec orientation."""
    rings = []
    polys = g.geoms if isinstance(g, _poly.MultiPolygon) else [g]
    for p in polys:
        ext = np.asarray(p.exterior, np.float64)
        if not _ring_is_clockwise(ext):
            ext = ext[::-1]
        rings.append(ext)
        for h in p.holes:
            h = np.asarray(h, np.float64)
            if _ring_is_clockwise(h):
                h = h[::-1]
            rings.append(h)
    return [np.vstack([r, r[:1]]) if not np.array_equal(r[0], r[-1]) else r for r in rings]


def write_shapefile(path: str, frame: "gf.GeoFrame") -> None:
    """Write polygon/point geometries + attributes to .shp/.shx/.dbf."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    geoms = list(frame["geometry"])

    def _is_null(g) -> bool:
        return g is None or getattr(g, "is_empty", False)

    real = [g for g in geoms if not _is_null(g)]
    is_point = bool(real) and all(isinstance(g, _poly.Point) for g in real)
    stype = SHAPE_POINT if is_point else SHAPE_POLYGON

    shp_records = []
    shx_records = []
    offset = 50  # in 16-bit words
    minx = miny = np.inf
    maxx = maxy = -np.inf
    for i, g in enumerate(geoms):
        if _is_null(g):
            # spec null shape (read_shapefile emits Empty for these; a
            # read->write round-trip must not crash on them)
            content = struct.pack("<I", SHAPE_NULL)
            length = len(content) // 2
            shp_records.append(struct.pack(">II", i + 1, length) + content)
            shx_records.append(struct.pack(">II", offset, length))
            offset += 4 + length
            continue
        if is_point:
            content = struct.pack("<Idd", SHAPE_POINT, g.x, g.y)
            bx = (g.x, g.y, g.x, g.y)
        else:
            rings = _polygon_records(g)
            pts = np.concatenate(rings)
            bx = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
            part_offsets = np.cumsum([0] + [len(r) for r in rings[:-1]]).astype(np.int64)
            content = struct.pack("<I4d", SHAPE_POLYGON, *bx)
            content += struct.pack("<II", len(rings), len(pts))
            content += struct.pack(f"<{len(rings)}I", *part_offsets)
            content += pts.astype("<f8").tobytes()
        minx, miny = min(minx, bx[0]), min(miny, bx[1])
        maxx, maxy = max(maxx, bx[2]), max(maxy, bx[3])
        length = len(content) // 2
        shp_records.append(struct.pack(">II", i + 1, length) + content)
        shx_records.append(struct.pack(">II", offset, length))
        offset += 4 + length

    if not np.isfinite([minx, miny, maxx, maxy]).all():
        minx = miny = maxx = maxy = 0.0  # all-null file: spec allows zeros

    def header(file_len_words: int) -> bytes:
        h = struct.pack(">I", 9994) + b"\x00" * 20 + struct.pack(">I", file_len_words)
        h += struct.pack("<II", 1000, stype)
        h += struct.pack("<4d", minx, miny, maxx, maxy)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    body = b"".join(shp_records)
    with open(base + ".shp", "wb") as f:
        f.write(header(50 + len(body) // 2))
        f.write(body)
    with open(base + ".shx", "wb") as f:
        f.write(header(50 + len(shx_records) * 4))
        f.write(b"".join(shx_records))

    # dbf
    cols = [c for c in frame.columns if c != "geometry"]
    today = datetime.date.today()
    field_descs = b""
    widths = []
    for c in cols:
        series = frame[c]
        if pd.api.types.is_numeric_dtype(series):
            width, ftype, dec = 19, b"N", 8
        else:
            width = int(min(max(series.astype(str).str.len().max(), 1), 254))
            ftype, dec = b"C", 0
        widths.append((c, ftype, width, dec))
        name = c.encode("ascii", "replace")[:10].ljust(11, b"\x00")
        field_descs += name + ftype + b"\x00" * 4 + bytes([width, dec]) + b"\x00" * 14
    record_size = 1 + sum(w for _, _, w, _ in widths)
    header_size = 32 + len(field_descs) + 1
    with open(base + ".dbf", "wb") as f:
        f.write(
            struct.pack(
                "<B3BIHH20x",
                0x03,
                today.year - 1900,
                today.month,
                today.day,
                len(frame),
                header_size,
                record_size,
            )
        )
        f.write(field_descs + b"\x0d")
        for _, row in frame.iterrows():
            rec = b" "
            for c, ftype, width, dec in widths:
                v = row[c]
                if ftype == b"N":
                    text = ("" if pd.isna(v) else f"{float(v):.{dec}f}")[:width].rjust(width)
                else:
                    text = str(v)[:width].ljust(width)
                rec += text.encode("latin-1", "replace")
            f.write(rec)
        f.write(b"\x1a")
