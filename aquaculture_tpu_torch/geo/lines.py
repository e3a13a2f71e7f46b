"""Linework operations: linemerge and polygonize.
A copy of aquaculture_tpu/geo/lines.py in the PyTorch port.

Used by the land-filter construction flow (reference:
src/load_data/create_land_filter.py:101-137 — shapely.ops linemerge +
polygonize over coastline linework). linemerge joins polylines at shared
endpoints (degree-2 graph walking); polygonize emits a polygon for every
closed ring in the merged linework. This covers the pipeline's case —
coastline segments that chain into closed loops — not full planar noding
of crossing lines.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import numpy as np

from aquaculture_tpu_torch.geo import polygon as _poly


def _key(pt: np.ndarray, tol: float) -> Tuple[int, int]:
    return (int(round(pt[0] / tol)), int(round(pt[1] / tol)))


def linemerge(lines: Iterable, tol: float = 1e-9) -> List[_poly.LineString]:
    """Join polylines that share endpoints into maximal chains."""
    segs: List[np.ndarray] = []
    for l in lines:
        if isinstance(l, _poly.MultiLineString):
            segs.extend(g.coords for g in l.geoms)
        elif isinstance(l, _poly.LineString):
            segs.append(l.coords)
        else:
            segs.append(np.asarray(l, np.float64).reshape(-1, 2))

    unused = set(range(len(segs)))
    by_end: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, s in enumerate(segs):
        by_end[_key(s[0], tol)].append(i)
        by_end[_key(s[-1], tol)].append(i)

    merged: List[_poly.LineString] = []
    while unused:
        i = unused.pop()
        chain = segs[i].copy()
        # extend forward then backward until no unused segment continues it
        for direction in (1, -1):
            while True:
                end = chain[-1] if direction == 1 else chain[0]
                k = _key(end, tol)
                nxt = next((j for j in by_end.get(k, ()) if j in unused), None)
                if nxt is None:
                    break
                unused.discard(nxt)
                s = segs[nxt]
                if _key(s[0], tol) != k:
                    s = s[::-1]
                if direction == 1:
                    chain = np.vstack([chain, s[1:]])
                else:
                    chain = np.vstack([s[::-1][:-1], chain])
        merged.append(_poly.LineString(chain))
    return merged


def polygonize(lines: Iterable, tol: float = 1e-9) -> List[_poly.Polygon]:
    """Polygons from every closed ring in the (merged) linework."""
    out = []
    for l in linemerge(lines, tol):
        if l.is_ring and len(l.coords) >= 4:
            p = _poly.Polygon(l.coords)
            if p.area > 0:
                out.append(p)
    return out
