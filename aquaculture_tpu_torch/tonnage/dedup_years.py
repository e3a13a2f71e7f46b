"""Within-period multi-year imagery dedup, whitespace-aware.
A copy of aquaculture_tpu/tonnage/dedup_years.py in the PyTorch port.

Port of the reference's permutation-exact dedup (reference:
src/utils_tonnage.py:668-911): when several years' images cover the same
tile inside one period, choose ONE coverage allocation — image boxes
greedily claim only area not already covered. 'random' shuffles the order;
'min'/'max' enumerate every permutation and keep the one minimizing /
maximizing the surviving cage area (the uncertainty bounds).

Geometry runs on the exact rectilinear Region algebra; the Dask partitioned
apply is replaced by a plain loop (the per-tile work is tiny — the
reference's parallelism was overhead, and the hot math here is O(#tiles *
perms) set algebra, not pandas).
"""

from __future__ import annotations

from itertools import permutations as iter_permutations
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.data.filenames import decode_tile_name
from aquaculture_tpu_torch.geo.polygon import intersects as _geom_intersects
from aquaculture_tpu_torch.geo.region import Region, from_geometry, to_geometry


def _cage_survives(cage_geom, reg_geom) -> bool:
    """Boundary-inclusive intersects, matching the reference's shapely
    ``.intersects`` filter (utils_tonnage.py:790-814): a cage that merely
    TOUCHES its box's kept region (zero-area boundary contact, e.g. a
    pixel-aligned cage abutting the coverage edge) is kept, where a
    positive-area Region intersection test would drop it. ``reg_geom`` is
    the kept Region already converted via to_geometry (convert once per
    allocation, not once per cage)."""
    return _geom_intersects(cage_geom, reg_geom)


def _tile_coverage(order: List[int], regions: List[Region]) -> List[Tuple[int, Region]]:
    """Greedy unique coverage in the given order: first box keeps its full
    region, later boxes keep only what is not yet covered
    (reference tile_coverage, utils_tonnage.py:686-713)."""
    out: List[Tuple[int, Region]] = []
    coverage: Optional[Region] = None
    for j, idx in enumerate(order):
        r = regions[idx]
        if j == 0:
            new = r
            coverage = r
        else:
            new = r.difference(coverage)
            if new.is_empty:
                continue
            coverage = coverage.union(new)
        out.append((idx, new))
    return out


def dedup_cages_in_overlap_years_with_white_space(
    cages: "gf.GeoFrame",
    image_boxes: "gf.GeoFrame",
    pass_map: Callable,
    year_selection: str,
    seed: int = 0,
) -> Tuple["gf.GeoFrame", Dict[str, "gf.GeoFrame"]]:
    """Returns (deduped cages, {pass: coverage GeoFrame}).

    cages: detections with 'image' (tile filename), 'year', 'area',
        'geometry'; image_boxes: per-image boxes with bbox_ind/x_offset/
        y_offset/year/image_file/geometry (whitespace-corrected geometries
        supported — any rectilinear polygon works).
    """
    assert year_selection in ("min", "max", "random")
    rng = np.random.default_rng(seed)

    boxes = image_boxes.to_crs(3857).reset_index(drop=True)
    boxes.crs = 3857
    cg = cages.to_crs(3857).reset_index(drop=True)
    cg.crs = 3857

    boxes["pass"] = boxes["year"].astype(int).map(pass_map)
    boxes["image_box_index"] = boxes.index
    boxes["tile_key"] = [
        f"{b}-{x}-{y}"
        for b, x, y in zip(boxes["bbox_ind"], boxes["x_offset"], boxes["y_offset"])
    ]

    cg["pass"] = cg["year"].astype(int).map(pass_map)
    specs = [decode_tile_name(f) for f in cg["image"]]
    cg["bbox_ind"] = [s.bbox_ind for s in specs]
    cg["x_offset"] = [s.x_offset for s in specs]
    cg["y_offset"] = [s.y_offset for s in specs]
    cg["tile_key"] = [f"{s.bbox_ind}-{s.x_offset}-{s.y_offset}" for s in specs]

    # match each cage to its image box (bbox_ind, offsets, year)
    key_to_idx = {
        (int(b), int(x), int(y), int(yr)): int(i)
        for b, x, y, yr, i in zip(
            boxes["bbox_ind"], boxes["x_offset"], boxes["y_offset"],
            boxes["year"].astype(int), boxes["image_box_index"],
        )
    }
    cg["image_box_index"] = [
        key_to_idx.get((int(b), int(x), int(y), int(yr)), -1)
        for b, x, y, yr in zip(cg["bbox_ind"], cg["x_offset"], cg["y_offset"], cg["year"].astype(int))
    ]

    box_regions = [from_geometry(g) for g in boxes["geometry"]]
    cage_geoms = list(cg["geometry"])
    cage_areas = cg["area"].to_numpy(np.float64) if "area" in cg.columns else np.ones(len(cg))

    deduped_rows: List[int] = []
    coverage_out: Dict[str, "gf.GeoFrame"] = {}

    for selected_pass in pd.unique(boxes["pass"]):
        bsel = boxes[boxes["pass"] == selected_pass]
        cage_rows_pass = np.nonzero((cg["pass"] == selected_pass).to_numpy())[0]
        cages_by_tile: Dict[str, List[int]] = {}
        for r in cage_rows_pass:
            cages_by_tile.setdefault(cg["tile_key"].iloc[r], []).append(int(r))

        cover_idx: List[int] = []
        cover_regions: List[Region] = []

        for tile_key, grp in bsel.groupby("tile_key", sort=False):
            idxs = grp["image_box_index"].tolist()
            if len(idxs) == 1:
                chosen = [(idxs[0], box_regions[idxs[0]])]
            elif year_selection == "random":
                order = list(rng.permutation(len(idxs)))
                chosen = _tile_coverage([idxs[i] for i in order], box_regions)
            else:
                tile_cages = cages_by_tile.get(tile_key, [])
                best = None
                best_area = -np.inf if year_selection == "max" else np.inf
                for perm in iter_permutations(range(len(idxs))):
                    alloc = _tile_coverage([idxs[i] for i in perm], box_regions)
                    alloc_geom = {
                        idx: to_geometry(reg) for idx, reg in alloc if not reg.is_empty
                    }
                    a = 0.0
                    for r in tile_cages:
                        geom = alloc_geom.get(cg["image_box_index"].iloc[r])
                        if geom is None:
                            continue
                        if _cage_survives(cage_geoms[r], geom):
                            a += cage_areas[r]
                    if year_selection == "max":
                        if a >= best_area:
                            best, best_area = alloc, a
                    else:
                        if a < best_area:
                            best, best_area = alloc, a
                chosen = best
            for idx, reg in chosen:
                cover_idx.append(idx)
                cover_regions.append(reg)

        # filter cages: keep those intersecting their own box's kept region
        alloc_geom = {
            idx: to_geometry(reg)
            for idx, reg in zip(cover_idx, cover_regions)
            if not reg.is_empty
        }
        for r in cage_rows_pass:
            geom = alloc_geom.get(int(cg["image_box_index"].iloc[r]))
            if geom is None:
                continue
            if _cage_survives(cage_geoms[r], geom):
                deduped_rows.append(int(r))

        coverage_out[selected_pass] = gf.GeoFrame(
            {"image_box_index": cover_idx},
            geometry=[to_geometry(r) for r in cover_regions],
            crs=3857,
        )

    out = cg.iloc[sorted(deduped_rows)].copy()
    out.crs = 3857
    return out, coverage_out
