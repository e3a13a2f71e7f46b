"""AquaFacility: the end-to-end facility-construction orchestration (a copy
of aquaculture_tpu/tonnage/facility.py whose DBSCAN and bootstrap run on the
facility's ``device``).

Port of the reference's AquaFacility / CF_Facility classes and the
missing-imagery period imputation (reference: src/utils_tonnage.py:914-1224):
filter predictions by max label cage area + confidence, dedup multi-year
coverage, DBSCAN-cluster into facilities, attach min/max cage selections and
bathymetry depth, and pickle the result.

Dependency-injected: predictions, image boxes and labels arrive as
GeoFrames (the reference reads them from fixed GCS/main_dir paths inside
__init__); the path-based wiring lives in cli/facilities.py.

``load_AquaFacility`` reads a pickle that either package wrote through a
restricted unpickler: classes of ``aquaculture_tpu.<module>`` resolve to
``aquaculture_tpu_torch.<module>``, and only the (module, name) pairs that a
facility pickle holds are allowed (the port's facility, frame and geometry
classes, numpy's and pandas' reconstructors, pyarrow's string storage and
plain builtins); everything else is refused, so loading never imports the
JAX package or calls anything a crafted file names."""

from __future__ import annotations

import importlib
import os
import pickle
from typing import Callable, Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_AREA, CRS_MAPPING, resolve_device
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.post.cluster import cluster_facilities
from aquaculture_tpu_torch.tonnage.bootstrap import compute_facility_tonnage_estimates
from aquaculture_tpu_torch.tonnage.dedup_years import dedup_cages_in_overlap_years_with_white_space
from aquaculture_tpu_torch.tonnage.depth import add_facility_depth
from aquaculture_tpu_torch.utils.logging import log_info, log_warning


def get_cage_min_and_max_areas(labels: "gf.GeoFrame") -> pd.Series:
    """Max label bbox area per cage type in EPSG:3035
    (reference utils.py:135-153)."""
    lab = labels.to_crs(CRS_AREA)
    areas = lab.area
    return pd.Series(areas.to_numpy(), index=lab["type"].to_numpy()).groupby(level=0).max()


class AquaFacility:
    """Facility construction + uncertainty selections.

    Args mirror the reference __init__ (utils_tonnage.py:914-977) minus the
    path-coupled IO: all inputs are in-memory GeoFrames. ``device`` is where
    the DBSCAN labels and the bootstrap run (the GPU by default; raises
    without one); a facility loaded from a JAX package pickle has the class
    default.
    """

    device = "cuda"

    def __init__(
        self,
        preds: "gf.GeoFrame",
        image_boxes: "gf.GeoFrame",
        selected_map: Callable,
        image_selection: str = "random",
        confidence_threshold: float = 0.785,
        distance_threshold: float = 50.0,
        min_cluster_size: int = 5,
        time_group: str = "pass",
        max_cage_areas: Optional[pd.Series] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = str(resolve_device(device))
        self.selected_map = selected_map
        self.confidence_threshold = confidence_threshold
        self.image_selection = image_selection
        self.distance_threshold = distance_threshold
        self.min_cluster_size = min_cluster_size
        self.time_group = time_group
        self.seed = seed

        preds = preds.copy()
        preds.crs = preds.crs or 4326
        preds_crs = preds.crs
        preds["farm_type"] = preds["type"]
        if max_cage_areas is not None:
            # Drop detections larger than the largest human-labeled cage.
            # Reference (utils_tonnage.py): `area < preds['type'].map(...)`
            # — a NaN limit (farm type with no labeled max, e.g. triangle)
            # compares False, so those rows are DROPPED, not kept. Replicate
            # that: NaN < comparisons are False in numpy too.
            areas_3035 = preds.to_crs(CRS_AREA).area.to_numpy()
            limit = preds["type"].map(max_cage_areas).to_numpy(np.float64)
            with np.errstate(invalid="ignore"):
                keep = areas_3035 < limit
            preds = preds[keep]
            # restore the INPUT crs (boolean indexing drops the metadata);
            # stamping a literal here would silently relabel e.g. a 3857
            # frame as degrees without transforming it
            preds.crs = preds_crs
        preds["pass"] = preds["year"].astype(int).map(selected_map)
        preds = preds[preds["det_conf"] >= confidence_threshold]
        preds = preds.reset_index(drop=True)
        preds.crs = preds_crs
        preds["index"] = preds.index  # unique cage id
        self.preds = preds
        self.rmblank_image_boxes = image_boxes
        self.min_max_selection: Optional[Dict[str, "gf.GeoFrame"]] = None

        log_info("deduplicating cages within periods (selection=%s)", image_selection)
        cages, coverage, facilities = self.deduplicate_and_cluster(image_selection)
        log_info("%d cages clustered into %d facilities", len(cages), len(facilities))
        assert facilities.crs == CRS_MAPPING
        self.facility_cages = cages.copy()
        self.final_facilities = facilities.copy()
        self.annual_coverage = coverage

    # ------------------------------------------------------------------

    def deduplicate_and_cluster(self, year_selection: str):
        cages, coverage = dedup_cages_in_overlap_years_with_white_space(
            cages=self.preds,
            image_boxes=self.rmblank_image_boxes,
            pass_map=self.selected_map,
            year_selection=year_selection,
            seed=self.seed,
        )
        cages_area = cages.to_crs(CRS_AREA)
        cages_area.crs = CRS_AREA
        facilities = cluster_facilities(
            cages_area,
            cluster_variable=self.time_group,
            distance_threshold=self.distance_threshold,
            min_cluster_size=self.min_cluster_size,
            include_area="area" in cages.columns,
            device=self.device,
        )
        return cages, coverage, facilities

    def compute_min_max_cages(self) -> None:
        """Attach cage_ids_min / cage_ids_max from the min/max image
        selections by best-overlap facility matching
        (reference utils_tonnage.py:997-1063)."""
        final = self.final_facilities.copy()
        if "cage_ids_max" in final.columns:
            return
        log_info("dedup with min/max selections for uncertainty bounds")
        selections: Dict[str, "gf.GeoFrame"] = {}
        for sel in ("min", "max"):
            _, _, fac_sel = self.deduplicate_and_cluster(sel)
            selections[sel] = fac_sel

        def all_cages(frame):
            return [
                _poly.unary_union(
                    [g for g in (row.get("square_farm_geoms"), row.get("circle_farm_geoms")) if g is not None]
                )
                for _, row in frame.iterrows()
            ]

        base = gf.GeoFrame(
            {
                "facility_index": final["facility_index"].to_numpy(),
                "pass": final["pass"].to_numpy(),
            },
            geometry=all_cages(final),
            crs=final.crs,
        ).to_crs(CRS_AREA)

        for sel in ("min", "max"):
            fs = selections[sel]
            cand = gf.GeoFrame(
                {
                    "facility_index_sel": fs["facility_index"].to_numpy(),
                    "pass_sel": fs["pass"].to_numpy(),
                    "cage_ids_sel": fs["cage_ids"].tolist(),
                },
                geometry=all_cages(fs),
                crs=fs.crs,
            ).to_crs(CRS_AREA)

            joined = base.sjoin(cand, how="inner", predicate="intersects")
            joined = joined[joined["pass"] == joined["pass_sel"]]
            # best-overlap match per base facility
            overlaps = []
            cand_geoms = {int(i): g for i, g in zip(cand["facility_index_sel"], cand["geometry"])}
            for _, row in joined.iterrows():
                g = row["geometry"]
                gs = cand_geoms[int(row["facility_index_sel"])]
                overlaps.append(
                    _poly.intersection_area(g, gs) / g.area if g.area > 0 else 0.0
                )
            joined["overlap"] = overlaps
            joined = joined.sort_values("overlap", ascending=False, kind="stable")
            joined = joined.drop_duplicates(subset=["facility_index"], keep="first")
            mapping = dict(zip(joined["facility_index"], joined["cage_ids_sel"]))
            final[f"cage_ids_{sel}"] = [
                mapping.get(fi, []) for fi in final["facility_index"]
            ]

        self.final_facilities = final
        self.min_max_selection = selections

    def add_depth(
        self,
        min_cage_threshold: float,
        default_cage_depth: float,
        bathymetry_statistic: str = "bathy_min",
        bathymetry_path: Optional[str] = None,
        bathymetry=None,
    ) -> None:
        if "cage_depth" in self.final_facilities.columns:
            return
        self.final_facilities = add_facility_depth(
            self.final_facilities,
            bathymetry_path=bathymetry_path,
            bathymetry=bathymetry,
            min_cage_threshold=min_cage_threshold,
            default_cage_depth=default_cage_depth,
            bathymetry_statistic=bathymetry_statistic,
        )

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)


# every global a facility pickle of either package names, and nothing more:
# the port's facility, frame and geometry classes and its pass map (the JAX
# package's modules are read as the port's), the numpy and pandas
# reconstructors (pyarrow holds pandas' string columns) and plain builtins.
# A name is looked up on its module alone, never followed through attributes.
_FACILITY_GLOBALS = frozenset({
    ("aquaculture_tpu_torch.tonnage.facility", "AquaFacility"),
    ("aquaculture_tpu_torch.tonnage.facility", "CF_Facility"),
    ("aquaculture_tpu_torch.tonnage.periods", "map_year_to_image_pass"),
    ("aquaculture_tpu_torch.frame", "GeoFrame"),
    *(("aquaculture_tpu_torch.geo.polygon", name)
      for name in ("Empty", "Point", "LineString", "MultiLineString", "Polygon", "MultiPolygon")),
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    *(("pandas", name) for name in ("DataFrame", "Series", "Index", "RangeIndex", "StringDtype")),
    ("pandas.arrays", "ArrowStringArray"),
    ("pandas.core.indexes.base", "_new_Index"),
    ("pandas.core.internals.managers", "BlockManager"),
    ("pandas.core.internals.managers", "SingleBlockManager"),
    ("pandas._libs.internals", "_unpickle_block"),
    *(("pyarrow.lib", name) for name in ("_restore_array", "py_buffer", "type_for_alias")),
    *(("builtins", name) for name in ("set", "frozenset", "slice", "range", "complex", "bytearray", "list",
                                      "dict", "tuple", "bool", "int", "float", "str", "bytes")),
})


class _FacilityUnpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to the port's counterparts and
    refuses every global outside ``_FACILITY_GLOBALS``."""

    def find_class(self, module: str, name: str):
        if module == "aquaculture_tpu" or module.startswith("aquaculture_tpu."):
            module = "aquaculture_tpu_torch" + module[len("aquaculture_tpu"):]
        if (module, name) not in _FACILITY_GLOBALS:
            raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a facility pickle")
        return getattr(importlib.import_module(module), name)


def load_AquaFacility(filename: Optional[str] = None, *args, **kwargs) -> AquaFacility:
    if filename and os.path.exists(filename):
        log_info("loading saved AquaFacility from %s", filename)
        with open(filename, "rb") as f:
            return _FacilityUnpickler(f).load()
    return AquaFacility(*args, **kwargs)


class CF_Facility(AquaFacility):
    """Human-label variant: construction from precomputed pieces
    (reference utils_tonnage.py:1204-1224)."""

    def __init__(
        self,
        final_facilities,
        preds,
        cages,
        annual_coverage,
        selected_map,
        distance_threshold,
        min_cluster_size,
        rmblank_image_boxes,
        image_selection,
        device: str | torch.device = "cuda",
    ):
        self.device = str(resolve_device(device))
        self.selected_map = selected_map
        self.confidence_threshold = 0
        self.image_selection = image_selection
        self.distance_threshold = distance_threshold
        self.min_cluster_size = min_cluster_size
        self.time_group = "pass"
        self.seed = 0
        self.preds = preds
        self.rmblank_image_boxes = rmblank_image_boxes
        self.min_max_selection = None
        self.facility_cages = cages
        self.final_facilities = final_facilities
        self.annual_coverage = annual_coverage


def modify_cage_list_using_geometry(
    cage_ids: List[int], bounds, cage_df: "gf.GeoFrame", sbound: str
) -> List[int]:
    """Keep cages inside/outside a geometry (reference utils_tonnage.py:
    1103-1136)."""
    assert sbound in ("inside", "outside")
    geom_by_id = dict(zip(cage_df["index"], cage_df["geometry"]))
    out = []
    for cid in cage_ids:
        g = geom_by_id.get(cid)
        if g is None:
            log_warning("zero cage matches for cage index %s", cid)
            continue
        hits = _poly.intersects(g, bounds)
        if (sbound == "inside" and hits) or (sbound == "outside" and not hits):
            out.append(cid)
    return out


def compute_complete_period_tonnage_estimates(
    facility: AquaFacility,
    current_period: str,
    compare_period: str,
    model_error_distributions: pd.DataFrame,
    min_cage_threshold: float,
    period_factor_table: pd.DataFrame,
    depth_dist_mixture_param: float,
    K: int = 10_000,
    seed: int = 0,
) -> pd.DataFrame:
    """Impute facilities missing from current_period's imagery using
    compare_period's cages outside the current coverage
    (reference utils_tonnage.py:1139-1201)."""
    bounded = facility.final_facilities.copy()
    preds_df = facility.preds.copy()
    coverage = facility.annual_coverage[current_period]
    pass_bounds = _poly.unary_union(list(coverage["geometry"]))
    # The coverage frames come out of dedup_cages_in_overlap_years_with_
    # white_space in EPSG:3857, while preds keep whatever CRS the caller's
    # detections file used (cli/geocode writes 4326). Raw-coordinate
    # intersects between the two can NEVER hit (meters vs degrees), which
    # would classify every compare-period cage as "outside" coverage and
    # double-count whole periods — so project the cage geometries into the
    # coverage CRS for the bounds test. (The reference is consistent only
    # because its ocean_detections.geojson is saved in 3857,
    # geocode_results.py:260-271.)
    cov_crs = coverage.crs or 3857
    preds_geo = preds_df if preds_df.crs == cov_crs else preds_df.to_crs(cov_crs)
    preds_geo.crs = cov_crs

    bounded = bounded[bounded["pass"].isin([compare_period, current_period])].copy()
    for col in ("cage_ids", "cage_ids_max", "cage_ids_min"):
        bounded[col] = [
            row[col]
            if row["pass"] == current_period
            else modify_cage_list_using_geometry(row[col], pass_bounds, preds_geo, "outside")
            for _, row in bounded.iterrows()
        ]
    bounded = bounded[bounded["cage_ids_min"].apply(len) > 0]
    log_info(
        "%d facilities total; %d imputed from %s",
        len(bounded),
        int((bounded["pass"] == compare_period).sum()),
        compare_period,
    )
    bounded["pass"] = current_period
    if len(bounded) == 0:
        return pd.DataFrame({"tonnage": [0.0]}, index=pd.Index([current_period], name="pass"))
    est = compute_facility_tonnage_estimates(
        facility_df=bounded,
        period_factor_table=period_factor_table,
        period_var=facility.time_group,
        min_cage_threshold=min_cage_threshold,
        preds_df=preds_df,
        model_error_distributions=model_error_distributions,
        depth_dist_mixture_param=depth_dist_mixture_param,
        K=K,
        seed=seed,
        device=facility.device,
    )
    return est.loc[[current_period]]
