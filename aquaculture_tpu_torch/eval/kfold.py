"""Stratified k-fold hyperparameter search over (conf, eps, min-size).

A copy of aquaculture_tpu/eval/kfold.py (reference:
src/get_kfold_cluster_performance.py:284-546 and the flag-file grid
src/get_kfold_cluster_performance_cfg.py: 82 conf x 8 distance x 10 size,
5 folds, seed 1) whose grid sweep runs as dense products on the entry
point's device.

The sweep never reads cluster labels, only whether a detection belongs to
some cluster, and DBSCAN membership has a closed form: a kept point is a
member exactly when it is a core point or neighbours one. With ``A`` the
eps-adjacency (self included) and ``keep`` the (C, n) confidence masks,

    deg    = keep @ A                       kept neighbours of each point
    core   = keep & (deg >= min_size)       for every min size at once
    member = keep & (core @ A > 0)

So one year group costs a few products per eps for all C x M conf and
min-size combinations, and gives the per-combination BFS's answer bit for
bit: the products count 0/1 entries in float32, exact below 2^24 (TF32 or
not), and the squared distances are float64 in the plain version's order.
``grid_search_plain`` keeps the JAX package's per-combination loop as the
plain version the tests and chip_smoke.py hold the sweep against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_AREA, CRS_MAPPING, resolve_device
from aquaculture_tpu_torch.eval.metrics import get_stats_total
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.post.cluster import dbscan_from_adjacency, pairwise_d2, predictions_cluster

# Elements of one (min sizes x conf thresholds x points) block of the sweep:
# conf thresholds are taken in chunks that keep each block within it.
_SWEEP_BLOCK = 1 << 27


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """The reference's grid (get_kfold_cluster_performance_cfg.py:4-31)."""

    confidence_thresholds: Tuple[float, ...] = tuple(np.arange(0.6, 1.01, 0.005).round(3))
    distance_thresholds: Tuple[float, ...] = tuple(np.arange(10.0, 160.0, 20.0))
    minimum_cluster_sizes: Tuple[int, ...] = tuple(range(1, 11))
    folds: int = 5
    seed: int = 1


def cluster_members(d2: torch.Tensor, keep: torch.Tensor, eps: float,
                    min_sizes: Sequence[int] | torch.Tensor) -> torch.Tensor:
    """(M, C, n) bool: point j is kept under conf mask c and belongs to a
    DBSCAN cluster of the kept points at (eps, min_sizes[m]).

    d2: (n, n) float64 squared distances; keep: (C, n) bool; min_sizes
    best as a float32 tensor on d2's device (a host list is copied over on
    every call)."""
    adj = (d2 <= eps * eps).to(torch.float32)
    kept = keep.to(torch.float32)
    deg = kept @ adj  # adj is symmetric: kept neighbours of each point
    sizes = torch.as_tensor(min_sizes, dtype=torch.float32, device=d2.device)
    core = keep[None] & (deg[None] >= sizes[:, None, None])
    m, c, n = core.shape
    reach = core.reshape(m * c, n).to(torch.float32) @ adj
    return keep[None] & (reach.reshape(m, c, n) > 0)


def _centers(preds: "gf.GeoFrame") -> np.ndarray:
    return _poly.centroid_array(list(preds.to_crs(CRS_AREA)["geometry"]))


def clustered_detections(
    preds: "gf.GeoFrame",
    conf_thresh: float,
    distance_threshold: float,
    min_cluster_size: int,
    device: str | torch.device = "cuda",
) -> "gf.GeoFrame":
    """Detections belonging to any facility at the given operating point
    (the reference's predictions_cluster(return_detections=True))."""
    dev = resolve_device(device)
    centers = _centers(preds)
    years = preds["year"].to_numpy()
    conf = preds["det_conf"].to_numpy(np.float64)
    member = np.zeros(len(preds), bool)
    for y in pd.unique(years):
        rows = np.nonzero(years == y)[0]
        keep = conf[rows] >= conf_thresh
        sel = rows[keep]
        if len(sel) == 0:
            continue
        all_kept = torch.ones((1, len(sel)), dtype=torch.bool, device=dev)
        m = cluster_members(pairwise_d2(centers[sel], dev), all_kept, distance_threshold, (min_cluster_size,))
        member[sel[m[0, 0].cpu().numpy()]] = True
    out = preds[member].copy()
    out.crs = preds.crs
    return out


def _match_matrix(labels: "gf.GeoFrame", preds: "gf.GeoFrame") -> np.ndarray:
    """(n_labels, n_preds) bool: label i and pred j intersect with the same
    year and type — the TP relation, computed ONCE for the whole grid."""
    m = np.zeros((len(labels), len(preds)), bool)
    if len(labels) == 0 or len(preds) == 0:
        return m
    lab = labels.copy()
    lab.crs = labels.crs
    lab["__lab_pos"] = range(len(labels))
    pr = preds.copy()
    pr.crs = preds.crs
    pr["__pred_pos"] = range(len(preds))
    joined = lab.sjoin(pr, how="inner", predicate="intersects", lsuffix="query", rsuffix="key")
    ok = (joined["year_query"] == joined["year_key"]) & (
        joined["type_query"] == joined["type_key"]
    )
    li = joined.loc[ok, "__lab_pos"].to_numpy(np.int64)
    pi = joined.loc[ok, "__pred_pos"].to_numpy(np.int64)
    m[li, pi] = True
    return m


def _sweep(groups: list, n_preds: int, tp_idx: torch.Tensor, match_t: torch.Tensor, grid: GridConfig,
           dev: torch.device):
    """Integer counts of every grid combination, each (E, M, C) int64 in
    the grid's order: members, true-positive members, labels hit.

    groups: per year group, (rows, conf, d2) on the device; tp_idx: the
    preds that match a label; match_t: (len(tp_idx), H) float32, which of H
    matched labels each of them matches."""
    cts = torch.as_tensor(np.asarray(grid.confidence_thresholds, np.float64), device=dev)
    sizes = torch.tensor(grid.minimum_cluster_sizes, dtype=torch.float32, device=dev)
    n_c, n_m = len(cts), len(sizes)
    widest = max([n_preds] + [len(g[0]) for g in groups])
    chunk = max(1, min(n_c, _SWEEP_BLOCK // (n_m * max(widest, 1))))
    shape = (len(grid.distance_thresholds), n_m, n_c)
    members, tps, hits = (np.zeros(shape, np.int64) for _ in range(3))
    for e, eps in enumerate(grid.distance_thresholds):
        for c0 in range(0, n_c, chunk):
            c1 = min(n_c, c0 + chunk)
            member = torch.zeros((n_m, c1 - c0, n_preds), dtype=torch.bool, device=dev)
            for rows, conf, d2 in groups:
                keep = conf[None, :] >= cts[c0:c1, None]
                member[:, :, rows] = cluster_members(d2, keep, eps, sizes)
            flat = member.reshape(n_m * (c1 - c0), n_preds)
            tp_member = flat[:, tp_idx]
            label_hits = (tp_member.to(torch.float32) @ match_t > 0).sum(1)
            counts = torch.stack([flat.sum(1), tp_member.sum(1), label_hits]).reshape(3, n_m, c1 - c0)
            members[e, :, c0:c1], tps[e, :, c0:c1], hits[e, :, c0:c1] = counts.cpu().numpy()
    return members, tps, hits


def _grid_frame(records: list) -> pd.DataFrame:
    df = pd.DataFrame.from_records(records)
    df["product"] = df["precision"] * df["recall"]
    df["f_score"] = 2 * df["product"] / (df["precision"] + df["recall"])
    return df


def grid_search(
    preds: "gf.GeoFrame",
    labels: "gf.GeoFrame",
    grid: GridConfig = GridConfig(),
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Sweep the full grid on ``device``; returns a frame with
    precision/recall/product/f per combination, rows in the JAX package's
    order (eps outer, min size, conf inner), equal to ``grid_search_plain``.

    Pairwise distances are computed once per year group, the label<->pred
    TP match matrix once on the host; precision is the TP share of the
    members and recall the share of labels matched by a member."""
    dev = resolve_device(device)
    centers = _centers(preds)
    years = preds["year"].to_numpy()
    conf = preds["det_conf"].to_numpy(np.float64)
    groups = []
    for y in pd.unique(years):
        rows = np.nonzero(years == y)[0]
        groups.append((torch.as_tensor(rows, device=dev), torch.as_tensor(conf[rows], device=dev),
                       pairwise_d2(centers[rows], dev)))

    match = _match_matrix(labels.to_crs(preds.crs), preds)  # (L, P)
    n_labels = len(labels)
    # only the preds that match a label and the labels with a match move
    # precision and recall
    tp_pred = match.any(axis=0)
    tp_idx = torch.as_tensor(np.nonzero(tp_pred)[0], device=dev)
    match_t = torch.as_tensor(match[match.any(axis=1)][:, tp_pred].T, dtype=torch.float32, device=dev)
    members, tps, hits = _sweep(groups, len(preds), tp_idx, match_t, grid, dev)
    # numpy's mean of a bool array is count / n in float64: so is this
    precision = np.divide(tps, members, out=np.full(members.shape, np.nan), where=members > 0)
    recall = hits / n_labels if n_labels else np.full(members.shape, np.nan)

    records = []
    for e, eps in enumerate(grid.distance_thresholds):
        for m, ms in enumerate(grid.minimum_cluster_sizes):
            for c, ct in enumerate(grid.confidence_thresholds):
                records.append(
                    {
                        "precision": float(precision[e, m, c]),
                        "recall": float(recall[e, m, c]),
                        "conf_thresh": ct,
                        "distance_threshold": eps,
                        "min_cluster_size": ms,
                    }
                )
    return _grid_frame(records)


def _masked_cluster_members(d2_by_year: dict, conf_by_year: dict, eps: float, min_size: int,
                            conf_thresh: float) -> dict:
    """For each year group: bool member mask of points that survive the
    confidence filter AND belong to a DBSCAN cluster (not noise), by BFS."""
    out = {}
    for year, d2 in d2_by_year.items():
        conf = conf_by_year[year]
        keep = conf >= conf_thresh
        idx = np.nonzero(keep)[0]
        members = np.zeros(len(conf), bool)
        if len(idx):
            sub = d2[np.ix_(idx, idx)]
            adj = sub <= eps * eps
            core = adj.sum(axis=1) >= min_size
            labels = dbscan_from_adjacency(adj, core)
            members[idx[labels >= 0]] = True
        out[year] = members
    return out


def grid_search_plain(
    preds: "gf.GeoFrame",
    labels: "gf.GeoFrame",
    grid: GridConfig = GridConfig(),
) -> pd.DataFrame:
    """The plain version of ``grid_search``: the JAX package's loop over
    every combination, one BFS DBSCAN per year group each, on the host."""
    centers = _centers(preds)
    years = preds["year"].to_numpy()
    conf = preds["det_conf"].to_numpy(np.float64)

    d2_by_year, conf_by_year, rows_by_year = {}, {}, {}
    for y in pd.unique(years):
        rows = np.nonzero(years == y)[0]
        c = centers[rows]
        d2_by_year[y] = np.sum((c[:, None] - c[None, :]) ** 2, axis=-1)
        conf_by_year[y] = conf[rows]
        rows_by_year[y] = rows

    match = _match_matrix(labels.to_crs(preds.crs), preds)  # (L, P)
    tp_pred = match.any(axis=0)                             # (P,) pred is TP
    n_labels = len(labels)

    records = []
    for eps in grid.distance_thresholds:
        for ms in grid.minimum_cluster_sizes:
            for ct in grid.confidence_thresholds:
                member = np.zeros(len(preds), bool)
                mm = _masked_cluster_members(d2_by_year, conf_by_year, eps, ms, ct)
                for y, m in mm.items():
                    member[rows_by_year[y][m]] = True
                n = int(member.sum())
                precision = float(tp_pred[member].mean()) if n else np.nan
                recall = (
                    float((match[:, member].any(axis=1)).mean()) if n_labels else np.nan
                )
                records.append(
                    {
                        "precision": precision,
                        "recall": recall,
                        "conf_thresh": ct,
                        "distance_threshold": eps,
                        "min_cluster_size": ms,
                    }
                )
    return _grid_frame(records)


def stratified_kfold_indices(
    strata: Sequence, n_folds: int, seed: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic stratified k-fold (train_idx, test_idx) pairs: within
    each stratum, shuffled samples deal round-robin into folds."""
    rng = np.random.default_rng(seed)
    strata = np.asarray(strata)
    fold_of = np.zeros(len(strata), np.int64)
    for s in pd.unique(strata):
        rows = np.nonzero(strata == s)[0]
        rows = rng.permutation(rows)
        fold_of[rows] = np.arange(len(rows)) % n_folds
    out = []
    for f in range(n_folds):
        test = np.nonzero(fold_of == f)[0]
        train = np.nonzero(fold_of != f)[0]
        out.append((train, test))
    return out


def _subset(frame, ims):
    # the same membership as on pandas' arrow strings, whose isin makes a
    # Python scalar per value of ``ims`` (tens of thousands of images)
    out = frame[frame["image"].astype(object).isin(ims["image"].astype(object))].copy()
    out.crs = frame.crs
    return out


def get_fold_performance(
    fold_index: Tuple[np.ndarray, np.ndarray],
    images: pd.DataFrame,
    predictions: "gf.GeoFrame",
    labels: "gf.GeoFrame",
    grid: GridConfig = GridConfig(),
    device: str | torch.device = "cuda",
) -> List[dict]:
    """Train-split grid search + test-split evaluation of the best combo
    under both decision metrics (reference :284-413)."""
    train_images = images.iloc[fold_index[0]]
    test_images = images.iloc[fold_index[1]]

    train_preds, test_preds = _subset(predictions, train_images), _subset(predictions, test_images)
    train_labels, test_labels = _subset(labels, train_images), _subset(labels, test_images)

    results = grid_search(train_preds, train_labels, grid, device)

    out = []
    for metric in ("product", "f_score"):
        if results[metric].notna().any():
            best = results.loc[results[metric].idxmax()]
        else:  # train split has no detections/labels: any combo is as good
            best = results.iloc[0]
        chosen = clustered_detections(
            test_preds,
            conf_thresh=float(best["conf_thresh"]),
            distance_threshold=float(best["distance_threshold"]),
            min_cluster_size=int(best["min_cluster_size"]),
            device=device,
        )
        stats = get_stats_total(labels=test_labels, preds=chosen)
        rec = {f"test_{k}": v for k, v in stats.items()}
        rec.update(
            {
                "train_best_conf_thresh": float(best["conf_thresh"]),
                "train_best_distance_threshold": float(best["distance_threshold"]),
                "train_best_min_cluster_size": int(best["min_cluster_size"]),
                "metric": metric,
            }
        )
        out.append(rec)
    return out


def kfold_cluster_performance(
    images: pd.DataFrame,
    predictions: "gf.GeoFrame",
    labels: "gf.GeoFrame",
    strata: Sequence,
    grid: GridConfig = GridConfig(),
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Full CV: stratified folds over images, grid per fold
    (reference __main__ :482-536)."""
    folds = stratified_kfold_indices(strata, grid.folds, grid.seed)
    records = []
    for i, fold in enumerate(folds):
        for rec in get_fold_performance(fold, images, predictions, labels, grid, device):
            rec["fold"] = i
            records.append(rec)
    return pd.DataFrame.from_records(records)


def _facility_boxes(frame: "gf.GeoFrame", conf: float, distance_threshold: float,
                    minimum_cluster_size: int, device) -> "gf.GeoFrame":
    """Facilities of ``frame`` at the operating point as the bounding boxes
    of their square and circle cages (rectangle cages left out, as the JAX
    package does), in EPSG:3857.

    The JAX package takes the bounds of the cages' ``unary_union``, which
    snaps to a lattice of about span / 2^25; here they are the members'
    joint bounds, within 1e-6 of the span of that value."""
    f = frame.copy()
    f.crs = frame.crs
    if "det_conf" not in f.columns:
        f["det_conf"] = 1.0
    f = f.reset_index(drop=True)
    f["index"] = f.index
    f3035 = f.to_crs(CRS_AREA)
    f3035.crs = CRS_AREA
    fac = predictions_cluster(
        f3035,
        cluster_variable="year",
        conf_thresh=conf,
        distance_threshold=distance_threshold,
        min_cluster_size=minimum_cluster_size,
        include_area=False,
        device=device,
    )
    geoms = []
    for _, row in fac.iterrows():
        cages = _poly.MultiPolygon([*row["square_farm_geoms"], *row["circle_farm_geoms"]])
        geoms.append(_poly.box(*cages.bounds) if not cages.is_empty else _poly.Empty())
    return gf.GeoFrame(
        {"year": fac["year"].to_numpy(), "type": ["facility"] * len(fac)},
        geometry=geoms,
        crs=CRS_MAPPING,
    )


def test_set_performance(
    images: pd.DataFrame,
    predictions: "gf.GeoFrame",
    labels: "gf.GeoFrame",
    confidence_threshold: float,
    distance_threshold: float,
    minimum_cluster_size: int,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Held-out cage- and facility-level P/R at a fixed operating point
    (reference :416-479)."""
    dev = resolve_device(device)
    test_preds = _subset(predictions, images)
    test_labels = _subset(labels, images)

    chosen = clustered_detections(
        test_preds, confidence_threshold, distance_threshold, minimum_cluster_size, dev
    )
    cage_result = get_stats_total(labels=test_labels, preds=chosen)

    # Facility-level: cluster labels too, compare facility bounding boxes
    fac_preds = _facility_boxes(test_preds, confidence_threshold, distance_threshold, minimum_cluster_size, dev)
    fac_labels = _facility_boxes(test_labels, 0.0, distance_threshold, minimum_cluster_size, dev)
    facility_result = get_stats_total(labels=fac_labels, preds=fac_preds)

    return pd.DataFrame(
        [cage_result, facility_result], index=["cage-level", "facility-level"]
    )
