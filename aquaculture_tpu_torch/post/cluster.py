"""Facility clustering of the PyTorch port: exact DBSCAN + facility aggregation.

A copy of aquaculture_tpu/post/cluster.py (reference:
src/cluster_facilities.py:13-208) whose DBSCAN labels are computed with
tensors on the entry point's device. The labels equal sklearn's (and the
JAX package's BFS) elementwise:

* a core component is a cluster, numbered by its smallest core index in
  ascending order (the BFS starts each cluster at the first core point it
  has not reached yet);
* a border point (not core, within eps of a core) takes the smallest cluster
  number among its adjacent cores: the BFS finishes cluster c before it
  starts c + 1, so that cluster reaches it first;
* everything else is noise, -1.

``dbscan_plain`` keeps the JAX package's BFS as the plain version the tests
and chip_smoke.py hold the tensor route against.

Facility aggregation mirrors DBSCAN_cluster / predictions_cluster: per
time-group clusters with per-type counts and MultiPolygon cage geometries,
summed areas/variances, centroid Point geometry, and a global
facility_index.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import pandas as pd
import torch

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.config import CRS_AREA, CRS_MAPPING, resolve_device
from aquaculture_tpu_torch.geo import polygon as _poly


def dbscan_from_adjacency(adj: np.ndarray, core: np.ndarray) -> np.ndarray:
    """DBSCAN label assignment from a boolean adjacency (self-inclusive)
    and core-point mask by BFS in sklearn's order; -1 = noise."""
    n = len(core)
    labels = np.full(n, -1, np.int64)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cluster
        q = deque([i])
        while q:
            j = q.popleft()
            if not core[j]:
                continue
            for k in np.nonzero(adj[j])[0]:
                if labels[k] == -1:
                    labels[k] = cluster
                    q.append(k)
        cluster += 1
    return labels


def dbscan_plain(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Exact DBSCAN labels over (N, 2) points by BFS on the host; -1 = noise."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64)
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    adj = d2 <= eps * eps  # includes self
    core = adj.sum(axis=1) >= min_samples
    return dbscan_from_adjacency(adj, core)


def pairwise_d2(points: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, N) float64 squared distances of (N, 2) points on ``device``, as
    dx*dx + dy*dy like the plain version, so that no ``d2 <= eps*eps`` test
    flips (torch.cdist's |a|^2 + |b|^2 - 2ab expansion rounds otherwise)."""
    c = torch.as_tensor(np.asarray(points, np.float64).reshape(-1, 2), device=device)
    diff = c[:, None, :] - c[None, :, :]
    return (diff * diff).sum(-1)


def _component_roots(cc: torch.Tensor) -> torch.Tensor:
    """Smallest index of each node's connected component, for a symmetric
    self-inclusive (K, K) boolean adjacency: min-label propagation with
    pointer jumping until no label changes."""
    k = cc.shape[0]
    lab = torch.arange(k, device=cc.device)
    while True:
        m = torch.where(cc, lab[None, :], k).amin(1)
        # m[i] is a node of i's component (cc[i, i] holds), so m[m] is too
        while True:
            jumped = m[m]
            if torch.equal(jumped, m):
                break
            m = jumped
        if torch.equal(m, lab):
            return lab
        lab = m


def dbscan(points: np.ndarray, eps: float, min_samples: int,
           device: str | torch.device = "cuda") -> np.ndarray:
    """Exact DBSCAN labels over (N, 2) points, computed on ``device``; -1 =
    noise. Equal to ``dbscan_plain`` elementwise."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64)
    adj = pairwise_d2(pts, dev) <= eps * eps  # includes self
    core = adj.sum(1) >= min_samples
    core_idx = torch.nonzero(core).squeeze(1)
    labels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    k = len(core_idx)
    if k:
        roots = _component_roots(adj[core_idx][:, core_idx])
        _, cluster = torch.unique(roots, sorted=True, return_inverse=True)
        labels[core_idx] = cluster
        first = torch.where(adj[:, core_idx], cluster[None, :], k).amin(1)
        labels = torch.where(~core & (first < k), first, labels)
    return labels.cpu().numpy()


_FTYPES = ("circle", "square", "rectangle")


def cluster_facilities(
    cages: "gf.GeoFrame",
    cluster_variable: str = "year",
    distance_threshold: float = 10.0,
    min_cluster_size: int = 5,
    include_area: bool = True,
    device: str | torch.device = "cuda",
) -> "gf.GeoFrame":
    """Group cage detections into facilities (reference DBSCAN_cluster).

    Args:
        cages: detections in EPSG:3035 with a unique ``index`` column
        cluster_variable: group column ('year' or 'pass')
        distance_threshold: DBSCAN eps in meters
        min_cluster_size: DBSCAN min_samples
        device: where the DBSCAN labels are computed
    Returns:
        facility GeoFrame in EPSG:3857 (point centroids), with the
        reference's schema (cluster_facilities.py:57-158).
    """
    assert "index" in cages.columns and cages["index"].nunique() == len(cages), "check cage ID"
    assert cages.crs == CRS_AREA, f"cages must be EPSG:{CRS_AREA}"
    if cluster_variable not in cages.columns:
        raise ValueError(f"missing cluster variable {cluster_variable!r}")
    dev = resolve_device(device)

    rows = []
    geoms = []
    for y in pd.unique(cages[cluster_variable]):
        sub = cages[cages[cluster_variable] == y]
        sub.crs = cages.crs  # subsetting does not always propagate metadata
        centers = _poly.centroid_array(list(sub["geometry"]))
        labels = dbscan(centers, distance_threshold, min_cluster_size, dev)
        n_noise = int((labels == -1).sum())
        sub_3857 = sub.to_crs(CRS_MAPPING)
        types = sub["type"].to_numpy()
        for l in np.unique(labels):
            if l == -1:
                continue
            m = labels == l
            members = sub_3857.iloc[np.nonzero(m)[0]]
            rec = {
                "num_circle_farms": int((types[m] == "circle_farm").sum()),
                "num_square_farms": int((types[m] == "square_farm").sum()),
                "num_rectangle_farms": int((types[m] == "rectangle_farm").sum()),
                cluster_variable: y,
                "noise_points": n_noise,
                "cage_ids": members["index"].tolist(),
            }
            for ft in _FTYPES:
                sel = [
                    g
                    for g, t in zip(members["geometry"], types[m])
                    if t == f"{ft}_farm" and isinstance(g, _poly.Polygon)
                ]
                rec[f"{ft}_farm_geoms"] = _poly.MultiPolygon(sel)
            if include_area:
                rec["area"] = float(members["area"].sum())
                rec["area_var"] = float(np.sum(members["area_var"].to_numpy()))
                rec["min_area"] = float(members["min_area"].sum())
                rec["max_area"] = float(members["max_area"].sum())
            rows.append(rec)
            c = centers[m].mean(axis=0)
            geoms.append(_poly.Point(float(c[0]), float(c[1])))

    out = gf.GeoFrame(pd.DataFrame(rows), geometry=geoms, crs=CRS_AREA)
    out.reset_index(inplace=True, drop=True)
    out["facility_index"] = out.index
    out.crs = CRS_AREA
    return out.to_crs(CRS_MAPPING)


def predictions_cluster(
    predictions: "gf.GeoFrame",
    cluster_variable: str = "year",
    conf_thresh: float = 0.5,
    distance_threshold: float = 10.0,
    min_cluster_size: int = 5,
    include_area: bool = True,
    device: str | torch.device = "cuda",
) -> "gf.GeoFrame":
    """Confidence-filter then cluster (reference predictions_cluster,
    cluster_facilities.py:181-208)."""
    preds = predictions[predictions["det_conf"] >= conf_thresh].copy()
    preds.crs = predictions.crs
    return cluster_facilities(
        preds,
        cluster_variable=cluster_variable,
        distance_threshold=distance_threshold,
        min_cluster_size=min_cluster_size,
        include_area=include_area,
        device=device,
    )
