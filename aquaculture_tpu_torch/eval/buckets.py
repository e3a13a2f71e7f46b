"""Image stratification buckets for sampling-based evaluation (a copy of
aquaculture_tpu/eval/buckets.py; host, pandas).

Port of set_image_stats / set_buckets / get_bucket_info_table (reference:
src/get_kfold_cluster_performance.py:148-257): per-image detection/label
counts, confidence-bin buckets, land bucket, and the near-known-facility
("jennifer area") refinement of the no-detection stratum.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import pandas as pd

from aquaculture_tpu_torch import frame as gf

# The reference's stratification bins (get_kfold_cluster_performance.py:28)
# — the strata design is part of the study, so the values must match
CONF_BINS: List[float] = [0.0, 0.3, 0.5, 0.8, 1.0]


def set_image_stats(
    images: "gf.GeoFrame", detections: "gf.GeoFrame", labels: "gf.GeoFrame"
) -> "gf.GeoFrame":
    """Append det_conf (max), num_detections, num_labels_sample per image."""
    out = images.copy()
    out.crs = images.crs

    def counts(objs):
        joined = images.sjoin(objs.to_crs(images.crs), how="left", predicate="intersects")
        same = joined[
            (joined.get("image_left") == joined.get("image_right"))
            | joined.get("image_right").isna()
        ]
        grp = same.groupby(level=0)
        n = grp["index_right"].agg(lambda x: 0 if x.isna().any() else len(x))
        return same, n

    det_joined, n_det = counts(detections)
    max_conf = det_joined.groupby(level=0)["det_conf"].max()
    _, n_lab = counts(labels)

    out["det_conf"] = max_conf.reindex(out.index)
    out["num_detections"] = n_det.reindex(out.index).fillna(0).astype(int)
    out["num_labels_sample"] = n_lab.reindex(out.index)
    if "in_sample" in out.columns:
        out.loc[~out["in_sample"].astype(bool), "num_labels_sample"] = np.nan
    return out


def set_buckets(
    ims: "gf.GeoFrame",
    trujillo_boxes: "gf.GeoFrame",
    conf_bins: Sequence[float] = CONF_BINS,
) -> "gf.GeoFrame":
    """Assign each image a stratum: land / confidence bin / no-detection
    split by proximity to known (Trujillo) facilities."""
    images = ims.copy()
    images.crs = ims.crs
    near = images.sjoin(trujillo_boxes.to_crs(images.crs), how="inner", predicate="intersects")
    images["in_jennifer_area"] = images.index.isin(near.index.unique())

    cb = pd.cut(images["det_conf"], bins=list(conf_bins))
    cb = cb.cat.add_categories("No detection").fillna("No detection")
    images["conf_bucket"] = cb

    bucket = images["conf_bucket"].astype(object)
    no_det = bucket == "No detection"
    bucket[no_det & images["in_jennifer_area"]] = "No detection, in jennifer area"
    bucket[no_det & ~images["in_jennifer_area"]] = "No detection, outside jennifer area"
    if "only_land" in images.columns:
        bucket[images["only_land"].astype(bool)] = "land"
    images["bucket"] = pd.Categorical(bucket.astype(str))
    return images


def get_bucket_info_table(images: pd.DataFrame) -> pd.DataFrame:
    """Per-bucket totals and in-sample totals, plus the estimated label
    count extrapolated from the sampling rate (reference :228-257)."""
    in_sample = images["in_sample"].astype(bool) if "in_sample" in images.columns else pd.Series(True, index=images.index)
    rows = []
    for bucket, grp in images.groupby("bucket", observed=True):
        s = in_sample.loc[grp.index]
        n_img = len(grp)
        n_img_sample = int(s.sum())
        n_det = float(grp["num_detections"].sum())
        n_det_sample = float(grp.loc[s, "num_detections"].sum())
        n_lab_sample = float(grp["num_labels_sample"].sum(skipna=True))
        est_labels = (n_lab_sample / n_img_sample) * n_img if n_img_sample else np.nan
        rows.append(
            {
                "bucket": bucket,
                "num_detections_bucket": n_det,
                "num_detections_sample": n_det_sample,
                "num_images_bucket": n_img,
                "num_images_sample": n_img_sample,
                "num_labels_sample": n_lab_sample,
                "estimated_num_labels_bucket": est_labels,
            }
        )
    return pd.DataFrame(rows).set_index("bucket")
