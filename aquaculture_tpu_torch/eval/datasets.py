"""Evaluation dataset assembly (a copy of aquaculture_tpu/eval/datasets.py;
host).

Port of load_datasets_for_model_evaluation (reference:
src/get_kfold_cluster_performance.py:31-120): wire labels, detections,
image boxes, Trujillo strata, sampled images and the land flag into the
bucket-annotated frames the CV harness consumes — with every input
injected instead of read from fixed paths.
"""

from __future__ import annotations

from typing import Dict, Optional

import pandas as pd

from aquaculture_tpu_torch import frame as gf
from aquaculture_tpu_torch.data.filenames import decode_tile_name
from aquaculture_tpu_torch.data.labels import mark_land_images
from aquaculture_tpu_torch.eval.buckets import set_buckets, set_image_stats
from aquaculture_tpu_torch.geo import polygon as _poly
from aquaculture_tpu_torch.post.dedup import deduplicate_download_boxes, deduplicate_gdf_with_bboxes


def assemble_evaluation_datasets(
    detections: "gf.GeoFrame",
    labels: "gf.GeoFrame",
    image_boxes: "gf.GeoFrame",
    download_bboxes: "gf.GeoFrame",
    trujillo: "gf.GeoFrame",
    sampled_images: pd.DataFrame,
    land: Optional["gf.GeoFrame"] = None,
) -> Dict[str, object]:
    """Returns the reference's dataset dict: all_images / detections /
    ocean_detections / ocean_images / sampled_images / labels, all
    dedup'd, land-marked and bucket-annotated."""
    dedup = deduplicate_download_boxes(download_bboxes)

    all_images = image_boxes.copy()
    all_images.crs = image_boxes.crs
    if "image" not in all_images.columns:
        all_images["image"] = all_images["image_file"]

    lab = labels[labels["type"].isin(["circle_cage", "square_cage"])].copy()
    lab.crs = labels.crs
    lab["type"] = lab["type"].replace({"circle_cage": "circle_farm", "square_cage": "square_farm"})
    if "bbox_ind" not in lab.columns:
        lab["bbox_ind"] = [decode_tile_name(f).bbox_ind for f in lab["image"]]
    lab = deduplicate_gdf_with_bboxes(dedup, lab)

    det = detections[detections["type"].isin(["circle_farm", "square_farm"])].copy()
    det.crs = detections.crs
    det["bbox_ind"] = [decode_tile_name(f).bbox_ind for f in det["image"]]
    det = deduplicate_gdf_with_bboxes(dedup, det)

    # Trujillo 1 km stratum boxes (designed in EPSG:3857; reference :66-70)
    tru = trujillo.to_crs(3857)
    tru_boxes = gf.GeoFrame(
        {"i": range(len(tru))},
        geometry=[
            _poly.box(p.x - 1000, p.y - 1000, p.x + 1000, p.y + 1000) for p in tru["geometry"]
        ],
        crs=3857,
    )

    if land is not None:
        all_images["only_land"] = mark_land_images(all_images, land).to_numpy()
    else:
        all_images["only_land"] = False
    land_images = set(all_images.loc[all_images["only_land"], "image"])
    det["surely_land"] = det["image"].isin(land_images)

    sampled = sampled_images.copy()
    # land images count as sampled (reference :88-93)
    extra = all_images.loc[all_images["only_land"], ["image", "only_land"]]
    sampled = pd.concat([sampled, pd.DataFrame(extra)], axis=0, ignore_index=True)
    sampled["only_land"] = sampled["only_land"].fillna(False) if "only_land" in sampled else False

    all_images["in_sample"] = all_images["image"].isin(sampled["image"])
    all_images = set_image_stats(all_images, det.to_crs(all_images.crs), lab.to_crs(all_images.crs))
    all_images = set_buckets(all_images, tru_boxes)

    bucket_by_image = dict(zip(all_images["image"], all_images["bucket"].astype(str)))
    sampled["bucket"] = sampled["image"].map(bucket_by_image)
    det["bucket"] = det["image"].map(bucket_by_image)
    lab["bucket"] = lab["image"].map(bucket_by_image)

    det = det.reset_index(drop=True)
    det["index"] = det.index
    det.crs = detections.crs

    ocean_images = all_images[~all_images["only_land"].astype(bool)]
    ocean_detections = det[~det["surely_land"].astype(bool)]
    ocean_images.crs = all_images.crs
    ocean_detections.crs = det.crs

    return {
        "all_images": all_images,
        "detections": det,
        "ocean_detections": ocean_detections,
        "ocean_images": ocean_images,
        "sampled_images": sampled,
        "labels": lab,
    }
