"""Annotation-frame loading and filtering. Port of
`pose3d_tpu/data/annotations.py` (`LABEL_COLS`, `BAD_CATS`, the
test-category lists, `pascal3d_frame` with its train filters: `novel`,
`train_cls`, `shot`).

Labels are read by column name: annotation files carry `azimuth`,
`elevation` and `inplane_rotation` columns.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

LABEL_COLS = ["azimuth", "elevation", "inplane_rotation"]

# categories whose canonical frame is never azimuth-randomized
BAD_CATS = [
    "ashtray", "basket", "bottle", "bucket", "can", "cap", "cup",
    "fire_extinguisher", "fish_tank", "flashlight", "helmet", "jar",
    "paintbrush", "pen", "pencil", "plate", "pot", "road_pole",
    "screwdriver", "toothbrush", "trash_bin", "trophy",
]

OBJECTNET3D_TEST_CATS = [
    "bed", "bookshelf", "calculator", "cellphone", "computer", "door",
    "filing_cabinet", "guitar", "iron", "knife", "microwave", "pen", "pot",
    "rifle", "shoe", "slipper", "stove", "toilet", "tub", "wheelchair",
]

PASCAL3D_TEST_CATS = [
    "aeroplane", "bicycle", "boat", "bottle", "bus", "car", "chair",
    "diningtable", "motorbike", "sofa", "train", "tvmonitor",
]

PIX3D_TEST_CATS = [
    "tool", "misc", "bookcase", "wardrobe", "desk", "bed", "table", "sofa", "chair",
]

LINEMOD_TEST_CATS = [1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]


def pascal3d_frame(
    root_dir: str,
    annotation_file: str,
    train: bool = True,
    keypoint: bool = True,
    novel: bool = False,
    cat_choice: list[str] | None = None,
    train_cls: list[str] | str | None = None,
    shot: int | None = None,
    contrast_val_keypoint: bool = False,
    seed: int | None = None,
) -> pd.DataFrame:
    """Filter chain shared by Pascal3D and Pascal3DContrast.

    Set contrast_val_keypoint=True for the Pascal3DContrast val path, which
    also requires has_keypoints == 1.
    """
    frame = pd.read_csv(os.path.join(root_dir, annotation_file))
    frame = frame[frame.elevation != 90]
    frame = frame[frame.difficult == 0]
    if os.path.basename(annotation_file) == "ObjectNet3D.txt":
        if keypoint:
            frame = frame[frame.has_keypoints == 1]
            frame = frame[frame.truncated == 0]
            frame = frame[frame.occluded == 0]
        frame = frame.copy()
        frame.azimuth = (360.0 + frame.azimuth) % 360
    if train:
        frame = frame[frame.set == "train"]
    else:
        frame = frame[frame.set == "val"]
        frame = frame[frame.truncated == 0]
        frame = frame[frame.occluded == 0]
        if contrast_val_keypoint:
            frame = frame[frame.has_keypoints == 1]

    if cat_choice is not None:
        if train:
            frame = frame[~frame.cat.isin(cat_choice)] if novel else frame
        else:
            frame = frame[frame.cat.isin(cat_choice)]

    if train_cls is not None:
        if isinstance(train_cls, list):
            frame = frame[frame.cat.isin(train_cls)]
        else:
            frame = frame[frame.cat == train_cls]

    if train and shot is not None:
        rng = np.random.RandomState(seed)
        parts = []
        for cls in np.unique(frame.cat):
            parts.append(frame[frame.cat == cls].sample(n=shot, random_state=rng))
        frame = pd.concat(parts)

    return frame.reset_index(drop=True)
