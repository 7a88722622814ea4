"""Annotation-frame loading and filtering. Port of
`pose3d_tpu/data/annotations.py` (`LABEL_COLS`, `BAD_CATS`, the
test-category lists, `pascal3d_frame` with its train filters: `novel`,
`train_cls`, `shot`; `pix3d_frame`, `pix3d_contrast_frame`, `linemod_frame`
and `shapenet_frame`).

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
        frame = _shot(frame, "cat", shot, seed)

    return frame.reset_index(drop=True)


def _shot(frame: pd.DataFrame, column: str, shot: int, seed: int | None) -> pd.DataFrame:
    """`shot` rows of each class of `column`, drawn from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return pd.concat([frame[frame[column] == cls].sample(n=shot, random_state=rng)
                      for cls in np.unique(frame[column])])


def pix3d_frame(root_dir: str, annotation_file: str,
                cat_choice: list | None = None) -> pd.DataFrame:
    """The Pix3D evaluation frame: unoccluded, untruncated rows; elevation
    + 90 and the in-plane rotation from radians to degrees + 180 (its
    label units)."""
    frame = pd.read_csv(os.path.join(root_dir, annotation_file))
    frame = frame[frame.truncated == False]  # noqa: E712  (stored as bools)
    frame = frame[frame.occluded == False]  # noqa: E712
    frame = frame[frame.slightly_occluded == False]  # noqa: E712
    frame = frame.copy()
    frame.elevation = frame.elevation + 90.0
    frame.inplane_rotation = (frame.inplane_rotation * 180.0 / np.pi) + 180.0
    if cat_choice is not None:
        frame = frame[frame.cat_id.isin(cat_choice)]
    return frame.reset_index(drop=True)


def pix3d_contrast_frame(root_dir: str, annotation_file: str, train: bool = True,
                         train_feat: bool = False, cls_choice: list[str] | None = None,
                         train_cls: list[str] | str | None = None, shot: int | None = None,
                         idx_choice: np.ndarray | None = None,
                         seed: int | None = None) -> pd.DataFrame:
    """The Pix3DContrast frame, its classes in `cls_name`: the train split
    (`cls_choice` left out) or the val split (unoccluded, untruncated, with
    keypoints; `cls_choice` only), then `train_cls`, `shot` and
    `idx_choice`."""
    frame = pd.read_csv(os.path.join(root_dir, annotation_file))
    frame = frame[frame.elevation != 90]
    frame = frame[frame.difficult == 0]
    if "ObjectNet3D" in annotation_file:
        frame = frame.copy()
        frame.azimuth = (360.0 + frame.azimuth) % 360
    if train or train_feat:
        frame = frame[frame.set == "train"]
    else:
        frame = frame[frame.set == "val"]
        frame = frame[frame.truncated == 0]
        frame = frame[frame.occluded == 0]
        frame = frame[frame.has_keypoints == 1]
    if cls_choice is not None:
        frame = (frame[~frame.cls_name.isin(cls_choice)] if train
                 else frame[frame.cls_name.isin(cls_choice)])
    if train_cls is not None:
        if isinstance(train_cls, list):
            frame = frame[frame.cls_name.isin(train_cls)]
        else:
            frame = frame[frame.cls_name == train_cls]
    if train and shot is not None:
        frame = _shot(frame, "cls_name", shot, seed)
    if train and idx_choice is not None:
        frame = frame.iloc[idx_choice, :]
    return frame.reset_index(drop=True)


def linemod_frame(root_dir: str, annotation_file: str,
                  cat_choice: list[int] | None = None) -> pd.DataFrame:
    """The LineMod frame, its objects in `obj_id`."""
    frame = pd.read_csv(os.path.join(root_dir, annotation_file))
    if cat_choice is not None:
        frame = frame[frame.obj_id.isin(cat_choice)]
    return frame.reset_index(drop=True)


def shapenet_frame(root_dir: str, annotation_file: str, train: bool = True,
                   novel: bool = False, cat_choice: list | None = None,
                   model_number: int = 200) -> pd.DataFrame:
    """The ShapeNet renders' frame: `cat_choice` left out in training with
    `novel` (kept alone at validation), then the first `model_number`
    models (sorted by example id) of each category."""
    frame = pd.read_csv(os.path.join(root_dir, annotation_file))
    if cat_choice is not None:
        if train:
            frame = frame[~frame.cat_id.isin(cat_choice)] if novel else frame
        else:
            frame = frame[frame.cat_id.isin(cat_choice)]
    parts = []
    for cat in np.unique(frame.cat_id):
        frame_cat = frame[frame.cat_id == cat]
        examples = list(np.unique(frame_cat.example_id))[:model_number]
        parts.append(frame_cat[frame_cat.example_id.isin(examples)])
    frame = pd.concat(parts) if parts else frame
    return frame.reset_index(drop=True)
