"""Dataset sample producers (host side, fixed-shape numpy outputs). Port of
`pose3d_tpu/data/datasets.py` `_finalize`, `Pascal3D` and
`Pascal3DContrast`, train and evaluation branches, with images only
(`shape=None`) or with the object's point cloud (`shape="PointCloud"`); the
MultiView renders, ShapeNet, Pix3D and LineMod come with their paths
(ROADMAP.md Queue 1).

Samples are dicts of numpy arrays: 'im' NHWC float32, 'label' the canonical
int triple, 'cat_id' the index of the sample's category in
`category_names`, so evaluation is one pass reduced per category, and
'shape' the (point_num, 3) float32 cloud. Contrastive train samples also
carry the flipped and the rotated view ('im_flip', 'label_flip', 'im_rot',
'label_rot'). Random draws come from the `rng` the loader passes, in JAX's
order, so the same seed gives the JAX loader's samples.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
from PIL import Image

from pose3d_tpu_torch.data import annotations as anno
from pose3d_tpu_torch.data import ply
from pose3d_tpu_torch.data import transforms as T


def _finalize(im: Image.Image, rng: np.random.Generator, train: bool,
              contrast: bool) -> np.ndarray:
    """To float, the train-time photometric augmentation (contrastive:
    color jitter with p 0.8 then grayscale with p 0.2; plain: color
    jitter), ImageNet normalisation, then PCA lighting in training."""
    arr = T.to_float_array(im)
    if train:
        if contrast:
            if rng.random() < 0.8:
                arr = T.color_jitter(arr, rng)
            arr = T.random_grayscale(arr, rng, p=0.2)
        else:
            arr = T.color_jitter(arr, rng)
    arr = T.normalize_image(arr)
    if train:
        arr = T.pca_lighting(arr, rng)
    return arr.astype(np.float32)


class _PascalBase:
    """The annotation frame, category ids and the point-cloud loader."""

    def __init__(self, root_dir, frame, shape, shape_dir, point_num, input_dim,
                 random_model):
        if shape not in (None, "None", "PointCloud"):
            raise NotImplementedError(f"shape={shape!r} datasets are not ported to "
                                      "pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
        self.root_dir = root_dir
        self.frame = frame
        self.shape = None if shape == "None" else shape
        self.shape_dir = shape_dir
        self.point_num = point_num
        self.input_dim = input_dim
        self.random_model = random_model
        self.category_names = (sorted(np.unique(frame.cat).tolist()) if len(frame) else [])
        self._cat_to_id = {c: i for i, c in enumerate(self.category_names)}

    def __len__(self):
        return len(self.frame)

    def _row(self, idx: int, rng: np.random.Generator):
        """The sample's row, its CAD model (another of its category with
        random_model) and its raw annotation triple."""
        row = self.frame.iloc[idx]
        cat, cad_index = row["cat"], row["cad_index"]
        if self.random_model:
            others = self.frame[(self.frame.cat == cat) & (self.frame.cad_index != cad_index)]
            if len(others):
                cad_index = others.iloc[rng.integers(len(others))]["cad_index"]
        return row, cat, cad_index, row[anno.LABEL_COLS].to_numpy(dtype=np.float64)

    def _cloud(self, cat, cad_index, rotation_deg, rng) -> np.ndarray:
        path = os.path.join(self.root_dir, self.shape_dir, str(cat),
                            "%02d" % int(cad_index), "compressed.ply")
        return T.sample_pointcloud(ply.load_vertices(path), self.point_num, rotation_deg, rng)


class Pascal3D(_PascalBase):
    """Pascal3D+ / ObjectNet3D samples (the reference's Pascal3D). Train:
    blur, jittered crop, flip and rotation with their label fixes,
    photometric augmentation; with `random`, the canonical frame's azimuth
    turns by a random multiple of 5 degrees (the cloud with it). Eval: the
    bounding-box crop."""

    def __init__(self, root_dir, annotation_file, input_dim=224, shape=None,
                 shape_dir="pointcloud", random=False, novel=True, keypoint=True, train=True,
                 cat_choice=None, random_range=0, point_num=2500):
        frame = anno.pascal3d_frame(root_dir, annotation_file, train=train, keypoint=keypoint,
                                    novel=novel, cat_choice=cat_choice)
        super().__init__(root_dir, frame, shape, shape_dir, point_num, input_dim,
                         random_model=False)
        self.train = train
        self.random = random
        self.random_range = random_range

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        row, cat, cad_index, label = self._row(idx, rng)
        left, upper, right, lower = row["left"], row["upper"], row["right"], row["lower"]
        im = T.load_rgb(os.path.join(self.root_dir, row["im_path"]))
        if self.train:
            if min(right - left, lower - upper) > 224 and rng.random() < 0.3:
                im = T.gaussian_blur(im, 3)
            im = T.random_crop(im, left, upper, right - left, lower - upper, rng)
            if rng.random() > 0.5:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
                label = T.flip_label(label)
            if rng.random() > 0.5:
                r = max(-60, min(60, rng.standard_normal() * 30))
                im = im.rotate(r)
                label = T.rotate_label(label, r)
        else:
            im = im.crop((left, upper, right, lower))
        arr = _finalize(T.resize_pad(im, self.input_dim), rng, train=self.train,
                        contrast=False)
        sample = {"im": arr, "label": T.process_viewpoint_label(label).astype(np.int32),
                  "cat_id": np.int32(self._cat_to_id.get(cat, -1))}
        if self.shape is None:
            return sample
        mutation = 0
        if self.random and cat not in anno.BAD_CATS:
            if self.random_range == 0:
                mutation = int(rng.integers(-8, 9)) % 72
            elif self.random_range == 1:
                mutation = int(rng.integers(-17, 18)) % 72
            else:
                mutation = int(rng.integers(0, 72))
            sample["label"] = sample["label"].copy()
            sample["label"][0] = (sample["label"][0] - mutation * 5) % 360
        sample["shape"] = self._cloud(cat, cad_index, mutation, rng)
        return sample


class Pascal3DContrast(_PascalBase):
    """Pascal3D+ / ObjectNet3D samples (the reference's Pascal3DContrast).
    Train: blur, jittered crop, then three views, each resize-padded and
    photometrically augmented: rotated by +-15 degrees, flipped, and the
    original. Eval: the bounding-box crop, resize-padded to `input_dim` and
    ImageNet-normalized. With shape="PointCloud", a cloud of `point_num`
    points sampled from `<root_dir>/<shape_dir>/<cat>/<cad_index:02d>/
    compressed.ply`; `random_model` takes another CAD model of the same
    category."""

    def __init__(self, root_dir, annotation_file, input_dim=224, keypoint=True,
                 cat_choice=None, shape=None, shape_dir="pointcloud", point_num=2500,
                 random_model=False, train=False, novel=False, shot=None, seed=None):
        frame = anno.pascal3d_frame(root_dir, annotation_file, train=train, keypoint=keypoint,
                                    novel=novel, cat_choice=cat_choice, shot=shot,
                                    contrast_val_keypoint=not train, seed=seed)
        super().__init__(root_dir, frame, shape, shape_dir, point_num, input_dim,
                         random_model)
        self.train = train

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        """Sample `idx`; `rng` draws the other CAD model, the augmentation
        and the cloud's subset, in JAX's order."""
        row, cat, cad_index, label = self._row(idx, rng)
        left, upper, right, lower = row["left"], row["upper"], row["right"], row["lower"]
        im = T.load_rgb(os.path.join(self.root_dir, row["im_path"]))
        cat_id = np.int32(self._cat_to_id.get(cat, -1))
        if self.train:
            if min(right - left, lower - upper) > 224 and rng.random() > 0.5:
                im = T.gaussian_blur(im, int(rng.integers(1, 5)))
            im = T.random_crop(im, left, upper, right - left, lower - upper, rng)
            r = float(rng.choice([-15, 15]))
            views = {}
            for key, view, view_label in (
                    ("rot", im.rotate(r), T.rotate_label(label, r)),
                    ("flip", im.transpose(Image.FLIP_LEFT_RIGHT), T.flip_label(label)),
                    ("", im, label)):
                arr = _finalize(T.resize_pad(view, self.input_dim), rng, train=True,
                                contrast=True)
                suffix = f"_{key}" if key else ""
                views["im" + suffix] = arr
                views["label" + suffix] = T.process_viewpoint_label(view_label).astype(np.int32)
            sample = {"im": views["im"], "label": views["label"],
                      "im_flip": views["im_flip"], "label_flip": views["label_flip"],
                      "im_rot": views["im_rot"], "label_rot": views["label_rot"],
                      "cat_id": cat_id}
        else:
            im = im.crop((left, upper, right, lower))
            arr = _finalize(T.resize_pad(im, self.input_dim), rng, train=False,
                            contrast=True)
            sample = {"im": arr, "label": T.process_viewpoint_label(label).astype(np.int32),
                      "cat_id": cat_id}
        if self.shape == "PointCloud":
            sample["shape"] = self._cloud(cat, cad_index, 0, rng)
        return sample
