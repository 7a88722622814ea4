"""Dataset sample producers (host side, fixed-shape numpy outputs). Port of
`pose3d_tpu/data/datasets.py Pascal3DContrast`, evaluation branch, with
images only (`shape=None`) or with the object's point cloud
(`shape="PointCloud"`); the MultiView renders and the training branches
come with their paths (ROADMAP.md Queue 1).

Samples are dicts of numpy arrays: 'im' NHWC float32, 'label' the canonical
int triple, 'cat_id' the index of the sample's category in
`category_names`, so evaluation is one pass reduced per category, and
'shape' the (point_num, 3) float32 cloud. Random draws come from the `rng`
the loader passes, in JAX's order (the `random_model` draw, then the
cloud's subset), so the same seed gives the same clouds as the JAX loader.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from pose3d_tpu_torch.data import annotations as anno
from pose3d_tpu_torch.data import ply
from pose3d_tpu_torch.data import transforms as T


class Pascal3DContrast:
    """Pascal3D+ / ObjectNet3D evaluation samples: the bounding-box crop,
    resize-padded to `input_dim` and ImageNet-normalized, and with
    shape="PointCloud" a cloud of `point_num` points sampled from
    `<root_dir>/<shape_dir>/<cat>/<cad_index:02d>/compressed.ply`.
    `random_model` takes another CAD model of the same category."""

    def __init__(self, root_dir, annotation_file, input_dim=224, keypoint=True,
                 cat_choice=None, shape=None, shape_dir="pointcloud", point_num=2500,
                 random_model=False):
        if shape not in (None, "None", "PointCloud"):
            raise NotImplementedError(f"Pascal3DContrast(shape={shape!r}) is not ported "
                                      "to pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
        self.root_dir = root_dir
        self.frame = anno.pascal3d_frame(
            root_dir, annotation_file, train=False, keypoint=keypoint,
            cat_choice=cat_choice, contrast_val_keypoint=True)
        self.input_dim = input_dim
        self.shape = None if shape == "None" else shape
        self.shape_dir = shape_dir
        self.point_num = point_num
        self.random_model = random_model
        self.category_names = (sorted(np.unique(self.frame.cat).tolist())
                               if len(self.frame) else [])
        self._cat_to_id = {c: i for i, c in enumerate(self.category_names)}

    def __len__(self):
        return len(self.frame)

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        """Sample `idx`; `rng` draws the other CAD model and the cloud's
        subset (images draw nothing at evaluation)."""
        row = self.frame.iloc[idx]
        cat, cad_index = row["cat"], row["cad_index"]
        if self.random_model:
            others = self.frame[(self.frame.cat == cat) & (self.frame.cad_index != cad_index)]
            if len(others):
                cad_index = others.iloc[rng.integers(len(others))]["cad_index"]
        label = row[anno.LABEL_COLS].to_numpy(dtype=np.float64)
        im = T.load_rgb(os.path.join(self.root_dir, row["im_path"]))
        im = im.crop((row["left"], row["upper"], row["right"], row["lower"]))
        arr = T.normalize_image(T.to_float_array(T.resize_pad(im, self.input_dim)))
        sample = {"im": arr,
                  "label": T.process_viewpoint_label(label).astype(np.int32),
                  "cat_id": np.int32(self._cat_to_id.get(cat, -1))}
        if self.shape == "PointCloud":
            path = os.path.join(self.root_dir, self.shape_dir, str(cat),
                                "%02d" % int(cad_index), "compressed.ply")
            sample["shape"] = T.sample_pointcloud(ply.load_vertices(path),
                                                  self.point_num, 0, rng)
        return sample
