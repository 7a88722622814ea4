"""Dataset sample producers (host side, fixed-shape numpy outputs). Port of
`pose3d_tpu/data/datasets.py Pascal3DContrast`, evaluation branch, images
only (`shape=None`); the shape-carrying and training branches come with the
teacher and the trainers (ROADMAP.md Queue 1).

Samples are dicts of numpy arrays: 'im' NHWC float32, 'label' the canonical
int triple, 'cat_id' the index of the sample's category in
`category_names`, so evaluation is one pass reduced per category.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from pose3d_tpu_torch.data import annotations as anno
from pose3d_tpu_torch.data import transforms as T


class Pascal3DContrast:
    """Pascal3D+ / ObjectNet3D evaluation samples: the bounding-box crop,
    resize-padded to `input_dim` and ImageNet-normalized."""

    def __init__(self, root_dir, annotation_file, input_dim=224, keypoint=True,
                 cat_choice=None):
        self.root_dir = root_dir
        self.frame = anno.pascal3d_frame(
            root_dir, annotation_file, train=False, keypoint=keypoint,
            cat_choice=cat_choice, contrast_val_keypoint=True)
        self.input_dim = input_dim
        self.category_names = (sorted(np.unique(self.frame.cat).tolist())
                               if len(self.frame) else [])
        self._cat_to_id = {c: i for i, c in enumerate(self.category_names)}

    def __len__(self):
        return len(self.frame)

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        """Sample `idx`; `rng` is unused, since evaluation draws nothing."""
        row = self.frame.iloc[idx]
        label = row[anno.LABEL_COLS].to_numpy(dtype=np.float64)
        im = T.load_rgb(os.path.join(self.root_dir, row["im_path"]))
        im = im.crop((row["left"], row["upper"], row["right"], row["lower"]))
        arr = T.normalize_image(T.to_float_array(T.resize_pad(im, self.input_dim)))
        return {"im": arr,
                "label": T.process_viewpoint_label(label).astype(np.int32),
                "cat_id": np.int32(self._cat_to_id.get(row["cat"], -1))}
