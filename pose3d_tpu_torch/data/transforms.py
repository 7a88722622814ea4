"""Host-side image transforms, point sampling and label algebra, evaluation
subset. Port of `pose3d_tpu/data/transforms.py` (`resize_pad`,
`normalize_image`, `to_float_array`, `sample_pointcloud`,
`process_viewpoint_label`), plus `load_rgb`; numpy and PIL only."""

from __future__ import annotations

import math

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_rgb(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


def resize_pad(im: Image.Image, dim: int) -> Image.Image:
    """Aspect-preserving resize of the longest side to `dim`, center-padded."""
    w, h = im.size
    if max(w, h) == 0:
        return Image.new(im.mode, (dim, dim))
    # torchvision F.resize(size=int) scales the SHORT side to int; the
    # reference passes int(dim * min/max) so the LONG side lands on dim
    target_short = int(dim * min(w, h) / max(w, h))
    scale = target_short / min(w, h) if min(w, h) else 1.0
    new_size = (max(1, round(w * scale)), max(1, round(h * scale)))
    im = im.resize(new_size, Image.BILINEAR)
    new_im = Image.new(im.mode if im.mode == "RGB" else "RGB", (dim, dim))
    new_im.paste(im, ((dim - new_size[0] + 1) // 2, (dim - new_size[1] + 1) // 2))
    return new_im


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """float [0,1] HWC -> ImageNet-normalized float32."""
    return ((arr - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def to_float_array(im: Image.Image) -> np.ndarray:
    return np.asarray(im, np.float32) / 255.0


def sample_pointcloud(vertices: np.ndarray, point_num: int, rotation_deg: float,
                      rng: np.random.Generator) -> np.ndarray:
    """A random subset of `point_num` vertices (with replacement only when
    there are fewer), rotated about z, then min-max normalised to [0, 1] over
    all coordinates in float64 -> (point_num, 3) float32."""
    replace = vertices.shape[0] < point_num
    idx = rng.choice(vertices.shape[0], point_num, replace=replace)
    pts = vertices[idx].astype(np.float64)
    if rotation_deg != 0:
        a = math.radians(rotation_deg)
        rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                        [np.sin(a), np.cos(a), 0.0],
                        [0.0, 0.0, 1.0]])
        pts = pts @ rot.T
    pts = pts - pts.min()
    m = pts.max()
    if m > 0:
        pts = pts / m
    return pts.astype(np.float32)


def process_viewpoint_label(label: np.ndarray, offset: float = 0.0) -> np.ndarray:
    """Annotation triple (azi, ele, inp) -> canonical int triple:
    azi = (360 - azi + offset) % 360, ele += 90, inp = (inp + 180) % 360."""
    label = np.asarray(label, np.float64).copy()
    label[0] = (360.0 - label[0] + offset) % 360.0
    label[1] = label[1] + 90.0
    label[2] = (label[2] + 180.0) % 360.0
    return label.astype(np.int64)
