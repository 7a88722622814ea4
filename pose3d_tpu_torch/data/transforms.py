"""Host-side image transforms, point sampling and label algebra. Port of
`pose3d_tpu/data/transforms.py` (`random_crop`, `resize_pad`,
`gaussian_blur`, `color_jitter`, `random_grayscale`, `pca_lighting`,
`normalize_image`, `to_float_array`, `sample_pointcloud`,
`process_viewpoint_label`, `flip_label`, `rotate_label`), plus `load_rgb`;
numpy and PIL only. Random draws come from the caller's numpy Generator in
JAX's order, so one seed gives JAX's samples."""

from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageFilter

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMAGENET_PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
IMAGENET_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                                [-0.5808, -0.0045, -0.8140],
                                [-0.5836, -0.6948, 0.4203]], np.float32)


def load_rgb(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


def random_crop(im: Image.Image, x, y, w, h, rng: np.random.Generator) -> Image.Image:
    """The box (x, y, w, h) with up to +-10 % jitter on each side."""
    left = max(0, x + int(rng.uniform(-0.1, 0.1) * w))
    upper = max(0, y + int(rng.uniform(-0.1, 0.1) * h))
    right = min(im.size[0], x + int(rng.uniform(0.9, 1.1) * w))
    lower = min(im.size[1], y + int(rng.uniform(0.9, 1.1) * h))
    return im.crop((left, upper, right, lower))


def gaussian_blur(im: Image.Image, radius: float) -> Image.Image:
    return im.filter(ImageFilter.GaussianBlur(radius))


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


def color_jitter(arr: np.ndarray, rng: np.random.Generator, brightness: float = 0.5,
                 contrast: float = 0.5, saturation: float = 0.5) -> np.ndarray:
    """ColorJitter on float [0, 1] HWC as the JAX package runs it: a factor
    drawn uniform in [max(0, 1 - v), 1 + v] for brightness, contrast and
    saturation, the three applied in a random order, then clipped. JAX's
    three closures bind their factor late, so all three apply the LAST
    factor drawn; the port does the same, so one seed gives JAX's pixels
    (ROADMAP.md Queue 3)."""
    draws = [rng.uniform(max(0.0, 1 - v), 1 + v)
             for v in (brightness, contrast, saturation) if v]
    f = draws[-1] if draws else 1.0
    ops = [op for op, v in ((lambda a: a * f, brightness),
                            (lambda a: _blend(a, _gray(a).mean(), f), contrast),
                            (lambda a: _blend(a, _gray(a)[..., None], f), saturation)) if v]
    for i in rng.permutation(len(ops)):
        arr = ops[i](arr)
    return np.clip(arr, 0.0, 1.0)


def _gray(a: np.ndarray) -> np.ndarray:
    return a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114


def _blend(a, b, f):
    return f * a + (1.0 - f) * b


def random_grayscale(arr: np.ndarray, rng: np.random.Generator, p: float = 0.2) -> np.ndarray:
    if rng.random() < p:
        g = _gray(arr)
        arr = np.stack([g, g, g], axis=-1)
    return arr


def pca_lighting(arr: np.ndarray, rng: np.random.Generator,
                 alphastd: float = 0.1) -> np.ndarray:
    """AlexNet-style PCA lighting noise on HWC."""
    alpha = rng.normal(0.0, alphastd, size=3).astype(np.float32)
    rgb = (IMAGENET_PCA_EIGVEC * alpha[None, :] * IMAGENET_PCA_EIGVAL[None, :]).sum(1)
    return arr + rgb[None, None, :]


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


def flip_label(label: np.ndarray) -> np.ndarray:
    """Horizontal flip on the raw annotation triple: azi -> 360 - azi,
    inp -> -inp."""
    label = np.asarray(label, np.float64).copy()
    label[0] = 360.0 - label[0]
    label[2] = -label[2]
    return label


def rotate_label(label: np.ndarray, r_deg: float) -> np.ndarray:
    """In-plane rotation on the raw annotation triple: inp += r, wrapped
    into (-180, 180]."""
    label = np.asarray(label, np.float64).copy()
    label[2] = label[2] + r_deg
    if label[2] < -180:
        label[2] += 360
    elif label[2] > 180:
        label[2] -= 360
    return label
