"""Dataset sample producers (host side, fixed-shape numpy outputs). Port of
`pose3d_tpu/data/datasets.py` `_finalize`, `Pascal3D`, `Pascal3DContrast`,
`ShapeNet`, `Pix3D`, `Linemod` and `Pix3DContrast`, train and evaluation
branches, with images only (`shape=None`), with the object's point cloud
(`shape="PointCloud"`) or with its ring of renders (`shape="MultiView"`),
and the on-device data options of `Pascal3D` and `Pascal3DContrast`:
  * `device_shapes`: a few scalars a sample (`_shape_ref`) in place of its
    cloud or renders, which the step resolves against the bank that
    `build_shape_bank` / `build_render_bank` load once;
  * `host_augment=False` (`Pascal3DContrast`): the views' raw pixels as
    uint8, augmented and normalised in the step (`--device_augment`);
  * `device_views` (`Pascal3DContrast`): one raw uint8 view a train sample
    and its `rot_sign`, the flipped and rotated views built in the step.
JAX's decode cache (`--cache_decoded_mb`) is not ported: every image is
decoded where it is used.

Samples are dicts of numpy arrays: 'im' NHWC float32 (uint8 on the raw
wire), 'label' the canonical int triple, 'cat_id' the index of the
sample's category in `category_names`, so evaluation is one pass reduced
per category, and 'shape' the (point_num, 3) float32 cloud or the
(view_num, H, W, 3) float32 renders. Contrastive train samples also carry
the flipped and the rotated view ('im_flip', 'label_flip', 'im_rot',
'label_rot'). Random draws come from the `rng` the loader passes, in JAX's
order, so the same seed gives the JAX loader's samples.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import pandas as pd
from PIL import Image

from pose3d_tpu_torch.data import annotations as anno
from pose3d_tpu_torch.data import ply
from pose3d_tpu_torch.data import transforms as T


def _finalize(im: Image.Image, rng: np.random.Generator, train: bool,
              contrast: bool, host_augment: bool = True) -> np.ndarray:
    """To float, the train-time photometric augmentation (contrastive:
    color jitter with p 0.8 then grayscale with p 0.2; plain: color
    jitter), ImageNet normalisation, then PCA lighting in training. With
    `host_augment` False: the raw pixels as uint8, and no draw from `rng`
    (the step augments and normalises them, `ops/augment.py`)."""
    if not host_augment:
        return np.asarray(im, np.uint8)
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


def _mutation(random_range: int, rng: np.random.Generator) -> int:
    """The canonical frame's azimuth turn, in 5-degree steps of the 72-step
    render ring: +-8 steps (random_range 0), +-17 (1), or any (2)."""
    if random_range == 0:
        return int(rng.integers(-8, 9)) % 72
    if random_range == 1:
        return int(rng.integers(-17, 18)) % 72
    return int(rng.integers(0, 72))


def _category_ids(frame: pd.DataFrame, column: str) -> tuple[list, dict]:
    names = sorted(np.unique(frame[column]).tolist()) if len(frame) else []
    return names, {c: i for i, c in enumerate(names)}


class _Renders:
    """A model's ring of renders: the `multiview_ids` of its sorted
    `<render_dir>/*` files, each to float in [0, 1] (no normalisation, no
    augmentation). Sorted listings are kept per directory."""

    def __init__(self, view_num: int, tour: int):
        self.view_num = view_num
        self.tour = tour
        self._names: dict[str, list[str]] = {}

    def load(self, render_dir: str, mutation: int, size: int | None) -> np.ndarray:
        """(view_num, H, W, 3) float32; each render resized (bilinear) to
        size x size unless `size` is None."""
        names = self._sorted(render_dir)
        return np.stack([T.to_float_array(self._decode(render_dir, names[i], size))
                         for i in T.multiview_ids(self.view_num, self.tour, mutation)]
                        ).astype(np.float32)

    def load_all(self, render_dir: str, size: int | None) -> np.ndarray:
        """(R, H, W, 3) uint8: every render of the directory, sorted,
        resized as `load` resizes them."""
        return np.stack([np.asarray(self._decode(render_dir, name, size), np.uint8)
                         for name in self._sorted(render_dir)])

    def _sorted(self, render_dir: str) -> list[str]:
        names = self._names.get(render_dir)
        if names is None:
            names = self._names[render_dir] = sorted(os.listdir(render_dir))
        return names

    @staticmethod
    def _decode(render_dir: str, name: str, size: int | None) -> Image.Image:
        im = T.load_rgb(os.path.join(render_dir, name))
        if size is not None:
            im = im.resize((size, size), Image.BILINEAR)
        return im


class _PascalBase:
    """The annotation frame, category ids and the shape loaders."""

    def __init__(self, root_dir, frame, shape, shape_dir, point_num, input_dim,
                 random_model, view_num=12, tour=2):
        if shape not in (None, "None", "PointCloud", "MultiView"):
            raise ValueError(f"shape={shape!r}: None, 'PointCloud' or 'MultiView'")
        self.root_dir = root_dir
        self.frame = frame
        self.shape = None if shape == "None" else shape
        self.shape_dir = shape_dir
        self.point_num = point_num
        self.input_dim = input_dim
        self.random_model = random_model
        self.renders = _Renders(view_num, tour)
        self.category_names, self._cat_to_id = _category_ids(frame, "cat")

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

    def _shape_index(self) -> dict:
        """(cat, cad_index) -> bank row over the frame's distinct CAD
        models, sorted, so that the train and evaluation sets agree."""
        if getattr(self, "_bank_rows", None) is None:
            pairs = sorted({(str(c), int(i)) for c, i in zip(self.frame.cat, self.frame.cad_index)})
            self._bank_rows = {p: k for k, p in enumerate(pairs)}
        return self._bank_rows

    def _model_dir(self, cat, cad_index) -> str:
        return os.path.join(self.root_dir, self.shape_dir, str(cat), "%02d" % int(cad_index))

    def build_shape_bank(self) -> tuple[np.ndarray, np.ndarray]:
        """Every distinct cloud, read once -> ((S, V, 3) f32 zero-padded,
        (S,) int32 counts) for `ops.shape_bank.ShapeBank.from_arrays`."""
        if self.shape != "PointCloud":
            raise ValueError("shape bank requires shape='PointCloud'")
        clouds = [np.asarray(ply.load_vertices(os.path.join(self._model_dir(cat, cad),
                                                            "compressed.ply")), np.float32)
                  for cat, cad in self._shape_index()]
        verts = np.zeros((len(clouds), max(c.shape[0] for c in clouds), 3), np.float32)
        counts = np.zeros((len(clouds),), np.int32)
        for k, c in enumerate(clouds):
            verts[k, :c.shape[0]] = c
            counts[k] = c.shape[0]
        return verts, counts

    def build_render_bank(self) -> tuple[np.ndarray, np.ndarray]:
        """Every distinct model's whole render set, decoded once ->
        ((S, R, H, W, 3) u8, (72, K) int32 id table) for
        `ops.shape_bank.RenderBank.from_arrays`. Renders resized to
        input_dim as `_shape` resizes them (at 224 the files' own size).
        Refuses a bank above 8 GiB, with JAX's message."""
        if self.shape != "MultiView":
            raise ValueError("render bank requires shape='MultiView'")
        size = None if self.input_dim == 224 else self.input_dim
        stacks = [self.renders.load_all(os.path.join(self._model_dir(cat, cad), "crop"), size)
                  for cat, cad in self._shape_index()]
        r = {s.shape[0] for s in stacks}
        if len(r) != 1:
            raise ValueError(f"render sets differ in size across models: {r}")
        nbytes = sum(s.nbytes for s in stacks)
        if nbytes > 8 << 30:
            raise SystemExit(
                f"render bank would need {nbytes / (1 << 30):.1f} GiB "
                "HBM — too large for --device_shapes; drop the flag (host "
                "render path) or reduce the model set")
        renders = np.stack(stacks)
        id_table = np.stack([T.multiview_ids(self.renders.view_num, self.renders.tour, m)
                             for m in range(72)]).astype(np.int32)
        return renders, id_table

    def _emit_shape(self, sample: dict, cat, cad_index, mutation, rng) -> None:
        """The sample's shape: the cloud or renders themselves, or with
        `device_shapes` their bank reference (`_shape_ref`)."""
        if getattr(self, "device_shapes", False):
            sample.update(self._shape_ref(cat, cad_index, mutation, rng))
        else:
            sample["shape"] = self._shape(cat, cad_index, mutation, rng)

    def _shape_ref(self, cat, cad_index, mutation, rng) -> dict[str, Any]:
        """The scalars that stand for the shape with `device_shapes`: the
        bank row and the mutation (MultiView; the views are the id table's
        row), or the bank row, the z-rotation in degrees and the subset's
        seed, one u32 drawn from `rng` where the host path draws its subset
        (PointCloud)."""
        row = self._shape_index()[(str(cat), int(cad_index))]
        if self.shape == "MultiView":
            return {"shape_id": np.int32(row), "shape_mut": np.int32(mutation)}
        if self.shape != "PointCloud":
            raise ValueError("device_shapes requires PointCloud or MultiView")
        return {"shape_id": np.int32(row), "shape_rot": np.float32(mutation),
                "shape_seed": rng.integers(0, 2**32, dtype=np.uint32)}

    def _shape(self, cat, cad_index, mutation, rng) -> np.ndarray:
        """The cloud under `<shape_dir>/<cat>/<XX>/compressed.ply`, turned by
        `mutation` 5-degree steps, or the renders under `.../<XX>/crop/`
        rolled by `mutation` ring steps (resized to input_dim when it is not
        224: at 224 the files' own size is kept, as in JAX)."""
        model_dir = self._model_dir(cat, cad_index)
        if self.shape == "MultiView":
            return self.renders.load(os.path.join(model_dir, "crop"), mutation,
                                     None if self.input_dim == 224 else self.input_dim)
        return T.sample_pointcloud(ply.load_vertices(os.path.join(model_dir, "compressed.ply")),
                                   self.point_num, mutation, rng)


class Pascal3D(_PascalBase):
    """Pascal3D+ / ObjectNet3D samples (the reference's Pascal3D). Train:
    blur, jittered crop, flip and rotation with their label fixes,
    photometric augmentation; with `random`, the canonical frame's azimuth
    turns by a random multiple of 5 degrees (the shape with it). Eval: the
    bounding-box crop. With `device_shapes` the shape's bank reference
    (`_shape_ref`) stands in for it."""

    def __init__(self, root_dir, annotation_file, input_dim=224, shape=None,
                 shape_dir="pointcloud", random=False, novel=True, keypoint=True, train=True,
                 cat_choice=None, random_range=0, point_num=2500, view_num=12, tour=2,
                 device_shapes=False):
        frame = anno.pascal3d_frame(root_dir, annotation_file, train=train, keypoint=keypoint,
                                    novel=novel, cat_choice=cat_choice)
        super().__init__(root_dir, frame, shape, shape_dir, point_num, input_dim,
                         random_model=False, view_num=view_num, tour=tour)
        self.train = train
        self.random = random
        self.random_range = random_range
        self.device_shapes = device_shapes

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
            mutation = _mutation(self.random_range, rng)
            sample["label"] = sample["label"].copy()
            sample["label"][0] = (sample["label"][0] - mutation * 5) % 360
        self._emit_shape(sample, cat, cad_index, mutation, rng)
        return sample


class Pascal3DContrast(_PascalBase):
    """Pascal3D+ / ObjectNet3D samples (the reference's Pascal3DContrast).
    Train: blur, jittered crop, then three views, each resize-padded and
    photometrically augmented: rotated by +-15 degrees, flipped, and the
    original. Eval: the bounding-box crop, resize-padded to `input_dim` and
    ImageNet-normalized. With a shape, the object's cloud of `point_num`
    points or its renders, unturned, in training and at validation (the
    reference emits no renders at validation, which its MultiView
    evaluation cannot unpack; JAX emits them, and so does the port);
    `random_model` takes another CAD model of the same category.
    `host_augment` False emits the train views' raw pixels as uint8;
    `device_views` emits one raw uint8 train view, its three labels and
    `rot_sign` (+-1, the rotated view's sign), the other views built in the
    step; `device_shapes` emits the shape's bank reference."""

    def __init__(self, root_dir, annotation_file, input_dim=224, keypoint=True,
                 cat_choice=None, shape=None, shape_dir="pointcloud", point_num=2500,
                 random_model=False, train=False, novel=False, shot=None, seed=None,
                 view_num=12, tour=2, host_augment=True, device_views=False,
                 device_shapes=False):
        frame = anno.pascal3d_frame(root_dir, annotation_file, train=train, keypoint=keypoint,
                                    novel=novel, cat_choice=cat_choice, shot=shot,
                                    contrast_val_keypoint=not train, seed=seed)
        super().__init__(root_dir, frame, shape, shape_dir, point_num, input_dim,
                         random_model, view_num=view_num, tour=tour)
        self.train = train
        self.host_augment = host_augment
        self.device_views = device_views
        self.device_shapes = device_shapes

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        """Sample `idx`; `rng` draws the other CAD model, the augmentation
        and the cloud's subset (or its seed), in JAX's order."""
        row, cat, cad_index, label = self._row(idx, rng)
        left, upper, right, lower = row["left"], row["upper"], row["right"], row["lower"]
        im = T.load_rgb(os.path.join(self.root_dir, row["im_path"]))
        cat_id = np.int32(self._cat_to_id.get(cat, -1))
        if self.train:
            if min(right - left, lower - upper) > 224 and rng.random() > 0.5:
                im = T.gaussian_blur(im, int(rng.integers(1, 5)))
            im = T.random_crop(im, left, upper, right - left, lower - upper, rng)
            r = float(rng.choice([-15, 15]))
            if self.device_views:
                sample = {"im": _finalize(T.resize_pad(im, self.input_dim), rng, True, True,
                                          host_augment=False),
                          "label": T.process_viewpoint_label(label).astype(np.int32),
                          "label_flip": T.process_viewpoint_label(
                              T.flip_label(label)).astype(np.int32),
                          "label_rot": T.process_viewpoint_label(
                              T.rotate_label(label, r)).astype(np.int32),
                          "rot_sign": np.float32(np.sign(r))}
            else:
                sample = _three_views(im, label, r, self.input_dim, rng,
                                      host_augment=self.host_augment)
            sample["cat_id"] = cat_id
        else:
            im = im.crop((left, upper, right, lower))
            arr = _finalize(T.resize_pad(im, self.input_dim), rng, train=False,
                            contrast=True)
            sample = {"im": arr, "label": T.process_viewpoint_label(label).astype(np.int32),
                      "cat_id": cat_id}
        if self.shape is not None:
            self._emit_shape(sample, cat, cad_index, 0, rng)
        return sample


def _three_views(im: Image.Image, label: np.ndarray, r: float, input_dim: int,
                 rng: np.random.Generator, offset: float = 0.0,
                 host_augment: bool = True) -> dict[str, np.ndarray]:
    """The contrastive train views of a cropped image, augmented in JAX's
    order (raw uint8 pixels without `host_augment`): rotated by `r`
    degrees, flipped, and the original, with their labels."""
    views = {}
    for key, view, view_label in (
            ("_rot", im.rotate(r), T.rotate_label(label, r)),
            ("_flip", im.transpose(Image.FLIP_LEFT_RIGHT), T.flip_label(label)),
            ("", im, label)):
        views["im" + key] = _finalize(T.resize_pad(view, input_dim), rng, train=True,
                                      contrast=True, host_augment=host_augment)
        views["label" + key] = T.process_viewpoint_label(view_label, offset).astype(np.int32)
    return views


def _center_or_random_crop(arr: np.ndarray, size: int, rng: np.random.Generator,
                           random_crop: bool) -> np.ndarray:
    """A size x size window of HWC `arr` (zero-padded to it first where it
    is smaller): at a random place, or centred."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        pad_h, pad_w = max(0, size - h), max(0, size - w)
        arr = np.pad(arr, ((pad_h // 2, pad_h - pad_h // 2),
                           (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        h, w = arr.shape[:2]
    if random_crop:
        top = int(rng.integers(0, h - size + 1))
        left = int(rng.integers(0, w - size + 1))
    else:
        top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


class ShapeNet(_PascalBase):
    """ShapeNetCore renders composited over random SUN backgrounds (the
    reference's ShapeNet). The render turns by a clipped normal in-plane
    angle, is pasted through its alpha over a background of its size (a
    white one where the drawn background is missing or another size), then
    in training blurred (p 0.3), flipped (p 0.5), color-jittered and cropped
    at random to 224 x 224 (centred at validation) whatever `input_dim`,
    normalised, and PCA-lit in training. With a shape, the model's ring of
    renders under `<shape_dir>/<cat:08d>/<example_id>/crop/` at the files'
    own size, rolled with `random` as in `Pascal3D`."""

    def __init__(self, root_dir, annotation_file, bg_dir, bg_list="SUN_database.txt",
                 input_dim=224, model_number=200, novel=False, shape="MultiView",
                 shape_dir="Renders_semi_sphere", view_num=12, tour=2, random_range=0,
                 point_num=2500, cat_choice=None, train=True, random=False):
        frame = anno.shapenet_frame(root_dir, annotation_file, train=train, novel=novel,
                                    cat_choice=cat_choice, model_number=model_number)
        super().__init__(root_dir, frame.rename(columns={"cat_id": "cat"}), shape,
                         shape_dir, point_num, input_dim, random_model=False,
                         view_num=view_num, tour=tour)
        self.bg_dir = bg_dir
        self.bg_list = pd.read_csv(os.path.join(bg_dir, bg_list))
        self.train = train
        self.random = random
        self.random_range = random_range

    def _background(self, size, rng: np.random.Generator) -> Image.Image:
        path = os.path.join(self.bg_dir,
                            self.bg_list.iloc[int(rng.integers(len(self.bg_list))), 1])
        try:
            bg = T.load_rgb(path)
            if bg.size == size:
                return bg
        except OSError:
            pass
        return Image.new("RGB", size, (255, 255, 255))

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        row = self.frame.iloc[idx]
        cat, example_id = row["cat"], row["example_id"]
        label = np.array([row["azimuth"], row["elevation"], 0.0], np.float64)

        render = Image.open(os.path.join(self.root_dir, row["image_path"]))
        r = max(-45, min(45, rng.standard_normal() * 15))
        render = render.rotate(r)
        label[2] += r
        im = self._background(render.size, rng).copy()
        im.paste(render, (0, 0), render if render.mode == "RGBA" else None)

        if self.train:
            if rng.random() < 0.3:
                im = T.gaussian_blur(im, 3)
            if rng.random() > 0.5:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
                label[0] = (360 - label[0]) % 360
                label[2] = -label[2]
            arr = T.color_jitter(T.to_float_array(im), rng)
            arr = T.normalize_image(_center_or_random_crop(arr, 224, rng, random_crop=True))
            arr = T.pca_lighting(arr, rng)
        else:
            arr = _center_or_random_crop(T.to_float_array(im), 224, rng, random_crop=False)
            arr = T.normalize_image(arr)
        label[1] += 90.0
        label[2] += 180.0

        sample = {"im": arr.astype(np.float32), "label": label.astype(np.int64).astype(np.int32),
                  "cat_id": np.int32(self._cat_to_id.get(cat, -1))}
        if self.shape is None:
            return sample
        mutation = 0
        if self.random:
            mutation = _mutation(self.random_range, rng)
            sample["label"][0] = (sample["label"][0] - mutation * 5) % 360
        render_dir = os.path.join(self.root_dir, self.shape_dir, "%08d" % int(cat),
                                  str(example_id), "crop")
        sample["shape"] = self.renders.load(render_dir, mutation, None)
        return sample


class Pix3D:
    """Pix3D evaluation samples (the reference's Pix3D): the whole image,
    resized (bilinear) to input_dim x input_dim unless it is 224 x 224
    already, normalised; labels in Pix3D's units (`pix3d_frame`). No shape:
    the reference's Pix3D carries none."""

    def __init__(self, root_dir, annotation_file, input_dim=224, cat_choice=None):
        self.root_dir = root_dir
        self.input_dim = input_dim
        self.frame = anno.pix3d_frame(root_dir, annotation_file, cat_choice)
        self.category_names, self._cat_to_id = _category_ids(self.frame, "cat_id")

    def __len__(self):
        return len(self.frame)

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        row = self.frame.iloc[idx]
        label = row[anno.LABEL_COLS].to_numpy(dtype=np.float64).astype(np.int64)
        im = T.load_rgb(os.path.join(self.root_dir, row["image_path"]))
        if self.input_dim != 224 or im.size != (self.input_dim, self.input_dim):
            im = im.resize((self.input_dim, self.input_dim), Image.BILINEAR)
        arr = T.normalize_image(T.to_float_array(im))
        return {"im": arr.astype(np.float32), "label": label.astype(np.int32),
                "cat_id": np.int32(self._cat_to_id.get(row["cat_id"], -1))}


class Linemod:
    """LineMod evaluation samples (the reference's Linemod): the (x, y, w,
    h) box, resize-padded and normalised; labels in LineMod's units
    (elevation + 90, in-plane (180 - inp) mod 360). No shape."""

    def __init__(self, root_dir, annotation_file, input_dim=224, cat_choice=None):
        self.root_dir = root_dir
        self.input_dim = input_dim
        self.frame = anno.linemod_frame(root_dir, annotation_file, cat_choice)
        self.category_names, self._cat_to_id = _category_ids(self.frame, "obj_id")

    def __len__(self):
        return len(self.frame)

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        row = self.frame.iloc[idx]
        x, y, w, h = row["x"], row["y"], row["w"], row["h"]
        label = row[anno.LABEL_COLS].to_numpy(dtype=np.float64)
        im = T.load_rgb(os.path.join(self.root_dir, row["image_path"]))
        arr = T.normalize_image(T.to_float_array(
            T.resize_pad(im.crop((x, y, x + w, y + h)), self.input_dim)))
        label[1] = label[1] + 90.0
        label[2] = (-label[2] + 180.0) % 360.0
        return {"im": arr.astype(np.float32),
                "label": label.astype(np.int64).astype(np.int32),
                "cat_id": np.int32(self._cat_to_id.get(row["obj_id"], -1))}


class Pix3DContrast:
    """Pix3D samples in the contrastive layout (the reference's
    Pix3DContrast). Train: blur, two jittered crops (the second the
    positive view 'im_pos'), then the rotated (+-`rot` degrees), flipped
    and original views as `Pascal3DContrast`'s, labels offset by `offset`;
    with `pose_batch`, each batch of `bs` draws from one 30-degree azimuth
    bucket (`_remap`). Eval: the box crop, resize-padded and normalised."""

    def __init__(self, root_dir, annotation_file, train=True, input_dim=224, offset=0,
                 shot=None, train_feat=False, cls_choice=None, idx_choice=None, rot=0,
                 train_cls=None, pose_batch=False, bs=32, seed=None):
        self.root_dir = root_dir
        self.input_dim = input_dim
        self.train = train
        self.offset = offset
        self.rot = rot
        self.frame = anno.pix3d_contrast_frame(
            root_dir, annotation_file, train=train, train_feat=train_feat,
            cls_choice=cls_choice, train_cls=train_cls, shot=shot, idx_choice=idx_choice,
            seed=seed)
        self.category_names, self._cat_to_id = _category_ids(self.frame, "cls_name")
        self.pose_batch = pose_batch
        self.bs = bs
        if pose_batch:
            self.pose_index = {i: [] for i in range(12)}
            for i, azimuth in enumerate(self.frame["azimuth"]):
                self.pose_index[int(azimuth // 30)].append(i)

    def __len__(self):
        return len(self.frame)

    def _remap(self, idx: int) -> int:
        """The pose-balanced index: batch b draws from bucket b mod 12."""
        bucket = self.pose_index[(idx // self.bs) % 12]
        if not bucket:
            return idx % len(self.frame)
        return bucket[(self.bs * idx // (12 * self.bs) + idx % self.bs) % len(bucket)]

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, Any]:
        if self.pose_batch:
            idx = self._remap(idx)
        row = self.frame.iloc[idx]
        left, upper, right, lower = row["left"], row["upper"], row["right"], row["lower"]
        label = row[anno.LABEL_COLS].to_numpy(dtype=np.float64)
        im = T.load_rgb(os.path.join(self.root_dir, row["im_path"]))
        cat_id = np.int32(self._cat_to_id.get(row["cls_name"], -1))
        if self.train:
            im_pos = im.copy()
            if min(right - left, lower - upper) > 224 and rng.random() > 0.5:
                im = T.gaussian_blur(im, int(rng.integers(1, 5)))
            im = T.random_crop(im, left, upper, right - left, lower - upper, rng)
            im_pos = T.random_crop(im_pos, left, upper, right - left, lower - upper, rng)
            arr_pos = _finalize(T.resize_pad(im_pos, self.input_dim), rng, True, True)
            r = float(rng.choice([-self.rot, self.rot]))
            sample = _three_views(im, label, r, self.input_dim, rng, self.offset)
            sample.update(cls_index=cat_id, im_pos=arr_pos, cat_id=cat_id)
            return sample
        im = im.crop((left, upper, right, lower))
        arr = _finalize(T.resize_pad(im, self.input_dim), rng, False, True)
        return {"im": arr,
                "label": T.process_viewpoint_label(label, self.offset).astype(np.int32),
                "cat_id": cat_id}
