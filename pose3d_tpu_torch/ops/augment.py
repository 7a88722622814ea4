"""The u8 image wire and the on-device image augmentation. Port of
`pose3d_tpu/ops/augment.py` (`dewire`, `_grayscale`, `device_augment`,
`device_normalize`, `_rotation_index_grid`, `rotate_views`,
`synthesize_views`).

Loaders may ship images across the host-to-device copy as uint8 (a quarter
of the bytes of float32); the step turns them back into the host's float
[0, 1] pixels (`dewire`). With `--device_augment` the loader emits those
raw pixels and the step applies, per image,
  * ColorJitter(brightness, contrast, saturation 0.5) with p 0.8, in the
    fixed order brightness, contrast, saturation (the reference draws the
    order per sample; JAX fixes it, and so does the port),
  * RandomGrayscale p 0.2,
  * the ImageNet normalisation,
  * the PCA lighting noise (alphastd 0.1).
With `--device_views` the loader emits one view a sample and the step
builds the flipped and the +-15 degree rotated views from it
(`synthesize_views`): the flip mirrors the letterboxed canvas, and the
rotation (PIL's nearest-neighbour `Image.rotate`, black fill) turns the
canvas, not the crop before its resize, as in JAX.

The draws of `device_augment` come from an explicit `torch.Generator`
(`augment_draws`), or are given, as the tests give JAX's. Everything here
is plain PyTorch on every device: JAX computes it outside any Pallas
kernel. Constants and index grids are cached on each device, so a step
makes no host-to-device copy for them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pose3d_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_PCA_EIGVAL,
                                              IMAGENET_PCA_EIGVEC, IMAGENET_STD)

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)
# the draws of one device_augment call, each (N,) but alpha (N, 3)
AUG_DRAW_KEYS = ("apply", "fb", "fc", "fs", "gray", "alpha")


@functools.cache
def _u8_scale(device: torch.device) -> torch.Tensor:
    return torch.tensor(255.0, dtype=torch.float32, device=device)


def dewire(im: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 / 255, correctly rounded on every device (as
    `data.transforms.to_float_array`; JAX's is one ulp off where XLA
    multiplies by the reciprocal); float tensors pass through untouched, so
    a step takes both wires. The divisor is a tensor on the pixels' device:
    CUDA divides by a Python scalar as a product with its reciprocal."""
    if im.dtype == torch.uint8:
        return torch.true_divide(im, _u8_scale(im.device))
    return im


@functools.cache
def _constants(device: torch.device) -> dict[str, torch.Tensor]:
    """The luma weights, the ImageNet mean and std, and the PCA lighting's
    (3, 3) eigenvectors scaled by their eigenvalues, as f32 on `device`."""
    return {"luma": torch.from_numpy(_LUMA).to(device),
            "mean": torch.from_numpy(IMAGENET_MEAN).to(device),
            "std": torch.from_numpy(IMAGENET_STD).to(device),
            "pca": torch.from_numpy(IMAGENET_PCA_EIGVEC * IMAGENET_PCA_EIGVAL[None, :]).to(device)}


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> its luma repeated over the 3 channels."""
    g = (x * _constants(x.device)["luma"].to(x.dtype)).sum(-1, keepdim=True)
    return g.expand(x.shape)


def augment_draws(n: int, generator: torch.Generator | None, device, jitter: float = 0.5,
                  jitter_p: float = 0.8, grayscale_p: float = 0.2,
                  pca_std: float = 0.1) -> dict[str, torch.Tensor]:
    """The random draws of `device_augment` for n images, from `generator`
    on `device`: whether the jitter applies (p `jitter_p`), its brightness,
    contrast and saturation factors (uniform in [1 - jitter, 1 + jitter]),
    whether the image turns gray (p `grayscale_p`) and the PCA lighting's
    (n, 3) alphas (normal, std `pca_std`)."""
    def uniform(shape=(n,)):
        return torch.rand(shape, generator=generator, device=device)

    apply = uniform() < jitter_p
    fb, fc, fs = (1.0 - jitter + 2.0 * jitter * uniform() for _ in range(3))
    gray = uniform() < grayscale_p
    alpha = pca_std * torch.randn((n, 3), generator=generator, device=device)
    return {"apply": apply, "fb": fb, "fc": fc, "fs": fs, "gray": gray, "alpha": alpha}


def device_augment(images: torch.Tensor, generator: torch.Generator | None = None,
                   draws: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """(N, H, W, 3) float [0, 1] raw pixels -> normalised augmented images,
    in f32 (JAX's `device_augment`): the jitter where `apply`, brightness x
    fb, contrast towards the image's mean luma by fc, saturation towards
    each pixel's luma by fs, clipped to [0, 1]; luma where `gray`; the
    ImageNet normalisation; plus the PCA lighting's per-image RGB shift.
    `draws` (`AUG_DRAW_KEYS`) are taken from `generator` unless given."""
    n = images.shape[0]
    d = draws if draws is not None else augment_draws(n, generator, images.device)
    k = _constants(images.device)
    x = images.to(torch.float32)

    def per_image(v):
        return v.to(torch.float32).reshape(n, 1, 1, 1)

    jittered = x * per_image(d["fb"])
    mean_gray = _grayscale(jittered)[..., :1].mean(dim=(1, 2, 3), keepdim=True)
    fc, fs = per_image(d["fc"]), per_image(d["fs"])
    jittered = fc * jittered + (1.0 - fc) * mean_gray
    jittered = fs * jittered + (1.0 - fs) * _grayscale(jittered)
    jittered = jittered.clamp(0.0, 1.0)
    x = torch.where(d["apply"].reshape(n, 1, 1, 1), jittered, x)
    x = torch.where(d["gray"].reshape(n, 1, 1, 1), _grayscale(x), x)
    x = (x - k["mean"]) / k["std"]
    rgb = d["alpha"].to(torch.float32) @ k["pca"].T                   # (N, 3)
    return x + rgb[:, None, None, :]


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """The evaluation path's equivalent: the ImageNet normalisation alone."""
    k = _constants(images.device)
    return ((images.to(torch.float32) - k["mean"]) / k["std"]).to(images.dtype)


def _rotation_index_grid(h: int, w: int, angle_deg: float) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-neighbour gather indices of PIL's `Image.rotate(angle)`
    (expand False, black fill), in numpy as JAX builds them: each output
    pixel centre (x + 0.5, y + 0.5) turned back about (w / 2, h / 2) and
    floored. Returns (flat index (h*w,) int32, valid (h*w,) bool)."""
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    ys, xs = np.mgrid[0:h, 0:w]
    xo = xs + 0.5 - w / 2.0
    yo = ys + 0.5 - h / 2.0
    sx = np.floor(c * xo - s * yo + w / 2.0).astype(np.int32)
    sy = np.floor(s * xo + c * yo + h / 2.0).astype(np.int32)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    flat = np.where(valid, sy * w + sx, 0).astype(np.int32)
    return flat.reshape(-1), valid.reshape(-1)


@functools.cache
def _rotation_grid(h: int, w: int, angle_deg: float, device: torch.device):
    """`_rotation_index_grid` on `device` (int64 index, bool valid), built
    once per (h, w, angle, device)."""
    flat, valid = _rotation_index_grid(h, w, angle_deg)
    return (torch.from_numpy(flat.astype(np.int64)).to(device),
            torch.from_numpy(valid).to(device))


def rotate_views(images: torch.Tensor, rot_sign: torch.Tensor,
                 angle_deg: float = 15.0) -> torch.Tensor:
    """(N, H, W, C) images, each turned by rot_sign * angle_deg (rot_sign
    (N,) +-1) as PIL turns it: one batched gather through the two grids."""
    n, h, w, ch = images.shape
    idx_p, val_p = _rotation_grid(h, w, float(angle_deg), images.device)
    idx_m, val_m = _rotation_grid(h, w, -float(angle_deg), images.device)
    pos = (rot_sign > 0)[:, None]
    idx = torch.where(pos, idx_p[None, :], idx_m[None, :])
    valid = torch.where(pos, val_p[None, :], val_m[None, :])
    out = images.reshape(n, h * w, ch).gather(1, idx[..., None].expand(n, h * w, ch))
    return out.masked_fill(~valid[..., None], 0).reshape(n, h, w, ch)


def synthesize_views(images: torch.Tensor, rot_sign: torch.Tensor,
                     angle_deg: float = 15.0) -> torch.Tensor:
    """One view a sample (N, H, W, C) -> the 3N views [base | flip | rot],
    the order of the host's three-view batch: the flip an exact mirror of
    the canvas, the rotation `rotate_views`."""
    return torch.cat([images, images.flip(2), rotate_views(images, rot_sign, angle_deg)])
