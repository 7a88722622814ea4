"""Weights bridge from the JAX package, and the reader of reference `.pth` files.

`baseline_state_dict` turns the JAX `BaselineEstimator`'s
{"params", "batch_stats"} tree (numpy arrays) into the port's state_dict,
mirroring `pose3d_tpu/train/torch_export.py export_baseline_estimator`:
  flax Dense kernel (in, out)        -> Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  flax BatchNorm scale/bias + batch_stats mean/var
                                     -> weight/bias/running_mean/running_var
  classifier.0's input axis          -> permuted from flax's (H, W, C)
                                        flatten to torch's (C, H, W)
The result loads into `models.estimators.BaselineEstimator` with strict=True.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pose3d_tpu_torch.models.estimators import HEADS

_VGG_CONVS = (0, 3, 6, 8, 11, 13, 16, 18)  # cfg A conv positions in `features`


def _linear(p, sd, prefix):
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{prefix}.bias"] = p["bias"]


def _conv2d(p, sd, prefix):
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{prefix}.bias"] = p["bias"]


def _mlp(params, stats, sd, prefix, start, n):
    """flax DenseBNRelu_{start..start+n-1} -> Sequential [Linear, BN, ReLU]*n."""
    for i in range(n):
        sub = f"DenseBNRelu_{start + i}"
        _linear(params[sub]["Dense_0"], sd, f"{prefix}.{3 * i}")
        bn, st = params[sub]["BatchNorm_0"], stats[sub]["BatchNorm_0"]
        bn_prefix = f"{prefix}.{3 * i + 1}"
        sd[f"{bn_prefix}.weight"] = bn["scale"]
        sd[f"{bn_prefix}.bias"] = bn["bias"]
        sd[f"{bn_prefix}.running_mean"] = st["mean"]
        sd[f"{bn_prefix}.running_var"] = st["var"]
        sd[f"{bn_prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def baseline_state_dict(variables) -> dict[str, torch.Tensor]:
    """JAX BaselineEstimator variables (numpy) -> the port's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    vgg = params["VGG_0"]
    sd: dict = {}
    for i, t in enumerate(_VGG_CONVS):
        _conv2d(vgg[f"Conv_{i}"], sd, f"img_encoder.features.{t}")
    # the permutation follows from the last conv's width and the kernel's
    # rows, so narrow students and small inputs convert too
    channels = np.shape(vgg[f"Conv_{len(_VGG_CONVS) - 1}"]["kernel"])[-1]
    w = np.asarray(vgg["Dense_0"]["kernel"]).T  # (4096, h*w*C), HWC order
    side = math.isqrt(w.shape[1] // channels)
    if side * side * channels != w.shape[1]:
        raise ValueError(f"classifier input {w.shape[1]} is not a square map of "
                         f"{channels} channels")
    sd["img_encoder.classifier.0.weight"] = (
        w.reshape(w.shape[0], side, side, channels).transpose(0, 3, 1, 2)
        .reshape(w.shape[0], -1))
    sd["img_encoder.classifier.0.bias"] = vgg["Dense_0"]["bias"]
    for i, t in enumerate((3, 6)):
        _linear(vgg[f"Dense_{i + 1}"], sd, f"img_encoder.classifier.{t}")
    _mlp(params, stats, sd, "compress", 0, 3)
    for i, name in enumerate(HEADS):
        _linear(params["_SixHeads_0"][f"Dense_{i}"], sd, name)
    _mlp(params, stats, sd, "projector", 3, 1)
    _linear(params["Dense_0"], sd, "projector.3")
    return {k: torch.from_numpy(np.array(
                v, np.int64 if k.endswith("num_batches_tracked") else np.float32,
                order="C"))
            for k, v in sd.items()}


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout `.pth` (as `torch_export.save_torch_checkpoint`
    writes it) -> state_dict. Unwraps the reference's container keys in its
    order: model, state_dict, net_vp, student_model, teacher_model."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(checkpoint, dict):
        for key in ("model", "state_dict", "net_vp", "student_model", "teacher_model"):
            if isinstance(checkpoint.get(key), dict):
                return checkpoint[key]
    return checkpoint
