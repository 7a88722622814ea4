"""Weights bridge from the JAX package, and the reader of reference `.pth` files.

`baseline_state_dict`, `pose_state_dict` and `pose_vanilla_state_dict` turn
the JAX `BaselineEstimator`'s, `PoseEstimator`'s and `PoseEstimatorVanilla`'s
{"params", "batch_stats"} trees (numpy arrays; the teachers with a
PointCloud or a MultiView shape encoder) into the port's state_dicts,
mirroring
`pose3d_tpu/train/torch_export.py export_baseline_estimator`,
`export_pose_estimator` and `export_pose_estimator_vanilla`:
  flax Dense kernel (in, out)        -> Linear weight (out, in), or Conv1d
                                        weight (out, in, 1) in the PointNet
                                        and the DeformNet
  flax Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  flax BatchNorm scale/bias + batch_stats mean/var
                                     -> weight/bias/running_mean/running_var
  classifier.0's input axis          -> permuted from flax's (H, W, C)
                                        flatten to torch's (C, H, W)
The results load into `models.estimators.BaselineEstimator`,
`PoseEstimator` and `PoseEstimatorVanilla` with strict=True.
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
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _conv1d(p, sd, prefix):
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
    sd[f"{prefix}.bias"] = p["bias"]


def _bn(p, st, sd, prefix):
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]
    sd[f"{prefix}.running_mean"] = st["mean"]
    sd[f"{prefix}.running_var"] = st["var"]
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _mlp(params, stats, sd, prefix, start, n):
    """flax DenseBNRelu_{start..start+n-1} -> Sequential [Linear, BN, ReLU]*n."""
    for i in range(n):
        sub = f"DenseBNRelu_{start + i}"
        _linear(params[sub]["Dense_0"], sd, f"{prefix}.{3 * i}")
        _bn(params[sub]["BatchNorm_0"], stats[sub]["BatchNorm_0"], sd,
            f"{prefix}.{3 * i + 1}")


def _to_tensors(sd) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(
                v, np.int64 if k.endswith("num_batches_tracked") else np.float32,
                order="C"))
            for k, v in sd.items()}


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
    return _to_tensors(sd)


def _resnet(params, stats, sd, prefix, stage_sizes, block, n_convs):
    """flax ResNet (ConvBN_0 stem, `{block}_k` blocks of ConvBN_0..n_convs-1
    plus ConvBN_{n_convs} for the projection, Dense_0 head)."""
    def convbn(p, st, conv, bn):
        _conv2d(p["Conv_0"], sd, conv)
        _bn(p["BatchNorm_0"], st["BatchNorm_0"], sd, bn)

    convbn(params["ConvBN_0"], stats["ConvBN_0"], f"{prefix}.conv1", f"{prefix}.bn1")
    k = 0
    for stage, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            p, st = params[f"{block}_{k}"], stats[f"{block}_{k}"]
            layer = f"{prefix}.layer{stage + 1}.{j}"
            for c in range(n_convs):
                convbn(p[f"ConvBN_{c}"], st[f"ConvBN_{c}"], f"{layer}.conv{c + 1}",
                       f"{layer}.bn{c + 1}")
            if f"ConvBN_{n_convs}" in p:
                convbn(p[f"ConvBN_{n_convs}"], st[f"ConvBN_{n_convs}"],
                       f"{layer}.downsample.0", f"{layer}.downsample.1")
            k += 1
    _linear(params["Dense_0"], sd, f"{prefix}.fc")


def _shape_encoder(params, stats, sd, shape):
    """ShapeEncoderPC_0 -> shape_encoder.conv/bn{1..3}, or
    ShapeEncoderMV_0/ResNet_0 (a ResNet-18) -> shape_encoder.render_encoder."""
    if shape == "MultiView":
        _resnet(params["ShapeEncoderMV_0"]["ResNet_0"], stats["ShapeEncoderMV_0"]["ResNet_0"],
                sd, "shape_encoder.render_encoder", (2, 2, 2, 2), "BasicBlock", 2)
        return
    if shape != "PointCloud":
        raise ValueError(f"shape={shape!r}: PointCloud or MultiView")
    pc, pc_stats = params["ShapeEncoderPC_0"], stats["ShapeEncoderPC_0"]
    for i in range(3):
        _conv1d(pc[f"Dense_{i}"], sd, f"shape_encoder.conv{i + 1}")
        _bn(pc[f"BatchNorm_{i}"], pc_stats[f"BatchNorm_{i}"], sd,
            f"shape_encoder.bn{i + 1}")


def pose_state_dict(variables, shape: str = "PointCloud") -> dict[str, torch.Tensor]:
    """JAX PoseEstimator(shape=shape) variables (numpy) -> the port's
    state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _resnet(params["ResNet_0"], stats["ResNet_0"], sd, "img_encoder", (3, 4, 6, 3),
            "Bottleneck", 3)
    _shape_encoder(params, stats, sd, shape)
    deform, deform_stats = params["DeformNet_0"], stats["DeformNet_0"]
    for i in range(3):
        sub = f"DenseBNRelu_{i}"
        _conv1d(deform[sub]["Dense_0"], sd, f"deformNet.conv{i + 1}")
        _bn(deform[sub]["BatchNorm_0"], deform_stats[sub]["BatchNorm_0"], sd,
            f"deformNet.bn{i + 1}")
    _conv1d(deform["Dense_0"], sd, "deformNet.conv4")
    for i, name in enumerate(HEADS):
        _linear(params["_SixHeads_0"][f"Dense_{i}"], sd, name)
    _mlp(params, stats, sd, "projector", 0, 2)
    _linear(params["Dense_0"], sd, "projector.6")
    return _to_tensors(sd)


def pose_vanilla_state_dict(variables, shape: str = "PointCloud") -> dict[str, torch.Tensor]:
    """JAX PoseEstimatorVanilla(shape=shape) variables (numpy) -> the port's
    state_dict: a ResNet-18 of basic blocks, the shape encoder, the
    compress MLP (Linear 0/3/6, BatchNorm 1/4/7) and the six heads."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _resnet(params["ResNet_0"], stats["ResNet_0"], sd, "img_encoder", (2, 2, 2, 2),
            "BasicBlock", 2)
    _shape_encoder(params, stats, sd, shape)
    _mlp(params, stats, sd, "compress", 0, 3)
    for i, name in enumerate(HEADS):
        _linear(params["_SixHeads_0"][f"Dense_{i}"], sd, name)
    return _to_tensors(sd)


def read_state_dict(path: str, role: str | None = None) -> dict[str, torch.Tensor]:
    """A reference-layout `.pth` (as `torch_export.save_torch_checkpoint`
    writes it, of a PointCloud or a MultiView teacher: the layouts differ in
    `shape_encoder.conv1.weight` against `shape_encoder.render_encoder.*`,
    and the model's strict load takes only its own) or the port's own
    `checkpoint.pth` -> state_dict. Unwraps
    the reference's container keys in its order: model, state_dict, net_vp,
    student_model, teacher_model. `role` ("teacher" or "student") first
    takes that train state out of a checkpoint that holds both, as KD
    `--stage 1`'s does (`{"teacher": {"model": ...}, "student": ...}`)."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    if role is not None and isinstance(checkpoint, dict) \
            and isinstance(checkpoint.get(role), dict):
        checkpoint = checkpoint[role]
    if isinstance(checkpoint, dict):
        for key in ("model", "state_dict", "net_vp", "student_model", "teacher_model"):
            if isinstance(checkpoint.get(key), dict):
                return checkpoint[key]
    return checkpoint
