"""Rotation geometry, viewpoint metrics and the two angle decoders, in PyTorch.

Port of `pose3d_tpu/geometry.py`. These are the plain versions: the
evaluation computes the geodesic error through `ops.geodesic.rotation_err`,
which launches the CUDA kernel for a CUDA tensor and calls `rotation_err`
here for a CPU tensor.

Viewpoint label convention (canonical):
  label = (azimuth in [0,360), elevation + 90 in [0,180), inplane + 180 in [0,360))
All functions take degrees and work on inputs of shape (..., 3).
"""

from __future__ import annotations

import math

import torch

DEG2RAD = math.pi / 180.0


def angles_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Euler viewpoint angles (radians, (..., 3)) -> flattened rotation (..., 9).

    R = Rz(inp) @ Rx(ele - pi/2) @ Rz(-azi), row-major 3x3 flattened.
    """
    azi, ele, rol = angles.unbind(-1)
    sin, cos = torch.sin, torch.cos
    e1 = cos(rol) * cos(azi) - sin(rol) * cos(ele) * sin(azi)
    e2 = sin(rol) * cos(azi) + cos(rol) * cos(ele) * sin(azi)
    e3 = sin(ele) * sin(azi)
    e4 = -cos(rol) * sin(azi) - sin(rol) * cos(ele) * cos(azi)
    e5 = -sin(rol) * sin(azi) + cos(rol) * cos(ele) * cos(azi)
    e6 = sin(ele) * cos(azi)
    e7 = sin(rol) * sin(ele)
    e8 = -cos(rol) * sin(ele)
    e9 = cos(ele)
    return torch.stack([e1, e2, e3, e4, e5, e6, e7, e8, e9], dim=-1)


def _to_matrix_from_labels(labels_deg: torch.Tensor) -> torch.Tensor:
    """Canonical label triple (degrees) -> flattened rotation matrix (..., 9).

    Elevation and inplane are both shifted by -180 degrees before conversion,
    although labels encode ele+90: the asymmetric offset is the reference's.
    """
    labels = labels_deg.to(torch.float32)
    shifted = torch.stack(
        [labels[..., 0], labels[..., 1] - 180.0, labels[..., 2] - 180.0], dim=-1)
    return angles_to_matrix(shifted * DEG2RAD)


def rotation_err(preds_deg: torch.Tensor, targets_deg: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error in degrees between label triples (..., 3) -> (...,).

    Keeps the reference's clamp(-1, 3) on trace(R_p^T R_g), applied before
    the (t - 1) / 2.
    """
    r_pred = _to_matrix_from_labels(preds_deg)
    r_gt = _to_matrix_from_labels(targets_deg)
    trace = torch.sum(r_pred * r_gt, dim=-1)
    cos_angle = (torch.clamp(trace, -1.0, 3.0) - 1.0) / 2.0
    return torch.arccos(cos_angle) * (180.0 / math.pi)


def rotation_acc(
    preds_deg: torch.Tensor, targets_deg: torch.Tensor, threshold: float = 30.0,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Acc@pi/6 (by default): 100 * mean(geodesic err <= threshold).
    `valid` (bool (N,)) masks padded batch rows out of the mean."""
    hit = (rotation_err(preds_deg, targets_deg) <= threshold).to(torch.float32)
    if valid is None:
        return 100.0 * hit.mean()
    v = valid.to(torch.float32)
    return 100.0 * (hit * v).sum() / v.sum().clamp(min=1.0)


def angle_err(preds_deg: torch.Tensor, targets_deg: torch.Tensor) -> torch.Tensor:
    """Per-angle wraparound error: min(|p - t|, 360 - |p - t|)."""
    errs = (preds_deg - targets_deg).abs()
    return torch.minimum(errs, 360.0 - errs)


def _delta_at_argmax(logits: torch.Tensor, reg: torch.Tensor):
    bins = logits.argmax(dim=-1)
    return bins, reg.gather(-1, bins[:, None])[:, 0]


def decode_predictions(cls_logits, reg_outputs, bin_size: float = 15.0) -> torch.Tensor:
    """Train/val-time decoder: (bin + tanh(delta)/2 + 0.5) * bin_size.

    The bin is the argmax of the classification logits (first maximum on a
    tie, as jnp.argmax); delta is the regression output at that bin.
    Returns (N, 3) angle predictions in degrees.
    """
    preds = []
    for logits, reg in zip(cls_logits, reg_outputs):
        bins, delta = _delta_at_argmax(logits, reg)
        preds.append((bins.to(torch.float32) + torch.tanh(delta) / 2.0 + 0.5) * bin_size)
    return torch.stack(preds, dim=-1)


def decode_predictions_inference(cls_logits, reg_outputs,
                                 bin_size: float = 15.0) -> torch.Tensor:
    """Inference-time decoder: (bin + raw_delta) * bin_size, clamped to
    [0, 360]. It differs from `decode_predictions` on purpose: the reference
    decodes one way in training and evaluation and another when serving."""
    preds = []
    for logits, reg in zip(cls_logits, reg_outputs):
        bins, delta = _delta_at_argmax(logits, reg)
        preds.append((bins.to(torch.float32) + delta) * bin_size)
    return torch.clamp(torch.stack(preds, dim=-1), 0.0, 360.0)
