"""PointNet-lite shape encoder. Port of `pose3d_tpu/models/pointnet.py
ShapeEncoderPC`.

Pointwise Conv1d 3 -> 64 -> 128 -> feature_dim with BatchNorm on each,
ReLU on the first two, then a max over the points. The parameters keep the
reference's layout (`conv{1,2,3}` with (out, in, 1) weights and a bias,
`bn{1,2,3}`), which `torch_export.export_pointnet` writes.

The eval forward folds each BatchNorm into its conv
(`ops.pointnet.fold_pointnet_params`) and runs `ops.pointnet.pointnet_eval`:
the CUDA kernel on the card, the plain version on the CPU. JAX's eval
forward computes (x W + b - mean) * rsqrt(var + eps) * scale + shift
unfolded, so the two round differently and agree to float32 tolerance.
It is the frozen teacher's forward and is not differentiated.

The train forward runs `ops.pointnet_train.pointnet_train`: the CUDA
kernels of `csrc/pointnet_train.cu` (forward and parameter gradient) on the
card, masked batches included, and the plain version on the CPU. Per
channel, statistics over the valid clouds' points, variance E[x^2] - E[x]^2
clamped at 0, the running statistics updated toward it (flax's update);
then the max over the points, whose gradient goes to the first point that
takes it.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch.models.common import BatchNorm
from pose3d_tpu_torch.ops.pointnet import HIDDEN, fold_pointnet_params, pointnet_eval
from pose3d_tpu_torch.ops.pointnet_train import pointnet_train


class ShapeEncoderPC(nn.Module):
    """Input (N, P, 3) float32 point clouds (channels last); output
    (N, feature_dim)."""

    def __init__(self, feature_dim: int = 1024, generator: torch.Generator | None = None):
        super().__init__()
        widths = (3, *HIDDEN, feature_dim)
        for i in range(3):
            conv = nn.Conv1d(widths[i], widths[i + 1], kernel_size=1)
            nn.init.normal_(conv.weight, 0.0, 1e-3, generator=generator)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{i + 1}", conv)
            setattr(self, f"bn{i + 1}", BatchNorm(widths[i + 1]))

    def forward(self, points: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            with torch.no_grad():
                return pointnet_eval(points, fold_pointnet_params(self.state_dict()))
        layers = [(getattr(self, f"conv{i}").weight[:, :, 0], getattr(self, f"conv{i}").bias,
                   getattr(self, f"bn{i}").weight, getattr(self, f"bn{i}").bias)
                  for i in (1, 2, 3)]
        out, stats = pointnet_train(points, layers, mask)
        for i, (mean, var) in enumerate(stats, 1):
            getattr(self, f"bn{i}").update_running(mean, var)
        return out
