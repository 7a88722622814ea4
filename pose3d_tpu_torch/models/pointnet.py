"""PointNet-lite shape encoder. Port of `pose3d_tpu/models/pointnet.py
ShapeEncoderPC`, eval mode.

Pointwise Conv1d 3 -> 64 -> 128 -> feature_dim with BatchNorm1d on each,
ReLU on the first two, then a max over the points. The parameters keep the
reference's layout (`conv{1,2,3}` with (out, in, 1) weights and a bias,
`bn{1,2,3}`), which `torch_export.export_pointnet` writes.

The eval forward folds each BatchNorm into its conv
(`ops.pointnet.fold_pointnet_params`) and runs `ops.pointnet.pointnet_eval`:
the CUDA kernel on the card, the plain version on the CPU. JAX's eval
forward computes (x W + b - mean) * rsqrt(var + eps) * scale + shift
unfolded, so the two round differently and agree to float32 tolerance.
It is the frozen teacher's forward and is not differentiated. The
train-mode forward (batch statistics, masked rows) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch.ops.pointnet import HIDDEN, fold_pointnet_params, pointnet_eval


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
            setattr(self, f"bn{i + 1}", nn.BatchNorm1d(widths[i + 1], eps=1e-5,
                                                       momentum=0.1))

    @torch.no_grad()
    def forward(self, points: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "ShapeEncoderPC's train-mode forward (batch-statistics BN) is not "
                "ported to pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
        return pointnet_eval(points, fold_pointnet_params(self.state_dict()))
