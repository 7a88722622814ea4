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

The train forward is JAX's `dense_bn_forward` in plain PyTorch with
autograd, on channels-last (N, P, C) activations: per channel, statistics
over the valid clouds' points, variance E[x^2] - E[x]^2 clamped at 0, the
running statistics updated toward it; then the max over the points. The
fused train-mode kernel (`pose3d_tpu/ops/pointnet_train_fused.py`) is not
ported yet (ROADMAP.md Queue 2 item 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.models.common import BatchNorm, batch_stats
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
            setattr(self, f"bn{i + 1}", BatchNorm(widths[i + 1]))

    def forward(self, points: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            with torch.no_grad():
                return pointnet_eval(points, fold_pointnet_params(self.state_dict()))
        x = points
        for i in (1, 2, 3):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            x = F.linear(x, conv.weight[:, :, 0], conv.bias)
            mean, var = batch_stats(x, (0, 1), mask)
            bn.update_running(mean, var)
            x = bn.normalize(x, mean, var, channel_dim=-1)
            if i < 3:
                x = torch.relu(x)
        return x.amax(dim=1)
