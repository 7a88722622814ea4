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

With a compute dtype (`compute_dtype=torch.bfloat16`, `--bf16`) the eval
forward takes flax's bf16 rounding points, which a folded (W, b) cannot:
`ops.pointnet.eval_layers_bf16` hands the unfolded layers to
`ops.pointnet.pointnet_eval_bf16` (the kernel's bf16 instance on the card,
the plain version on the CPU). The bf16 train forward hands the bf16
points and the float32 layers to `ops.pointnet_train.pointnet_train` (the
train-mode kernel's bf16 instance on the card, `pointnet_train_plain_bf16`
on the CPU): flax's rounding points, the statistics float32, the running
statistics updated from them in float32, and the max's gradient split
evenly over tied points, as JAX's `jnp.max` splits it.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch.models.common import BatchNorm
from pose3d_tpu_torch.ops.pointnet import (HIDDEN, eval_layers_bf16, fold_pointnet_params,
                                           pointnet_eval, pointnet_eval_bf16)
from pose3d_tpu_torch.ops.pointnet_train import pointnet_train


class ShapeEncoderPC(nn.Module):
    """Input (N, P, 3) float32 point clouds (channels last); output
    (N, feature_dim), in `compute_dtype` if one is given."""

    def __init__(self, feature_dim: int = 1024, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        widths = (3, *HIDDEN, feature_dim)
        for i in range(3):
            conv = nn.Conv1d(widths[i], widths[i + 1], kernel_size=1)
            nn.init.normal_(conv.weight, 0.0, 1e-3, generator=generator)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{i + 1}", conv)
            setattr(self, f"bn{i + 1}", BatchNorm(widths[i + 1]))

    def forward(self, points: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        cd = self.compute_dtype
        if not self.training:
            with torch.no_grad():
                # the module's own tensors, not state_dict()'s detached
                # copies: under torch.export they are the traced ones
                state = {**dict(self.named_parameters()), **dict(self.named_buffers())}
                if cd is not None:
                    return pointnet_eval_bf16(points.to(cd), eval_layers_bf16(state))
                return pointnet_eval(points, fold_pointnet_params(state))
        if cd is not None:
            points = points.to(cd)
        layers = [(getattr(self, f"conv{i}").weight[:, :, 0], getattr(self, f"conv{i}").bias,
                   getattr(self, f"bn{i}").weight, getattr(self, f"bn{i}").bias)
                  for i in (1, 2, 3)]
        out, stats = pointnet_train(points, layers, mask)
        for i, (mean, var) in enumerate(stats, 1):
            getattr(self, f"bn{i}").update_running(mean, var)
        return out
