"""DeformNet fusion head. Port of `pose3d_tpu/models/deformnet.py`.

bottleneck -> bottleneck -> bottleneck/2 -> bottleneck/4 (Dense + BN + ReLU
each) -> out_dim, then tanh. The reference runs these as Conv1d over a
length-1 axis; the parameters keep that layout (`conv1..4` with (out, in, 1)
weights, `bn1..3`, as `torch_export.export_deformnet` writes them) and the
forward applies each as the Dense layer it is, in `compute_dtype` if one
is given (x W rounded, + b rounded; BatchNorm in float32 rounded; tanh),
as JAX's DeformNet(dtype=bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.models.common import BatchNorm


class DeformNet(nn.Module):
    """Input (N, bottleneck_size); output (N, out_dim) in (-1, 1). In train
    mode `mask` keeps padded rows out of the BatchNorm statistics."""

    def __init__(self, bottleneck_size: int = 1024, out_dim: int = 200,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        b = bottleneck_size
        widths = (b, b, b // 2, b // 4, out_dim)
        for i in range(4):
            conv = nn.Conv1d(widths[i], widths[i + 1], kernel_size=1)
            nn.init.normal_(conv.weight, 0.0, 1e-3, generator=generator)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{i + 1}", conv)
            if i < 3:
                setattr(self, f"bn{i + 1}", BatchNorm(widths[i + 1]))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        cd = self.compute_dtype
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}")
            if cd is None:
                x = F.linear(x, conv.weight[:, :, 0], conv.bias)
            else:
                x = F.linear(x.to(cd), conv.weight[:, :, 0].to(cd)) + conv.bias.to(cd)
            if i < 4:
                x = torch.relu(getattr(self, f"bn{i}")(x, mask))
        return torch.tanh(x)
