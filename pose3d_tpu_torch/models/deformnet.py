"""DeformNet fusion head. Port of `pose3d_tpu/models/deformnet.py`.

bottleneck -> bottleneck -> bottleneck/2 -> bottleneck/4 (Dense + BN + ReLU
each) -> out_dim, then tanh. The reference runs these as Conv1d over a
length-1 axis; the parameters keep that layout (`conv1..4` with (out, in, 1)
weights, `bn1..3`, as `torch_export.export_deformnet` writes them) and the
forward applies each as the Dense layer it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DeformNet(nn.Module):
    """Input (N, bottleneck_size); output (N, out_dim) in (-1, 1)."""

    def __init__(self, bottleneck_size: int = 1024, out_dim: int = 200,
                 generator: torch.Generator | None = None):
        super().__init__()
        b = bottleneck_size
        widths = (b, b, b // 2, b // 4, out_dim)
        for i in range(4):
            conv = nn.Conv1d(widths[i], widths[i + 1], kernel_size=1)
            nn.init.normal_(conv.weight, 0.0, 1e-3, generator=generator)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{i + 1}", conv)
            if i < 3:
                setattr(self, f"bn{i + 1}", nn.BatchNorm1d(widths[i + 1], eps=1e-5,
                                                           momentum=0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}")
            x = F.linear(x, conv.weight[:, :, 0], conv.bias)
            if i < 4:
                x = torch.relu(getattr(self, f"bn{i}")(x))
        return torch.tanh(x)
