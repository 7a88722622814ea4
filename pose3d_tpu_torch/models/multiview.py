"""The multi-view render encoders. Port of `pose3d_tpu/models/multiview.py`
(`ShapeEncoderMV`, `ShapeEncoderMVRaw`).

The K views of each sample are folded into the batch (sample-major: a
sample's K views in ring order), encoded by one ResNet-18 whose head's
output is the per-view feature, and unfolded: (N, K * D) concatenated per
sample (`ShapeEncoderMV`), or (N, K, D) (`ShapeEncoderMVRaw`). A padded
batch's (N,) mask is folded the same way, each sample's flag repeated for
its K views (`repeat_interleave`, as `jnp.repeat`), so that every
BatchNorm's statistics leave out the padded samples' renders. The ResNet is
the submodule `render_encoder`, as in the reference's state_dict.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch.models.resnet import resnet18


class ShapeEncoderMVRaw(nn.Module):
    """Input (N, K, H, W, 3) renders in [0, 1]; output (N, K, feature_dim),
    in `compute_dtype` if one is given."""

    def __init__(self, feature_dim: int = 256, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.render_encoder = resnet18(num_classes=feature_dim, generator=generator,
                                       compute_dtype=compute_dtype)

    def forward(self, renders: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        n, k = renders.shape[:2]
        if mask is not None:
            mask = mask.repeat_interleave(k)
        _, feat = self.render_encoder(renders.reshape((n * k,) + renders.shape[2:]), mask)
        return feat.reshape(n, k, -1)


class ShapeEncoderMV(ShapeEncoderMVRaw):
    """Input (N, K, H, W, 3) renders in [0, 1]; output (N, K * feature_dim),
    each sample's K view features concatenated in ring order."""

    def forward(self, renders: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        return super().forward(renders, mask).reshape(renders.shape[0], -1)
