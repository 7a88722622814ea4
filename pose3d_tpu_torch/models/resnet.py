"""ResNet with the reference's two-output forward. Port of
`pose3d_tpu/models/resnet.py`.

torchvision-style: a 7x7/2 stem conv + BN, a 3x3/2 max-pool and ReLU, four
stages of residual blocks (the stride on the 3x3 conv of a Bottleneck), a
global average pool and a linear head. The forward returns both the pooled
feature and the head's output, as the reference does; the teacher uses the
head's output as its image feature. Keys follow the reference's state_dict
(`conv1`, `bn1`, `layer{1..4}.{j}.conv{c}/bn{c}`, `.downsample.0/1`, `fc`).
In train mode every BatchNorm takes the forward's `mask` (padded rows out of
the batch statistics, as JAX passes `mask` to each ConvBN).

The JAX package's `remat` option (recompute blocks in the backward) is a
TPU memory trade and is not ported.

With a compute dtype (`compute_dtype=torch.bfloat16`) each conv runs in it
(cuDNN), each BatchNorm normalises in float32 and rounds to it
(`models.common.BatchNorm`), the residual adds and the average pool round
to it, and the head is a bf16 Dense, as JAX's ResNet(dtype=bfloat16).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pose3d_tpu_torch.models.common import conv2d, conv_bn, head_dense, linear


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(in_channels, features, 3, stride, generator)
        self.conv2, self.bn2 = conv_bn(features, features, 3, 1, generator)
        self.downsample = _downsample(in_channels, features * self.expansion, stride,
                                      generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        y = torch.relu(self.bn1(conv2d(self.conv1, x, dtype), mask))
        y = self.bn2(conv2d(self.conv2, y, dtype), mask)
        return torch.relu(y + _residual(self.downsample, x, mask, dtype))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(in_channels, features, 1, 1, generator)
        self.conv2, self.bn2 = conv_bn(features, features, 3, stride, generator)
        self.conv3, self.bn3 = conv_bn(features, features * self.expansion, 1, 1,
                                       generator)
        self.downsample = _downsample(in_channels, features * self.expansion, stride,
                                      generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        y = torch.relu(self.bn1(conv2d(self.conv1, x, dtype), mask))
        y = torch.relu(self.bn2(conv2d(self.conv2, y, dtype), mask))
        y = self.bn3(conv2d(self.conv3, y, dtype), mask)
        return torch.relu(y + _residual(self.downsample, x, mask, dtype))


def _downsample(in_channels, out_channels, stride, generator):
    """The projection of the residual where the block changes its shape
    (JAX: `residual.shape != y.shape`)."""
    if stride == 1 and in_channels == out_channels:
        return None
    return nn.Sequential(*conv_bn(in_channels, out_channels, 1, stride, generator))


def _residual(downsample, x, mask, dtype=None):
    if downsample is None:
        return x
    conv, bn = downsample
    return bn(conv2d(conv, x, dtype), mask)


class ResNet(nn.Module):
    """Input NHWC float32 (N, H, W, 3); returns (pooled_feature, fc_output),
    in `compute_dtype` if one is given (None: the parameters' dtype)."""

    def __init__(self, block: type, stage_sizes: Sequence[int], num_classes: int = 1000,
                 features: int = 64, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1, self.bn1 = conv_bn(3, features, 7, 2, generator)
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        channels = features
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(channels, features * 2**i, stride, generator))
                channels = features * 2**i * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = head_dense(channels, num_classes, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        # NHWC -> the NCHW view convolutions take. The stem pools before its
        # ReLU, as JAX does: both are monotone, so the order is exact.
        cd = self.compute_dtype
        x = self.bn1(conv2d(self.conv1, x.permute(0, 3, 1, 2), cd), mask)
        x = torch.relu(self.maxpool(x))
        for i in range(self.n_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, mask, cd)
        feat = x.mean(dim=(2, 3))
        return feat, linear(self.fc, feat, cd)


def resnet18(num_classes: int = 1000, generator: torch.Generator | None = None,
             compute_dtype: torch.dtype | None = None) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, generator=generator,
                  compute_dtype=compute_dtype)


def resnet50(num_classes: int = 1000, generator: torch.Generator | None = None,
             compute_dtype: torch.dtype | None = None) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, generator=generator,
                  compute_dtype=compute_dtype)
