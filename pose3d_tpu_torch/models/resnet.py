"""ResNet with the reference's two-output forward. Port of
`pose3d_tpu/models/resnet.py`.

torchvision-style: a 7x7/2 stem conv + BN, a 3x3/2 max-pool and ReLU, four
stages of residual blocks (the stride on the 3x3 conv of a Bottleneck), a
global average pool and a linear head. The forward returns both the pooled
feature and the head's output, as the reference does; the teacher uses the
head's output as its image feature. Keys follow the reference's state_dict
(`conv1`, `bn1`, `layer{1..4}.{j}.conv{c}/bn{c}`, `.downsample.0/1`, `fc`).

The JAX package's `remat` option (recompute blocks in the backward) is a
TPU memory trade and is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pose3d_tpu_torch.models.common import conv_bn, head_dense


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(in_channels, features, 3, stride, generator)
        self.conv2, self.bn2 = conv_bn(features, features, 3, 1, generator)
        self.downsample = _downsample(in_channels, features * self.expansion, stride,
                                      generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


def _downsample(in_channels, out_channels, stride, generator):
    """The projection of the residual where the block changes its shape
    (JAX: `residual.shape != y.shape`)."""
    if stride == 1 and in_channels == out_channels:
        return None
    return nn.Sequential(*conv_bn(in_channels, out_channels, 1, stride, generator))


class ResNet(nn.Module):
    """Input NHWC float32 (N, H, W, 3); returns (pooled_feature, fc_output)."""

    def __init__(self, block: type, stage_sizes: Sequence[int], num_classes: int = 1000,
                 features: int = 64, generator: torch.Generator | None = None):
        super().__init__()
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

    def forward(self, x: torch.Tensor):
        # NHWC -> the NCHW view convolutions take. The stem pools before its
        # ReLU, as JAX does: both are monotone, so the order is exact.
        x = self.bn1(self.conv1(x.permute(0, 3, 1, 2)))
        x = torch.relu(self.maxpool(x))
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        feat = x.mean(dim=(2, 3))
        return feat, self.fc(feat)


def resnet18(num_classes: int = 1000, generator: torch.Generator | None = None) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, generator=generator)


def resnet50(num_classes: int = 1000, generator: torch.Generator | None = None) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, generator=generator)
