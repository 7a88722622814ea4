"""VGG, the student backbone. Port of `pose3d_tpu/models/vgg.py`, config A.

torchvision-style: 3x3 conv -> ReLU (-> 2x2 max pool), then the classifier
512*h*w -> 4096 -> 4096 -> num_classes with dropout after the first two
ReLUs. The student uses vgg11(num_classes=img_feature_dim). Layer indices
follow the reference's state_dict: convs at `features.{0,3,6,8,11,13,16,18}`,
Linears at `classifier.{0,3,6}`.

The JAX package's TPU rewrites of the conv + pool pairs (`_ConvPool2x2`,
`_ConvPool2x2Deep`, `_PrePoolConv`) compute the same values as the plain
order and are not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pose3d_tpu_torch.models.common import dense_init_, kaiming_leaky02_

CFG_A = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def scaled_width(v: int, width_mult: float) -> int:
    """Conv width under `width_mult` (narrower students), as in JAX: a
    multiple of 16, at least 16."""
    if width_mult == 1.0:
        return v
    return max(16, int(round(v * width_mult / 16)) * 16)


class VGG(nn.Module):
    """Input NHWC float32 (N, input_dim, input_dim, 3) -> (N, num_classes).

    `input_dim` fixes the classifier's input width (512*7*7 at 224), which
    flax infers at init.
    """

    def __init__(self, cfg: Sequence, num_classes: int = 1000,
                 width_mult: float = 1.0, dropout_rate: float = 0.5,
                 input_dim: int = 224, generator: torch.Generator | None = None):
        super().__init__()
        layers: list[nn.Module] = []
        channels, hw = 3, input_dim
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
                hw //= 2
                continue
            v = scaled_width(v, width_mult)
            conv = nn.Conv2d(channels, v, kernel_size=3, padding=1)
            kaiming_leaky02_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            layers += [conv, nn.ReLU(inplace=True)]
            channels = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            dense_init_(nn.Linear(channels * hw * hw, 4096), generator),
            nn.ReLU(inplace=True),
            nn.Dropout(dropout_rate),
            dense_init_(nn.Linear(4096, 4096), generator),
            nn.ReLU(inplace=True),
            nn.Dropout(dropout_rate),
            dense_init_(nn.Linear(4096, num_classes), generator),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> the NCHW view convolutions take; for a contiguous NHWC
        # input this view is channels-last in memory, so nothing is copied
        x = self.features(x.permute(0, 3, 1, 2))
        return self.classifier(torch.flatten(x, 1))  # flattens C, H, W


def vgg11(num_classes: int = 1000, width_mult: float = 1.0,
          dropout_rate: float = 0.5, input_dim: int = 224,
          generator: torch.Generator | None = None) -> VGG:
    return VGG(CFG_A, num_classes=num_classes, width_mult=width_mult,
               dropout_rate=dropout_rate, input_dim=input_dim, generator=generator)
