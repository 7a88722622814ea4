"""Shared building blocks and initializers. Port of `pose3d_tpu/models/common.py`.

Initialization (the reference's KaiMingInit, applied to every from-scratch
run):
  * conv kernels:  kaiming normal with leaky-relu slope a=0.2, fan_in;
  * dense kernels: normal(std=1e-3);
  * all biases:    zeros. BatchNorm: weight 1, bias 0.
Random draws take an optional `torch.Generator`.
"""

from __future__ import annotations

from torch import nn


def kaiming_leaky02_(weight, generator=None):
    """kaiming_normal_(a=0.2), fan_in, in place."""
    return nn.init.kaiming_normal_(weight, a=0.2, generator=generator)


def dense_init_(linear: nn.Linear, generator=None) -> nn.Linear:
    """N(0, 1e-3) weight and zero bias, in place."""
    nn.init.normal_(linear.weight, 0.0, 1e-3, generator=generator)
    nn.init.zeros_(linear.bias)
    return linear


def dense_bn_relu(in_features: int, out_features: int,
                  generator=None) -> list[nn.Module]:
    """Linear + BatchNorm1d + ReLU, the reference's MLP block (for example
    `compress`). Returned as three layers, not one module, so that a
    Sequential built from them has the reference's flat keys
    (`compress.0`, `compress.1`, ...). BatchNorm1d's momentum 0.1 is flax's
    running-average decay 0.9."""
    return [dense_init_(nn.Linear(in_features, out_features), generator),
            nn.BatchNorm1d(out_features, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True)]


def conv_bn(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
            generator=None) -> tuple[nn.Conv2d, nn.BatchNorm2d]:
    """The reference's ConvBN: Conv2d without bias, then BatchNorm2d (the
    caller applies the ReLU where there is one). Padding is symmetric
    (k - 1) // 2, as in JAX (not XLA SAME). Returned as a pair so that the
    caller names them (`conv1`, `bn1`, `downsample.0/1`) as the reference's
    state_dict does."""
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=(kernel_size - 1) // 2, bias=False)
    kaiming_leaky02_(conv.weight, generator)
    return conv, nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)


def head_dense(in_features: int, out_features: int, generator=None) -> nn.Linear:
    """A plain Linear head (fc_cls_* / fc_reg_*), N(0, 1e-3)."""
    return dense_init_(nn.Linear(in_features, out_features), generator)
