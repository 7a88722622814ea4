"""Shared building blocks and initializers. Port of `pose3d_tpu/models/common.py`.

Initialization (the reference's KaiMingInit, applied to every from-scratch
run):
  * conv kernels:  kaiming normal with leaky-relu slope a=0.2, fan_in;
  * dense kernels: normal(std=1e-3);
  * all biases:    zeros. BatchNorm: weight 1, bias 0.
Random draws take an optional `torch.Generator`.

BatchNorm follows flax (`nn.BatchNorm(momentum=0.9, epsilon=1e-5)` with the
`mask` of `bn_mask`), not torch: in train mode the statistics come from the
valid rows only, and the running variance moves toward the BIASED batch
variance (torch's BatchNorm moves it toward the unbiased one).

Compute dtype (`--bf16`), as flax's `dtype` with `param_dtype` float32:
the parameters, the optimizer state and the checkpoints stay in their
dtype; a model built with `compute_dtype` (bfloat16) casts each layer's
input and weights to it (`linear`, `conv2d`), so a layer's output rounds
where flax's does: x W to bf16, then + b to bf16. BatchNorm takes its
statistics and normalises in float32 and rounds its output to the input's
dtype. `compute_dtype=None` is the parameters' dtype, and those paths run
as before. A parameter's gradient reaches it through the cast, so it is
rounded to the compute dtype before it is widened, as JAX's gradient of
`kernel.astype(bfloat16)` is.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM, BN_EPS = 0.1, 1e-5  # flax's decay 0.9 is torch's momentum 0.1


def kaiming_leaky02_(weight, generator=None):
    """kaiming_normal_(a=0.2), fan_in, in place."""
    return nn.init.kaiming_normal_(weight, a=0.2, generator=generator)


def dense_init_(linear: nn.Linear, generator=None) -> nn.Linear:
    """N(0, 1e-3) weight and zero bias, in place."""
    nn.init.normal_(linear.weight, 0.0, 1e-3, generator=generator)
    nn.init.zeros_(linear.bias)
    return linear


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax's Dense under compute dtype `dtype`: x W^T in `dtype` (one
    rounding), then + b (another); with None, `layer(x)` as it is."""
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype | None = None,
           bias: bool = True) -> torch.Tensor:
    """flax's Conv under compute dtype `dtype` (None: the parameters'): the
    convolution (one rounding), then + b (another) unless `bias` is False
    (the caller adds it, after a pool); with None and the bias, `conv(x)`."""
    if dtype is None and bias:
        return conv(x)
    w = conv.weight if dtype is None else conv.weight.to(dtype)
    y = F.conv2d(x if dtype is None else x.to(dtype), w, None, conv.stride, conv.padding)
    if bias and conv.bias is not None:
        y = y + conv.bias.to(y.dtype)[:, None, None]
    return y


def batch_stats(x: torch.Tensor, dims: Sequence[int],
                mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's train-mode statistics over `dims`: mean and E[x^2] - E[x]^2
    clamped at 0, over the rows where the (N,) bool `mask` is set (all rows
    with None). Differentiable."""
    if mask is None:
        mu = x.mean(dims)
        mu2 = (x * x).mean(dims)
    else:
        w = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        count = mask.sum().to(x.dtype)
        for d in dims:
            if d != 0:
                count = count * x.shape[d]
        mu = (x * w).sum(dims) / count
        mu2 = (x * x * w).sum(dims) / count
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the channel axis 1 of (N, C) or (N, C, H, W), with
    torch's parameter and buffer names (so reference state_dicts load with
    strict=True) and flax's train-mode semantics:

      * forward(x, mask): the (N,) bool `mask` keeps padded rows out of the
        batch statistics (JAX `bn_mask`); normalisation is
        (x - mean) * rsqrt(var + eps) * weight + bias, differentiated
        through the statistics;
      * the running statistics move by momentum 0.1 toward the batch mean
        and the biased batch variance.

    Eval mode uses the running statistics, as torch's BatchNorm does.

    An input in a narrower dtype than the parameters (a bf16 compute dtype)
    is normalised as flax's BatchNorm(dtype=bfloat16) does: the statistics
    from the input in float32, the normalisation in float32, rounded once to
    the input's dtype. The library call (eval mode, and train mode without a
    mask) takes a bf16 input with float32 parameters and buffers and does
    its arithmetic in float32; the masked statistics widen the input first.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def _check_input_dim(self, x):
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm takes (N, C) or (N, C, H, W); got {tuple(x.shape)}")

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = (1 - momentum) running + momentum batch (flax's update)."""
        self.running_mean.mul_(1.0 - self.momentum).add_(mean.detach(), alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var.detach(), alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  channel_dim: int = 1) -> torch.Tensor:
        """(x - mean) * rsqrt(var + eps) * weight + bias, per channel."""
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]  # values per channel
        if mask is None and n > 1:
            # the library kernel normalises with the biased variance and,
            # at momentum 1, hands back the batch mean and the UNBIASED
            # variance in zeroed buffers; the running update takes the
            # biased one, so no second pass over x computes the statistics
            mean, var = torch.zeros_like(self.running_mean), torch.zeros_like(self.running_var)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            var = var * ((n - 1) / n)
        else:
            xp = x.to(self.weight.dtype)  # a bf16 input's statistics in float32
            mean, var = batch_stats(xp, [0] + list(range(2, x.dim())), mask)
            y = self.normalize(xp, mean, var).to(x.dtype)
        self.update_running(mean, var)
        return y


def run_layers(layers: Iterable[nn.Module], x: torch.Tensor,
               mask: torch.Tensor | None = None,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """Apply a flat list of layers, handing `mask` to each BatchNorm and
    the compute dtype `dtype` to each Linear."""
    for layer in layers:
        if isinstance(layer, BatchNorm):
            x = layer(x, mask)
        elif isinstance(layer, nn.Linear):
            x = linear(layer, x, dtype)
        else:
            x = layer(x)
    return x


def dense_bn_relu(in_features: int, out_features: int,
                  generator=None) -> list[nn.Module]:
    """Linear + BatchNorm + ReLU, the reference's MLP block (for example
    `compress`). Returned as three layers, not one module, so that a
    Sequential built from them has the reference's flat keys
    (`compress.0`, `compress.1`, ...); `run_layers` applies it with a mask."""
    return [dense_init_(nn.Linear(in_features, out_features), generator),
            BatchNorm(out_features), nn.ReLU(inplace=True)]


def conv_bn(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
            generator=None) -> tuple[nn.Conv2d, BatchNorm]:
    """The reference's ConvBN: Conv2d without bias, then BatchNorm (the
    caller applies the ReLU where there is one). Padding is symmetric
    (k - 1) // 2, as in JAX (not XLA SAME). Returned as a pair so that the
    caller names them (`conv1`, `bn1`, `downsample.0/1`) as the reference's
    state_dict does."""
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=(kernel_size - 1) // 2, bias=False)
    kaiming_leaky02_(conv.weight, generator)
    return conv, BatchNorm(out_channels)


def head_dense(in_features: int, out_features: int, generator=None) -> nn.Linear:
    """A plain Linear head (fc_cls_* / fc_reg_*), N(0, 1e-3)."""
    return dense_init_(nn.Linear(in_features, out_features), generator)
