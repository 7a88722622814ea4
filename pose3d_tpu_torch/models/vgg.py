"""VGG, the student backbone. Port of `pose3d_tpu/models/vgg.py`, config A.

torchvision-style: 3x3 conv -> ReLU (-> 2x2 max pool), then the classifier
512*h*w -> 4096 -> 4096 -> num_classes with dropout after the first two
ReLUs. The student uses vgg11(num_classes=img_feature_dim). Layer indices
follow the reference's state_dict: convs at `features.{0,3,6,8,11,13,16,18}`,
Linears at `classifier.{0,3,6}`.

The first block (`features.0` conv, `features.1` ReLU, `features.2` pool)
runs as one call of `ops.vgg_stem.vgg_stem`: the fused CUDA kernel on the
card (forward and weight gradient), its plain version on the CPU. It is
the function of JAX's `_ConvPool2x2` stem, first-tie-wins pooling
included. The deeper conv + pool pairs run as cuDNN conv, ReLU and
MaxPool2d; JAX's TPU rewrites of them (`_ConvPool2x2Deep`, `_PrePoolConv`)
compute the same values and are not ported.

Dropout draws nothing from torch's global generator: in train mode its
keep-masks are given (`keep`) or drawn from the caller's `generator`.

Each deeper conv that a pool follows pools before it adds its bias, as
JAX's `_PrePoolConv` does, in every dtype. With a compute dtype
(`compute_dtype=torch.bfloat16`, `--bf16`) the layers round where JAX's
bf16 student does: the stem kernel's bf16 instance (each window sum
rounded, pooled, + bias rounded); each deeper conv rounded, pooled where a
pool follows, + bias rounded; the classifier's Linears and dropout in bf16
(`x / (1 - rate)` rounds as flax's does).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.models.common import conv2d, dense_init_, kaiming_leaky02_, linear
from pose3d_tpu_torch.ops.vgg_stem import vgg_stem

CFG_A = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
CLASSIFIER_WIDTH = 4096


def scaled_width(v: int, width_mult: float) -> int:
    """Conv width under `width_mult` (narrower students), as in JAX: a
    multiple of 16, at least 16."""
    if width_mult == 1.0:
        return v
    return max(16, int(round(v * width_mult / 16)) * 16)


class KeepMaskDropout(nn.Module):
    """Dropout with a given keep-mask: x / (1 - rate) where `keep` is set,
    0 elsewhere (flax's Dropout); the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            raise ValueError("train-mode dropout takes its keep-mask from the caller")
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class VGG(nn.Module):
    """Input NHWC float32 (N, input_dim, input_dim, 3) -> (N, num_classes).

    `input_dim` fixes the classifier's input width (512*7*7 at 224), which
    flax infers at init. `cfg` starts with a conv followed by a pool (the
    stem), as config A does. `compute_dtype`: see the module docstring
    (None: the parameters' dtype).
    """

    def __init__(self, cfg: Sequence, num_classes: int = 1000,
                 width_mult: float = 1.0, dropout_rate: float = 0.5,
                 input_dim: int = 224, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
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
        self.dropout_rate = dropout_rate
        self.classifier = nn.Sequential(
            dense_init_(nn.Linear(channels * hw * hw, CLASSIFIER_WIDTH), generator),
            nn.ReLU(inplace=True),
            KeepMaskDropout(dropout_rate),
            dense_init_(nn.Linear(CLASSIFIER_WIDTH, CLASSIFIER_WIDTH), generator),
            nn.ReLU(inplace=True),
            KeepMaskDropout(dropout_rate),
            dense_init_(nn.Linear(CLASSIFIER_WIDTH, num_classes), generator),
        )

    def keep_masks(self, n: int, generator: torch.Generator | None,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The two (n, 4096) bool keep-masks of the classifier's dropouts,
        drawn from `generator`; None where no dropout applies."""
        if not self.training or self.dropout_rate == 0.0:
            return None
        if generator is None:
            raise ValueError("train-mode dropout draws its keep-masks from a generator: "
                             "pass `generator` or `keep`")
        return tuple(torch.rand((n, CLASSIFIER_WIDTH), generator=generator, device=device)
                     < 1.0 - self.dropout_rate for _ in range(2))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                keep: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        """`keep`: the two keep-masks, as `keep_masks` draws them; without
        them, train-mode dropout draws from `generator`."""
        # NHWC -> the NCHW view convolutions take; for a contiguous NHWC
        # input this view is channels-last in memory, so nothing is copied
        cd = self.compute_dtype
        stem = self.features[0]
        w, b = stem.weight, stem.bias
        if cd is not None:
            x, w, b = x.to(cd), w.to(cd), b.to(cd)
        x = torch.flatten(self._deep_features(vgg_stem(x.permute(0, 3, 1, 2), w, b)), 1)
        if keep is None:
            keep = self.keep_masks(x.shape[0], generator, x.device)
        c = self.classifier
        for i, (layer, dropout) in enumerate(((c[0], c[2]), (c[3], c[5]))):
            x = dropout(torch.relu(linear(layer, x, cd)), None if keep is None else keep[i])
        return linear(c[6], x, cd)

    def _deep_features(self, x: torch.Tensor) -> torch.Tensor:
        """The convolutions after the stem, at JAX's rounding points: a conv
        followed by a pool pools its output, then adds the bias
        (`_PrePoolConv`; rounding is monotone, so in f32 and f64 the values
        are those of bias, ReLU, pool); the others add it at once."""
        cd, layers = self.compute_dtype, self.features
        for i in range(3, len(layers)):  # conv, ReLU[, MaxPool2d]
            conv = layers[i]
            if not isinstance(conv, nn.Conv2d):
                continue
            if i + 2 < len(layers) and isinstance(layers[i + 2], nn.MaxPool2d):
                x = F.max_pool2d(conv2d(conv, x, cd, bias=False), 2)
                x = x + conv.bias.to(x.dtype)[:, None, None]
            else:
                x = conv2d(conv, x, cd)
            x = torch.relu(x)
        return x


def vgg11(num_classes: int = 1000, width_mult: float = 1.0,
          dropout_rate: float = 0.5, input_dim: int = 224,
          generator: torch.Generator | None = None,
          compute_dtype: torch.dtype | None = None) -> VGG:
    return VGG(CFG_A, num_classes=num_classes, width_mult=width_mult,
               dropout_rate=dropout_rate, input_dim=input_dim, generator=generator,
               compute_dtype=compute_dtype)
