"""The RGB-only student. Port of `pose3d_tpu/models/estimators.py`
(`_SixHeads`, `BaselineEstimator`).

vgg11(img_feature_dim) -> compress MLP img_feature_dim -> 800 -> 400 -> 200
(BN + ReLU each) -> six heads; projector 200 -> 200 (BN + ReLU) -> 200.
Forward returns ([6 heads], projector(compress(x))), heads in the order
[cls_azi, cls_ele, cls_inp, reg_azi, reg_ele, reg_inp] with
(360/bin, 180/bin, 360/bin) classes.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.models.common import dense_bn_relu, head_dense
from pose3d_tpu_torch.models.vgg import vgg11

COMPRESS_WIDTHS = (800, 400, 200)
# the six heads (JAX `_SixHeads`) sit directly on the estimator, as in the
# reference's state_dict
HEADS = ("fc_cls_azi", "fc_cls_ele", "fc_cls_inp",
         "fc_reg_azi", "fc_reg_ele", "fc_reg_inp")


class BaselineEstimator(nn.Module):
    """RGB-only student. Input (N, H, W, 3) float32; returns
    ([6 heads], projected_feat)."""

    def __init__(self, img_feature_dim: int = 2048, azi_classes: int = 24,
                 ele_classes: int = 12, inp_classes: int = 24, bin_size: int = 15,
                 width_mult: float = 1.0, dropout_rate: float = 0.5,
                 input_dim: int = 224, generator: torch.Generator | None = None):
        super().__init__()
        self.bin_size = bin_size
        self.img_encoder = vgg11(num_classes=img_feature_dim, width_mult=width_mult,
                                 dropout_rate=dropout_rate, input_dim=input_dim,
                                 generator=generator)
        layers: list[nn.Module] = []
        width = img_feature_dim
        for out in COMPRESS_WIDTHS:
            layers += dense_bn_relu(width, out, generator)
            width = out
        self.compress = nn.Sequential(*layers)
        for name, n in zip(HEADS, (azi_classes, ele_classes, inp_classes) * 2):
            setattr(self, name, head_dense(width, n, generator))
        self.projector = nn.Sequential(*dense_bn_relu(width, 200, generator),
                                       head_dense(200, 200, generator))

    def forward(self, im: torch.Tensor):
        x = self.compress(self.img_encoder(im))
        return [getattr(self, name)(x) for name in HEADS], self.projector(x)

    @torch.no_grad()
    def predict_viewpoint(self, im: torch.Tensor) -> torch.Tensor:
        """Serving: NHWC images -> (N, 3) degrees through the inference
        decoder, in canonical label convention. Call in eval mode."""
        outputs, _ = self(im)
        return geometry.decode_predictions_inference(outputs[:3], outputs[3:],
                                                     self.bin_size)
