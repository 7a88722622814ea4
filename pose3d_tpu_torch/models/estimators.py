"""The pose estimators. Port of `pose3d_tpu/models/estimators.py`
(`_SixHeads`, `BaselineEstimator`, `PoseEstimator` and
`PoseEstimatorVanilla`, each with a point cloud or with a ring of renders).

  * BaselineEstimator, the RGB-only student: vgg11(img_feature_dim) ->
    compress MLP img_feature_dim -> 800 -> 400 -> 200 (BN + ReLU each) ->
    six heads; projector 200 -> 200 (BN + ReLU) -> 200. Forward returns
    ([6 heads], projector(compress(x))).
  * PoseEstimator, the teacher: resnet50 (its head's output is the image
    feature) and the shape encoder, concat (shape, image) -> DeformNet ->
    the 200-d fused feature; six heads on it; projector img_feature -> 800
    -> 400 (BN + ReLU each) -> 200. Forward returns ([6 heads], fused,
    projector(img_feature)).
  * PoseEstimatorVanilla, the KD `--stage 1` teacher: resnet18 (its head's
    output is the image feature) and the shape encoder, concat (shape,
    image) -> compress MLP -> 800 -> 400 -> 200 (BN + ReLU each) -> six
    heads. Forward returns ([6 heads], compress(x)).

The shape encoder is `shape="PointCloud"`'s ShapeEncoderPC (a
shape_feature_dim feature from (N, P, 3) clouds) or `shape="MultiView"`'s
ShapeEncoderMV (ResNet-18 over each of the `view_num` renders of (N,
view_num, H, W, 3), shape_feature_dim each, concatenated: a
shape_feature_dim * view_num feature). Flax infers the widths that follow
from it; here `_shape_encoder` computes them.

Heads in the order [cls_azi, cls_ele, cls_inp, reg_azi, reg_ele, reg_inp]
with (360/bin, 180/bin, 360/bin) classes.

`compute_dtype` (torch.bfloat16 under `--bf16`; None: the parameters'
dtype) is handed to every layer, as JAX's estimators hand `dtype` down:
the outputs come in it, and the steps and the decoders widen them to
float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.models.common import dense_bn_relu, head_dense, linear, run_layers
from pose3d_tpu_torch.models.deformnet import DeformNet
from pose3d_tpu_torch.models.multiview import ShapeEncoderMV
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.models.resnet import resnet18, resnet50
from pose3d_tpu_torch.models.vgg import vgg11

COMPRESS_WIDTHS = (800, 400, 200)
PROJECTOR_WIDTHS = (800, 400)  # the teacher's projector, then a plain 200
# the six heads (JAX `_SixHeads`) sit directly on the estimator, as in the
# reference's state_dict
HEADS = ("fc_cls_azi", "fc_cls_ele", "fc_cls_inp",
         "fc_reg_azi", "fc_reg_ele", "fc_reg_inp")
SHAPES = ("PointCloud", "MultiView")


def _shape_encoder(shape: str, shape_feature_dim: int, view_num: int, generator,
                   compute_dtype) -> tuple[nn.Module, int]:
    """The shape encoder of `shape` and the width of its feature."""
    if shape == "PointCloud":
        return (ShapeEncoderPC(shape_feature_dim, generator=generator,
                               compute_dtype=compute_dtype), shape_feature_dim)
    if shape == "MultiView":
        return (ShapeEncoderMV(shape_feature_dim, generator=generator,
                               compute_dtype=compute_dtype), shape_feature_dim * view_num)
    raise ValueError(f"shape={shape!r}: one of {SHAPES}")


class BaselineEstimator(nn.Module):
    """RGB-only student. Input (N, H, W, 3) float32; returns
    ([6 heads], projected_feat). Trains in train mode (batch-statistics
    BatchNorm with `mask`, classifier dropout at `dropout_rate`; 0 makes
    the student deterministic, as JAX's parity runs do)."""

    def __init__(self, img_feature_dim: int = 2048, azi_classes: int = 24,
                 ele_classes: int = 12, inp_classes: int = 24, bin_size: int = 15,
                 width_mult: float = 1.0, dropout_rate: float = 0.5,
                 input_dim: int = 224, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.bin_size = bin_size
        self.compute_dtype = compute_dtype
        self.img_encoder = vgg11(num_classes=img_feature_dim, width_mult=width_mult,
                                 dropout_rate=dropout_rate, input_dim=input_dim,
                                 generator=generator, compute_dtype=compute_dtype)
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

    def forward(self, im: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                keep: Sequence[torch.Tensor] | None = None):
        """`mask`: (N,) bool, the valid rows of a padded batch in train
        mode (kept out of every BatchNorm's statistics). `generator` /
        `keep`: the classifier dropout's keep-masks in train mode, drawn
        from the generator unless given (`VGG.forward`)."""
        cd = self.compute_dtype
        x = run_layers(self.compress, self.img_encoder(im, generator, keep), mask, cd)
        return ([linear(getattr(self, name), x, cd) for name in HEADS],
                run_layers(self.projector, x, mask, cd))

    @torch.no_grad()
    def predict_viewpoint(self, im: torch.Tensor) -> torch.Tensor:
        """Serving: NHWC images -> (N, 3) degrees through the inference
        decoder, in canonical label convention. Call in eval mode."""
        outputs = [o.float() for o in self(im)[0]]
        return geometry.decode_predictions_inference(outputs[:3], outputs[3:],
                                                     self.bin_size)


class PoseEstimator(nn.Module):
    """The teacher. Inputs im (N, H, W, 3) and shape (N', P, 3) clouds or
    (N', view_num, H', W', 3) renders, float32; returns ([6 heads],
    fused_200d, projector(img_feature)). Trains in train mode
    (batch-statistics BatchNorm, with `mask`)."""

    def __init__(self, shape: str = "PointCloud", img_feature_dim: int = 1024,
                 shape_feature_dim: int = 1024, azi_classes: int = 24,
                 ele_classes: int = 12, inp_classes: int = 24, bin_size: int = 15,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None, view_num: int = 12):
        super().__init__()
        self.bin_size = bin_size
        self.compute_dtype = compute_dtype
        self.img_encoder = resnet50(num_classes=img_feature_dim, generator=generator,
                                    compute_dtype=compute_dtype)
        self.shape_encoder, shape_width = _shape_encoder(shape, shape_feature_dim, view_num,
                                                         generator, compute_dtype)
        self.deformNet = DeformNet(shape_width + img_feature_dim,
                                   generator=generator, compute_dtype=compute_dtype)
        for name, n in zip(HEADS, (azi_classes, ele_classes, inp_classes) * 2):
            setattr(self, name, head_dense(200, n, generator))
        layers: list[nn.Module] = []
        width = img_feature_dim
        for out in PROJECTOR_WIDTHS:
            layers += dense_bn_relu(width, out, generator)
            width = out
        self.projector = nn.Sequential(*layers, head_dense(width, 200, generator))

    def forward(self, im: torch.Tensor, shape: torch.Tensor, view_tile: int = 1,
                mask: torch.Tensor | None = None):
        """view_tile > 1: `im` holds view_tile stacked views of the same
        samples (the KD step's [im, im_flip, im_rot]) and `shape` only the
        leading im.shape[0] / view_tile clouds or render stacks. Each is
        encoded once and its feature tiled as `jnp.tile` does: rows 0..n-1, then 0..n-1
        again (not each row repeated in place). It is exact only with
        running-statistics BatchNorm, so eval mode only, as in JAX.
        `mask`: (N,) bool, the valid rows of a padded batch in train mode."""
        if view_tile > 1 and self.training:
            raise ValueError("view_tile tiling is only exact with eval-mode BatchNorm")
        _, img_feature = self.img_encoder(im, mask)
        shape_feature = self.shape_encoder(shape, mask)
        if view_tile > 1:
            shape_feature = shape_feature.repeat(view_tile, 1)
        x = self.deformNet(torch.cat([shape_feature, img_feature], dim=-1), mask)
        cd = self.compute_dtype
        return ([linear(getattr(self, name), x, cd) for name in HEADS], x,
                run_layers(self.projector, img_feature, mask, cd))

    @torch.no_grad()
    def predict_viewpoint(self, im: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
        """Serving: NHWC images and their clouds or renders -> (N, 3)
        degrees through the inference decoder, in canonical label
        convention. Call in eval mode."""
        outputs = [o.float() for o in self(im, shape)[0]]
        return geometry.decode_predictions_inference(outputs[:3], outputs[3:],
                                                     self.bin_size)


class PoseEstimatorVanilla(nn.Module):
    """The vanilla teacher of KD `--stage 1`. Inputs im (N, H, W, 3) and
    shape (N', P, 3) clouds or (N', view_num, H', W', 3) renders, float32;
    returns ([6 heads], compressed_200d). Trains in train mode
    (batch-statistics BatchNorm, with `mask`; a PointNet in its train-mode
    kernel on the card)."""

    def __init__(self, shape: str = "PointCloud", img_feature_dim: int = 1024,
                 shape_feature_dim: int = 256, azi_classes: int = 24,
                 ele_classes: int = 12, inp_classes: int = 24, bin_size: int = 15,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None, view_num: int = 12):
        super().__init__()
        self.bin_size = bin_size
        self.compute_dtype = compute_dtype
        self.img_encoder = resnet18(num_classes=img_feature_dim, generator=generator,
                                    compute_dtype=compute_dtype)
        self.shape_encoder, shape_width = _shape_encoder(shape, shape_feature_dim, view_num,
                                                         generator, compute_dtype)
        layers: list[nn.Module] = []
        width = shape_width + img_feature_dim
        for out in COMPRESS_WIDTHS:
            layers += dense_bn_relu(width, out, generator)
            width = out
        self.compress = nn.Sequential(*layers)
        for name, n in zip(HEADS, (azi_classes, ele_classes, inp_classes) * 2):
            setattr(self, name, head_dense(width, n, generator))

    def forward(self, im: torch.Tensor, shape: torch.Tensor, view_tile: int = 1,
                mask: torch.Tensor | None = None):
        """view_tile and mask as `PoseEstimator.forward` takes them
        (view_tile > 1 in eval mode only)."""
        if view_tile > 1 and self.training:
            raise ValueError("view_tile tiling is only exact with eval-mode BatchNorm")
        _, img_feature = self.img_encoder(im, mask)
        shape_feature = self.shape_encoder(shape, mask)
        if view_tile > 1:
            shape_feature = shape_feature.repeat(view_tile, 1)
        cd = self.compute_dtype
        x = run_layers(self.compress, torch.cat([shape_feature, img_feature], dim=-1), mask, cd)
        return [linear(getattr(self, name), x, cd) for name in HEADS], x

    @torch.no_grad()
    def predict_viewpoint(self, im: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
        """Serving: as `PoseEstimator.predict_viewpoint`. Call in eval mode."""
        outputs = [o.float() for o in self(im, shape)[0]]
        return geometry.decode_predictions_inference(outputs[:3], outputs[3:],
                                                     self.bin_size)
