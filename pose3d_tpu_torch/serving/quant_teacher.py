"""Post-training int8 quantization of the teachers' ResNets. Port of
`pose3d_tpu/serving/quant_teacher.py`.

Every block conv of a ResNet-50 (52: 3 a Bottleneck x 16, and 4
downsamples) or a ResNet-18 (19: 2 a BasicBlock x 8, and 3 downsamples)
runs s8 x s8 -> s32 in the port's int8 kernel (`ops.int8_conv`), its
eval-mode BatchNorm folded into the dequantization: y = z * (a * s[c]) +
h[c], s = ws * g, with g = scale / sqrt(var + eps) and h = bias - mean * g
from the running statistics. The 7x7 stem stays in the model dtype (a
convolution of the dtype's values summed in float32 and rounded to the
dtype, then `float32 * g + h`, the 3x3/2 max-pool, the ReLU and the cast,
JAX's rounding points), the average pool sums in float32 and rounds
to the dtype, and the fc runs in the dtype. Weights per output channel in
numpy float32 and activations per tensor from a float32 calibration forward,
as `quant_student`.

The teachers around the ResNets reuse the port's eval-mode modules in the
teacher's dtype: the PointCloud teacher's ShapeEncoderPC (the eval PointNet
kernel), DeformNet, the heads and the projector; the vanilla teacher's
compress MLP. The MultiView teacher quantizes both its ResNet-50 and the
ResNet-18 its render encoder runs over every view (`quantize_teacher_mv`).
The quantized trees follow JAX's schema ({stem, blocks[k][i]{w, s, h, a},
fc}, or {img, shape} of two), and `.npz` artifacts load across the two
packages (`quant_student.save_quantized`, `load_quantized_teacher`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pose3d_tpu_torch.models.common import linear, run_layers
from pose3d_tpu_torch.models.estimators import HEADS
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.ops import int8_conv as i8
from pose3d_tpu_torch.serving.quant_student import (_np, _tensors, act_scale, calibrate, hwio,
                                                    quantize_weight, read_npz)

_EPS = 1e-5  # flax's BatchNorm epsilon (ConvBN)

# JAX's arch table: the stages and the block; the downsample is the last
# ConvBN of a block that has one
_ARCHS = {
    "resnet50": {"stages": (3, 4, 6, 3), "block": "bottleneck"},
    "resnet18": {"stages": (2, 2, 2, 2), "block": "basic"},
}
TEACHER_GROUPS = {"stem", "blocks", "fc", "img", "shape"}


def _stage_first(stages) -> dict[int, int]:
    """block index k -> stride of each stage's opening block (stage 0
    opens at stride 1)."""
    out, k = {}, 0
    for i, n in enumerate(stages):
        out[k] = 1 if i == 0 else 2
        k += n
    return out


def _conv_specs(block: str, stride: int):
    """Each ConvBN's (stride, padding, relu_after) in application order
    (JAX's `_conv_specs`): Bottleneck 1x1/1 + relu, 3x3/s + relu, 1x1/1;
    BasicBlock 3x3/s + relu, 3x3/1. The block's output ReLU runs on y +
    residual."""
    if block == "bottleneck":
        return [(1, 0, True), (stride, 1, True), (1, 0, False)]
    return [(stride, 1, True), (1, 1, False)]


def _blocks(resnet):
    """The ResNet's blocks in order (JAX's Bottleneck_k / BasicBlock_k)."""
    return [b for i in range(resnet.n_stages) for b in getattr(resnet, f"layer{i + 1}")]


def _block_convbns(block) -> list:
    """(conv, bn) of each ConvBN of a port block in JAX's ConvBN_i order,
    the downsample last where there is one."""
    n = 3 if hasattr(block, "conv3") else 2
    pairs = [(getattr(block, f"conv{c}"), getattr(block, f"bn{c}")) for c in range(1, n + 1)]
    if block.downsample is not None:
        pairs.append((block.downsample[0], block.downsample[1]))
    return pairs


def _affine(bn) -> tuple[np.ndarray, np.ndarray]:
    """Eval BatchNorm as x * g + h, numpy float32 (JAX's `_affine`)."""
    g = _np(bn.weight) / np.sqrt(_np(bn.running_var) + _EPS)
    return g, _np(bn.bias) - _np(bn.running_mean) * g


def _affine_t(bn):
    g, h = _affine(bn)
    dev = bn.weight.device
    return torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)


@torch.no_grad()
def _observe_resnet(resnet, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The float32 eval replica of the ResNet (JAX's `_observe_resnet`):
    {quant point: max|x|} at each block conv's input."""
    stats = {}
    g, h = _affine_t(resnet.bn1)
    x = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), resnet.conv1.weight.float(),
                 stride=2, padding=3) * g[:, None, None] + h[:, None, None]
    x = torch.relu(F.max_pool2d(x, 3, 2, 1))
    for k, block in enumerate(_blocks(resnet)):
        pairs = _block_convbns(block)
        n = 3 if hasattr(block, "conv3") else 2
        residual, y = x, x
        for i, (conv, bn) in enumerate(pairs):
            g, h = _affine_t(bn)
            if i == n:  # the downsample
                stats[f"b{k}_{i}"] = residual.abs().max()
                residual = (F.conv2d(residual, conv.weight.float(), stride=conv.stride,
                                     padding=conv.padding) * g[:, None, None]
                            + h[:, None, None])
                continue
            stats[f"b{k}_{i}"] = y.abs().max()
            y = (F.conv2d(y, conv.weight.float(), stride=conv.stride, padding=conv.padding)
                 * g[:, None, None] + h[:, None, None])
            if i != n - 1:
                y = torch.relu(y)
        x = torch.relu(y + residual)
    return stats


def quantize_resnet(resnet, calibration_batches, arch: str = "resnet50") -> dict:
    """Quantize one port ResNet (`models.resnet.ResNet`, eval statistics):
    every block conv int8 with the BatchNorm folded into its dequantization;
    the 7x7 stem and the fc in full precision. Returns JAX's tree for
    `resnet_int8_forward`, its tensors on the ResNet's device."""
    if arch not in _ARCHS:
        raise ValueError(f"arch={arch!r}: one of {sorted(_ARCHS)}")
    device = resnet.conv1.weight.device
    maxes = calibrate(lambda x: _observe_resnet(resnet, x), calibration_batches, device)
    sg, sh = _affine(resnet.bn1)
    q = {"stem": {"kernel": hwio(resnet.conv1.weight), "g": sg, "h": sh}, "blocks": [],
         "fc": {"kernel": _np(resnet.fc.weight).T, "bias": _np(resnet.fc.bias)}}
    for k, block in enumerate(_blocks(resnet)):
        entries = []
        for i, (conv, bn) in enumerate(_block_convbns(block)):
            wq, ws = quantize_weight(hwio(conv.weight))
            g, h = _affine(bn)
            entries.append({"w": wq, "s": (ws * g).astype(np.float32), "h": h,
                            "a": np.float32(act_scale(maxes[f"b{k}_{i}"]))})
        q["blocks"].append(entries)
    return _tensors(q, device)


def resnet_int8_forward(q: dict, im: torch.Tensor, arch: str = "resnet50",
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The quantized eval forward of NHWC `im` -> the fc's output, in
    `dtype`."""
    a = _ARCHS[arch]
    n_convs = len(_conv_specs(a["block"], 1))
    stage_first = _stage_first(a["stages"])
    stem = q["stem"]
    # the conv of the dtype's values with float32 sums, rounded once to the
    # dtype: the function of JAX's (and cuDNN's) bf16 convolution, whose
    # roundings a bf16 library call on the CPU does not keep
    acc = torch.promote_types(dtype, torch.float32)
    x = F.conv2d(im.to(dtype).permute(0, 3, 1, 2).to(acc),
                 stem["kernel"].permute(3, 2, 0, 1).to(dtype).to(acc),
                 stride=2, padding=3).to(dtype)
    x = x.to(torch.float32) * stem["g"][:, None, None] + stem["h"][:, None, None]
    x = torch.relu(F.max_pool2d(x, 3, 2, 1)).to(dtype).permute(0, 2, 3, 1)
    for k, block in enumerate(q["blocks"]):
        stride = stage_first.get(k, 1)
        residual, y = x, x
        for (st, pad, relu_after), c in zip(_conv_specs(a["block"], stride), block[:n_convs]):
            y = i8.int8_conv(y, c["a"], c["w"], c["s"], c["h"], st, pad, relu=relu_after)
        if len(block) == n_convs + 1:
            c = block[n_convs]
            residual = i8.int8_conv(residual, c["a"], c["w"], c["s"], c["h"], stride, 0)
        x = torch.relu(y + residual)
    feat = x.to(torch.float32).mean(dim=(1, 2)).to(dtype)
    fc = q["fc"]
    return torch.matmul(feat, fc["kernel"].to(dtype)) + fc["bias"].to(dtype)


def resnet50_int8_forward(q: dict, im: torch.Tensor,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The quantized ResNet-50 eval forward (the teacher's image feature)."""
    return resnet_int8_forward(q, im, "resnet50", dtype)


def quantize_teacher_resnet(teacher, calibration_batches) -> dict:
    """The PointCloud teacher (`PoseEstimator`): its ResNet-50 image
    encoder quantized, for `make_teacher_int8_infer`."""
    return quantize_resnet(teacher.img_encoder, calibration_batches, "resnet50")


def quantize_teacher_mv(teacher, calibration_images, calibration_renders) -> dict:
    """The MultiView teacher: both conv trunks, the ResNet-50 image encoder
    and the ResNet-18 its render encoder runs over every view.
    calibration_renders: iterable of (N, K, H, W, 3). Returns {"img": q50,
    "shape": q18}."""
    flat = [np.asarray(r).reshape((-1,) + np.asarray(r).shape[2:]) for r in calibration_renders]
    return {"img": quantize_resnet(teacher.img_encoder, calibration_images, "resnet50"),
            "shape": quantize_resnet(teacher.shape_encoder.render_encoder, flat, "resnet18")}


def quantize_teacher_vanilla(teacher, calibration_batches) -> dict:
    """The vanilla teacher (`PoseEstimatorVanilla`): its ResNet-18 image
    encoder; the shape encoder, compress MLP and heads stay in the dtype."""
    return quantize_resnet(teacher.img_encoder, calibration_batches, "resnet18")


def _unflatten_resnet(items) -> dict:
    q = {"stem": {}, "blocks": [], "fc": {}}
    blocks: dict[int, dict[int, dict]] = {}
    for key, arr in items:
        parts = key.split("/")
        if parts[0] in ("stem", "fc"):
            q[parts[0]][parts[1]] = arr
        else:
            blocks.setdefault(int(parts[1]), {}).setdefault(int(parts[2]), {})[parts[3]] = arr
    q["blocks"] = [[blocks[k][i] for i in sorted(blocks[k])] for k in sorted(blocks)]
    return q


def load_quantized_teacher(path: str, device="cpu") -> dict:
    """Inverse of `save_quantized` for the teacher schemas (JAX's
    `load_quantized_teacher`): one quantized ResNet, or the MultiView
    pair {img, shape}."""
    data = read_npz(path, TEACHER_GROUPS, "teacher",
                    "student artifacts load via quant_student.load_quantized")
    items = [(k.split("/", 1)[1], v) for k, v in data.items()]
    if any(k.startswith(("img/", "shape/")) for k, _ in items):
        q = {side: _unflatten_resnet([(k.split("/", 1)[1], v) for k, v in items
                                      if k.startswith(side + "/")])
             for side in ("img", "shape")}
    else:
        q = _unflatten_resnet(items)
    return _tensors(q, device)


def _dtype(teacher) -> torch.dtype:
    """The dtype a teacher computes in: its compute dtype (bfloat16 under
    --bf16), else its parameters'."""
    return teacher.compute_dtype or next(teacher.parameters()).dtype


def _parts(teacher):
    """(image-feature q picker, shape-feature function) of a PointCloud or
    MultiView teacher: the PointCloud teacher's q is one ResNet-50 tree and
    its shape encoder is the eval PointNet; the MultiView teacher's q is
    {img, shape} and its renders go through the int8 ResNet-18."""
    dtype = _dtype(teacher)
    # an exported int8 MultiView teacher holds no float shape encoder
    # (serving/aot.py), so a missing one is the MultiView case
    if isinstance(getattr(teacher, "shape_encoder", None), ShapeEncoderPC):
        return (lambda q: q), (lambda q, shape: teacher.shape_encoder(shape.to(dtype)))

    def renders(q, shape):
        n, k = shape.shape[:2]
        flat = shape.reshape((n * k,) + shape.shape[2:])
        return resnet_int8_forward(q["shape"], flat, "resnet18", dtype).reshape(n, -1)

    return (lambda q: q["img"]), renders


def make_teacher_int8_infer(teacher):
    """teacher: a `PoseEstimator` in eval mode. Returns fn(q, im, shape) ->
    [6 head outputs] in the teacher's dtype: the conv trunks int8, the
    shape encoder (PointCloud), DeformNet and the heads through the port's
    modules. PointCloud: q = quantize_teacher_resnet(...); MultiView: q =
    quantize_teacher_mv(...)."""
    img_q, shape_feat = _parts(teacher)
    dtype = _dtype(teacher)

    @torch.no_grad()
    def infer(q, im, shape):
        teacher.eval()
        img_feature = resnet_int8_forward(img_q(q), im, "resnet50", dtype)
        x = teacher.deformNet(torch.cat([shape_feat(q, shape), img_feature], dim=-1))
        return [linear(getattr(teacher, name), x, teacher.compute_dtype) for name in HEADS]

    return infer


def make_teacher_int8_kd_fwd(teacher):
    """The frozen teacher's forward in the KD --crd step with its conv
    trunks int8: fn(q, im, shape, view_tile=3) -> (outputs, projector
    feature), elements 0 and 2 of `PoseEstimator.forward(im, shape,
    view_tile)`. `im` holds view_tile stacked views; `shape` only the
    leading samples' clouds or render stacks, each encoded once and its
    feature tiled (exact with eval-mode BatchNorm)."""
    img_q, shape_feat = _parts(teacher)
    dtype = _dtype(teacher)

    @torch.no_grad()
    def fwd(q, im, shape, view_tile=3):
        teacher.eval()
        img_feature = resnet_int8_forward(img_q(q), im, "resnet50", dtype)
        shape_feature = shape_feat(q, shape)
        if view_tile > 1:
            shape_feature = shape_feature.repeat(view_tile, 1)
        x = teacher.deformNet(torch.cat([shape_feature, img_feature], dim=-1))
        cd = teacher.compute_dtype
        return ([linear(getattr(teacher, name), x, cd) for name in HEADS],
                run_layers(teacher.projector, img_feature, None, cd))

    return fwd


def make_vanilla_int8_kd_fwd(teacher):
    """The frozen vanilla teacher's forward in the --stage 2 step:
    fn(q, im, shape, view_tile=3) -> [6 head outputs], element 0 of
    `PoseEstimatorVanilla.forward(im, shape, view_tile)`, its ResNet-18
    int8 (q = quantize_teacher_vanilla(...)). PointCloud only, as in JAX."""
    if not isinstance(teacher.shape_encoder, ShapeEncoderPC):
        raise NotImplementedError("int8 vanilla KD teacher: PointCloud only")
    dtype = _dtype(teacher)

    @torch.no_grad()
    def fwd(q, im, shape, view_tile=3):
        teacher.eval()
        img_feature = resnet_int8_forward(q, im, "resnet18", dtype)
        shape_feature = teacher.shape_encoder(shape.to(dtype))
        if view_tile > 1:
            shape_feature = shape_feature.repeat(view_tile, 1)
        cd = teacher.compute_dtype
        x = run_layers(teacher.compress, torch.cat([shape_feature, img_feature], dim=-1),
                       None, cd)
        return [linear(getattr(teacher, name), x, cd) for name in HEADS]

    return fwd
