"""Post-training int8 quantization of the student's serving path. Port of
`pose3d_tpu/serving/quant_student.py`.

Scope: inference (the six pose heads). A trained `BaselineEstimator` and a
few calibration batches give a quantized tree in JAX's schema (a dict of
tensors: `stem`, `convs`, `fcs`, `compress`, `heads`), which `save_quantized`
writes to, and `load_quantized` reads from, the same `.npz` layout as JAX's:
an artifact of either package loads in the other.

Scheme (symmetric PTQ, JAX's):
  * weights: int8 per output channel, ws[c] = max|W[..., c]| / 127, in
    numpy float32 as JAX's `_quantize_weight`; conv weights HWIO, dense
    weights (in, out), Dense_0's rows in flax's (H, W, C) flatten order
    (the port's model holds them as (C, H, W), `convert.py`: they are
    permuted back);
  * activations: int8 per tensor, a = max|x| / 127 over the calibration
    batches, from a float32 replica of the eval graph with TF32 off;
  * convs 1-7 and the three VGG dense layers: s8 x s8 -> s32 in the port's
    int8 kernel (`ops.int8_conv`), dequantized by (a * ws) and the bias;
    the four convs a 2x2 max-pool follows take it inside the kernel, on the
    s32 sums before the dequantization (`int8_conv(..., pool=True)`):
    JAX's order, and only the pooled quarter of the pixels is written;
  * the stem (conv + 2x2 pool, JAX's `_stem`: max of the window sums, then
    the bias and the ReLU) stays in the model dtype, in the port's stem
    kernel; the compress MLP with its BatchNorm folded into a per-channel
    affine (`_fold_bn`) and the six heads run in the model dtype, the heads
    widened to float32 at the end.

The activations between layers are NHWC in the model dtype, as in JAX.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from pose3d_tpu_torch.models.estimators import HEADS
from pose3d_tpu_torch.ops import int8_conv as i8
from pose3d_tpu_torch.ops.vgg_stem import vgg_stem

# VGG-A's feature plan (JAX's `_PLAN`): (kind, conv index); "stem" is the
# conv + pool of Conv_0, "prepool" a conv that a pool follows, "plain" a
# conv + ReLU
_PLAN = (("stem", 0), ("prepool", 1), ("plain", 2), ("prepool", 3),
         ("plain", 4), ("prepool", 5), ("plain", 6), ("prepool", 7))
_VGG_CONVS = (0, 3, 6, 8, 11, 13, 16, 18)  # Conv_i at `features.{_VGG_CONVS[i]}`
_EPS = 1e-5  # flax's BatchNorm epsilon (DenseBNRelu)
STUDENT_GROUPS = {"stem", "convs", "fcs", "compress", "heads"}


@contextlib.contextmanager
def exact_f32():
    """TF32 off for convolutions and matmuls while calibrating (restored
    after): the calibration forward is JAX's float32 one."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """JAX's `_quantize_weight`, in numpy float32: per output channel (the
    last axis) ws = max|w| / 127 (at least 1e-12) and round(w / ws) clamped
    to +-127 as int8."""
    w = np.asarray(w, np.float32)
    ws = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0) / 127.0
    ws = np.maximum(ws, 1e-12)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    return wq, ws.astype(np.float32)


def act_scale(max_abs: float) -> float:
    """a = max(max|x|, 1e-12) / 127 in Python's float64, rounded once to
    float32 (JAX's `jnp.float32(max(...) / 127.0)`)."""
    return float(np.float32(max(max_abs, 1e-12) / 127.0))


def hwio(conv_weight: torch.Tensor) -> np.ndarray:
    """A torch conv weight (O, I, KH, KW) as flax's HWIO kernel."""
    return conv_weight.detach().cpu().float().numpy().transpose(2, 3, 1, 0)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _fold_bn(layer, bn) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JAX's `_fold_bn`: relu(BN(x W + b)) with running statistics is
    relu((x W) * g + h), g = scale / sqrt(var + eps), h = bias + g (b -
    mean), in numpy float32. Returns (W (in, out), g, h)."""
    g = _np(bn.weight) / np.sqrt(_np(bn.running_var) + _EPS)
    h = _np(bn.bias) + g * (_np(layer.bias) - _np(bn.running_mean))
    return _np(layer.weight).T, g.astype(np.float32), h.astype(np.float32)


def dense0_hwc(weight: torch.Tensor, channels: int) -> np.ndarray:
    """classifier.0's weight (out, C*H*W), the port's (C, H, W) input order,
    as flax's Dense_0 kernel (H*W*C, out) in (H, W, C) order (`convert.py`
    the other way)."""
    w = _np(weight).T
    side = math.isqrt(w.shape[0] // channels)
    return (w.reshape(channels, side, side, -1).transpose(1, 2, 0, 3)
            .reshape(w.shape[0], -1))


@torch.no_grad()
def _observe_features(model, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The float32 replica of the student's eval feature graph (JAX's
    `_observe_features`): {quant point: max|x|} at each int8 layer's input."""
    vgg = model.img_encoder
    feats = vgg.features
    stem = feats[0]
    stats = {}
    x = vgg_stem(x.to(torch.float32).permute(0, 3, 1, 2), stem.weight.float(),
                 stem.bias.float())
    for kind, i in _PLAN[1:]:
        conv = feats[_VGG_CONVS[i]]
        stats[f"conv{i}"] = x.abs().max()
        y = F.conv2d(x, conv.weight.float(), padding=1)
        bias = conv.bias.float()[:, None, None]
        x = torch.relu(F.max_pool2d(y, 2) + bias if kind == "prepool" else y + bias)
    x = torch.flatten(x, 1)  # (C, H, W): classifier.0's order in the port
    c = vgg.classifier
    for d, layer in enumerate((c[0], c[3], c[6])):
        stats[f"fc{d}"] = x.abs().max()
        x = F.linear(x, layer.weight.float(), layer.bias.float())
        if d < 2:
            x = torch.relu(x)
    return stats


def calibrate(observe, batches, device) -> dict[str, float]:
    """The largest max|x| of each quant point over the batches."""
    maxes: dict[str, float] = {}
    with exact_f32():
        for batch in batches:
            for k, v in observe(torch.as_tensor(np.asarray(batch, np.float32),
                                                device=device)).items():
                maxes[k] = max(maxes.get(k, 0.0), float(v))
    if not maxes:
        raise ValueError("calibration_batches was empty")
    return maxes


def _tensors(tree, device):
    """numpy leaves -> tensors on `device` (0-d float32 for the scales). The
    int8 weights ("w": HWIO convs, (in, out) dense layers) keep their shape
    and values, stored K-major (`ops.int8_conv.k_major`), the layout the
    int8 kernel reads: the copy is made here, once a tree, and never
    written (`save_quantized` writes the HWIO values, JAX's schema)."""
    if isinstance(tree, dict):
        return {k: (i8.k_major(np.asarray(v)).to(device)
                    if k == "w" and np.asarray(v).dtype == np.int8 else _tensors(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree)).to(device)


def quantize_student(model, calibration_batches) -> dict:
    """model: a trained `BaselineEstimator` (its eval-mode weights and
    running statistics); calibration_batches: iterable of (N, H, W, 3)
    image arrays (the normalized crops the model takes). Returns the
    quantized tree, JAX's schema, its tensors on the model's device."""
    device = next(model.parameters()).device
    maxes = calibrate(lambda x: _observe_features(model, x), calibration_batches, device)
    feats, cls = model.img_encoder.features, model.img_encoder.classifier
    stem = feats[0]
    q = {"stem": {"kernel": hwio(stem.weight), "bias": _np(stem.bias)}, "convs": [], "fcs": []}
    for _kind, i in _PLAN[1:]:
        conv = feats[_VGG_CONVS[i]]
        wq, ws = quantize_weight(hwio(conv.weight))
        q["convs"].append({"w": wq, "ws": ws, "b": _np(conv.bias),
                           "a": np.float32(act_scale(maxes[f"conv{i}"]))})
    last_channels = feats[_VGG_CONVS[-1]].weight.shape[0]
    for d, layer in enumerate((cls[0], cls[3], cls[6])):
        kernel = dense0_hwc(layer.weight, last_channels) if d == 0 else _np(layer.weight).T
        wq, ws = quantize_weight(kernel)
        q["fcs"].append({"w": wq, "ws": ws, "b": _np(layer.bias),
                         "a": np.float32(act_scale(maxes[f"fc{d}"]))})
    q["compress"] = [_fold_bn(model.compress[3 * j], model.compress[3 * j + 1])
                     for j in range(3)]
    q["heads"] = [(_np(getattr(model, name).weight).T, _np(getattr(model, name).bias))
                  for name in HEADS]
    return _tensors(q, device)


def _stem(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """JAX's `_stem` + ReLU in `dtype`: the conv + 2x2 pool of NHWC `x`
    (max of the window sums, then the bias, then the ReLU) through the stem
    kernel in its serving form. Returns NHWC."""
    y = vgg_stem(x.to(dtype).permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(dtype),
                 bias.to(dtype))
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def student_int8_infer(q: dict, im: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> list[torch.Tensor]:
    """The int8 serving forward. im: (N, H, W, 3) float. Returns the six
    head outputs in float32, in the order [cls_azi, cls_ele, cls_inp,
    reg_azi, reg_ele, reg_inp]."""
    x = _stem(im, q["stem"]["kernel"], q["stem"]["bias"], dtype)
    kinds = [k for k, _ in _PLAN if k != "stem"]
    for kind, c in zip(kinds, q["convs"]):
        x = i8.int8_conv(x, c["a"], c["w"], c["ws"], c["b"], stride=1, padding=1, relu=True,
                         pool=kind == "prepool")
    x = x.reshape(x.shape[0], -1)  # (H, W, C): Dense_0's row order in q
    for d, f in enumerate(q["fcs"]):
        x = i8.int8_dense(x, f["a"], f["w"], f["ws"], f["b"], relu=d < 2)
    for w, g, h in q["compress"]:
        x = torch.relu(torch.matmul(x, w.to(dtype)) * g.to(dtype) + h.to(dtype))
    return [(torch.matmul(x, w.to(dtype)) + b.to(dtype)).float() for w, b in q["heads"]]


def flatten_tree(tree, prefix: str = "q") -> dict[str, np.ndarray]:
    """JAX's `save_quantized` key scheme: dict keys and list / tuple
    positions joined by '/', under 'q'."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_tree(v, f"{prefix}/{i}"))
    else:
        flat[prefix] = (tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                        else np.asarray(tree))
    return flat


def save_quantized(q: dict, path: str) -> None:
    """Write a quantized tree (student or teacher) as one .npz in JAX's
    schema; int8 weights stay int8 on disk."""
    np.savez(path, **flatten_tree(q))


def read_npz(path: str, groups: set[str], kind: str, other: str) -> dict[str, np.ndarray]:
    """The arrays of a quantized .npz whose top-level groups are within
    `groups`, or a ValueError naming the other artifact kind's loader."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    found = {k.split("/")[1] for k in data.keys()}
    if not found <= groups:
        raise ValueError(f"{path}: not a {kind} int8 artifact (top-level groups "
                         f"{sorted(found)}); {other}")
    return {k: data[k] for k in data.keys()}


def load_quantized(path: str, device="cpu") -> dict:
    """Inverse of `save_quantized` for the STUDENT schema (JAX's
    `load_quantized`): a student artifact of either package. Teacher
    artifacts load through `quant_teacher.load_quantized_teacher`."""
    data = read_npz(path, STUDENT_GROUPS, "student",
                    "teacher artifacts load via load_quantized_teacher / the --ply_path "
                    "teacher mode")
    q = {"stem": {}, "convs": [], "fcs": [], "compress": [], "heads": []}
    convs, fcs, compress, heads = {}, {}, {}, {}
    for key, arr in data.items():
        parts = key.split("/")[1:]
        if parts[0] == "stem":
            q["stem"][parts[1]] = arr
        elif parts[0] in ("convs", "fcs"):
            (convs if parts[0] == "convs" else fcs).setdefault(
                int(parts[1]), {})[parts[2]] = arr
        else:
            (compress if parts[0] == "compress" else heads).setdefault(
                int(parts[1]), {})[int(parts[2])] = arr
    q["convs"] = [convs[i] for i in sorted(convs)]
    q["fcs"] = [fcs[i] for i in sorted(fcs)]
    q["compress"] = [tuple(compress[i][j] for j in sorted(compress[i])) for i in sorted(compress)]
    q["heads"] = [tuple(heads[i][j] for j in sorted(heads[i])) for i in sorted(heads)]
    return _tensors(q, device)
