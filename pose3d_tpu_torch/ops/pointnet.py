"""Eval-mode PointNet shape encoder, fused: the CUDA kernel
`csrc/pointnet_eval.cu` and its wrapper.

Port of `pose3d_tpu/ops/pointnet_fused.py` (`fold_pointnet_params`,
`_xla_pointnet_eval`, `fused_pointnet_eval`). Eval-mode BatchNorm is an
affine map, so each Conv1d + BatchNorm pair of `models.pointnet.
ShapeEncoderPC` folds into one (W, b): W' = W * g, b' = b * g + c with
g = scale / sqrt(var + eps) and c = shift - mean * g. The encoder is then
3 -> 64 (ReLU) -> 128 (ReLU) -> D, then a max over the points; the kernel
keeps the (N, P, D) activation out of device memory.

bf16 (`--bf16`, flax's bfloat16 compute in `models/pointnet.py
dense_bn_forward`) is another function: each layer rounds x W to bf16,
adds b in bf16, and normalises in f32 before it rounds again, which no
folded (W, b) reproduces. `eval_layers_bf16` gives the unfolded layers,
`pointnet_eval_bf16_plain` the function and `pointnet_eval_bf16` its
kernel (the bf16 instance in the same source, on the bf16 tensor cores),
with its own launch count.

Both instances are custom ops (`pose3d_torch::pointnet_eval`,
`pose3d_torch::pointnet_eval_bf16`) on flat parameter lists: the CUDA
kernel the hand kernel, the CPU kernel the plain version, the fake
implementation the (N, D) output, so that `torch.export` keeps the encoder
whole in an exported graph (`serving/aot.py`) and no size of a symbolic
batch reaches Python (`segments_for` runs inside the CUDA kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Sequence

import torch

from pose3d_tpu_torch.ops import _build

# the kernel's tiling (csrc/pointnet_eval.cu kTileP, kChunkD) and its fixed
# hidden widths (ShapeEncoderPC's 64 and 128)
TILE_P, CHUNK_D = 128, 256
HIDDEN = (64, 128)
# a tile's layers 1-2 (8,384 f32 FMAs a point on the CUDA cores) and a
# block's setup (W2 into shared memory, the ring's first k-steps), in units
# of one 256-column pass of layer 3 over a tile (split TF32 on the tensor
# cores); estimates that steer the split
_LAYERS12_PASSES, _BLOCK_SETUP_PASSES = 0.5, 0.1

Folded = Sequence[tuple[torch.Tensor, torch.Tensor]]
# per layer: W (in, out) and b (out,) in bf16, and the eval BN (3, out) in
# f32: the running mean, rsqrt(var + eps) * scale, and the shift
Unfolded = Sequence[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def fold_pointnet_params(state: Mapping[str, torch.Tensor], eps: float = 1e-5) -> Folded:
    """ShapeEncoderPC weights in the reference layout (`conv{i}.weight`
    (out, in, 1), `conv{i}.bias`, `bn{i}.weight/bias/running_mean/
    running_var`, i = 1..3) -> three (W (in, out), b (out,)) pairs."""
    folded = []
    for i in (1, 2, 3):
        w = state[f"conv{i}.weight"][:, :, 0].t()
        g = state[f"bn{i}.weight"] / torch.sqrt(state[f"bn{i}.running_var"] + eps)
        c = state[f"bn{i}.bias"] - state[f"bn{i}.running_mean"] * g
        folded.append(((w * g[None, :]).contiguous(), state[f"conv{i}.bias"] * g + c))
    return folded


def pointnet_eval_plain(points: torch.Tensor, folded: Folded) -> torch.Tensor:
    """The plain version: Dense + ReLU, Dense + ReLU, Dense, max over points."""
    (w1, b1), (w2, b2), (w3, b3) = folded
    h = torch.relu(points @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    h = h @ w3 + b3
    return h.amax(dim=1)


def eval_layers_bf16(state: Mapping[str, torch.Tensor], eps: float = 1e-5) -> Unfolded:
    """ShapeEncoderPC weights in the reference layout -> the bf16 instance's
    three (W (in, out) bf16, b bf16, bn (3, out) f32) layers; the BN
    multiplier rsqrt(var + eps) * scale in f32, as flax computes it."""
    layers = []
    for i in (1, 2, 3):
        var, scale = state[f"bn{i}.running_var"].float(), state[f"bn{i}.weight"].float()
        bn = torch.stack([state[f"bn{i}.running_mean"].float(), torch.rsqrt(var + eps) * scale,
                          state[f"bn{i}.bias"].float()])
        layers.append((state[f"conv{i}.weight"][:, :, 0].t().to(torch.bfloat16).contiguous(),
                       state[f"conv{i}.bias"].to(torch.bfloat16).contiguous(), bn.contiguous()))
    return layers


def pointnet_eval_bf16_plain(points: torch.Tensor, layers: Unfolded) -> torch.Tensor:
    """The plain bf16 version, flax's rounding points: per layer
    bf16(x W) (f32 sums of the exact products), + b rounded to bf16, the BN
    (h - mean) * mul + shift in f32 rounded to bf16, ReLU on layers 1-2;
    then the max over the points."""
    x = points
    for i, (w, b, bn) in enumerate(layers):
        h = (x.float() @ w.float()).to(torch.bfloat16)
        h = (h.float() + b.float()).to(torch.bfloat16)
        y = ((h.float() - bn[0]) * bn[1] + bn[2]).to(torch.bfloat16)
        x = torch.relu(y) if i < 2 else y
    return x.amax(dim=1)


@functools.cache
def segments_for(n: int, p: int, d: int, sms: int) -> tuple[int, int]:
    """(segments, groups): how many blocks share one cloud's points (runs of
    whole TILE_P tiles) and its columns (runs of whole CHUNK_D passes), so
    that the grid of n x segments x groups blocks (one an SM at a time)
    keeps the card's `sms` SMs busy: the split that minimises waves x a
    block's work, which is its tiles x (layers 1-2, computed once a tile of
    each group, + its passes) + its setup. Ties keep fewer groups, then
    fewer segments."""
    tiles, passes = -(-p // TILE_P), -(-d // CHUNK_D)
    best, best_cost = (1, 1), None
    for groups in range(1, passes + 1):
        per_group = -(-passes // groups)
        if -(-passes // per_group) < groups:
            continue  # a group would have no columns
        for per in range(tiles, max(1, -(-tiles // 65535)) - 1, -1):
            segments = -(-tiles // per)
            cost = -(-n * segments * groups // sms) * (
                per * (_LAYERS12_PASSES + per_group) + _BLOCK_SETUP_PASSES)
            if best_cost is None or cost < best_cost:
                best, best_cost = (segments, groups), cost
    return best


@functools.cache
def _lib(path: str | None = None):
    """The kernels' library, its entry points typed: csrc/pointnet_eval.cu's
    build, or the library at `path`, built from another version of the
    source with the same C interface."""
    lib = _build.load("pointnet_eval") if path is None else ctypes.CDLL(path)
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    lib.pointnet_eval.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pointnet_eval.restype = ctypes.c_int
    lib.pointnet_eval_scratch_floats.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.pointnet_eval_scratch_floats.restype = ctypes.c_int64
    lib.pointnet_eval_smem_bytes.restype = ctypes.c_int
    lib.pointnet_eval_bf16.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pointnet_eval_bf16.restype = ctypes.c_int
    lib.pointnet_eval_bf16_scratch_words.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                                     ctypes.c_int]
    lib.pointnet_eval_bf16_scratch_words.restype = ctypes.c_int64
    lib.pointnet_eval_bf16_smem_bytes.restype = ctypes.c_int
    return lib


def shared_memory_bytes(dtype: torch.dtype = torch.float32) -> int:
    """The dynamic shared memory a block of the kernel takes (builds it):
    the f32 instance's, or the bf16 one's."""
    if dtype == torch.bfloat16:
        return _lib().pointnet_eval_bf16_smem_bytes()
    return _lib().pointnet_eval_smem_bytes()


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(points: torch.Tensor, folded: Folded) -> int:
    """Validate shapes, dtypes and devices; return D."""
    if len(folded) != 3:
        raise ValueError(f"pointnet_eval takes three folded (W, b) pairs; got {len(folded)}")
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"pointnet_eval takes (N, P, 3) points; got {tuple(points.shape)}")
    d = folded[2][0].shape[-1]
    want = [(3, HIDDEN[0]), (HIDDEN[0],), (HIDDEN[0], HIDDEN[1]), (HIDDEN[1],),
            (HIDDEN[1], d), (d,)]
    tensors = [t for pair in folded for t in pair]
    got = [tuple(t.shape) for t in tensors]
    if got != want:
        raise ValueError(f"pointnet_eval: folded shapes {got}, expected {want}")
    for t in [points] + tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"pointnet_eval takes float32 tensors; got {t.dtype}")
        if t.device != points.device:
            raise ValueError("pointnet_eval: inputs on different devices "
                             f"({points.device}, {t.device})")
    if points.shape[1] == 0:
        raise ValueError("pointnet_eval: a max over zero points is undefined (P = 0)")
    return d


def _kernel_sizes(name: str, tensors: Sequence[torch.Tensor], d: int) -> tuple[int, int]:
    """(N, P) of the points, refused where the kernel does not take them."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s kernel takes contiguous tensors")
    n, p = tensors[0].shape[0], tensors[0].shape[1]
    if n >= 2**31 or 3 * p >= 2**31 or d >= 2**31 // 256:
        raise ValueError(f"{name}'s kernel takes N < 2^31, 3P < 2^31 and D < 2^23; got "
                         f"{(n, p, d)}")
    return n, p


@torch.library.custom_op("pose3d_torch::pointnet_eval", mutates_args=(), device_types="cuda")
def pointnet_eval_op(points: torch.Tensor, params: list[torch.Tensor]) -> torch.Tensor:
    """`pointnet_eval` as an opaque op, which `torch.export` keeps whole:
    params the flat (w1, b1, w2, b2, w3, b3). A CUDA tensor launches the
    kernel (its scratch and its split chosen here, at run time); a CPU one
    takes `pointnet_eval_plain`."""
    d = params[5].shape[0]
    n, p = _kernel_sizes("pointnet_eval", [points, *params], d)
    out = torch.empty((n, d), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    segments, groups = segments_for(n, p, d, _sm_count(points.device))
    lib = _lib()
    scratch = torch.empty(lib.pointnet_eval_scratch_floats(n, d, segments),
                          dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = lib.pointnet_eval(points.data_ptr(), *(t.data_ptr() for t in params),
                                out.data_ptr(), scratch.data_ptr(), n, p, d, segments, groups,
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_eval kernel launch failed: cudaError_t {err}")
    pointnet_eval.launches += 1
    return out


@pointnet_eval_op.register_kernel("cpu")
def _(points, params):
    return pointnet_eval_plain(points, list(zip(params[::2], params[1::2])))


@pointnet_eval_op.register_fake
def _(points, params):
    return points.new_empty((points.shape[0], params[5].shape[0]))


def pointnet_eval(points: torch.Tensor, folded: Folded) -> torch.Tensor:
    """(N, P, 3) float32 points, folded parameters -> (N, D) float32.

    A CPU tensor goes to `pointnet_eval_plain`. A CUDA tensor goes to the
    kernel, on the current stream, or the call raises: there is no
    fallback. Each launch adds one to `pointnet_eval.launches`. Both go
    through the op `pose3d_torch::pointnet_eval`.
    """
    _check(points, folded)
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pointnet_eval has no kernel for device {points.device}")
    return pointnet_eval_op(points, [t for pair in folded for t in pair])


pointnet_eval.launches = 0


def _check_bf16(points: torch.Tensor, layers: Unfolded) -> int:
    """Validate the bf16 instance's shapes, dtypes and devices; return D."""
    if len(layers) != 3:
        raise ValueError(f"pointnet_eval_bf16 takes three (W, b, bn) layers; got {len(layers)}")
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"pointnet_eval_bf16 takes (N, P, 3) points; got {tuple(points.shape)}")
    d = layers[2][0].shape[-1]
    widths = (3, *HIDDEN, d)
    for i, (w, b, bn) in enumerate(layers):
        want = [(widths[i], widths[i + 1]), (widths[i + 1],), (3, widths[i + 1])]
        if [tuple(w.shape), tuple(b.shape), tuple(bn.shape)] != want:
            raise ValueError(f"pointnet_eval_bf16: layer {i + 1} shapes {tuple(w.shape)}, "
                             f"{tuple(b.shape)}, {tuple(bn.shape)}, expected {want}")
        if (w.dtype, b.dtype, bn.dtype) != (torch.bfloat16, torch.bfloat16, torch.float32):
            raise TypeError("pointnet_eval_bf16 takes W and b in bfloat16 and the BN in "
                            f"float32; got {w.dtype}, {b.dtype}, {bn.dtype}")
    if points.dtype != torch.bfloat16:
        raise TypeError(f"pointnet_eval_bf16 takes bfloat16 points; got {points.dtype}")
    if any(t.device != points.device for layer in layers for t in layer):
        raise ValueError("pointnet_eval_bf16: inputs on different devices")
    if points.shape[1] == 0:
        raise ValueError("pointnet_eval_bf16: a max over zero points is undefined (P = 0)")
    return d


@torch.library.custom_op("pose3d_torch::pointnet_eval_bf16", mutates_args=(),
                         device_types="cuda")
def pointnet_eval_bf16_op(points: torch.Tensor, params: list[torch.Tensor]) -> torch.Tensor:
    """`pointnet_eval_bf16` as an opaque op: params the flat (w1, b1, bn1,
    w2, b2, bn2, w3, b3, bn3). A CUDA tensor launches the bf16 kernel; a
    CPU one takes `pointnet_eval_bf16_plain`."""
    d = params[7].shape[0]
    n, p = _kernel_sizes("pointnet_eval_bf16", [points, *params], d)
    out = torch.empty((n, d), dtype=torch.bfloat16, device=points.device)
    if n == 0:
        return out
    segments, groups = segments_for(n, p, d, _sm_count(points.device))
    lib = _lib()
    scratch = torch.empty(lib.pointnet_eval_bf16_scratch_words(n, d, segments),
                          dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = lib.pointnet_eval_bf16(points.data_ptr(), *(t.data_ptr() for t in params),
                                     out.data_ptr(), scratch.data_ptr(), n, p, d, segments,
                                     groups, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_eval_bf16 kernel launch failed: cudaError_t {err}")
    pointnet_eval_bf16.launches += 1
    return out


@pointnet_eval_bf16_op.register_kernel("cpu")
def _(points, params):
    return pointnet_eval_bf16_plain(points, [params[i:i + 3] for i in (0, 3, 6)])


@pointnet_eval_bf16_op.register_fake
def _(points, params):
    return points.new_empty((points.shape[0], params[7].shape[0]))


def pointnet_eval_bf16(points: torch.Tensor, layers: Unfolded) -> torch.Tensor:
    """(N, P, 3) bfloat16 points, the unfolded layers of `eval_layers_bf16`
    -> (N, D) bfloat16.

    A CPU tensor goes to `pointnet_eval_bf16_plain`. A CUDA tensor goes to
    the bf16 kernel, on the current stream, or the call raises: there is no
    fallback. Each launch adds one to `pointnet_eval_bf16.launches`. Both
    go through the op `pose3d_torch::pointnet_eval_bf16`.
    """
    _check_bf16(points, layers)
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pointnet_eval_bf16 has no kernel for device {points.device}")
    return pointnet_eval_bf16_op(points, [t for layer in layers for t in layer])


pointnet_eval_bf16.launches = 0
