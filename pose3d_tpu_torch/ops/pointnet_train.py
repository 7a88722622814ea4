"""Train-mode PointNet shape encoder, fused: the CUDA kernels
`csrc/pointnet_train.cu` (forward and parameter gradient), their wrappers,
and the plain version.

Port of `pose3d_tpu/ops/pointnet_train_fused.py pointnet_train_fused`, with
the (N,) cloud validity of JAX's masked XLA path (`models/pointnet.py
dense_bn_forward` with `mask`) added: three Dense + BatchNorm layers
3 -> 64 -> 128 -> D with batch statistics over the valid clouds' points
(variance E[a^2] - E[a]^2 clamped at 0), ReLU on the first two, then the
max over the points. The max's gradient goes to the FIRST point that takes
it (torch.argmax's rule, which JAX's kernel keeps); the points get no
gradient. The batch statistics ((mu, var) of each layer) come out beside
the features, for the running-statistics update; they take no gradient.

Parameters are given per layer as (weight (out, in), bias, gamma, beta),
the layout of `models.pointnet.ShapeEncoderPC`'s Conv1d (its kernel axis
dropped) and BatchNorm. A CPU tensor takes `pointnet_train_plain`,
differentiated by autograd. A CUDA tensor goes through `_PointNetTrain`,
whose forward and backward launch the kernels (`train_forward`,
`train_backward`, one count each a call), or the call raises: there is no
fallback. The kernels take float32 or float64 and D a multiple of 64.

The kernels compute layer 3's statistics and gradients from h2's Gram sums
(G = sum h2 h2^T, s = sum h2 over the valid clouds' points), which the
forward keeps for the backward; only the max computes the D-wide layer
over the points (`csrc/pointnet_train.cu`'s header has the forms).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from pose3d_tpu_torch.models.common import BN_EPS, batch_stats
from pose3d_tpu_torch.ops import _build

HIDDEN = (64, 128)
CHUNK_D = 64  # csrc/pointnet_train.cu kChunk: D a multiple of it
GRAM_SIZE = HIDDEN[1] * (HIDDEN[1] + 1)  # G (128 x 128) and s (128), float64
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

Layer = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Stats = tuple[tuple[torch.Tensor, torch.Tensor], ...]


def pointnet_train_plain(points: torch.Tensor, params: Sequence[Layer],
                         valid: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, Stats, torch.Tensor]:
    """The plain version: returns (out (N, D), ((mu, var) x 3), index (N, D)),
    index the point each output was taken from. The max is a gather at the
    first maximum (torch.argmax), so that its gradient goes to that point
    alone (amax's would split ties)."""
    x, stats = points, []
    for i, (w, b, gamma, beta) in enumerate(params):
        x = F.linear(x, w, b)
        mean, var = batch_stats(x, (0, 1), valid)
        stats.append((mean, var))
        x = (x - mean) * (torch.rsqrt(var + BN_EPS) * gamma) + beta
        if i < 2:
            x = torch.relu(x)
    index = x.detach().argmax(dim=1)
    return x.gather(1, index[:, None, :])[:, 0], tuple(stats), index


@functools.cache
def _lib():
    lib = _build.load("pointnet_train")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    for suffix in _SUFFIX.values():
        fwd = getattr(lib, f"pointnet_train_forward_{suffix}")
        fwd.argtypes = [p, p, i64, i64, i64] + [p] * 9 + [ctypes.c_int, p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"pointnet_train_backward_{suffix}")
        bwd.argtypes = [p, p, i64, i64, i64] + [p] * 10 + [ctypes.c_int, p]
        bwd.restype = ctypes.c_int
    lib.pointnet_train_workspace.argtypes = [i64, i64, i64, ctypes.c_int, ctypes.c_int]
    lib.pointnet_train_workspace.restype = i64
    lib.pointnet_train_launches.argtypes = [ctypes.c_int]
    lib.pointnet_train_launches.restype = ctypes.c_int
    lib.pointnet_train_smem_bytes.argtypes = [ctypes.c_int]
    lib.pointnet_train_smem_bytes.restype = ctypes.c_int
    return lib


def kernel_launches_per_call() -> tuple[int, int]:
    """The CUDA kernels one forward call and one backward call launch
    (builds the library)."""
    lib = _lib()
    return lib.pointnet_train_launches(0), lib.pointnet_train_launches(1)


def shared_memory_bytes(dtype: torch.dtype = torch.float32) -> int:
    """The dynamic shared memory of the largest block (builds the library)."""
    return _lib().pointnet_train_smem_bytes(int(dtype == torch.float64))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pack_params(params: Sequence[Layer]) -> torch.Tensor:
    """The kernels' packed parameters: per layer W (in, out), b, gamma, beta."""
    return torch.cat([t.reshape(-1) for w, b, gamma, beta in params
                      for t in (w.t(), b, gamma, beta)])


def unpack_grads(flat: torch.Tensor, d: int) -> list[torch.Tensor]:
    """The packed gradient -> per layer (dW (out, in), db, dgamma, dbeta)."""
    grads, at = [], 0
    for fan_in, out in ((3, HIDDEN[0]), HIDDEN, (HIDDEN[1], d)):
        w = flat[at:at + fan_in * out].view(fan_in, out).t()
        at += fan_in * out
        grads += [w, *flat[at:at + 3 * out].view(3, out)]
        at += 3 * out
    return grads


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def train_forward(points: torch.Tensor, prm: torch.Tensor, d: int,
                  valid: torch.Tensor | None):
    """Launch the forward kernels on CUDA tensors (checked by the caller):
    points (N, P, 3) contiguous, prm from `pack_params`, valid (N,) bool or
    None. Returns (out (N, D), stats (2 (64 + 128 + D),): mu1, var1, mu2,
    var2, mu3, var3, idx (N, D) int32, and for the backward h1 (N, P, 64),
    h2 (N, P, 128) and gram (GRAM_SIZE,) float64: G = sum h2 h2^T and
    s = sum h2 over the valid clouds' points)."""
    n, p, _ = points.shape
    sms = _sm_count(points.device)
    lib = _lib()
    new = functools.partial(torch.empty, dtype=points.dtype, device=points.device)
    out, stats = new((n, d)), new(2 * (sum(HIDDEN) + d))
    h1, h2 = new((n, p, HIDDEN[0])), new((n, p, HIDDEN[1]))
    gram = torch.empty(GRAM_SIZE, dtype=torch.float64, device=points.device)
    ws = new(lib.pointnet_train_workspace(n, p, d, sms, 0))
    idx = torch.empty((n, d), dtype=torch.int32, device=points.device)
    iws = torch.empty(lib.pointnet_train_workspace(n, p, d, sms, 1), dtype=torch.int32,
                      device=points.device)
    fn = getattr(lib, f"pointnet_train_forward_{_SUFFIX[points.dtype]}")
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), _ptr(valid), n, p, d, prm.data_ptr(), stats.data_ptr(),
                 out.data_ptr(), idx.data_ptr(), h1.data_ptr(), h2.data_ptr(), gram.data_ptr(),
                 ws.data_ptr(), iws.data_ptr(), sms, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train forward kernel launch failed: cudaError_t {err}")
    train_forward.launches += 1
    return out, stats, idx, h1, h2, gram


train_forward.launches = 0


def train_backward(points: torch.Tensor, prm: torch.Tensor, d: int,
                   valid: torch.Tensor | None, stats: torch.Tensor, idx: torch.Tensor,
                   h1: torch.Tensor, h2: torch.Tensor, gram: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernels: the gradient of sum(out * g) with
    respect to the packed parameters, in `pack_params`' layout."""
    n, p, _ = points.shape
    sms = _sm_count(points.device)
    lib = _lib()
    g = g.to(points.dtype).contiguous()
    grads = torch.empty_like(prm)
    ws = torch.empty(lib.pointnet_train_workspace(n, p, d, sms, 2), dtype=points.dtype,
                     device=points.device)
    dws = torch.empty(lib.pointnet_train_workspace(n, p, d, sms, 3), dtype=torch.float64,
                      device=points.device)
    fn = getattr(lib, f"pointnet_train_backward_{_SUFFIX[points.dtype]}")
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), _ptr(valid), n, p, d, prm.data_ptr(), stats.data_ptr(),
                 gram.data_ptr(), idx.data_ptr(), h1.data_ptr(), h2.data_ptr(), g.data_ptr(),
                 grads.data_ptr(), ws.data_ptr(), dws.data_ptr(), sms,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train backward kernel launch failed: cudaError_t {err}")
    train_backward.launches += 1
    return grads


train_backward.launches = 0


def split_stats(stats: torch.Tensor, d: int) -> Stats:
    c1, c2 = HIDDEN
    sizes = (c1, c1, c2, c2, d, d)
    parts = torch.split(stats, sizes)
    return tuple((parts[2 * i], parts[2 * i + 1]) for i in range(3))


class _PointNetTrain(torch.autograd.Function):
    """The kernels under autograd: the forward keeps the packed parameters,
    the statistics, the argmax indices, h1, h2 and h2's Gram sums; the
    backward launches the gradient passes with the upstream gradient of the
    features."""

    @staticmethod
    def forward(ctx, points, valid, *flat):
        d = flat[8].shape[0]
        prm = pack_params([flat[4 * i:4 * i + 4] for i in range(3)])
        out, stats, idx, h1, h2, gram = train_forward(points, prm, d, valid)
        ctx.save_for_backward(points, prm, stats, idx, h1, h2, gram)
        ctx.valid, ctx.d = valid, d
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, g, _g_stats):
        points, prm, stats, idx, h1, h2, gram = ctx.saved_tensors
        grads = train_backward(points, prm, ctx.d, ctx.valid, stats, idx, h1, h2, gram, g)
        return (None, None, *unpack_grads(grads, ctx.d))


def _check(points: torch.Tensor, params: Sequence[Layer], valid: torch.Tensor | None) -> int:
    """Validate shapes, dtypes and devices; return D."""
    if len(params) != 3 or any(len(layer) != 4 for layer in params):
        raise ValueError("pointnet_train takes three (weight, bias, gamma, beta) layers")
    if points.dim() != 3 or points.shape[2] != 3 or points.shape[1] == 0:
        raise ValueError(f"pointnet_train takes (N, P, 3) points with P > 0; got "
                         f"{tuple(points.shape)}")
    d = params[2][0].shape[0]
    widths = (3, *HIDDEN, d)
    for i, layer in enumerate(params):
        want = [(widths[i + 1], widths[i])] + [(widths[i + 1],)] * 3
        if [tuple(t.shape) for t in layer] != want:
            raise ValueError(f"pointnet_train: layer {i + 1} shapes "
                             f"{[tuple(t.shape) for t in layer]}, expected {want}")
    for t in [points] + [t for layer in params for t in layer]:
        if t.dtype != points.dtype or not t.dtype.is_floating_point:
            raise TypeError(f"pointnet_train takes floating tensors of one dtype; got "
                            f"{points.dtype} and {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"pointnet_train: inputs on different devices ({points.device}, "
                             f"{t.device})")
    if valid is not None and (valid.shape != points.shape[:1] or valid.dtype != torch.bool
                              or valid.device != points.device):
        raise ValueError(f"pointnet_train takes an (N,) bool mask on the points' device; got "
                         f"{tuple(valid.shape)} {valid.dtype} on {valid.device}")
    return d


def pointnet_train(points: torch.Tensor, params: Sequence[Layer],
                   valid: torch.Tensor | None = None) -> tuple[torch.Tensor, Stats]:
    """(N, P, 3) points, three (weight, bias, gamma, beta) layers and the
    (N,) bool validity of a padded batch (None: all clouds count) ->
    (out (N, D), ((mu, var) x 3)). Differentiable in the parameters."""
    d = _check(points, params, valid)
    if points.device.type == "cpu":
        out, stats, _ = pointnet_train_plain(points, params, valid)
        return out, stats
    if points.device.type != "cuda":
        raise ValueError(f"pointnet_train has no kernel for device {points.device}")
    if points.dtype not in _SUFFIX:
        raise TypeError(f"pointnet_train's kernels take float32 or float64; got {points.dtype}")
    n, p = points.shape[:2]
    if d % CHUNK_D or n * p >= 2**31 or n * d >= 2**31:
        raise ValueError(f"pointnet_train's kernels take D a multiple of {CHUNK_D} and fewer "
                         f"than 2^31 points and outputs; got {(n, p, d)}")
    flat = [t for layer in params for t in layer]
    out, stats = _PointNetTrain.apply(points.detach().contiguous(),
                                      None if valid is None else valid.contiguous(), *flat)
    return out, split_stats(stats, d)
