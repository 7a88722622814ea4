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
fallback. The kernels take float32, float64 or (with float32 layers) bf16
points, and D a multiple of 64.

The kernels compute layer 3's statistics and gradients from h2's Gram sums
(G = sum h2 h2^T, s = sum h2 over the valid clouds' points), which the
forward keeps for the backward; only the max computes the D-wide layer
over the points (`csrc/pointnet_train.cu`'s header has the forms).

bf16 (`--bf16`, flax's `dtype=bfloat16` over float32 parameters: JAX's
`models/pointnet.py dense_bn_forward` and the `jnp.max` after it): bf16
points with float32 (weight, bias, gamma, beta) layers. Each layer rounds
where flax's does (x W to bf16, + b to bf16; the statistics of those
rounded values and the normalisation in float32, rounded to bf16), and
the max's gradient is split evenly over the points that tie at the
maximum, as JAX's VJP of `jnp.max` (and torch's `amax`) splits it: in
bf16 ties are common (about 2 % of the maxima at 2,500 points), where in
float32 and float64 they are rare enough that the first-argmax rule above
stays. A CPU tensor takes `pointnet_train_plain_bf16`; a CUDA tensor the
kernels' bf16 instance (`train_forward_bf16`, `train_backward_bf16`, one
count each a call), whose gradients of the weights and biases are bf16
values in float32, as JAX's gradient of `kernel.astype(bfloat16)` is.
The statistics are float32 in every dtype.
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
FUSED_D = 256  # kGroupW: the bf16 backward's widest D with dh2 in layer 3's pass
GRAM_SIZE = HIDDEN[1] * (HIDDEN[1] + 1)  # G (128 x 128) and s (128), float64
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
BF16 = torch.bfloat16

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


def _bn_relu_bf16(a: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, relu: bool) -> torch.Tensor:
    """flax's BatchNorm(dtype=bfloat16) after its statistics: in float32,
    rounded to bf16 (JAX widens the bf16 input once here and once for the
    statistics, so each use's gradient is rounded to bf16 before the two
    are added, as autograd adds them here). rsqrt(var + eps) as 1 / sqrt,
    each step rounded to nearest, as the kernel computes it (CUDA's rsqrt
    is within 2 ulps, not rounded)."""
    y = ((a.float() - mean) * ((1.0 / torch.sqrt(var + BN_EPS)) * gamma) + beta).to(BF16)
    return torch.relu(y) if relu else y


def _dense_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flax's Dense(dtype=bfloat16) on float32 (weight (out, in), bias):
    x W rounded to bf16, then + b rounded (`models.common.linear`'s
    rounding points); the gradients of w and b come back through their
    casts as bf16 values."""
    return F.linear(x, w.to(BF16)) + b.to(BF16)


def _max_over_points(y: torch.Tensor) -> torch.Tensor:
    """JAX's `jnp.max(y, axis=1)`: `amax`, whose gradient splits a tied
    maximum evenly over the points that reach it, as JAX's VJP does."""
    return y.amax(dim=1)


def plain_bf16_parts(points: torch.Tensor, params: Sequence[Layer],
                     valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, Stats, list[torch.Tensor]]:
    """`pointnet_train_plain_bf16` with each dense layer's rounded output
    before its BatchNorm (a1, a2, a3) beside (out, stats)."""
    x, stats, pre = points.to(BF16), [], []
    for i, (w, b, gamma, beta) in enumerate(params):
        a = _dense_bf16(x, w, b)
        mean, var = batch_stats(a.float(), (0, 1), valid)
        stats.append((mean, var))
        pre.append(a)
        x = _bn_relu_bf16(a, mean, var, gamma, beta, i < 2)
    return _max_over_points(x), tuple(stats), pre


def pointnet_train_plain_bf16(points: torch.Tensor, params: Sequence[Layer],
                              valid: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, Stats]:
    """The plain bf16 version: bf16 points and float32 layers -> (out (N, D)
    bf16, ((mu, var) x 3) float32). Each Dense rounds where flax's does
    (`_dense_bf16`), the statistics come from those values in float32
    (`batch_stats`), and the max splits ties (`_max_over_points`)."""
    return plain_bf16_parts(points, params, valid)[:2]


@functools.cache
def _lib(path: str | None = None):
    """The kernels' library, its entry points typed: csrc/pointnet_train.cu's
    build, or the library at `path`, built from another version of the
    source with the same C interface."""
    lib = _build.load("pointnet_train") if path is None else ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    for suffix in ("f32", "f64"):
        fwd = getattr(lib, f"pointnet_train_forward_{suffix}")
        fwd.argtypes = [p, p, i64, i64, i64] + [p] * 9 + [ctypes.c_int, p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"pointnet_train_backward_{suffix}")
        bwd.argtypes = [p, p, i64, i64, i64] + [p] * 10 + [ctypes.c_int, p]
        bwd.restype = ctypes.c_int
    lib.pointnet_train_forward_bf16.argtypes = [p, p, i64, i64, i64] + [p] * 9 + [ctypes.c_int,
                                                                                  p]
    lib.pointnet_train_forward_bf16.restype = ctypes.c_int
    lib.pointnet_train_backward_bf16.argtypes = [p, p, i64, i64, i64] + [p] * 11 + [
        ctypes.c_int, p]
    lib.pointnet_train_backward_bf16.restype = ctypes.c_int
    for name in ("pointnet_train_workspace", "pointnet_train_bf16_workspace"):
        getattr(lib, name).argtypes = [i64, i64, i64, ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = i64
    lib.pointnet_train_launches.argtypes = [ctypes.c_int]
    lib.pointnet_train_launches.restype = ctypes.c_int
    lib.pointnet_train_smem_bytes.argtypes = [ctypes.c_int]
    lib.pointnet_train_smem_bytes.restype = ctypes.c_int
    return lib


def kernel_launches_per_call(dtype: torch.dtype = torch.float32,
                             d: int = 256) -> tuple[int, int]:
    """The CUDA kernels one forward call and one backward call launch, of
    the float32 and float64 instances or of the bf16 one at D `d` (its
    backward fuses dh2 into layer 3's pass up to D 256; builds the
    library)."""
    lib = _lib()
    at = 0 if dtype != BF16 else 2 if d <= FUSED_D else 4
    return lib.pointnet_train_launches(at), lib.pointnet_train_launches(at + 1)


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


def train_forward_bf16(points: torch.Tensor, prm: torch.Tensor, d: int,
                       valid: torch.Tensor | None):
    """Launch the bf16 instance's forward kernels on CUDA tensors (checked
    by the caller): points (N, P, 3) bf16 contiguous, prm float32 from
    `pack_params` (the kernels round W and b to bf16), valid (N,) bool or
    None. Returns (out (N, D) bf16, stats (2 (64 + 128 + D),) float32,
    and for the backward count (N, D) int32, the points that tie at each
    maximum; tsum (N, D) float32, the sum of a3 - mu3 over them; a1 (N, P,
    64) and a2 (N, P, 128) bf16, layers 1 and 2 before their BatchNorm)."""
    n, p, _ = points.shape
    sms = _sm_count(points.device)
    lib = _lib()
    dev = points.device
    out = torch.empty((n, d), dtype=BF16, device=dev)
    stats = torch.empty(2 * (sum(HIDDEN) + d), dtype=torch.float32, device=dev)
    count = torch.empty((n, d), dtype=torch.int32, device=dev)
    tsum = torch.empty((n, d), dtype=torch.float32, device=dev)
    a1 = torch.empty((n, p, HIDDEN[0]), dtype=BF16, device=dev)
    a2 = torch.empty((n, p, HIDDEN[1]), dtype=BF16, device=dev)
    ws = torch.empty(lib.pointnet_train_bf16_workspace(n, p, d, sms, 0), dtype=torch.float32,
                     device=dev)
    iws = torch.empty(lib.pointnet_train_bf16_workspace(n, p, d, sms, 1), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.pointnet_train_forward_bf16(
            points.data_ptr(), _ptr(valid), n, p, d, prm.data_ptr(), stats.data_ptr(),
            out.data_ptr(), count.data_ptr(), tsum.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            ws.data_ptr(), iws.data_ptr(), sms, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train bf16 forward kernel launch failed: cudaError_t {err}")
    train_forward_bf16.launches += 1
    return out, stats, count, tsum, a1, a2


train_forward_bf16.launches = 0


def train_backward_bf16(points: torch.Tensor, prm: torch.Tensor, d: int,
                        valid: torch.Tensor | None, stats: torch.Tensor, out: torch.Tensor,
                        count: torch.Tensor, tsum: torch.Tensor, a1: torch.Tensor,
                        a2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the bf16 instance's backward kernels: the gradient of
    sum(out * g) (g rounded to bf16) with respect to the packed float32
    parameters, in `pack_params`' layout; W and b's entries bf16 values."""
    n, p, _ = points.shape
    sms = _sm_count(points.device)
    lib = _lib()
    g = g.to(BF16).contiguous()
    grads = torch.empty_like(prm)
    ws = torch.empty(lib.pointnet_train_bf16_workspace(n, p, d, sms, 2), dtype=torch.float32,
                     device=points.device)
    hws = torch.empty(lib.pointnet_train_bf16_workspace(n, p, d, sms, 3), dtype=BF16,
                      device=points.device)
    with torch.cuda.device(points.device):
        err = lib.pointnet_train_backward_bf16(
            points.data_ptr(), _ptr(valid), n, p, d, prm.data_ptr(), stats.data_ptr(),
            out.data_ptr(), count.data_ptr(), tsum.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            g.data_ptr(), grads.data_ptr(), ws.data_ptr(), hws.data_ptr(), sms,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train bf16 backward kernel launch failed: cudaError_t {err}")
    train_backward_bf16.launches += 1
    return grads


train_backward_bf16.launches = 0


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


class _PointNetTrainBf16(torch.autograd.Function):
    """The bf16 instance under autograd: the forward keeps the packed
    float32 parameters, the statistics, the output, the tie counts and
    sums, a1 and a2; the backward launches the gradient passes with the
    upstream gradient of the features."""

    @staticmethod
    def forward(ctx, points, valid, *flat):
        d = flat[8].shape[0]
        prm = pack_params([flat[4 * i:4 * i + 4] for i in range(3)])
        out, stats, count, tsum, a1, a2 = train_forward_bf16(points, prm, d, valid)
        ctx.save_for_backward(points, prm, stats, out, count, tsum, a1, a2)
        ctx.valid, ctx.d = valid, d
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, g, _g_stats):
        grads = train_backward_bf16(*ctx.saved_tensors[:2], ctx.d, ctx.valid,
                                    *ctx.saved_tensors[2:], g)
        return (None, None, *unpack_grads(grads, ctx.d))


def _check(points: torch.Tensor, params: Sequence[Layer], valid: torch.Tensor | None) -> int:
    """Validate shapes, dtypes and devices; return D. bf16 points take
    float32 layers (the parameters' dtype); other points layers of their
    own dtype."""
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
    want_dtype = torch.float32 if points.dtype == BF16 else points.dtype
    for t in [t for layer in params for t in layer]:
        if t.dtype != want_dtype or not t.dtype.is_floating_point:
            raise TypeError(f"pointnet_train takes floating layers of the points' dtype, or "
                            f"float32 layers with bf16 points; got {points.dtype} and {t.dtype}")
    for t in [points] + [t for layer in params for t in layer]:
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
    (out (N, D), ((mu, var) x 3)). Differentiable in the parameters.
    bf16 points take float32 layers and give a bf16 out (flax's bf16
    compute; the statistics float32)."""
    d = _check(points, params, valid)
    if points.device.type == "cpu":
        if points.dtype == BF16:
            return pointnet_train_plain_bf16(points, params, valid)
        out, stats, _ = pointnet_train_plain(points, params, valid)
        return out, stats
    if points.device.type != "cuda":
        raise ValueError(f"pointnet_train has no kernel for device {points.device}")
    if points.dtype not in _SUFFIX:
        raise TypeError(f"pointnet_train's kernels take float32, float64 or bfloat16; got "
                        f"{points.dtype}")
    n, p = points.shape[:2]
    if d % CHUNK_D or n * p >= 2**31 or n * d >= 2**31:
        raise ValueError(f"pointnet_train's kernels take D a multiple of {CHUNK_D} and fewer "
                         f"than 2^31 points and outputs; got {(n, p, d)}")
    flat = [t for layer in params for t in layer]
    fn = _PointNetTrainBf16 if points.dtype == BF16 else _PointNetTrain
    out, stats = fn.apply(points.detach().contiguous(),
                          None if valid is None else valid.contiguous(), *flat)
    return out, split_stats(stats, d)
