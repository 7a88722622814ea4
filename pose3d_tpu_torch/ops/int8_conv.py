"""The int8 convolution of post-training-quantized serving: the CUDA kernel
`csrc/int8_conv.cu`, its wrapper, and the plain version.

It replaces no TPU kernel: the JAX package computes its int8 products with
XLA's convolution (`pose3d_tpu/serving/quant_student.py` `_conv(...,
acc=jnp.int32)` and `quant_teacher.py` likewise), not with Pallas. PyTorch
on CUDA has no int8 convolution, so the port writes its own: an implicit
GEMM with s8 x s8 -> s32 products on the tensor cores after a first pass
that quantizes the input once, its epilogue the dequantization, and with
`pool` VGG's 2x2 max-pool taken on the s32 sums before it. Routes by shape
(`route`): a C_in that is a multiple of 16 (every conv and dense layer of
the main path) takes the wgmma kernel (Hopper's wgmma.mma_async from a
TMA / cp.async ring, a shared-memory epilogue with 16-byte stores); any
other C_in takes the mma.sync kernel. A call is two CUDA launches,
three where it goes through the s32 workspace (K split over blocks for the
dense layers and small batches, or a pool on the mma.sync route); it adds
one to the launch count. im2col + `torch._int_mm` would materialise the
patches (1.85 GB of s8 and 1.6 GB of s32 for one VGG conv at batch 256)
and refuses M <= 16 (batch-1 serving); chip_smoke.py times it as the
yardstick, and the port never calls it.

    int8_conv(x, a, w, ws, shift, stride, padding, relu, pool=False)

x: NHWC (N, H, W, C) float32 or bfloat16 (the model's dtype); a: the
per-tensor activation scale, a 0-d float32 tensor; w: HWIO (KH, KW, C, CO)
int8, JAX's layout; ws, shift: (CO,) float32. Returns (N, OH, OW, CO) in x's
dtype, or (N, OH // 2, OW // 2, CO) with `pool`:

    q = clamp(round_half_even(float32(x) / a), -127, 127)        (JAX's _quantize_act)
    z = conv(q, w) in int32                                      (exact)
    z = max over each 2x2 window of z, VALID                     (with pool: JAX's _max_pool)
    y = float32(z) * (a * ws) + shift, then the ReLU if asked, cast to x's dtype

with `a * ws` one float32 product and the dequantization two rounded
operations (no fused multiply-add), as JAX's `(y.astype(f32) * (a * ws) +
b).astype(dtype)`. A dense layer is a 1x1 conv on a 1x1 image
(`int8_dense`). What bounds the kernel on the card: the operations at
1,979 TOPS (dense int8, H100 SXM) or the bytes at 3.35 TB/s, whichever is
larger (chip_smoke.py computes both at the main path's shapes).

The kernel reads the weights K-major: (CO, KH, KW, C), each channel's K
contiguous, which is what wgmma takes for s8. `k_major` gives a weight
whose storage is that copy and whose shape and values are the HWIO (or
(K, CO)) ones: the quantized trees hold their int8 weights so
(`serving/quant_student.py _tensors`, once when a tree is put on a device),
and a weight stored otherwise (artifacts exported with HWIO leaves) is copied
K-major on each call (`int8_conv.weight_copies` counts those copies).

A CPU tensor takes `int8_conv_plain`. A CUDA tensor launches the kernel, on
the current stream, or the call raises: there is no fallback. Each launching
call adds one to `int8_conv.launches` and to its route's count in
`int8_conv.route_launches`. Both go through the custom ops
`pose3d_torch::int8_conv` (`int8_conv_op`) and `pose3d_torch::int8_conv_pool`
(`int8_conv_pool_op`), whose fake implementations give the outputs' shapes,
so that `torch.export` keeps the convolution whole in an exported graph
(`serving/aot.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pose3d_tpu_torch.ops import _build

_KIND = {torch.float32: 0, torch.bfloat16: 2}  # the C interface's numbers
QMAX = 127.0


def quantize_act(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """JAX's `_quantize_act`: clamp(round(float32(x) / a), -127, 127) as
    int8, round half to even. `a` is a 0-d float32 tensor on x's device
    (torch divides by a CPU scalar as a product with its reciprocal on the
    card, which would round otherwise)."""
    q = torch.round(x.to(torch.float32) / a.to(x.device))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def int8_sums(xq: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The exact int32 sums of the convolution of NHWC int8 `xq` with HWIO
    int8 `w`: float64 products and sums of the s8 values are exact below
    2^53 (|sum| <= K * 127^2, 4.05e8 at K = 25,088)."""
    z = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64),
                 w.permute(3, 2, 0, 1).to(torch.float64), stride=stride, padding=padding)
    return z.permute(0, 2, 3, 1).to(torch.int32).contiguous()  # NHWC, as the kernel's


def dequantize(z: torch.Tensor, a: torch.Tensor, ws: torch.Tensor, shift: torch.Tensor,
               dtype: torch.dtype, relu: bool) -> torch.Tensor:
    """float32(z) * (a * ws) + shift, each a rounded float32 operation,
    cast to `dtype`, then the ReLU if asked."""
    scale = a.to(z.device) * ws
    y = (z.to(torch.float32) * scale + shift).to(dtype)
    return torch.relu(y) if relu else y


def max_pool_s32(z: torch.Tensor) -> torch.Tensor:
    """JAX's `_max_pool` of NHWC sums: the maximum of each 2x2 window,
    stride 2, VALID (an odd last row or column dropped)."""
    n, h, w, c = z.shape
    z = z[:, :h // 2 * 2, :w // 2 * 2]
    return z.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def int8_conv_pool_plain(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                         shift: torch.Tensor, stride: int = 1, padding: int = 0,
                         relu: bool = False) -> torch.Tensor:
    """The pooled convolution's plain version, JAX's order: `quantize_act`,
    the exact sums, their 2x2 max-pool (`max_pool_s32`), then `dequantize`."""
    z = max_pool_s32(int8_sums(quantize_act(x, a), w, stride, padding))
    return dequantize(z, a, ws, shift, x.dtype, relu)


def int8_conv_plain(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                    shift: torch.Tensor, stride: int = 1, padding: int = 0,
                    relu: bool = False, pool: bool = False) -> torch.Tensor:
    """The plain version: `quantize_act`, the exact sums (`int8_sums`), then
    `dequantize` as separate torch operations (with `pool`,
    `int8_conv_pool_plain`)."""
    if pool:
        return int8_conv_pool_plain(x, a, w, ws, shift, stride, padding, relu)
    z = int8_sums(quantize_act(x, a), w, stride, padding)
    return dequantize(z, a, ws, shift, x.dtype, relu)


def k_major(w) -> torch.Tensor:
    """An int8 weight, HWIO (KH, KW, C, CO) or dense (K, CO), numpy or torch,
    as a tensor of the same shape and values whose storage is its K-major
    copy: (CO, KH, KW, C) or (CO, K), contiguous. The kernel reads that
    storage as it is. The quantized trees never change after quantization,
    so a copy made when a tree is built or loaded cannot go stale."""
    t = w if isinstance(w, torch.Tensor) else torch.as_tensor(w)
    return t.movedim(-1, 0).contiguous().movedim(0, -1)


def _k_major_storage(w: torch.Tensor) -> torch.Tensor:
    """The (CO, KH, KW, C) contiguous, 16-byte aligned tensor the kernel
    reads: `w`'s own storage where it is one (`k_major`), else a copy."""
    wk = w.permute(3, 0, 1, 2)
    if wk.is_contiguous() and wk.data_ptr() % 16 == 0:
        return wk
    _counted.weight_copies += 1
    return wk.clone(memory_format=torch.contiguous_format)


ROUTES = ("wgmma", "mma.sync")  # the C interface's route numbers


@functools.cache
def _lib():
    lib = _build.load("int8_conv")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    lib.int8_conv.argtypes = ([p, ctypes.c_int] + [p] * 7 + [i64] * 11
                              + [ctypes.c_int, ctypes.c_int, p])
    lib.int8_conv.restype = ctypes.c_int
    lib.int8_conv_workspace.argtypes = [i64] * 4 + [ctypes.c_int]
    lib.int8_conv_workspace.restype = ctypes.c_int64
    lib.int8_conv_route.argtypes = [i64]
    lib.int8_conv_route.restype = ctypes.c_int
    return lib


def route(c: int) -> str:
    """The kernel a call with C_in = c takes: "wgmma" where c is a multiple
    of 16 (16-byte gathers of one tap, a 16-byte row pitch for the weights'
    TMA), else "mma.sync" (byte gathers)."""
    return "wgmma" if c % 16 == 0 else "mma.sync"


def _check(x, a, w, ws, shift, stride, padding):
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"int8_conv takes NHWC x and HWIO w with matching channels; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    co = w.shape[3]
    if tuple(ws.shape) != (co,) or tuple(shift.shape) != (co,) or a.numel() != 1:
        raise ValueError(f"int8_conv takes (CO,) ws and shift and a scalar a; got "
                         f"{tuple(ws.shape)}, {tuple(shift.shape)}, {tuple(a.shape)}")
    if w.dtype != torch.int8 or ws.dtype != torch.float32 or shift.dtype != torch.float32 \
            or a.dtype != torch.float32:
        raise TypeError(f"int8_conv takes an int8 w and float32 a, ws, shift; got {w.dtype}, "
                        f"{a.dtype}, {ws.dtype}, {shift.dtype}")
    if stride < 1 or padding < 0:
        raise ValueError(f"int8_conv: stride {stride}, padding {padding}")
    if x.shape[1] + 2 * padding < w.shape[0] or x.shape[2] + 2 * padding < w.shape[1]:
        raise ValueError(f"int8_conv: a {w.shape[0]}x{w.shape[1]} window over "
                         f"{x.shape[1]}x{x.shape[2]} with padding {padding} leaves no output")
    if not (x.device == a.device == w.device == ws.device == shift.device):
        raise ValueError("int8_conv: inputs on different devices "
                         f"({x.device}, {a.device}, {w.device}, {ws.device}, {shift.device})")


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def _launch(x, a, w, ws, shift, stride, padding, relu, pool):
    """The kernel on CUDA tensors (the sizes and the alignment checked here,
    at run time)."""
    if x.dtype not in _KIND:
        raise TypeError(f"int8_conv's kernel takes float32 or bfloat16 input; got {x.dtype}")
    n, h, wd, c = x.shape
    kh, kw, _, co = w.shape
    oh, ow = _out_size(h, kh, stride, padding), _out_size(wd, kw, stride, padding)
    rows, k = (4 * n * (oh // 2) * (ow // 2) if pool else n * oh * ow), kh * kw * c
    if k >= 2**31 or rows * co >= 2**62 or max(h, wd, c, co) >= 2**31:
        raise ValueError(f"int8_conv: sizes out of range (M {rows}, K {k}, CO {co})")
    x = x.contiguous()
    ws, shift, a = ws.contiguous(), shift.contiguous(), a.reshape(())
    if x.data_ptr() % 16:
        raise ValueError("int8_conv's kernel takes x aligned to 16 bytes")
    wk = _k_major_storage(w)
    y = torch.empty((n, oh // 2, ow // 2, co) if pool else (n, oh, ow, co), dtype=x.dtype,
                    device=x.device)
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)  # the quantized input
    lib = _lib()
    with torch.cuda.device(x.device):
        slabs = lib.int8_conv_workspace(rows, co, k, c, int(pool))
        acc = torch.empty(slabs, dtype=torch.int32, device=x.device) if slabs else None
        err = lib.int8_conv(x.data_ptr(), _KIND[x.dtype], a.data_ptr(), wk.data_ptr(),
                            ws.data_ptr(), shift.data_ptr(), y.data_ptr(), xq.data_ptr(),
                            None if acc is None else acc.data_ptr(), n, h, wd, c, kh, kw,
                            stride, padding, oh, ow, co, int(relu), int(pool),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: error {err} (a cudaError_t; -1 "
                           "no cuTensorMapEncodeTiled; -1000 - CUresult: the weights' tensor "
                           "map refused)")
    _counted.launches += 1
    _counted.route_launches[ROUTES[lib.int8_conv_route(c)]] += 1
    return y


@torch.library.custom_op("pose3d_torch::int8_conv", mutates_args=(), device_types="cuda")
def int8_conv_op(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                 shift: torch.Tensor, stride: int, padding: int, relu: bool) -> torch.Tensor:
    """`int8_conv` as an opaque op, which `torch.export` keeps whole. A
    CUDA tensor launches the kernel; a CPU one takes `int8_conv_plain`. Its
    schema is the one existing exported artifacts name, so that they still
    load."""
    return _launch(x, a, w, ws, shift, stride, padding, relu, pool=False)


@int8_conv_op.register_kernel("cpu")
def _(x, a, w, ws, shift, stride, padding, relu):
    return int8_conv_plain(x, a, w, ws, shift, stride, padding, relu)


@int8_conv_op.register_fake
def _(x, a, w, ws, shift, stride, padding, relu):
    kh, kw, _, co = w.shape
    return x.new_empty((x.shape[0], _out_size(x.shape[1], kh, stride, padding),
                        _out_size(x.shape[2], kw, stride, padding), co))


@torch.library.custom_op("pose3d_torch::int8_conv_pool", mutates_args=(), device_types="cuda")
def int8_conv_pool_op(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                      shift: torch.Tensor, stride: int, padding: int,
                      relu: bool) -> torch.Tensor:
    """`int8_conv(..., pool=True)` as an opaque op: the convolution with the
    2x2 max-pool on its s32 sums. A CUDA tensor launches the kernel; a CPU
    one takes `int8_conv_pool_plain`."""
    return _launch(x, a, w, ws, shift, stride, padding, relu, pool=True)


@int8_conv_pool_op.register_kernel("cpu")
def _(x, a, w, ws, shift, stride, padding, relu):
    return int8_conv_pool_plain(x, a, w, ws, shift, stride, padding, relu)


@int8_conv_pool_op.register_fake
def _(x, a, w, ws, shift, stride, padding, relu):
    kh, kw, _, co = w.shape
    return x.new_empty((x.shape[0], _out_size(x.shape[1], kh, stride, padding) // 2,
                        _out_size(x.shape[2], kw, stride, padding) // 2, co))


def int8_conv(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
              shift: torch.Tensor, stride: int = 1, padding: int = 0,
              relu: bool = False, pool: bool = False) -> torch.Tensor:
    """The int8 convolution (module docstring): the kernel on a CUDA tensor,
    `int8_conv_plain` on a CPU one, through the op `pose3d_torch::int8_conv`,
    or `pose3d_torch::int8_conv_pool` with `pool`."""
    _check(x, a, w, ws, shift, stride, padding)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv has no kernel for device {x.device}")
    op = int8_conv_pool_op if pool else int8_conv_op
    return op(x, a, w, ws, shift, stride, padding, relu)


int8_conv.launches = 0
int8_conv.route_launches = dict.fromkeys(ROUTES, 0)
int8_conv.weight_copies = 0
_counted = int8_conv  # the counts stay here while a caller swaps the module's name


def int8_dense(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
               shift: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """A dense layer through the int8 convolution: (N, K) x (K, CO) int8 as
    a 1x1 conv on a 1x1 image."""
    y = int8_conv(x.reshape(x.shape[0], 1, 1, -1), a, w.reshape(1, 1, *w.shape), ws, shift,
                  relu=relu)
    return y.reshape(x.shape[0], -1)
