"""The VGG stem, fused: conv3x3 (3 -> F, SAME) + bias + ReLU + 2x2/2 max
pool, forward and weight gradient. The CUDA kernels `csrc/vgg_stem.cu`,
their wrappers, and the plain version.

Port of `pose3d_tpu/ops/vgg_stem.py` (`fused_vgg_stem`, `fused_vgg_stem_cf`,
`xla_vgg_stem`): the function, not either TPU block layout. It is the
student's first block (`models/vgg.py`): `features.0` (the conv) through
`features.2` (the pool). Ties in a pooling window go to the first maximum
in row-major (dy, dx) order, as torch's MaxPool2d and JAX's `_ConvPool2x2`
route them; odd H or W pool with MaxPool2d's floor.

`vgg_stem(x, weight, bias)` takes NCHW `x` (N, 3, H, W), the weight
(F, 3, 3, 3) and the bias (F,), and returns (N, F, H/2, W/2) in
channels-last memory (NHWC), the layout the next cuDNN convolution takes
without a transpose. The kernel reads the image as NHWC memory: the
student's channels-last view of its NHWC batch is read in place, any
other layout is copied once. Where a gradient is wanted, a CPU tensor
takes `vgg_stem_plain`, differentiated by autograd, and a CUDA tensor goes
through `_VggStem`, whose forward and backward launch the kernels
(`stem_forward`, `stem_backward`, one launch count each). Otherwise the
call is the custom op `pose3d_torch::vgg_stem_serve` (`vgg_stem_serve`):
its CUDA kernel the forward kernel without the window indices, its CPU
kernel `vgg_stem_plain`, its fake implementation the channels-last output,
so that `torch.export` keeps the stem whole in an exported graph
(`serving/aot.py`). A CUDA tensor launches a kernel or the call raises:
there is no fallback. The image gets no gradient: an `x` that requires
one is refused.

On the card, f32: the forward is one CUDA launch, an im2col product on the
tensor cores in split TF32 (each f32 operand a TF32 big part plus a TF32
small part, three TF32 products per f32 product, f32 accumulators), which
keeps f32's accuracy where one TF32 product would not (the emulation in
tests/test_torch_vgg_stem.py: 2e-7 of max|ref| against 3e-4). With the
window indices, a routing decision (a maximum, or the ReLU) closer to its
threshold than the split's error bound is made again from f32 FMA sums in
cuDNN's tap order, so the gradient goes where MaxPool2d on cuDNN's output
sends it; windows equal on every weighed tap (a flat region, such as the
constant bars around a padded crop) tie exactly in any order and route to
the first without being made again. The backward is two launches: the
weight gradient's partials, streamed on the CUDA cores over a grid of whole
waves, then their fixed-order sum. f64 (the card-vs-CPU step checks) runs
both on the CUDA cores, with the same launch counts.

bf16 (`--bf16`, flax's bfloat16 compute) is another function: JAX's
bf16 student rounds each window sum to bf16, pools, then adds the bias in
bf16 (`pose3d_tpu/models/vgg.py _ConvPool2x2`), so x, the weight and the
bias come in bf16 (the model casts them) and `vgg_stem_plain` rounds at
those points. Its kernels: the im2col product on the bf16 tensor cores
(mma.m16n8k16, f32 accumulators, no split) and the f32 kernels' weight
gradient stream on bf16 inputs, dW and db summed in f32 and rounded to
bf16 at the store. They count their launches apart
(`stem_forward.bf16_launches`, `stem_backward.bf16_launches`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pose3d_tpu_torch.ops import _build

MAX_F = 256  # csrc/vgg_stem.cu kMaxF
SUMS = 28    # the weight gradient's partials: 27 taps and the bias
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_KIND = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}  # the C interface's numbers


def vgg_stem_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version: conv (padding 1), ReLU, 2x2/2 max pool. In bf16,
    JAX's rounding points: each window sum (f32, where the products of bf16
    values are exact) rounded to bf16, the 2x2 max (the first maximum wins),
    + bias in f32 rounded to bf16, then the ReLU."""
    if x.dtype == torch.bfloat16:
        conv = F.conv2d(x.float(), weight.float(), padding=1).to(torch.bfloat16)
        pooled = F.max_pool2d(conv, 2).float() + bias.float()[:, None, None]
        return torch.relu(pooled.to(torch.bfloat16))
    return F.max_pool2d(torch.relu(F.conv2d(x, weight, bias, padding=1)), 2)


@functools.cache
def _lib(path: str | None = None):
    """The kernels' library, its entry points typed: csrc/vgg_stem.cu's
    build, or the library at `path`, built from another version of the
    source with the same C interface."""
    lib = _build.load("vgg_stem") if path is None else ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    for suffix in _SUFFIX.values():
        fwd = getattr(lib, f"vgg_stem_forward_{suffix}")
        fwd.argtypes = [p] * 3 + [i64] * 4 + [p] * 3
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"vgg_stem_wgrad_{suffix}")
        bwd.argtypes = [p] * 3 + [i64] * 4 + [p] * 4
        bwd.restype = ctypes.c_int
    lib.vgg_stem_partial_blocks.argtypes = [i64] * 3
    lib.vgg_stem_partial_blocks.restype = ctypes.c_int
    lib.vgg_stem_smem_bytes.argtypes = [i64, ctypes.c_int, ctypes.c_int]
    lib.vgg_stem_smem_bytes.restype = ctypes.c_int
    return lib


def shared_memory_bytes(f: int, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """The dynamic shared memory a block takes at F output channels:
    forward, and the weight gradient's first pass (builds the library)."""
    lib = _lib()
    return lib.vgg_stem_smem_bytes(f, 0, _KIND[dtype]), lib.vgg_stem_smem_bytes(f, 1, _KIND[dtype])


def _count(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.bf16_launches += 1
    else:
        fn.launches += 1


def stem_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 with_index: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the forward kernel on CUDA tensors (checked by the caller):
    x (N, H, W, 3) NHWC contiguous. Returns y (N, F, H/2, W/2) in
    channels-last memory and, with `with_index`, the (N, H/2, W/2, F) uint8
    window position of each maximum (4 where the ReLU masked it)."""
    n, h, w, _ = x.shape
    f = weight.shape[0]
    y = torch.empty((n, f, h // 2, w // 2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    index = (torch.empty((n, h // 2, w // 2, f), dtype=torch.uint8, device=x.device)
             if with_index else None)
    fn = getattr(_lib(), f"vgg_stem_forward_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), n, h, w, f,
                 y.data_ptr(), None if index is None else index.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"vgg_stem forward kernel launch failed: cudaError_t {err}")
    _count(stem_forward, x.dtype)
    return y, index


stem_forward.launches = stem_forward.bf16_launches = 0


def stem_backward(x: torch.Tensor, index: torch.Tensor,
                  g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the weight-gradient passes: x and index as `stem_forward`
    took and gave them, g the gradient of y (any layout; made channels-last
    contiguous). Returns (dW (F, 3, 3, 3), db (F,)) in x's dtype."""
    n, h, w, _ = x.shape
    f = index.shape[-1]
    g = g.contiguous(memory_format=torch.channels_last)
    lib = _lib()
    # the most partials the first pass writes (f32 and bf16 write one a
    # resident block, in f32)
    partial = torch.empty((lib.vgg_stem_partial_blocks(n, h, w), f, SUMS),
                          dtype=torch.float64 if x.dtype == torch.float64 else torch.float32,
                          device=x.device)
    dw = torch.empty((f, 3, 3, 3), dtype=x.dtype, device=x.device)
    db = torch.empty((f,), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"vgg_stem_wgrad_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), index.data_ptr(), n, h, w, f,
                 partial.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"vgg_stem backward kernel launch failed: cudaError_t {err}")
    _count(stem_backward, x.dtype)
    return dw, db


stem_backward.launches = stem_backward.bf16_launches = 0


class _VggStem(torch.autograd.Function):
    """The kernels under autograd: the forward keeps the image and the
    window indices; the backward launches the weight-gradient passes."""

    @staticmethod
    def forward(ctx, x_nhwc, weight, bias):
        y, index = stem_forward(x_nhwc, weight, bias, with_index=True)
        ctx.save_for_backward(x_nhwc, index)
        return y

    @staticmethod
    def backward(ctx, g):
        x_nhwc, index = ctx.saved_tensors
        dw, db = stem_backward(x_nhwc, index, g)
        return None, dw, db


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] != 3 or x.shape[2] < 2 or x.shape[3] < 2:
        raise ValueError(f"vgg_stem takes (N, 3, H, W) images with H, W >= 2; got "
                         f"{tuple(x.shape)}")
    f = weight.shape[0]
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (3, 3, 3) or tuple(bias.shape) != (f,):
        raise ValueError(f"vgg_stem takes a (F, 3, 3, 3) weight and an (F,) bias; got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if not (x.dtype == weight.dtype == bias.dtype) or not x.dtype.is_floating_point:
        raise TypeError(f"vgg_stem takes floating tensors of one dtype; got {x.dtype}, "
                        f"{weight.dtype}, {bias.dtype}")
    if not (x.device == weight.device == bias.device):
        raise ValueError(f"vgg_stem: inputs on different devices ({x.device}, "
                         f"{weight.device}, {bias.device})")
    if x.requires_grad:
        raise ValueError("vgg_stem computes no gradient for the image; pass an image "
                         "that does not require one")


def _kernel_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """What the kernels take: x as NHWC memory (a view of channels-last
    input, else a copy), the weight and the bias contiguous; the sizes and
    dtypes they do not take are refused."""
    f = weight.shape[0]
    if x.dtype not in _SUFFIX:
        raise TypeError(f"vgg_stem's kernels take float32 or float64 (or bfloat16); got "
                        f"{x.dtype}")
    if f % 8 or f > MAX_F or x.shape[2] >= 2**30 or x.shape[3] >= 2**30:
        raise ValueError(f"vgg_stem's kernels take F a multiple of 8 up to {MAX_F}; "
                         f"got F {f}")
    return x.permute(0, 2, 3, 1).contiguous(), weight.contiguous(), bias.contiguous()


@torch.library.custom_op("pose3d_torch::vgg_stem_serve", mutates_args=(), device_types="cuda")
def vgg_stem_serve(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The serving forward as an opaque op, which `torch.export` keeps
    whole: x the (N, 3, H, W) image in any layout, no window index. A CUDA
    tensor launches the forward kernel; a CPU one takes `vgg_stem_plain`.
    y is channels-last either way, as the fake implementation gives it."""
    return stem_forward(*_kernel_inputs(x, weight, bias), with_index=False)[0]


@vgg_stem_serve.register_kernel("cpu")
def _(x, weight, bias):
    return vgg_stem_plain(x, weight, bias).contiguous(memory_format=torch.channels_last)


@vgg_stem_serve.register_fake
def _(x, weight, bias):
    n, _, h, w = x.shape
    return torch.empty((n, weight.shape[0], h // 2, w // 2), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def vgg_stem(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv3x3 (SAME) + bias + ReLU + 2x2/2 max pool of NCHW `x`
    (N, 3, H, W) -> (N, F, H/2, W/2); in bf16 with `vgg_stem_plain`'s
    rounding points. Differentiable in `weight` and `bias`: where a
    gradient is wanted, the plain version on the CPU and `_VggStem` on the
    card; otherwise the op `vgg_stem_serve` (channels-last)."""
    _check(x, weight, bias)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vgg_stem has no kernel for device {x.device}")
    if not (torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad)):
        return vgg_stem_serve(x, weight, bias)
    if x.device.type == "cpu":
        return vgg_stem_plain(x, weight, bias)
    return _VggStem.apply(*_kernel_inputs(x, weight, bias))
