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
other layout is copied once. A CPU tensor takes `vgg_stem_plain`,
differentiated by autograd. A CUDA tensor goes through `_VggStem`, whose
forward and backward launch the kernels (`stem_forward`, `stem_backward`,
one launch count each), or the call raises: there is no fallback. The
image gets no gradient: an `x` that requires one is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pose3d_tpu_torch.ops import _build

MAX_F = 256  # csrc/vgg_stem.cu kMaxF
SUMS = 28    # the weight gradient's partials: 27 taps and the bias
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def vgg_stem_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version: conv (padding 1), ReLU, 2x2/2 max pool."""
    return F.max_pool2d(torch.relu(F.conv2d(x, weight, bias, padding=1)), 2)


@functools.cache
def _lib():
    lib = _build.load("vgg_stem")
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
    dbl = int(dtype == torch.float64)
    return lib.vgg_stem_smem_bytes(f, 0, dbl), lib.vgg_stem_smem_bytes(f, 1, dbl)


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
    stem_forward.launches += 1
    return y, index


stem_forward.launches = 0


def stem_backward(x: torch.Tensor, index: torch.Tensor,
                  g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the weight-gradient passes: x and index as `stem_forward`
    took and gave them, g the gradient of y (any layout; made channels-last
    contiguous). Returns (dW (F, 3, 3, 3), db (F,))."""
    n, h, w, _ = x.shape
    f = index.shape[-1]
    g = g.contiguous(memory_format=torch.channels_last)
    lib = _lib()
    partial = torch.empty((lib.vgg_stem_partial_blocks(n, h, w), f, SUMS), dtype=x.dtype,
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
    stem_backward.launches += 1
    return dw, db


stem_backward.launches = 0


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


def vgg_stem(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv3x3 (SAME) + bias + ReLU + 2x2/2 max pool of NCHW `x`
    (N, 3, H, W) -> (N, F, H/2, W/2), channels-last on the card.
    Differentiable in `weight` and `bias`."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return vgg_stem_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"vgg_stem has no kernel for device {x.device}")
    f = weight.shape[0]
    if x.dtype not in _SUFFIX:
        raise TypeError(f"vgg_stem's kernels take float32 or float64; got {x.dtype}")
    if f % 8 or f > MAX_F or x.shape[2] >= 2**30 or x.shape[3] >= 2**30:
        raise ValueError(f"vgg_stem's kernels take F a multiple of 8 up to {MAX_F}; "
                         f"got F {f}")
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()  # a view for channels-last input
    weight, bias = weight.contiguous(), bias.contiguous()
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        return _VggStem.apply(x_nhwc, weight, bias)
    return stem_forward(x_nhwc, weight, bias, with_index=False)[0]  # no indices to keep
