"""In-batch infoNCE-KD, forward and backward: the CUDA kernels
`csrc/info_nce.cu`, their wrappers, and the plain version.

Port of `pose3d_tpu/ops/nce_fused.py fused_info_nce` and
`pose3d_tpu/ops/nce_blocked.py blocked_info_nce` /
`blocked_info_nce_partial`. All three are one rectangular, masked core:
query rows s (Nr, D) against key rows t (Nc, D), the positive of row r at
column `row_offset + r`, rows and columns masked by validity vectors:

    s_n, t_n = rows of s, t over max(|row|, 1e-12)
    z = s_n t_n^T / tau, invalid columns at -1e30 (JAX's _NEG)
    per_row = -z[r, off + r] + log(e^{z[r, off + r]} + sum_c e^{z[r, c]})
    core = sum over valid rows of per_row

(the positive counts twice, as in the reference). `fused_info_nce` is the
all-valid mean, `blocked_info_nce` the masked mean over max(valid rows, 1),
`blocked_info_nce_partial` the sum (the per-shard term of a data-parallel
loss; kept so that the multi-GPU port needs no new kernel). A valid row
whose own positive column is invalid has a loss of about 1e30 in JAX and
here; callers pass masks where that cannot happen.

A CPU tensor takes `info_nce_plain`, differentiated by autograd. A CUDA
tensor goes through `_InfoNCE`, whose forward and backward launch the
kernels (`nce_forward`, `nce_backward`), or the call raises: there is no
fallback. Each wrapper counts its launches (`launches`) and, apart, those
made for the blocked entries (`blocked_launches`: JAX's
`pose3d_tpu/ops/nce_blocked.py` kernel, where `fused_info_nce` stands for
`nce_fused.py`'s). On the card a forward call is one CUDA
launch and a backward call one; their products run in split TF32 on the
tensor cores (three TF32 products per f32 product, f32 accuracy).
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from pose3d_tpu_torch.ops import _build

NEG = -1e30  # masked logits, as JAX's _NEG: exp() stays NaN-free
EPS = 1e-12
MAX_D = 512  # csrc/info_nce.cu kMaxD: the backward's shared memory


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), min=EPS)


def info_nce_plain(s: torch.Tensor, t: torch.Tensor, tau: float = 0.1,
                   valid_rows: torch.Tensor | None = None,
                   valid_cols: torch.Tensor | None = None,
                   row_offset: int = 0) -> torch.Tensor:
    """The plain version of the core: the SUM over valid rows of the
    per-row loss (module docstring). Masks are bool (Nr,) and (Nc,), None
    for all valid. Differentiable by autograd; the row max is held constant,
    as the analytic backward does (its gradient is zero)."""
    z = _normalize(s) @ _normalize(t).T / tau
    if valid_cols is not None:
        z = torch.where(valid_cols[None, :], z, torch.full_like(z, NEG))
    nr, nc = z.shape
    cols = torch.arange(nr, device=z.device) + row_offset
    has_pos = cols < nc
    pos = torch.where(has_pos, z.gather(1, cols.clamp(max=nc - 1)[:, None])[:, 0],
                      torch.zeros((), device=z.device))
    m = z.detach().amax(dim=1)
    se = torch.exp(z - m[:, None]).sum(dim=1)
    per_row = -(pos - m) + torch.log(torch.exp(pos - m) + se)
    if valid_rows is not None:
        per_row = torch.where(valid_rows, per_row, torch.zeros_like(per_row))
    return per_row.sum()


@functools.cache
def _lib(path: str | None = None):
    """The kernels' library, its entry points typed: csrc/info_nce.cu's
    build, or the library at `path`, built from another version of the
    source with the same C interface."""
    lib = _build.load("info_nce") if path is None else ctypes.CDLL(path)
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    lib.info_nce_forward.argtypes = [p] * 4 + [i64] * 4 + [f32, i32] + [p] * 10 + [p]
    lib.info_nce_forward.restype = ctypes.c_int
    lib.info_nce_backward.argtypes = [p] * 11 + [i64] * 4 + [f32, i32] + [p] * 2 + [p]
    lib.info_nce_backward.restype = ctypes.c_int
    lib.info_nce_smem_bytes.argtypes = [i64, i32]
    lib.info_nce_smem_bytes.restype = ctypes.c_int
    return lib


def shared_memory_bytes(d: int) -> tuple[int, int]:
    """The dynamic shared memory a block takes at width d (16-row tiles),
    forward and backward (builds the library)."""
    lib = _lib()
    return lib.info_nce_smem_bytes(d, 0), lib.info_nce_smem_bytes(d, 1)


def kernel_launches_per_call() -> tuple[int, int]:
    """CUDA launches a forward and a backward call make, as the library
    reports them (builds it)."""
    lib = _lib()
    lib.info_nce_launches.argtypes = [ctypes.c_int]
    lib.info_nce_launches.restype = ctypes.c_int
    return lib.info_nce_launches(0), lib.info_nce_launches(1)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _offsets(nr: int, nc: int, d: int) -> tuple[int, ...]:
    """Where sn, tn, s_norm, t_norm, m, denom, pos, row_loss, loss and count
    start in the forward's workspace, in floats, and its length."""
    return tuple(itertools.accumulate((nr * d, nc * d, nr, nc, nr, nr, nr, nr, 1, 1),
                                      initial=0))


def nce_forward(s, t, vrow, vcol, row_offset: int, tau: float, divide: bool,
                blocked: bool = False):
    """Launch the forward kernel on CUDA tensors (checked by the caller);
    `blocked`: for a blocked entry. Returns (loss, saved): loss 0-d float32,
    a view of saved, the one workspace that holds the normalised rows, their
    norms and the residuals the backward reads."""
    nr, d = s.shape
    nc = t.shape[0]
    offsets = _offsets(nr, nc, d)
    saved = torch.empty(offsets[-1], dtype=torch.float32, device=s.device)
    base = saved.data_ptr()
    with torch.cuda.device(s.device):
        err = _lib().info_nce_forward(
            s.data_ptr(), t.data_ptr(), _ptr(vrow), _ptr(vcol), nr, nc, d, row_offset, tau,
            int(divide), *(base + 4 * o for o in offsets[:-1]),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"info_nce forward kernel launch failed: cudaError_t {err}")
    nce_forward.launches += 1
    nce_forward.blocked_launches += blocked
    return saved[offsets[8]], saved


nce_forward.launches = nce_forward.blocked_launches = 0


def nce_backward(saved, vrow, vcol, g, shape: tuple[int, int, int], row_offset: int,
                 tau: float, divide: bool, blocked: bool = False):
    """Launch the backward kernel (the ds and dt passes in one grid): saved
    is nce_forward's workspace, shape (Nr, Nc, D). Returns (ds, dt), views
    of one allocation."""
    nr, nc, d = shape
    o = _offsets(nr, nc, d)
    base = saved.data_ptr()
    ds, dt = torch.empty((nr + nc, d), dtype=torch.float32, device=saved.device).split((nr, nc))
    g = g.to(torch.float32).contiguous()
    with torch.cuda.device(saved.device):
        err = _lib().info_nce_backward(
            *(base + 4 * o[i] for i in range(4)), _ptr(vrow), _ptr(vcol),
            *(base + 4 * o[i] for i in (4, 5, 6, 9)), g.data_ptr(), nr, nc, d, row_offset, tau,
            int(divide), ds.data_ptr(), dt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"info_nce backward kernel launch failed: cudaError_t {err}")
    nce_backward.launches += 1
    nce_backward.blocked_launches += blocked
    return ds, dt


nce_backward.launches = nce_backward.blocked_launches = 0


class _InfoNCE(torch.autograd.Function):
    """The kernels under autograd: the forward saves its workspace (the
    normalised rows, their norms, the residuals m, denom, pos of each row
    and the valid count); the backward launches the ds and dt passes with
    the upstream gradient, read on the device (no host sync)."""

    @staticmethod
    def forward(ctx, s, t, vrow, vcol, row_offset, tau, divide, blocked):
        loss, saved = nce_forward(s, t, vrow, vcol, row_offset, tau, divide, blocked)
        ctx.save_for_backward(saved)
        ctx.masks = (vrow, vcol)
        ctx.args = ((s.shape[0], t.shape[0], s.shape[1]), row_offset, tau, divide, blocked)
        return loss

    @staticmethod
    def backward(ctx, g):
        (saved,) = ctx.saved_tensors
        ds, dt = nce_backward(saved, *ctx.masks, g, *ctx.args)
        return ds, dt, None, None, None, None, None, None


def _mask_f32(mask: torch.Tensor | None) -> torch.Tensor | None:
    return None if mask is None else mask.to(torch.float32).contiguous()


def _info_nce(s, t, tau, valid_rows, valid_cols, row_offset, divide,
              blocked: bool) -> torch.Tensor:
    if s.dim() != 2 or t.dim() != 2 or s.shape[1] != t.shape[1]:
        raise ValueError("info_nce takes (Nr, D) and (Nc, D) tensors; got "
                         f"{tuple(s.shape)} and {tuple(t.shape)}")
    if s.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError(f"info_nce takes float32 tensors; got {s.dtype} and {t.dtype}")
    if s.device != t.device:
        raise ValueError(f"info_nce: inputs on different devices ({s.device}, {t.device})")
    if s.shape[0] == 0 or t.shape[0] == 0 or s.shape[1] == 0:
        raise ValueError(f"info_nce takes non-empty inputs; got {tuple(s.shape)}, "
                         f"{tuple(t.shape)}")
    for mask, n in ((valid_rows, s.shape[0]), (valid_cols, t.shape[0])):
        if mask is not None and (mask.shape != (n,) or mask.device != s.device):
            raise ValueError(f"info_nce: a mask of shape {tuple(mask.shape)} on "
                             f"{mask.device} for {n} rows on {s.device}")
    if s.device.type == "cpu":
        lsum = info_nce_plain(s, t, tau, valid_rows, valid_cols, row_offset)
        if not divide:
            return lsum
        n = s.shape[0] if valid_rows is None else valid_rows.sum()
        return lsum / torch.clamp(torch.as_tensor(n, dtype=torch.float32), min=1.0)
    if s.device.type != "cuda":
        raise ValueError(f"info_nce has no kernel for device {s.device}")
    if not (s.is_contiguous() and t.is_contiguous()):
        raise ValueError("info_nce's kernels take contiguous tensors")
    if s.shape[1] > MAX_D or max(s.shape[0], t.shape[0]) >= 2**31:
        raise ValueError(f"info_nce's kernels take D <= {MAX_D} and fewer than 2^31 rows; "
                         f"got {tuple(s.shape)}, {tuple(t.shape)}")
    return _InfoNCE.apply(s, t, _mask_f32(valid_rows), _mask_f32(valid_cols),
                          int(row_offset), float(tau), bool(divide), blocked)


def fused_info_nce(s: torch.Tensor, t: torch.Tensor, tau: float = 0.1) -> torch.Tensor:
    """The mean infoNCE-KD over all rows, no mask (JAX `fused_info_nce`;
    dropout, if any, is applied to t by the caller)."""
    return _info_nce(s, t, tau, None, None, 0, True, False)


def blocked_info_nce(s: torch.Tensor, t: torch.Tensor, tau: float = 0.1,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """The masked mean (JAX `blocked_info_nce`): `valid` (N,) bool keeps
    rows out of the mean and out of every row's keys; the sum over valid
    rows is divided by max(number valid, 1)."""
    return _info_nce(s, t, tau, valid, valid, 0, True, True)


def blocked_info_nce_partial(s: torch.Tensor, t: torch.Tensor, valid_rows: torch.Tensor,
                             valid_cols: torch.Tensor, row_offset: int,
                             tau: float = 0.1) -> torch.Tensor:
    """The per-shard SUM (JAX `blocked_info_nce_partial`): this shard's rows
    s (Nr, D) against all the keys t (Nc, D), the positive of local row r at
    column row_offset + r."""
    return _info_nce(s, t, tau, valid_rows, valid_cols, row_offset, False, True)
