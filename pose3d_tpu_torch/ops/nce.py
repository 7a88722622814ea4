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
kernels (`nce_forward`, `nce_backward`, one launch count each), or the call
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

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
def _lib():
    lib = _build.load("info_nce")
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
    """The dynamic shared memory a block takes at width d, forward and
    backward (builds the library)."""
    lib = _lib()
    return lib.info_nce_smem_bytes(d, 0), lib.info_nce_smem_bytes(d, 1)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def nce_forward(s, t, vrow, vcol, row_offset: int, tau: float, divide: bool):
    """Launch the forward kernels on CUDA tensors (checked by the caller).
    Returns (loss, count, saved): loss and count are 0-d and (1,) float32,
    saved the workspace and residuals the backward reads."""
    nr, d = s.shape
    nc = t.shape[0]
    new = functools.partial(torch.empty, dtype=torch.float32, device=s.device)
    sn, tn, s_norm, t_norm = new((nr, d)), new((nc, d)), new(nr), new(nc)
    m, denom, pos, row_loss = new(nr), new(nr), new(nr), new(nr)
    loss, count = new(()), new(1)
    with torch.cuda.device(s.device):
        err = _lib().info_nce_forward(
            s.data_ptr(), t.data_ptr(), _ptr(vrow), _ptr(vcol), nr, nc, d, row_offset,
            tau, int(divide), sn.data_ptr(), tn.data_ptr(), s_norm.data_ptr(),
            t_norm.data_ptr(), m.data_ptr(), denom.data_ptr(), pos.data_ptr(),
            row_loss.data_ptr(), loss.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"info_nce forward kernel launch failed: cudaError_t {err}")
    nce_forward.launches += 1
    return loss, count, (sn, tn, s_norm, t_norm, m, denom, pos)


nce_forward.launches = 0


def nce_backward(saved, vrow, vcol, count, g, row_offset: int, tau: float, divide: bool):
    """Launch the two backward passes; returns (ds, dt)."""
    sn, tn, s_norm, t_norm, m, denom, pos = saved
    nr, d = sn.shape
    nc = tn.shape[0]
    ds = torch.empty_like(sn)
    dt = torch.empty_like(tn)
    g = g.to(torch.float32).contiguous()
    with torch.cuda.device(sn.device):
        err = _lib().info_nce_backward(
            sn.data_ptr(), tn.data_ptr(), s_norm.data_ptr(), t_norm.data_ptr(), _ptr(vrow),
            _ptr(vcol), m.data_ptr(), denom.data_ptr(), pos.data_ptr(), count.data_ptr(),
            g.data_ptr(), nr, nc, d, row_offset, tau, int(divide), ds.data_ptr(),
            dt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"info_nce backward kernel launch failed: cudaError_t {err}")
    nce_backward.launches += 1
    return ds, dt


nce_backward.launches = 0


class _InfoNCE(torch.autograd.Function):
    """The kernels under autograd: the forward saves the normalised rows,
    their norms and the residuals (m, denom, pos) of each row; the backward
    launches the ds and dt passes with the upstream gradient, read on the
    device (no host sync)."""

    @staticmethod
    def forward(ctx, s, t, vrow, vcol, row_offset, tau, divide):
        loss, count, saved = nce_forward(s, t, vrow, vcol, row_offset, tau, divide)
        ctx.save_for_backward(*saved, count)
        ctx.masks = (vrow, vcol)
        ctx.args = (row_offset, tau, divide)
        return loss

    @staticmethod
    def backward(ctx, g):
        *saved, count = ctx.saved_tensors
        ds, dt = nce_backward(saved, *ctx.masks, count, g, *ctx.args)
        return ds, dt, None, None, None, None, None


def _mask_f32(mask: torch.Tensor | None) -> torch.Tensor | None:
    return None if mask is None else mask.to(torch.float32).contiguous()


def _info_nce(s, t, tau, valid_rows, valid_cols, row_offset, divide) -> torch.Tensor:
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
                          int(row_offset), float(tau), bool(divide))


def fused_info_nce(s: torch.Tensor, t: torch.Tensor, tau: float = 0.1) -> torch.Tensor:
    """The mean infoNCE-KD over all rows, no mask (JAX `fused_info_nce`;
    dropout, if any, is applied to t by the caller)."""
    return _info_nce(s, t, tau, None, None, 0, True)


def blocked_info_nce(s: torch.Tensor, t: torch.Tensor, tau: float = 0.1,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """The masked mean (JAX `blocked_info_nce`): `valid` (N,) bool keeps
    rows out of the mean and out of every row's keys; the sum over valid
    rows is divided by max(number valid, 1)."""
    return _info_nce(s, t, tau, valid, valid, 0, True)


def blocked_info_nce_partial(s: torch.Tensor, t: torch.Tensor, valid_rows: torch.Tensor,
                             valid_cols: torch.Tensor, row_offset: int,
                             tau: float = 0.1) -> torch.Tensor:
    """The per-shard SUM (JAX `blocked_info_nce_partial`): this shard's rows
    s (Nr, D) against all the keys t (Nc, D), the positive of local row r at
    column row_offset + r."""
    return _info_nce(s, t, tau, valid_rows, valid_cols, row_offset, False)
