"""Batched geodesic rotation error: the CUDA kernel `csrc/geodesic.cu` and its
wrapper.

Port of `pose3d_tpu/ops/geodesic.py rotation_err_pallas`, the kernel of the
evaluation: `train.evaluate.evaluate_categories` computes every validation
error through `rotation_err` below. Its plain version is
`pose3d_tpu_torch.geometry.rotation_err`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.ops import _build


@functools.cache
def _kernel():
    fn = _build.load("geodesic").geodesic_rotation_err
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rotation_err(preds_deg: torch.Tensor, targets_deg: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (N, 3) float32 label triples -> (N,) geodesic error in degrees.

    A CPU tensor goes to the plain `geometry.rotation_err`. A CUDA tensor
    goes to the kernel, on the current stream, or the call raises: there is
    no fallback. Each launch adds one to `rotation_err.launches`.
    """
    if preds_deg.shape != targets_deg.shape or preds_deg.dim() != 2 \
            or preds_deg.shape[1] != 3:
        raise ValueError("rotation_err takes two (N, 3) tensors; got "
                         f"{tuple(preds_deg.shape)} and {tuple(targets_deg.shape)}")
    if preds_deg.dtype != torch.float32 or targets_deg.dtype != torch.float32:
        raise TypeError("rotation_err takes float32 tensors; got "
                        f"{preds_deg.dtype} and {targets_deg.dtype}")
    if preds_deg.device != targets_deg.device:
        raise ValueError("rotation_err: inputs on different devices "
                         f"({preds_deg.device}, {targets_deg.device})")
    if preds_deg.device.type == "cpu":
        return geometry.rotation_err(preds_deg, targets_deg)
    if preds_deg.device.type != "cuda":
        raise ValueError(f"rotation_err has no kernel for device {preds_deg.device}")
    if not (preds_deg.is_contiguous() and targets_deg.is_contiguous()):
        raise ValueError("rotation_err's kernel takes contiguous tensors")

    n = preds_deg.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=preds_deg.device)
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(preds_deg.device):
        err = fn(preds_deg.data_ptr(), targets_deg.data_ptr(), out.data_ptr(), n,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"geodesic kernel launch failed: cudaError_t {err}")
    rotation_err.launches += 1
    return out


rotation_err.launches = 0
