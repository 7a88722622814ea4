"""Eval-mode PointNet shape encoder, fused: the CUDA kernel
`csrc/pointnet_eval.cu` and its wrapper.

Port of `pose3d_tpu/ops/pointnet_fused.py` (`fold_pointnet_params`,
`_xla_pointnet_eval`, `fused_pointnet_eval`). Eval-mode BatchNorm is an
affine map, so each Conv1d + BatchNorm pair of `models.pointnet.
ShapeEncoderPC` folds into one (W, b): W' = W * g, b' = b * g + c with
g = scale / sqrt(var + eps) and c = shift - mean * g. The encoder is then
3 -> 64 (ReLU) -> 128 (ReLU) -> D, then a max over the points; the kernel
keeps the (N, P, D) activation out of device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Sequence

import torch

from pose3d_tpu_torch.ops import _build

# the kernel's tiling (csrc/pointnet_eval.cu kTileP, kChunkD) and its fixed
# hidden widths (ShapeEncoderPC's 64 and 128)
TILE_P, CHUNK_D = 64, 256
HIDDEN = (64, 128)
# a block's setup (its 160 KB of weights from L2 into shared memory) costs
# about a quarter of one tile's 2.6 M FMAs; a guess that steers the split
_BLOCK_SETUP_TILES = 0.25

Folded = Sequence[tuple[torch.Tensor, torch.Tensor]]


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


@functools.cache
def segments_for(n: int, p: int, d: int, sms: int) -> int:
    """How many blocks share one cloud's points, so that the grid of
    n x ceil(d / CHUNK_D) x segments blocks (one per SM at a time) keeps the
    card's `sms` SMs busy: the segment length (in tiles) that minimises
    waves x (tiles per block + setup). Ties keep fewer segments."""
    tiles = -(-p // TILE_P)
    blocks = n * -(-d // CHUNK_D)
    best, best_cost = 1, None
    for per in range(tiles, max(1, -(-tiles // 65535)) - 1, -1):
        segments = -(-tiles // per)
        cost = -(-blocks * segments // sms) * (per + _BLOCK_SETUP_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = segments, cost
    return best


@functools.cache
def _kernel():
    fn = _build.load("pointnet_eval").pointnet_eval
    # pointers and the stream are 64-bit: ctypes' default int would cut them
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [ctypes.c_int,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_memory_bytes() -> int:
    """The dynamic shared memory a block of the kernel takes (builds it)."""
    fn = _build.load("pointnet_eval").pointnet_eval_smem_bytes
    fn.restype = ctypes.c_int
    return fn()


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


def pointnet_eval(points: torch.Tensor, folded: Folded) -> torch.Tensor:
    """(N, P, 3) float32 points, folded parameters -> (N, D) float32.

    A CPU tensor goes to `pointnet_eval_plain`. A CUDA tensor goes to the
    kernel, on the current stream, or the call raises: there is no
    fallback. Each launch adds one to `pointnet_eval.launches`.
    """
    d = _check(points, folded)
    if points.device.type == "cpu":
        return pointnet_eval_plain(points, folded)
    if points.device.type != "cuda":
        raise ValueError(f"pointnet_eval has no kernel for device {points.device}")
    tensors = [points] + [t for pair in folded for t in pair]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pointnet_eval's kernel takes contiguous tensors")
    n, p = points.shape[0], points.shape[1]
    if n >= 2**31 or 3 * p >= 2**31 or -(-d // CHUNK_D) > 65535:
        raise ValueError(f"pointnet_eval's kernel takes N < 2^31, 3P < 2^31 and "
                         f"D <= {65535 * CHUNK_D}; got {(n, p, d)}")

    out = torch.empty((n, d), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    segments = segments_for(n, p, d, _sm_count(points.device))
    partial = (torch.empty((n, segments, d), dtype=torch.float32, device=points.device)
               if segments > 1 else out)
    fn = _kernel()
    with torch.cuda.device(points.device):
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), partial.data_ptr(),
                 n, p, d, segments, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_eval kernel launch failed: cudaError_t {err}")
    pointnet_eval.launches += 1
    return out


pointnet_eval.launches = 0
