"""Device-resident shape banks: the clouds or renders of every CAD model
live on the device, and the step resolves each sample's shape from a few
scalars. Port of `pose3d_tpu/ops/shape_bank.py` (`ShapeBank`,
`_sample_one`, `sample_from_bank`, `RenderBank`, `gather_renders`,
`resolve`).

  * `ShapeBank`: every distinct cloud zero-padded into one (S, V, 3) f32
    tensor, uploaded once. The loader emits `shape_id` (the row),
    `shape_rot` (the z-rotation in degrees) and `shape_seed` (a host-drawn
    u32) a sample in place of its (point_num, 3) cloud; the step draws the
    subset on the device, rotates it about z and min-max normalises it, as
    `data/transforms.py sample_pointcloud` does on the host (in f32 here).
  * `RenderBank`: every model's whole render set as (S, R, H, W, 3) u8 and
    the (72, K) table of the K views each of the 72 azimuth mutations
    selects (`multiview_ids`). The loader emits `shape_id` and `shape_mut`;
    the step gathers the b*K selected renders in one flat gather and turns
    them to f32 in [0, 1].

The subset of a sample is a pure function of its `shape_seed`, whatever
batch it is in. Its uniform keys are a counter-based integer hash of
(seed, vertex index), computed in int64 tensor ops, so the card and the
CPU pick the same vertices. JAX draws them from threefry instead, so the
two packages pick different subsets from one seed; `sample_with_indices`
takes given indices, as the tests give JAX's.

The banks are plain PyTorch on every device: JAX computes them outside any
Pallas kernel (a gather, a top-k and elementwise math in `jnp`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pose3d_tpu_torch.ops.augment import dewire

# the batch keys that replace "shape" when a dataset runs device_shapes
SHAPE_ID_KEYS = ("shape_id", "shape_rot", "shape_seed")  # PointCloud bank
RENDER_ID_KEYS = ("shape_id", "shape_mut")               # MultiView bank

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    in two 16-bit halves so that no int64 product overflows."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) (the "lowbias32" integer hash): distinct
    inputs give distinct keys."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_keys(seeds: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(b,) seeds in [0, 2^32) -> (b, n) int64 keys in [0, 2^32): key j of a
    seed is mix(mix(seed ^ stream) + j), so the n keys of one seed are
    distinct and each seed's keys depend on that seed alone."""
    base = _mix32(seeds.to(torch.int64) ^ stream)
    j = torch.arange(n, device=seeds.device, dtype=torch.int64)
    return _mix32((base[:, None] + j[None, :]) & _M32)


def sample_indices(counts: torch.Tensor, seeds: torch.Tensor, n_verts: int,
                   point_num: int) -> torch.Tensor:
    """(b,) vertex counts and seeds -> (b, point_num) vertex indices, as
    JAX's `_sample_one` selects them: without replacement (count >=
    point_num) the top point_num of uniform keys over the valid prefix (the
    pad rows' keys -1 never win), a uniform random subset in the keys'
    order; with replacement (count < point_num) point_num independent
    uniform indices in [0, count)."""
    keys = uniform_keys(seeds, n_verts, 0x243F6A88)
    valid = torch.arange(n_verts, device=keys.device)[None, :] < counts[:, None]
    idx_wor = torch.topk(torch.where(valid, keys, -1), point_num, dim=1).indices
    draws = uniform_keys(seeds, point_num, 0x85A308D3)
    idx_wr = (draws * counts.clamp(min=1).to(torch.int64)[:, None]) >> 32
    return torch.where((counts >= point_num)[:, None], idx_wor, idx_wr)


@dataclass(frozen=True)
class ShapeBank:
    """verts: (S, V, 3) f32, zero-padded rows beyond counts[s]; counts:
    (S,) int64 true vertex counts; point_num: the subset's size. Both
    tensors on the device the step runs on."""

    verts: torch.Tensor
    counts: torch.Tensor
    point_num: int

    batch_keys = SHAPE_ID_KEYS

    @classmethod
    def from_arrays(cls, verts: np.ndarray, counts: np.ndarray, point_num: int,
                    device: torch.device | str) -> "ShapeBank":
        return cls(torch.as_tensor(np.asarray(verts, np.float32)).to(device),
                   torch.as_tensor(np.asarray(counts, np.int64)).to(device), int(point_num))

    @property
    def nbytes(self) -> int:
        return self.verts.nbytes + self.counts.nbytes


def sample_with_indices(bank: ShapeBank, ids: torch.Tensor, idx: torch.Tensor,
                        rot_deg: torch.Tensor) -> torch.Tensor:
    """The clouds of rows `ids` (b,) at vertex indices `idx` (b, P), rotated
    by `rot_deg` (b,) about z, then min-max normalised over all their
    coordinates to [0, 1] -> (b, P, 3) f32. The rotation and the
    normalisation run in f32, as JAX's; rot_deg 0 is the exact identity."""
    pts = bank.verts[ids[:, None], idx]                       # (b, P, 3)
    a = (rot_deg.to(torch.float32) * (math.pi / 180.0))[:, None]
    c, s = torch.cos(a), torch.sin(a)
    x, y, z = pts.unbind(-1)
    pts = torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)
    pts = pts - pts.amin(dim=(1, 2), keepdim=True)
    m = pts.amax(dim=(1, 2), keepdim=True)
    return torch.where(m > 0, pts / m.clamp(min=1e-30), pts)


def sample_from_bank(bank: ShapeBank, ids: torch.Tensor, rot_deg: torch.Tensor,
                     seeds: torch.Tensor) -> torch.Tensor:
    """ids (b,) int, rot_deg (b,) f32, seeds (b,) u32 or int64 -> (b,
    point_num, 3) f32: each sample's subset (`sample_indices`, a pure
    function of its seed), gathered straight from the bank without a (b,
    V, 3) intermediate, rotated and normalised (`sample_with_indices`)."""
    ids = ids.to(torch.int64)
    idx = sample_indices(bank.counts[ids], seeds, bank.verts.shape[1], bank.point_num)
    return sample_with_indices(bank, ids, idx, rot_deg)


@dataclass(frozen=True)
class RenderBank:
    """renders: (S, R, H, W, 3) u8, every model's whole render set; id_table:
    (72, K) int64, the view ids of each azimuth mutation
    (`multiview_ids(view_num, tour, m)`). Both on the step's device."""

    renders: torch.Tensor
    id_table: torch.Tensor

    batch_keys = RENDER_ID_KEYS

    @classmethod
    def from_arrays(cls, renders: np.ndarray, id_table: np.ndarray,
                    device: torch.device | str) -> "RenderBank":
        return cls(torch.as_tensor(np.asarray(renders, np.uint8)).to(device),
                   torch.as_tensor(np.asarray(id_table, np.int64)).to(device))

    @property
    def nbytes(self) -> int:
        return self.renders.nbytes + self.id_table.nbytes


def gather_renders(bank: RenderBank, ids: torch.Tensor, mutation: torch.Tensor) -> torch.Tensor:
    """ids (b,), mutation (b,) -> (b, K, H, W, 3) f32 in [0, 1]: one flat
    gather of exactly the b*K selected renders (never the (b, R, ...)
    intermediate), then the u8 wire's `dewire`."""
    s, r = bank.renders.shape[:2]
    view_ids = bank.id_table[mutation.to(torch.int64)]                # (b, K)
    flat = ids.to(torch.int64)[:, None] * r + view_ids
    sel = bank.renders.reshape(s * r, *bank.renders.shape[2:]).index_select(0, flat.reshape(-1))
    return dewire(sel.reshape(*flat.shape, *bank.renders.shape[2:]))


def resolve(bank, batch: dict) -> torch.Tensor:
    """A batch's bank reference keys -> its shapes, by the bank's kind."""
    if isinstance(bank, RenderBank):
        return gather_renders(bank, batch["shape_id"], batch["shape_mut"])
    return sample_from_bank(bank, batch["shape_id"], batch["shape_rot"], batch["shape_seed"])
