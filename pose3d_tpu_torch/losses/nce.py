"""The contrastive KD loss, per sample. Port of `pose3d_tpu/losses/nce.py
info_nce_kd_per_sample`, the teacher's validation NCE.

Per row i: L2-normalise the query (student/image) features s and the key
(teacher/fused) features t, z_ij = s_i . t_j / tau, and
loss_i = -z_ii + log(e^{z_ii} + sum_j e^{z_ij}): the reference counts the
positive twice (once alone, once among the keys). `valid` masks padded rows
out of the keys. Dropout on the keys (p = 0.3, kept values scaled by
1 / 0.7), which the reference applies even at validation, takes its
keep-mask as an argument: JAX's and torch's generators never draw the same
bits, so the caller owns the mask.
"""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis, as torch F.normalize."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def info_nce_kd_per_sample(feat_ori: torch.Tensor, feat_pos: torch.Tensor,
                           tau: float = 0.1, keep: torch.Tensor | None = None,
                           dropout_rate: float = 0.3,
                           valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, C) query and key features -> (N,) losses. `keep`: bool (N, C)
    dropout keep-mask on the keys, or None for no dropout. `valid`: bool
    (N,), padded rows out of the keys (the caller drops them from the
    returned vector before reducing)."""
    if keep is not None and dropout_rate > 0.0:
        feat_pos = torch.where(keep, feat_pos / (1.0 - dropout_rate),
                               torch.zeros_like(feat_pos))
    feat_ori = _l2_normalize(feat_ori)
    feat_pos = _l2_normalize(feat_pos)
    pos = torch.sum(feat_ori * feat_pos, dim=-1) / tau
    neg = (feat_ori @ feat_pos.T) / tau
    m = torch.maximum(pos, neg.amax(dim=-1))[:, None]
    exp_pos = torch.exp(pos[:, None] - m)[:, 0]
    exp_neg = torch.exp(neg - m)
    if valid is not None:
        exp_neg = exp_neg * valid[None, :].to(exp_neg.dtype)
    denom = exp_pos + torch.sum(exp_neg, dim=-1)
    return -(torch.log(exp_pos) - torch.log(denom))
