"""The contrastive losses. Port of `pose3d_tpu/losses/nce.py`:
`info_nce_kd_per_sample` (the teacher's validation NCE) and `info_nce_kd`
(its mean over the valid rows, the teacher step's contrastive term without
`--fused_nce`); `info_nce` (in-batch, eye-masked); the pose-weighted family
of `--nce pose` / `--nce multipose`: `pose_nce`, `pose_nce_kd` (negatives
weighted by `_pairwise_pose_distance` under one of five weightings),
`multi_pose_nce_kd` (every pair within 30 degrees a positive) and
`single_info_nce_kd` (positives only). The pose distances come from the
plain `geometry.rotation_err`, as JAX's from its plain one.

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

import math

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import masked_mean


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis, as torch F.normalize."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _pairwise_pose_distance_raw(labels_deg: torch.Tensor) -> torch.Tensor:
    """(N, 3) label triples -> (N, N) geodesic distances in degrees."""
    n = labels_deg.shape[0]
    a = labels_deg[:, None, :].expand(n, n, 3).reshape(-1, 3)
    b = labels_deg[None, :, :].expand(n, n, 3).reshape(-1, 3)
    return geometry.rotation_err(a, b).reshape(n, n)


def _pairwise_pose_distance(labels_deg: torch.Tensor, weighting: str) -> torch.Tensor:
    """The (N, N) distances rescaled by the reference's weighting schemes."""
    if weighting not in ("linear", "square", "sqrt", "sin", "sinsin"):
        raise ValueError(f"unknown weighting: {weighting}")
    dist = _pairwise_pose_distance_raw(labels_deg)
    if weighting == "linear":
        return dist / 180.0
    if weighting == "square":
        return (dist / 180.0) ** 2
    if weighting == "sqrt":
        return torch.sqrt(dist / 180.0)
    if weighting == "sin":
        return torch.abs(torch.sin(dist / 180.0 * math.pi))
    return torch.sin(dist / 180.0 * math.pi) ** 2


def _weighted_nce(pos_logit: torch.Tensor, neg_logits: torch.Tensor,
                  neg_weights: torch.Tensor | None,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """mean_i -log(e^pos_i / (e^pos_i + sum_j w_ij e^neg_ij)), shifted by
    the row max (held constant); `valid` (N,) bool masks rows out of the
    mean (the caller masks the columns)."""
    all_logits = torch.cat([pos_logit[:, None], neg_logits], dim=-1)
    m = all_logits.amax(dim=-1, keepdim=True).detach()
    exp_pos = torch.exp(pos_logit[:, None] - m)[:, 0]
    exp_neg = torch.exp(neg_logits - m)
    if neg_weights is not None:
        exp_neg = exp_neg * neg_weights
    denom = exp_pos + exp_neg.sum(dim=-1)
    return masked_mean(-(torch.log(exp_pos) - torch.log(denom)), valid)


def info_nce(feat_ori: torch.Tensor, feat_pos: torch.Tensor, tau: float = 0.1) -> torch.Tensor:
    """In-batch infoNCE, the Gram matrix of the queries with its diagonal
    replaced by the positive inner products: CE over its rows."""
    feat_ori, feat_pos = _l2_normalize(feat_ori), _l2_normalize(feat_pos)
    eye = torch.eye(feat_ori.shape[0], dtype=feat_ori.dtype, device=feat_ori.device)
    l_pos = torch.sum(feat_ori * feat_pos, dim=-1)
    logits = ((1.0 - eye) * (feat_ori @ feat_ori.T) + eye * l_pos[:, None]) / tau
    return -torch.diagonal(torch.log_softmax(logits, dim=-1)).mean()


def _pose_nce(feat_ori, feat_pos, keys, labels_deg, tau, weighting, valid):
    dist = _pairwise_pose_distance(labels_deg, weighting)
    if valid is not None:
        dist = dist * valid[None, :].to(dist.dtype)
    pos = torch.sum(feat_ori * feat_pos, dim=-1) / tau
    return _weighted_nce(pos, (feat_ori @ keys.T) / tau, dist, valid)


def pose_nce(feat_ori: torch.Tensor, feat_pos: torch.Tensor, labels_deg: torch.Tensor,
             tau: float = 0.1, weighting: str = "linear",
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Negatives from the queries, each weighted by its pose distance to
    the row's; `valid` zeroes padded rows' weights and drops them from the
    mean."""
    feat_ori = _l2_normalize(feat_ori)
    return _pose_nce(feat_ori, _l2_normalize(feat_pos), feat_ori, labels_deg, tau, weighting,
                     valid)


def pose_nce_kd(feat_ori: torch.Tensor, feat_pos: torch.Tensor, labels_deg: torch.Tensor,
                tau: float = 0.1, weighting: str = "linear",
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """As `pose_nce`, with the negatives from the keys (`--nce pose`)."""
    feat_pos = _l2_normalize(feat_pos)
    return _pose_nce(_l2_normalize(feat_ori), feat_pos, feat_pos, labels_deg, tau, weighting,
                     valid)


def single_info_nce_kd(feat_ori: torch.Tensor, feat_pos: torch.Tensor,
                       tau: float = 0.1) -> torch.Tensor:
    """Positives only: -mean(<s_i, t_i> / tau)."""
    pos = torch.sum(_l2_normalize(feat_ori) * _l2_normalize(feat_pos), dim=-1) / tau
    return torch.mean(-pos)


def multi_pose_nce_kd(feat_ori: torch.Tensor, feat_pos: torch.Tensor,
                      labels_deg: torch.Tensor, tau: float = 0.1, threshold: float = 30.0,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-positive NCE (`--nce multipose`): every key whose pose lies
    within `threshold` degrees of the row's is a positive. `valid` masks
    padded rows out of positives, negatives and the mean; an invalid row's
    positive mass is clamped at 1e-30, as JAX's, so its log stays finite."""
    feat_ori, feat_pos = _l2_normalize(feat_ori), _l2_normalize(feat_pos)
    n = feat_ori.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=feat_ori.device)
    mask = ((_pairwise_pose_distance_raw(labels_deg) <= threshold) | eye).to(feat_ori.dtype)
    logits = (feat_ori @ feat_pos.T) / tau
    exp_logits = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    if valid is not None:
        exp_logits = exp_logits * valid[None, :].to(exp_logits.dtype)
    l_pos = torch.sum(exp_logits * mask, dim=-1)
    if valid is not None:
        l_pos = torch.clamp(l_pos, min=1e-30)
    denom = l_pos + exp_logits.sum(dim=-1)
    return masked_mean(-(torch.log(l_pos) - torch.log(denom)), valid)


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
    # a constant shift, as JAX's stop_gradient: its gradient is zero
    m = torch.maximum(pos, neg.amax(dim=-1)).detach()[:, None]
    exp_pos = torch.exp(pos[:, None] - m)[:, 0]
    exp_neg = torch.exp(neg - m)
    if valid is not None:
        exp_neg = exp_neg * valid[None, :].to(exp_neg.dtype)
    denom = exp_pos + torch.sum(exp_neg, dim=-1)
    return -(torch.log(exp_pos) - torch.log(denom))


def info_nce_kd(feat_ori: torch.Tensor, feat_pos: torch.Tensor, tau: float = 0.1,
                keep: torch.Tensor | None = None, dropout_rate: float = 0.3,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """The batch-mean infoNCE-KD of the reference's recipes: the mean of
    `info_nce_kd_per_sample` over the valid rows (all rows with None)."""
    return masked_mean(
        info_nce_kd_per_sample(feat_ori, feat_pos, tau, keep, dropout_rate, valid), valid)
