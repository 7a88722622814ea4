"""Binned viewpoint loss. Port of `pose3d_tpu/losses/binned.py`
(`pose_loss_per_sample`, the validation loss of the evaluation step;
`masked_mean` and `pose_loss`, the train steps' 4-term loss).

Per sample: bin cross-entropy for azimuth, elevation and inplane (class =
label // (range // n_classes)) plus the in-bin delta Huber
SmoothL1(5 * tanh(reg[gt_bin]) / 2, 5 * ((label % bin) / bin - 0.5)),
averaged over the three angles. Its mean over the batch is the reference's
4-term pose loss (JAX sums the four batch means when no row is padded: the
same value up to float32 rounding).
"""

from __future__ import annotations

import torch


def pose_loss_per_sample(outputs, target_deg: torch.Tensor,
                         bin_size: int = 15) -> torch.Tensor:
    """outputs: the six heads [cls_azi, cls_ele, cls_inp, reg_azi, reg_ele,
    reg_inp]; target_deg: (N, 3) canonical integer labels -> (N,)."""
    target_int = target_deg.to(torch.int64)
    per = torch.zeros(target_deg.shape[0], dtype=torch.float32,
                      device=target_deg.device)
    for i, angle_range in ((0, 360), (1, 180), (2, 360)):
        logits = outputs[i]
        labels = torch.div(target_int[:, i], angle_range // logits.shape[-1],
                           rounding_mode="floor")
        log_probs = torch.log_softmax(logits, dim=-1)
        per = per - log_probs.gather(-1, labels[:, None])[:, 0]

    target_delta = torch.remainder(target_deg.to(torch.float32), bin_size) / bin_size - 0.5
    gt_bin = torch.div(target_int, bin_size, rounding_mode="floor")
    pred_delta = torch.stack(
        [torch.tanh(reg.gather(-1, gt_bin[:, i:i + 1])[:, 0]) / 2.0
         for i, reg in enumerate(outputs[3:6])], dim=-1)
    diff = torch.abs(5.0 * pred_delta - 5.0 * target_delta)
    huber = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return per + huber.mean(dim=-1)


def masked_mean(per_sample: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Mean over the valid rows ((N,) bool), or a plain mean with None;
    padded rows add exactly nothing to the loss or its gradient."""
    if valid is None:
        return per_sample.mean()
    v = valid.to(per_sample.dtype)
    return torch.sum(per_sample * v) / torch.clamp(v.sum(), min=1.0)


def pose_loss(outputs, target_deg: torch.Tensor, bin_size: int = 15,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """The 4-term viewpoint loss (three bin cross-entropies and the delta
    Huber), a mean over the valid rows."""
    return masked_mean(pose_loss_per_sample(outputs, target_deg, bin_size), valid)
