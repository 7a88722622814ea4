"""Knowledge-distillation losses. Port of `pose3d_tpu/losses/kd.py:26-91`
(the reference's vanilla_kd.py):

  * `temperature_scaled_kl`: T^2 * KL(softmax(t/T) || softmax(s/T)) with
    torch's `reduction="batchmean"`; `valid` keeps padded rows out of the
    mean;
  * `kd_loss`: 0.25 * gt + 0.75 * the sum of the six heads' KL;
  * `kd_loss_with_features`: the `--crd` loss, `kd_loss` + 0.75 * the KL of
    the 200-d projector features, treated as logits and softmaxed, as the
    reference does;
  * `gaussian_vid_loss` and `vid_loss` (`pose3d_tpu/losses/kd.py:43-56,
    94-117`): the `--vid` loss, 0.6 * gt + 0.2 * the mean of the six heads'
    KL + 0.2 * the Gaussian VID term on the projector features (variance
    ones unless given).

The teacher's logits and features carry no gradient: the caller computes
them under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def temperature_scaled_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                          temperature: float = 1.0,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """T^2 * batchmean KL(q || p), q = softmax(teacher / T), p =
    softmax(student / T); `valid` (N,) bool masks padded rows out of the
    mean (divided by max(valid rows, 1))."""
    log_p = F.log_softmax(student_logits / temperature, dim=-1)
    log_q = F.log_softmax(teacher_logits / temperature, dim=-1)
    kl = (torch.exp(log_q) * (log_q - log_p)).sum(dim=-1)
    if valid is None:
        return temperature ** 2 * kl.mean()
    v = valid.to(kl.dtype)
    return temperature ** 2 * ((kl * v).sum() / torch.clamp(v.sum(), min=1.0))


def _heads_kl(student_outputs: Sequence[torch.Tensor], teacher_outputs: Sequence[torch.Tensor],
              temperature: float, valid: torch.Tensor | None) -> torch.Tensor:
    return sum(temperature_scaled_kl(s, t, temperature, valid)
               for s, t in zip(student_outputs, teacher_outputs))


def kd_loss(student_outputs: Sequence[torch.Tensor], teacher_outputs: Sequence[torch.Tensor],
            gt_loss: torch.Tensor, temperature: float = 1.0, gt_weight: float = 0.25,
            kl_weight: float = 0.75, valid: torch.Tensor | None = None) -> torch.Tensor:
    """0.25 * gt + 0.75 * the sum over the six heads of the scaled KL."""
    return gt_weight * gt_loss + kl_weight * _heads_kl(student_outputs, teacher_outputs,
                                                       temperature, valid)


def kd_loss_with_features(student_outputs: Sequence[torch.Tensor],
                          teacher_outputs: Sequence[torch.Tensor],
                          student_features: torch.Tensor, teacher_features: torch.Tensor,
                          gt_loss: torch.Tensor, temperature: float = 1.0,
                          gt_weight: float = 0.25, kl_weight: float = 0.75,
                          feature_weight: float = 0.75,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """The `--crd` loss (the reference's calculate_kd_loss_new)."""
    return (kd_loss(student_outputs, teacher_outputs, gt_loss, temperature, gt_weight,
                    kl_weight, valid)
            + feature_weight * temperature_scaled_kl(student_features, teacher_features,
                                                     temperature, valid))


def gaussian_vid_loss(pred_mean: torch.Tensor, pred_var: torch.Tensor, target: torch.Tensor,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """mean(0.5 * ((mu - y)^2 / var + log var)); `valid` (N,) bool takes
    the mean of each row, then of the valid rows (over max(valid rows, 1))."""
    per = 0.5 * ((pred_mean - target) ** 2 / pred_var + torch.log(pred_var))
    if valid is None:
        return per.mean()
    per_row = per.mean(dim=tuple(range(1, per.dim())))
    v = valid.to(per_row.dtype)
    return (per_row * v).sum() / torch.clamp(v.sum(), min=1.0)


def vid_loss(student_outputs: Sequence[torch.Tensor], teacher_outputs: Sequence[torch.Tensor],
             student_loss: torch.Tensor, student_features: torch.Tensor,
             teacher_features: torch.Tensor, pred_var: torch.Tensor | None = None,
             temperature: float = 1.0, valid: torch.Tensor | None = None) -> torch.Tensor:
    """The `--vid` loss (the reference's calculate_vid_loss): 0.6 * gt +
    0.2 * the six heads' mean KL + 0.2 * the VID term; `valid` masks padded
    rows out of every term."""
    kl = sum(temperature_scaled_kl(s, t, temperature, valid) / 6.0
             for s, t in zip(student_outputs, teacher_outputs))
    if pred_var is None:
        pred_var = torch.ones_like(student_features)
    vid = gaussian_vid_loss(student_features, pred_var, teacher_features, valid)
    return 0.6 * student_loss + 0.2 * kl + 0.2 * vid
