"""The evaluation step. Port of `pose3d_tpu/train/steps.py make_eval_step`,
student and teacher kinds; the vanilla kind comes with its model
(ROADMAP.md Queue 1)."""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import pose_loss_per_sample
from pose3d_tpu_torch.losses.nce import info_nce_kd_per_sample

NCE_TAU, NCE_DROPOUT = 0.1, 0.3


@functools.cache
def fixed_keep_mask(n: int, width: int, device) -> torch.Tensor:
    """The validation NCE's dropout keep-mask for a batch of n rows: drawn
    once per shape from a CPU generator seeded 0, then the same in every
    batch and on every device. JAX draws it from `jax.random.key(0)` in
    every batch, so it too is one fixed mask per shape, but with other
    bits. Read-only: callers share it."""
    mask = torch.rand((n, width), generator=torch.Generator().manual_seed(0))
    return (mask < 1.0 - NCE_DROPOUT).to(device)


def make_eval_step(model, kind: str, bin_size: int = 15) -> Callable:
    """Returns step(batch) -> {'pred': (N, 3), 'loss': scalar,
    'per_sample_loss': (N,)} and, for the teacher, 'per_sample_nce': (N,);
    tensors on the model's device.

    `batch` holds 'im' (N, H, W, 3) float32 and 'label' (N, 3) integer
    tensors on the model's device; the teacher also takes 'shape' (N, P, 3)
    float32 and, optionally, 'valid' (N,) bool, which keeps padded rows out
    of the NCE's keys. The model runs in eval mode (BatchNorm running
    statistics, no dropout) and the train/val decoder
    (bin + tanh(d)/2 + 0.5) * bin_size decodes the predictions. The
    teacher's NCE drops out its keys with `fixed_keep_mask`.
    """
    if kind not in ("student", "teacher"):
        raise NotImplementedError(f"eval step kind {kind!r} is not ported yet; "
                                  "see ROADMAP.md Queue 1")

    @torch.no_grad()
    def step(batch: dict) -> dict:
        model.eval()
        if kind == "student":
            outputs, _ = model(batch["im"])
        else:
            outputs, fused, img_proj = model(batch["im"], batch["shape"])
        per_sample = pose_loss_per_sample(outputs, batch["label"], bin_size)
        preds = geometry.decode_predictions(outputs[:3], outputs[3:], bin_size)
        metrics = {"pred": preds, "loss": per_sample.mean(),
                   "per_sample_loss": per_sample}
        if kind == "teacher":
            # the reference's contrastive validation loss, teacher dropout
            # included (a fixed mask); padded rows are not keys
            keep = fixed_keep_mask(*fused.shape, fused.device)
            metrics["per_sample_nce"] = info_nce_kd_per_sample(
                img_proj, fused, NCE_TAU, keep=keep, dropout_rate=NCE_DROPOUT,
                valid=batch.get("valid"))
        return metrics

    return step
