"""The evaluation step. Port of `pose3d_tpu/train/steps.py make_eval_step`,
student kind; the teacher and vanilla kinds come with their models
(ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import Callable

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import pose_loss_per_sample


def make_eval_step(model, kind: str, bin_size: int = 15) -> Callable:
    """Returns step(batch) -> {'pred': (N, 3), 'loss': scalar,
    'per_sample_loss': (N,)}, tensors on the model's device.

    `batch` holds 'im' (N, H, W, 3) float32 and 'label' (N, 3) integer
    tensors on the model's device. The model runs in eval mode (BatchNorm
    running statistics, no dropout) and the train/val decoder
    (bin + tanh(d)/2 + 0.5) * bin_size decodes the predictions.
    """
    if kind != "student":
        raise NotImplementedError(f"eval step kind {kind!r} is not ported yet; "
                                  "see ROADMAP.md Queue 1")

    @torch.no_grad()
    def step(batch: dict) -> dict:
        model.eval()
        outputs, _ = model(batch["im"])
        per_sample = pose_loss_per_sample(outputs, batch["label"], bin_size)
        preds = geometry.decode_predictions(outputs[:3], outputs[3:], bin_size)
        return {"pred": preds, "loss": per_sample.mean(),
                "per_sample_loss": per_sample}

    return step
