"""Evaluation loop: one pass over the validation set, reduced per category.
Port of `pose3d_tpu/train/evaluate.py evaluate_categories`.

Predictions, labels and the validation losses stay on the model's device
through the pass; the geodesic errors of the whole set are computed there in
one call of `ops.geodesic.rotation_err` (the CUDA kernel on the card). Only
the (N,) errors come back to the host, where the per-category median, mean
and Acc@pi/6 threshold reduce, as in JAX.

Numbers (the reference's testing log):
  * per-category Acc@pi/6 = 100 * mean(err <= 30) and MedErr = median(err);
  * category-mean Acc / Med;
  * sample-mean Acc / Med (the reference swaps these two on its summary
    line; they are reported here in their right places);
  * the validation pose loss and, for a teacher, the contrastive NCE loss,
    each a mean over the valid rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from pose3d_tpu_torch.ops import geodesic


@dataclass
class CategoryEvalResult:
    per_category_acc: dict[str, float]
    per_category_med: dict[str, float]
    mean_acc: float = 0.0
    mean_med: float = 0.0
    sample_acc: float = 0.0
    sample_med: float = 0.0
    val_loss: float = 0.0
    val_nce_loss: float = 0.0
    predictions: np.ndarray = field(default=None, repr=False)
    labels: np.ndarray = field(default=None, repr=False)
    errors: np.ndarray = field(default=None, repr=False)
    cat_ids: np.ndarray = field(default=None, repr=False)


def evaluate_categories(
    eval_step: Callable,
    batches: Iterable[dict],
    category_names: list[str],
    device: torch.device | str,
    threshold: float = 30.0,
) -> CategoryEvalResult:
    """Run `eval_step(batch)` over all batches and reduce.

    Each batch is a dict of host arrays as the loader emits them: 'im',
    'label', 'shape' for a teacher, 'cat_id' (int per sample, indexing
    category_names) and 'valid' (bool mask of the padded tail batch; padded
    rows are dropped from every statistic). 'im', 'label', 'shape' and
    'valid' move to `device` for the step.
    """
    preds, labels, cats = [], [], []
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    nce_sum = torch.zeros((), dtype=torch.float64, device=device)
    for batch in batches:
        valid_np = np.asarray(batch.get("valid", np.ones(len(batch["label"]), bool)))
        step_batch = {k: torch.as_tensor(np.asarray(batch[k]), device=device)
                      for k in ("im", "label", "shape") if k in batch}
        valid = step_batch["valid"] = torch.as_tensor(valid_np, device=device)
        metrics = eval_step(step_batch)
        preds.append(metrics["pred"][valid])
        labels.append(step_batch["label"][valid])
        cats.append(np.asarray(batch["cat_id"])[valid_np])
        # per-sample losses: exact masking of the padded tail rows
        loss_sum += metrics["per_sample_loss"][valid].sum(dtype=torch.float64)
        if "per_sample_nce" in metrics:
            nce_sum += metrics["per_sample_nce"][valid].sum(dtype=torch.float64)

    preds_t = torch.cat(preds).contiguous()
    labels_t = torch.cat(labels)
    errs = geodesic.rotation_err(
        preds_t, labels_t.to(torch.float32).contiguous()).cpu().numpy()
    cat_ids = np.concatenate(cats)
    total = max(len(cat_ids), 1)

    per_acc, per_med = {}, {}
    for ci, name in enumerate(category_names):
        mask = cat_ids == ci
        if not mask.any():
            continue
        e = errs[mask]
        per_acc[name] = 100.0 * float(np.mean(e <= threshold))
        per_med[name] = float(np.median(e))

    return CategoryEvalResult(
        per_category_acc=per_acc,
        per_category_med=per_med,
        mean_acc=float(np.mean(list(per_acc.values()))) if per_acc else 0.0,
        mean_med=float(np.mean(list(per_med.values()))) if per_med else 0.0,
        sample_acc=100.0 * float(np.mean(errs <= threshold)),
        sample_med=float(np.median(errs)),
        val_loss=float(loss_sum) / total,
        val_nce_loss=float(nce_sum) / total,
        predictions=preds_t.cpu().numpy(),
        labels=labels_t.cpu().numpy(),
        errors=errs,
        cat_ids=cat_ids,
    )
