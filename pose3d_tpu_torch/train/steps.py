"""Train and evaluation steps. Port of `pose3d_tpu/train/steps.py`:
`route_info_nce`, `make_teacher_train_step` (the contrastive teacher,
`nce_variant="info"`) and `make_eval_step` (student and teacher kinds). The
vanilla kind, the KD steps and the pose-weighted NCE variants come with
their paths (ROADMAP.md Queue 1)."""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import pose_loss, pose_loss_per_sample
from pose3d_tpu_torch.losses.nce import info_nce_kd, info_nce_kd_per_sample
from pose3d_tpu_torch.ops import nce
from pose3d_tpu_torch.ops.augment import dewire
from pose3d_tpu_torch.train.state import TrainState

NCE_TAU, NCE_DROPOUT, NCE_WEIGHT = 0.1, 0.3, 0.5
# JAX's widest batch for the single-block kernel (its b^2 Gram in VMEM);
# the routing table is kept as JAX's, so both route a batch alike
SINGLE_BLOCK_NCE_MAX = 1024


def route_info_nce(feat_q: torch.Tensor, feat_k: torch.Tensor, tau: float,
                   keep: torch.Tensor | None, dropout_rate: float,
                   valid: torch.Tensor | None, use_fused: bool) -> torch.Tensor:
    """The in-batch infoNCE-KD selector, JAX's table case by case:

      * use_fused False: `losses.nce.info_nce_kd` (dropout inside);
      * use_fused True: dropout applied here with the (N, C) bool keep-mask
        `keep` (None: no dropout), then
          - N > 1024, masked or not: `ops.nce.blocked_info_nce`;
          - N <= 1024 with a `valid` mask: `info_nce_kd` without dropout
            (JAX's single-block kernel has no mask);
          - N <= 1024 unmasked: `ops.nce.fused_info_nce`.
    The two kernel entries run the same CUDA kernels on the card."""
    if not use_fused:
        return info_nce_kd(feat_q, feat_k, tau, keep=keep, dropout_rate=dropout_rate,
                           valid=valid)
    if keep is not None and dropout_rate > 0.0:
        feat_k = torch.where(keep, feat_k / (1.0 - dropout_rate), torch.zeros_like(feat_k))
    if feat_q.shape[0] > SINGLE_BLOCK_NCE_MAX:
        return nce.blocked_info_nce(feat_q, feat_k, tau, valid=valid)
    if valid is not None:
        return info_nce_kd(feat_q, feat_k, tau, keep=None, dropout_rate=0.0, valid=valid)
    return nce.fused_info_nce(feat_q, feat_k, tau)


def make_teacher_train_step(bin_size: int = 15, nce_dropout: float = NCE_DROPOUT,
                            use_fused_nce: bool = False) -> Callable:
    """The contrastive teacher's step (JAX's `nce_variant="info"`): the
    4-term pose loss plus 0.5 times the infoNCE-KD (tau 0.1) between the
    image projection and the fused feature, through `route_info_nce`; one
    Adam update and one schedule step. JAX's `nce_mesh` has no single-GPU
    meaning and is not taken; the pose-weighted variants are refused by the
    CLI (ROADMAP.md).

    Returns step(state, batch, keep=None) -> {'loss', 'pose_loss',
    'nce_loss', 'acc_rot'} (0-d tensors on the model's device, no host
    sync). `batch` holds 'im' (N, H, W, 3) float32 or uint8 (the u8
    wire), 'shape' (N, P, 3), 'label' (N, 3) and, for a padded batch,
    'valid' (N,) bool, all on the model's device. The dropout keep-mask on
    the keys is drawn from `state.generator` unless `keep` ((N, 200) bool)
    is given, as a test does to hand JAX's mask in.
    """
    def step(state: TrainState, batch: dict, keep: torch.Tensor | None = None) -> dict:
        model = state.model
        model.train()
        valid = batch.get("valid")
        outputs, fused, img_proj = model(dewire(batch["im"]), batch["shape"], mask=valid)
        # the losses in float32 whatever the model's dtype, as JAX's step
        outputs = [o.float() for o in outputs]
        fused, img_proj = fused.float(), img_proj.float()
        gt = pose_loss(outputs, batch["label"], bin_size, valid=valid)
        if keep is None and nce_dropout > 0.0:
            keep = torch.rand(fused.shape, generator=state.generator,
                              device=fused.device) < 1.0 - nce_dropout
        nce_loss = route_info_nce(img_proj, fused, NCE_TAU, keep, nce_dropout, valid,
                                  use_fused_nce)
        loss = gt + NCE_WEIGHT * nce_loss
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            preds = geometry.decode_predictions(outputs[:3], outputs[3:], bin_size)
            acc = geometry.rotation_acc(preds, batch["label"].to(torch.float32),
                                        valid=valid)
        return {"loss": loss.detach(), "pose_loss": gt.detach(),
                "nce_loss": nce_loss.detach(), "acc_rot": acc}

    return step


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
