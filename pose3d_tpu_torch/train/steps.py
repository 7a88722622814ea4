"""Train and evaluation steps. Port of `pose3d_tpu/train/steps.py`:
`route_info_nce`, `make_teacher_train_step` (the contrastive teacher,
`nce_variant="info"`), `make_kd_crd_step` (the KD `--crd` student step,
`loss_variant="crd"`), `make_stage1_step` (KD `--stage 1`, the vanilla
teacher and the student trained together, without the memory bank) and
`make_eval_step` (student, teacher and vanilla kinds). The stage-2 step,
the other KD loss variants, the memory bank and the pose-weighted NCE
variants come with their paths (ROADMAP.md Queue 1)."""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import pose_loss, pose_loss_per_sample
from pose3d_tpu_torch.losses.kd import kd_loss_with_features
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


def make_kd_crd_step(bin_size: int = 15, temperature: float = 1.0) -> Callable:
    """The KD `--crd` student step (JAX's `make_kd_crd_step`,
    `loss_variant="crd"`): the three views of each sample through the
    student in train mode, the frozen teacher's responses and projector
    features on them, then 0.25 * the pose loss + 0.75 * the six heads' KL
    + 0.75 * the features' KL (`losses.kd.kd_loss_with_features`, at
    `temperature`); one Adam update and one schedule step. JAX's
    `device_augment`, `device_views`, `int8_teacher` and `with_shape_bank`
    are not taken (the CLI refuses them; ROADMAP.md).

    Returns step(state, teacher, batch, keep=None) -> {'loss', 'gt_loss',
    'acc_rot'} (0-d tensors on the student's device, no host sync).
    `batch` holds 'im', 'im_flip', 'im_rot' (N, H, W, 3) float32 or uint8
    (the u8 wire), 'label', 'label_flip', 'label_rot' (N, 3), 'shape'
    (N, P, 3) the samples' clouds and, for a padded batch, 'valid' (N,)
    bool, all on the student's device. The views are stacked [im, im_flip,
    im_rot] and their rows masked by `valid` three times over. The teacher
    (a `PoseEstimator`, frozen) runs in eval mode without a gradient, in
    its own dtype, with `view_tile=3`: each cloud is encoded once for its
    three views. The classifier dropout's keep-masks come from
    `state.generator` unless `keep` (two (3N, 4096) bool masks) is given.
    """
    def step(state: TrainState, teacher, batch: dict, keep=None) -> dict:
        model = state.model
        model.train()
        teacher.eval()
        valid = batch.get("valid")
        valid3 = None if valid is None else torch.cat([valid] * 3)
        im = dewire(torch.cat([batch["im"], batch["im_flip"], batch["im_rot"]]))
        label = torch.cat([batch["label"], batch["label_flip"], batch["label_rot"]])
        s_out, s_feat = model(im, mask=valid3, generator=state.generator, keep=keep)
        t_dtype = next(teacher.parameters()).dtype
        with torch.no_grad():
            t_out, _, t_feat = teacher(im.to(t_dtype), batch["shape"].to(t_dtype),
                                       view_tile=3)
        # the losses in float32 whatever the models' dtypes, as JAX's step
        s_out, t_out = [o.float() for o in s_out], [o.float() for o in t_out]
        gt = pose_loss(s_out, label, bin_size, valid=valid3)
        loss = kd_loss_with_features(s_out, t_out, s_feat.float(), t_feat.float(), gt,
                                     temperature=temperature, valid=valid3)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            preds = geometry.decode_predictions(s_out[:3], s_out[3:], bin_size)
            acc = geometry.rotation_acc(preds, label.to(torch.float32), valid=valid3)
        return {"loss": loss.detach(), "gt_loss": gt.detach(), "acc_rot": acc}

    return step


def make_stage1_step(bin_size: int = 15, tau: float = 0.5, nce_weight: float = 0.75,
                     use_fused_nce: bool = False) -> Callable:
    """KD `--stage 1` (JAX's `make_stage1_step` with `nce_variant="info"`
    and no memory bank): the vanilla teacher (`PoseEstimatorVanilla`) and
    the student both in train mode with `mask=valid`; the teacher's 4-term
    pose loss plus nce_weight * (0.5 NCE(s -> t) + 0.5 NCE(t -> s)), the
    symmetric infoNCE-KD at `tau` with key dropout 0.3, each direction
    through `route_info_nce`; one Adam update and one schedule step for
    each model.

    Returns step(teacher_state, student_state, batch, keep=None,
    student_keep=None) -> {'loss', 'teacher_loss', 'acc_rot'} (0-d tensors
    on the models' device, no host sync; acc_rot is the teacher's).
    `batch` holds 'im' (N, H, W, 3) float32 or uint8 (the u8 wire),
    'shape' (N, P, 3), 'label' (N, 3) and, for a padded batch, 'valid'
    (N,) bool. Each model takes the images in its own dtype. The two NCE
    keep-masks (`keep`, two (N, 200) bool) and the student's classifier
    dropout masks (`student_keep`, as `BaselineEstimator.forward` takes
    them) are drawn from `student_state.generator` unless given, as a test
    does to hand JAX's masks in.
    """
    def step(teacher_state: TrainState, student_state: TrainState, batch: dict,
             keep=None, student_keep=None) -> dict:
        teacher, student = teacher_state.model, student_state.model
        teacher.train()
        student.train()
        valid = batch.get("valid")
        im = dewire(batch["im"])
        s_dtype = next(student.parameters()).dtype
        t_dtype = next(teacher.parameters()).dtype
        s_out, s_feat = student(im.to(s_dtype), mask=valid, generator=student_state.generator,
                                keep=student_keep)
        t_out, t_feat = teacher(im.to(t_dtype), batch["shape"].to(t_dtype), mask=valid)
        # the losses in float32 whatever the models' dtypes, as JAX's step
        t_out = [o.float() for o in t_out]
        s_feat, t_feat = s_feat.float(), t_feat.float()
        teacher_loss = pose_loss(t_out, batch["label"], bin_size, valid=valid)
        if keep is None:
            keep = [torch.rand(t_feat.shape, generator=student_state.generator,
                               device=t_feat.device) < 1.0 - NCE_DROPOUT for _ in range(2)]
        nce_s2t = route_info_nce(s_feat, t_feat, tau, keep[0], NCE_DROPOUT, valid,
                                 use_fused_nce)
        nce_t2s = route_info_nce(t_feat, s_feat, tau, keep[1], NCE_DROPOUT, valid,
                                 use_fused_nce)
        loss = teacher_loss + nce_weight * (0.5 * nce_s2t + 0.5 * nce_t2s)
        for state in (teacher_state, student_state):
            state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for state in (teacher_state, student_state):
            # the student's heads take no part in the loss: as JAX's
            # optimizer, Adam still updates them (weight decay on a zero
            # gradient), which torch's skips for a missing gradient
            for p in state.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()
            state.scheduler.step()
            state.step += 1
        with torch.no_grad():
            preds = geometry.decode_predictions(t_out[:3], t_out[3:], bin_size)
            acc = geometry.rotation_acc(preds, batch["label"].to(torch.float32),
                                        valid=valid)
        return {"loss": loss.detach(), "teacher_loss": teacher_loss.detach(),
                "acc_rot": acc}

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
    tensors on the model's device; the teacher and the vanilla teacher
    (`PoseEstimatorVanilla`, kind "vanilla") also take 'shape' (N, P, 3)
    float32 and, optionally, 'valid' (N,) bool, which keeps padded rows out
    of the teacher's NCE keys. The model runs in eval mode (BatchNorm running
    statistics, no dropout) and the train/val decoder
    (bin + tanh(d)/2 + 0.5) * bin_size decodes the predictions. The
    teacher's NCE drops out its keys with `fixed_keep_mask`.
    """
    if kind not in ("student", "teacher", "vanilla"):
        raise NotImplementedError(f"eval step kind {kind!r} is not ported yet; "
                                  "see ROADMAP.md Queue 1")

    @torch.no_grad()
    def step(batch: dict) -> dict:
        model.eval()
        if kind == "student":
            outputs, _ = model(batch["im"])
        elif kind == "vanilla":
            outputs, _ = model(batch["im"], batch["shape"])
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
