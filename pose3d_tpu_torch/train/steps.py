"""Train and evaluation steps. Port of `pose3d_tpu/train/steps.py`:
`route_info_nce`; `make_teacher_train_step` (the contrastive teacher, its
NCE `"info"`, `"pose"` or `"multipose"`); `make_vanilla_train_step` (the
4-term pose loss alone: the RGB-only baseline, or the vanilla teacher);
`make_kd_crd_step` (the KD student step against a frozen teacher,
`loss_variant` `"crd"`, `"contrast"` or `"vid"`); `make_stage1_step` (KD
`--stage 1`, the vanilla teacher and the student trained together, with
the memory bank or a pose-weighted NCE as options); `make_stage2_step` (KD
`--stage 2`, response KD from the frozen stage-1 teacher); and
`make_eval_step` (student, teacher and vanilla kinds). Where a batch's
'shape' is described as (N, P, 3) clouds, a MultiView teacher takes (N, K,
H, W, 3) renders in its place; no step depends on which.

The on-device data options, as JAX's factories take them:
  * `shape_bank` (`--device_shapes`): a `ShapeBank` or `RenderBank` on the
    step's device, bound when the step is built; the batch then carries
    the bank's reference keys in place of 'shape', and `shape_of` resolves
    them in the step. Every factory that takes a shape takes it.
  * `device_augment` (the teacher step, KD `--crd`): the batch's images
    are raw pixels (u8), augmented and normalised in the step
    (`ops.augment.device_augment`), its draws from the state's generator
    or given (`aug`).
  * `device_views` (KD `--crd` and `--stage 2`): the batch carries one raw
    view a sample and 'rot_sign'; the flipped and rotated views are built
    in the step (`ops.augment.synthesize_views`), then augmented as above
    (the option implies the device photometrics, as in JAX)."""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import pose_loss, pose_loss_per_sample
from pose3d_tpu_torch.losses.kd import kd_loss, kd_loss_with_features, vid_loss
from pose3d_tpu_torch.losses.memory_bank import enqueue, info_nce_memory
from pose3d_tpu_torch.losses.nce import (info_nce_kd, info_nce_kd_per_sample,
                                         multi_pose_nce_kd, pose_nce_kd)
from pose3d_tpu_torch.ops import nce
from pose3d_tpu_torch.ops import shape_bank as _shape_bank
from pose3d_tpu_torch.ops.augment import augment_draws, dewire, device_augment, synthesize_views
from pose3d_tpu_torch.serving.quant_teacher import (make_teacher_int8_kd_fwd,
                                                    make_vanilla_int8_kd_fwd)
from pose3d_tpu_torch.train.state import TrainState

NCE_TAU, NCE_DROPOUT, NCE_WEIGHT = 0.1, 0.3, 0.5
# JAX's widest batch for the single-block kernel (its b^2 Gram in VMEM);
# the routing table is kept as JAX's, so both route a batch alike
SINGLE_BLOCK_NCE_MAX = 1024
NCE_VARIANTS = ("info", "pose", "multipose")
KD_LOSS_VARIANTS = ("crd", "contrast", "vid")


def _pose_variant_nce(variant: str, q: torch.Tensor, k: torch.Tensor, labels: torch.Tensor,
                      tau: float, weighting: str, valid: torch.Tensor | None) -> torch.Tensor:
    """The pose-weighted NCE of `--nce pose` (`pose_nce_kd` under
    `weighting`) or `--nce multipose` (`multi_pose_nce_kd`), the labels as
    f32: no dropout and no kernel, as in JAX."""
    labels = labels.to(torch.float32)
    if variant == "pose":
        return pose_nce_kd(q, k, labels, tau, weighting, valid=valid)
    return multi_pose_nce_kd(q, k, labels, tau, valid=valid)


def input_dtype(model: torch.nn.Module) -> torch.dtype:
    """The dtype a model takes its images and clouds in: its compute dtype
    (bfloat16 under `--bf16`), else its parameters' (float32, or float64 in
    the parity tests)."""
    return getattr(model, "compute_dtype", None) or next(model.parameters()).dtype


def shape_of(batch: dict, bank, dtype: torch.dtype | None = None) -> torch.Tensor | None:
    """batch['shape'], or the shapes resolved on the device from the
    batch's bank reference keys when a bank is given and the batch carries
    them (`ops.shape_bank.resolve`: f32, cast to `dtype` if given)."""
    if bank is not None and "shape_id" in batch:
        shape = _shape_bank.resolve(bank, batch)
        return shape if dtype is None else shape.to(dtype)
    return batch.get("shape")


def _augmented(im: torch.Tensor, generator: torch.Generator | None, aug) -> torch.Tensor:
    """`device_augment` of f32 [0, 1] images, its draws `aug` (a dict of
    `ops.augment.AUG_DRAW_KEYS`) or, if None, drawn from `generator`."""
    if aug is None:
        aug = augment_draws(im.shape[0], generator, im.device)
    return device_augment(im, draws=aug)


def _update(state: TrainState) -> None:
    """One Adam update and one schedule step after the backward pass. A
    parameter the loss does not reach takes a zero gradient: JAX's
    optimizer still applies its weight decay, which torch's Adam would skip
    for a missing gradient."""
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def _acc(outputs, labels: torch.Tensor, bin_size: int, valid) -> torch.Tensor:
    with torch.no_grad():
        preds = geometry.decode_predictions(outputs[:3], outputs[3:], bin_size)
        return geometry.rotation_acc(preds, labels.to(torch.float32), valid=valid)


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
                            use_fused_nce: bool = False, nce_variant: str = "info",
                            nce_weighting: str = "linear", device_augment: bool = False,
                            shape_bank=None) -> Callable:
    """The contrastive teacher's step: the 4-term pose loss plus 0.5 times
    the NCE (tau 0.1) between the image projection and the fused feature.
    `nce_variant` "info" takes the infoNCE-KD through `route_info_nce`;
    "pose" (`pose_nce_kd` under `nce_weighting`) and "multipose"
    (`multi_pose_nce_kd`) take the batch's labels, no dropout and no
    kernel, as JAX's. One Adam update and one schedule step. JAX's
    `nce_mesh` has no single-GPU meaning and is not taken.
    `device_augment`: the images are raw pixels, augmented and normalised
    in the step. `shape_bank`: the device-resident bank, bound here; the
    batch then carries its reference keys in place of 'shape'.

    Returns step(state, batch, keep=None, aug=None) -> {'loss',
    'pose_loss', 'nce_loss', 'acc_rot'} (0-d tensors on the model's
    device, no host sync). `batch` holds 'im' (N, H, W, 3) float32 or
    uint8 (the u8 wire), 'shape' (N, P, 3) or the bank's keys, 'label' (N,
    3) and, for a padded batch, 'valid' (N,) bool, all on the model's
    device. The augmentation's draws (`aug`), then the "info" NCE's
    dropout keep-mask on the keys, are drawn from `state.generator` unless
    given (`keep`: (N, 200) bool), as a test does to hand JAX's in.
    """
    if nce_variant not in NCE_VARIANTS:
        raise ValueError(f"unknown nce_variant: {nce_variant!r}")

    def step(state: TrainState, batch: dict, keep: torch.Tensor | None = None,
             aug: dict | None = None) -> dict:
        model = state.model
        model.train()
        valid = batch.get("valid")
        im = dewire(batch["im"])
        if device_augment:
            im = _augmented(im, state.generator, aug)
        shape = shape_of(batch, shape_bank, input_dtype(model))
        outputs, fused, img_proj = model(im, shape, mask=valid)
        # the losses in float32 whatever the model's dtype, as JAX's step
        outputs = [o.float() for o in outputs]
        fused, img_proj = fused.float(), img_proj.float()
        gt = pose_loss(outputs, batch["label"], bin_size, valid=valid)
        if nce_variant != "info":
            nce_loss = _pose_variant_nce(nce_variant, img_proj, fused, batch["label"], NCE_TAU,
                                         nce_weighting, valid)
        else:
            if keep is None and nce_dropout > 0.0:
                keep = torch.rand(fused.shape, generator=state.generator,
                                  device=fused.device) < 1.0 - nce_dropout
            nce_loss = route_info_nce(img_proj, fused, NCE_TAU, keep, nce_dropout, valid,
                                      use_fused_nce)
        loss = gt + NCE_WEIGHT * nce_loss
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _update(state)
        return {"loss": loss.detach(), "pose_loss": gt.detach(),
                "nce_loss": nce_loss.detach(),
                "acc_rot": _acc(outputs, batch["label"], bin_size, valid)}

    return step


def make_vanilla_train_step(has_shape: bool, bin_size: int = 15, shape_bank=None) -> Callable:
    """Plain supervised training (JAX's `make_vanilla_train_step`): the
    4-term pose loss alone, one Adam update and one schedule step. Without
    a shape the model is the RGB-only `BaselineEstimator` (the `--shape
    None` baseline; its classifier dropout from `state.generator` unless
    `keep` is given); with one, a `PoseEstimatorVanilla` on 'shape', or on
    the shapes resolved from `shape_bank` (bound here).

    Returns step(state, batch, keep=None) -> {'loss', 'acc_rot'} (0-d
    tensors on the model's device, no host sync). `batch` holds 'im' (N,
    H, W, 3) float32 or uint8, 'label' (N, 3), with a shape 'shape' (N, P,
    3), and, for a padded batch, 'valid' (N,) bool.
    """
    def step(state: TrainState, batch: dict, keep=None) -> dict:
        model = state.model
        model.train()
        valid = batch.get("valid")
        im = dewire(batch["im"]).to(input_dtype(model))
        if has_shape:
            out = model(im, shape_of(batch, shape_bank).to(input_dtype(model)), mask=valid)
        else:
            out = model(im, mask=valid, generator=state.generator, keep=keep)
        outputs = [o.float() for o in out[0]]
        loss = pose_loss(outputs, batch["label"], bin_size, valid=valid)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _update(state)
        return {"loss": loss.detach(), "acc_rot": _acc(outputs, batch["label"], bin_size, valid)}

    return step


def _int8_teacher_forward(loss_kind: str) -> Callable:
    """The frozen teacher's forward with its conv trunks int8:
    fn({"model": teacher, "q8": quantized tree}, im, shape) -> (six heads,
    feature), the PointCloud or MultiView teacher's heads and projector
    feature (`make_teacher_int8_kd_fwd`) or, for "stage2", the vanilla
    teacher's heads and None (`make_vanilla_int8_kd_fwd`); view_tile 3."""
    def fwd(teacher: dict, im: torch.Tensor, shape: torch.Tensor):
        model, dtype = teacher["model"], input_dtype(teacher["model"])
        im, shape = im.to(dtype), shape.to(dtype)
        if loss_kind == "stage2":
            return make_vanilla_int8_kd_fwd(model)(teacher["q8"], im, shape, view_tile=3), None
        return make_teacher_int8_kd_fwd(model)(teacher["q8"], im, shape, view_tile=3)

    return fwd


def _views_step(bin_size: int, temperature: float, loss_kind: str,
                int8_teacher: bool = False, augment: bool = False,
                device_views: bool = False, shape_bank=None) -> Callable:
    """The student step over three views against a frozen teacher, shared
    by `make_kd_crd_step` and `make_stage2_step`; `loss_kind` "crd",
    "contrast", "vid" or "stage2" (the response KD: `kd_loss`, as
    "contrast"). With `int8_teacher` the step's `teacher` is {"model":
    the teacher, "q8": its quantized tree} and the teacher's forward runs
    its conv trunks int8 (`_int8_teacher_forward`). `device_views`: the
    views are built from the batch's one raw view (`synthesize_views`);
    `augment`: the views are augmented and normalised in the step;
    `shape_bank`: the shapes are resolved from it (bound here)."""
    int8_fwd = _int8_teacher_forward(loss_kind) if int8_teacher else None

    def step(state: TrainState, teacher, batch: dict, keep=None, aug=None) -> dict:
        model = state.model
        model.train()
        valid = batch.get("valid")
        valid3 = None if valid is None else torch.cat([valid] * 3)
        if device_views:
            im = synthesize_views(dewire(batch["im"]), batch["rot_sign"])
        else:
            im = dewire(torch.cat([batch["im"], batch["im_flip"], batch["im_rot"]]))
        if augment:
            im = _augmented(im, state.generator, aug)
        label = torch.cat([batch["label"], batch["label_flip"], batch["label_rot"]])
        shape = shape_of(batch, shape_bank)
        s_out, s_feat = model(im.to(input_dtype(model)), mask=valid3,
                              generator=state.generator, keep=keep)
        with torch.no_grad():
            # ([6 heads], ..., feature): the teacher's projector feature,
            # or the vanilla teacher's compressed one (unused by its loss);
            # each cloud encoded once, its feature tiled over the views
            if int8_fwd is not None:
                t_out, t_feat = int8_fwd(teacher, im, shape)
            else:
                teacher.eval()
                t_dtype = input_dtype(teacher)
                t = teacher(im.to(t_dtype), shape.to(t_dtype), view_tile=3)
                t_out, t_feat = t[0], t[-1]
        # the losses in float32 whatever the models' dtypes, as JAX's step
        s_out, t_out = [o.float() for o in s_out], [o.float() for o in t_out]
        s_feat = s_feat.float()
        t_feat = None if t_feat is None else t_feat.float()
        gt = pose_loss(s_out, label, bin_size, valid=valid3)
        if loss_kind == "crd":
            loss = kd_loss_with_features(s_out, t_out, s_feat, t_feat, gt,
                                         temperature=temperature, valid=valid3)
        elif loss_kind == "vid":
            loss = vid_loss(s_out, t_out, gt, s_feat, t_feat, temperature=temperature,
                            valid=valid3)
        else:
            loss = kd_loss(s_out, t_out, gt, temperature=temperature, valid=valid3)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _update(state)
        return {"loss": loss.detach(), "gt_loss": gt.detach(),
                "acc_rot": _acc(s_out, label, bin_size, valid3)}

    return step


def make_kd_crd_step(bin_size: int = 15, temperature: float = 1.0,
                     loss_variant: str = "crd", int8_teacher: bool = False,
                     device_augment: bool = False, device_views: bool = False,
                     shape_bank=None) -> Callable:
    """The KD student step (JAX's `make_kd_crd_step`): the three views of
    each sample through the student in train mode, the frozen teacher's
    responses and projector features on them, then by `loss_variant`:
      * "crd" (`--crd`): 0.25 * the pose loss + 0.75 * the six heads' KL +
        0.75 * the features' KL (`losses.kd.kd_loss_with_features`);
      * "contrast" (`--contrast`): the same without the features' KL
        (`kd_loss`);
      * "vid" (`--vid`): 0.6 * the pose loss + 0.2 * the heads' mean KL +
        0.2 * the VID term on the 200-d features (`vid_loss`);
    at `temperature`; one Adam update and one schedule step. With
    `int8_teacher` the frozen teacher's conv trunks run int8
    (`serving.quant_teacher.make_teacher_int8_kd_fwd`: the ResNet-50, and a
    MultiView teacher's per-view ResNet-18), and the step's `teacher` is
    {"model": the teacher, "q8": its quantized tree}, as JAX's
    {"variables", "q8"}. `device_augment`: the views' raw pixels are
    augmented and normalised in the step. `device_views`: the batch
    carries one raw view a sample and 'rot_sign' in place of 'im_flip' and
    'im_rot'; the views are built in the step and augmented, whatever
    `device_augment` says, as in JAX. `shape_bank`: the device-resident
    bank, bound here; the batch carries its reference keys in place of
    'shape'.

    Returns step(state, teacher, batch, keep=None, aug=None) -> {'loss',
    'gt_loss', 'acc_rot'} (0-d tensors on the student's device, no host
    sync). `batch` holds 'im', 'im_flip', 'im_rot' (N, H, W, 3) float32 or
    uint8 (the u8 wire), 'label', 'label_flip', 'label_rot' (N, 3), 'shape'
    (N, P, 3) the samples' clouds and, for a padded batch, 'valid' (N,)
    bool, all on the student's device. The views are stacked [im, im_flip,
    im_rot] and their rows masked by `valid` three times over. The teacher
    (a `PoseEstimator`, frozen) runs in eval mode without a gradient, in
    its own dtype, with `view_tile=3`: each of the N shapes is encoded
    once for its three views. The augmentation's draws for the 3N views
    (`aug`), then the classifier dropout's keep-masks (`keep`, two (3N,
    4096) bool masks), come from `state.generator` unless given.
    """
    if loss_variant not in KD_LOSS_VARIANTS:
        raise ValueError(f"unknown loss_variant: {loss_variant!r}")
    return _views_step(bin_size, temperature, loss_variant, int8_teacher,
                       augment=device_augment or device_views, device_views=device_views,
                       shape_bank=shape_bank)


def make_stage2_step(bin_size: int = 15, temperature: float = 1.0,
                     int8_teacher: bool = False, device_views: bool = False,
                     shape_bank=None) -> Callable:
    """KD `--stage 2` (JAX's `make_stage2_step`): response KD from the
    frozen stage-1 teacher, a `PoseEstimatorVanilla` in eval mode without a
    gradient, in its own dtype, with `view_tile=3` (each cloud once through
    the eval PointNet for its three views); the student in train mode over
    the three views; 0.25 * the pose loss + 0.75 * the six heads' KL at
    `temperature` (`kd_loss`), the losses in f32; one Adam update and one
    schedule step. The batch, `keep` and the returned metrics are
    `make_kd_crd_step`'s: step(state, teacher, batch, keep=None) ->
    {'loss', 'gt_loss', 'acc_rot'}, no host sync. With `int8_teacher` the
    teacher's ResNet-18 runs int8
    (`serving.quant_teacher.make_vanilla_int8_kd_fwd`, PointCloud only) and
    the step's `teacher` is {"model": the teacher, "q8": its quantized
    tree}. `device_views` and `shape_bank` as `make_kd_crd_step`'s; the
    device photometrics run with `device_views` only (JAX's stage-2 step
    takes no `device_augment`)."""
    return _views_step(bin_size, temperature, "stage2", int8_teacher, augment=device_views,
                       device_views=device_views, shape_bank=shape_bank)


def make_stage1_step(bin_size: int = 15, tau: float = 0.5, nce_weight: float = 0.75,
                     use_fused_nce: bool = False, use_memory_bank: bool = False,
                     nce_variant: str = "info", nce_weighting: str = "linear",
                     shape_bank=None) -> Callable:
    """KD `--stage 1` (JAX's `make_stage1_step`): the vanilla teacher
    (`PoseEstimatorVanilla`) and the student both in train mode with
    `mask=valid`; the teacher's 4-term pose loss plus nce_weight * (0.5
    NCE(s -> t) + 0.5 NCE(t -> s)) at `tau`; one Adam update and one
    schedule step for each model. The symmetric NCE, by `nce_variant`:
      * "info": the infoNCE-KD with key dropout 0.3, each direction through
        `route_info_nce` (the NCE kernels with `use_fused_nce`); with
        `use_memory_bank`, `info_nce_memory` instead (the same dropout,
        the queue's entries as extra negatives; `use_fused_nce` is
        ignored, as in JAX), and the teacher's features are enqueued, only
        the valid rows, after the step;
      * "pose" / "multipose": `pose_nce_kd` under `nce_weighting` /
        `multi_pose_nce_kd` on the batch's labels, without dropout.
    `shape_bank`: the device-resident bank, bound here; the batch carries
    its reference keys in place of 'shape'.

    Returns step(teacher_state, student_state, batch, keep=None,
    student_keep=None[, bank]) -> {'loss', 'teacher_loss', 'acc_rot'}
    (0-d tensors on the models' device, no host sync; acc_rot is the
    teacher's) or, with the memory bank, (metrics, the advanced bank).
    `batch` holds 'im' (N, H, W, 3) float32 or uint8 (the u8 wire),
    'shape' (N, P, 3), 'label' (N, 3) and, for a padded batch, 'valid'
    (N,) bool. Each model takes the images in its own dtype. The two NCE
    keep-masks (`keep`, two (N, 200) bool) and the student's classifier
    dropout masks (`student_keep`, as `BaselineEstimator.forward` takes
    them) are drawn from `student_state.generator` unless given, as a test
    does to hand JAX's masks in.
    """
    if nce_variant not in NCE_VARIANTS:
        raise ValueError(f"unknown nce_variant: {nce_variant!r}")
    if use_memory_bank and nce_variant != "info":
        raise ValueError("pose-weighted NCE has no memory-bank form "
                         "(the queue holds no pose labels)")

    def step(teacher_state: TrainState, student_state: TrainState, batch: dict,
             keep=None, student_keep=None, bank=None):
        teacher, student = teacher_state.model, student_state.model
        teacher.train()
        student.train()
        valid = batch.get("valid")
        im = dewire(batch["im"])
        s_dtype, t_dtype = input_dtype(student), input_dtype(teacher)
        s_out, s_feat = student(im.to(s_dtype), mask=valid, generator=student_state.generator,
                                keep=student_keep)
        t_out, t_feat = teacher(im.to(t_dtype), shape_of(batch, shape_bank).to(t_dtype),
                                mask=valid)
        # the losses in float32 whatever the models' dtypes, as JAX's step
        t_out = [o.float() for o in t_out]
        s_feat, t_feat = s_feat.float(), t_feat.float()
        teacher_loss = pose_loss(t_out, batch["label"], bin_size, valid=valid)
        if nce_variant != "info":
            nce_s2t, nce_t2s = (_pose_variant_nce(nce_variant, q, k, batch["label"], tau,
                                                  nce_weighting, valid)
                                for q, k in ((s_feat, t_feat), (t_feat, s_feat)))
        else:
            if keep is None:
                keep = [torch.rand(t_feat.shape, generator=student_state.generator,
                                   device=t_feat.device) < 1.0 - NCE_DROPOUT
                        for _ in range(2)]
            if use_memory_bank:
                nce_s2t = info_nce_memory(s_feat, t_feat, bank, tau, valid=valid,
                                          keep=keep[0], dropout_rate=NCE_DROPOUT)
                nce_t2s = info_nce_memory(t_feat, s_feat, bank, tau, valid=valid,
                                          keep=keep[1], dropout_rate=NCE_DROPOUT)
            else:
                nce_s2t = route_info_nce(s_feat, t_feat, tau, keep[0], NCE_DROPOUT, valid,
                                         use_fused_nce)
                nce_t2s = route_info_nce(t_feat, s_feat, tau, keep[1], NCE_DROPOUT, valid,
                                         use_fused_nce)
        loss = teacher_loss + nce_weight * (0.5 * nce_s2t + 0.5 * nce_t2s)
        for state in (teacher_state, student_state):
            state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # the student's heads take no part in the loss: `_update` hands
        # them a zero gradient, so that Adam updates them as JAX's does
        _update(teacher_state)
        _update(student_state)
        metrics = {"loss": loss.detach(), "teacher_loss": teacher_loss.detach(),
                   "acc_rot": _acc(t_out, batch["label"], bin_size, valid)}
        if use_memory_bank:
            return metrics, enqueue(bank, t_feat, valid)
        return metrics

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


def make_eval_step(model, kind: str, bin_size: int = 15, shape_bank=None) -> Callable:
    """Returns step(batch) -> {'pred': (N, 3), 'loss': scalar,
    'per_sample_loss': (N,)} and, for the teacher, 'per_sample_nce': (N,);
    tensors on the model's device.

    `batch` holds 'im' (N, H, W, 3) float32 and 'label' (N, 3) integer
    tensors on the model's device; the teacher and the vanilla teacher
    (`PoseEstimatorVanilla`, kind "vanilla") also take 'shape' (N, P, 3)
    float32 and, optionally, 'valid' (N,) bool, which keeps padded rows out
    of the teacher's NCE keys. The inputs go to the model in its compute
    dtype (`input_dtype`), its outputs back to float32 for the losses and the
    decoder. The model runs in eval mode (BatchNorm running
    statistics, no dropout) and the train/val decoder
    (bin + tanh(d)/2 + 0.5) * bin_size decodes the predictions. The
    teacher's NCE drops out its keys with `fixed_keep_mask`. With
    `shape_bank` (bound here; `testing --device_shapes`) the batch carries
    the bank's reference keys in place of 'shape'.
    """
    if kind not in ("student", "teacher", "vanilla"):
        raise NotImplementedError(f"eval step kind {kind!r} is not ported yet; "
                                  "see ROADMAP.md Queue 1")
    dtype = input_dtype(model)

    @torch.no_grad()
    def step(batch: dict) -> dict:
        model.eval()
        im = batch["im"].to(dtype)
        if kind == "student":
            outputs, _ = model(im)
        elif kind == "vanilla":
            outputs, _ = model(im, shape_of(batch, shape_bank).to(dtype))
        else:
            outputs, fused, img_proj = model(im, shape_of(batch, shape_bank).to(dtype))
            fused, img_proj = fused.float(), img_proj.float()
        # the decoders and the losses in float32 whatever the model's dtype
        outputs = [o.float() for o in outputs]
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
