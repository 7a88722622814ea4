"""Shared CLI plumbing. Port of `pose3d_tpu/cli/common.py`: the flags of the
evaluation and serving CLIs, the device, the construction of the student,
of the PointCloud teacher and of the vanilla teacher, and the training
datasets (the teacher's and the KD regimes') and loader.

Flags of the JAX CLIs whose paths are not ported yet are still accepted
where a user would pass them, and refused with a message that names
ROADMAP.md, so that no flag is silently ignored.
"""

from __future__ import annotations

import argparse
import os

import torch

from pose3d_tpu_torch.data import annotations, datasets
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.train.convert import read_state_dict

MANUAL_SEED = 46  # the reference's fixed seed
TEST_CATS = {"ObjectNet3D": annotations.OBJECTNET3D_TEST_CATS,
             "Pascal3D": annotations.PASCAL3D_TEST_CATS}


def add_student_flags(parser: argparse.ArgumentParser, img_feature_dim: int) -> None:
    parser.add_argument("--img_feature_dim", type=int, default=img_feature_dim)
    parser.add_argument("--bin_size", type=int, default=15)
    parser.add_argument("--input_dim", type=int, default=224)
    parser.add_argument("--student_width_mult", type=float, default=1.0,
                        help="VGG conv width multiplier of the student (the "
                             "JAX KD CLI's --student_width_mult)")
    parser.add_argument("--bf16", action="store_true",
                        help="not ported yet: refused (ROADMAP.md Queue 1)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda). On a CUDA device the "
                             "geodesic error and the PointNet encoder run in their "
                             "CUDA kernels; on cpu the plain PyTorch versions "
                             "run. TF32 is turned off for "
                             "convolutions and matmuls, matching the JAX "
                             "package's float32 semantics.")


def refuse_unported(opt, flags: tuple[str, ...]) -> None:
    """Exit with a message for each set flag whose path is not ported."""
    for flag in flags:
        if getattr(opt, flag, None):
            raise SystemExit(f"--{flag} is not ported to pose3d_tpu_torch yet; "
                             "see ROADMAP.md Queue 1")


def setup_device(opt) -> torch.device:
    """The device of --device, with TF32 off. A CUDA device that is not there
    is an error: nothing moves to the CPU unasked."""
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {opt.device}: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def num_classes(bin_size: int) -> tuple[int, int, int]:
    return int(360 / bin_size), int(180 / bin_size), int(360 / bin_size)


def build_student(opt, checkpoint: str | None, device: torch.device,
                  img_feature_dim: int | None = None) -> BaselineEstimator:
    """The student of the flags, with weights from `checkpoint` (a
    reference-layout .pth, loaded strictly) or, without one, a seeded
    random init. In eval mode, on `device`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = BaselineEstimator(
        img_feature_dim=img_feature_dim or opt.img_feature_dim, azi_classes=azi,
        ele_classes=ele, inp_classes=inp, bin_size=opt.bin_size,
        width_mult=opt.student_width_mult,
        input_dim=opt.input_dim, generator=torch.Generator().manual_seed(0))
    return _loaded(model, checkpoint, device)


def build_teacher(opt, checkpoint: str | None, device: torch.device,
                  img_feature_dim: int | None = None) -> PoseEstimator:
    """The PointCloud teacher of the flags, with weights from `checkpoint`
    (a reference-layout .pth, loaded strictly) or, without one, a seeded
    random init. In eval mode, on `device`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = PoseEstimator(
        img_feature_dim=img_feature_dim or opt.img_feature_dim,
        shape_feature_dim=opt.shape_feature_dim, azi_classes=azi, ele_classes=ele,
        inp_classes=inp, bin_size=opt.bin_size,
        generator=torch.Generator().manual_seed(0))
    return _loaded(model, checkpoint, device)


def build_vanilla(opt, device: torch.device,
                  checkpoint: str | None = None) -> PoseEstimatorVanilla:
    """The vanilla PointCloud teacher of the flags (ResNet-18, PointNet,
    compress MLP) on `device`. Without `checkpoint`, from a seeded random
    init in train mode: KD `--stage 1` trains it from scratch, as JAX's CLI
    does. With one (KD `--stage 2`'s frozen teacher), loaded strictly and
    in eval mode: the "teacher" train state of the port's stage-1
    `checkpoint.pth`, or a reference-layout vanilla `.pth`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = PoseEstimatorVanilla(
        img_feature_dim=opt.img_feature_dim, shape_feature_dim=opt.shape_feature_dim,
        azi_classes=azi, ele_classes=ele, inp_classes=inp, bin_size=opt.bin_size,
        generator=torch.Generator().manual_seed(1))
    if checkpoint is None:
        return model.to(device)
    return _loaded(model, checkpoint, device, role="teacher")


def _loaded(model, checkpoint: str | None, device: torch.device, role: str | None = None):
    if checkpoint:
        if os.path.isdir(checkpoint):
            raise SystemExit(f"{checkpoint}: a checkpoint directory (the JAX package's "
                             "orbax format) is not read by pose3d_tpu_torch; see "
                             "ROADMAP.md Queue 1. Pass a .pth: a reference-layout "
                             "state_dict or the port's own checkpoint.pth")
        model.load_state_dict(read_state_dict(checkpoint, role), strict=True)
    else:
        print("WARNING: no checkpoint given; the model keeps its seeded random init")
    return model.to(device).eval()


def make_train_loader(dataset, opt, seed: int = MANUAL_SEED) -> DataLoader:
    """The shuffled train loader. The ragged tail is dropped unless the set
    is smaller than one batch (then its one batch is padded and masked)."""
    return DataLoader(dataset, opt.batch_size, shuffle=True,
                      drop_last=len(dataset) > opt.batch_size, num_workers=opt.workers,
                      seed=seed)


def build_train_eval_datasets(opt):
    """The train set and the validation (val_new) set of --dataset, as the
    JAX CLI builds them: ObjectNet3D trains on the contrastive three-view
    samples and validates on Pascal3D-style samples of the test categories;
    Pascal3D trains and validates on Pascal3D samples."""
    root_dir = os.path.join(opt.data_root, opt.dataset)
    annotation_file = f"{opt.dataset}.txt"
    shape = dict(shape=opt.shape, shape_dir=opt.shape_dir, input_dim=opt.input_dim,
                 point_num=opt.point_num)
    if opt.dataset == "ObjectNet3D":
        cats = annotations.OBJECTNET3D_TEST_CATS
        train = datasets.Pascal3DContrast(
            root_dir, annotation_file, train=True, cat_choice=cats, keypoint=opt.keypoint,
            novel=opt.novel, shot=opt.shot, seed=MANUAL_SEED, **shape)
        val = datasets.Pascal3D(root_dir, annotation_file, train=False, cat_choice=cats,
                                keypoint=opt.keypoint, novel=opt.novel, random=False, **shape)
    elif opt.dataset == "Pascal3D":
        cats = ["bus", "motorbike"] if opt.novel else None
        train = datasets.Pascal3D(root_dir, annotation_file, train=True, cat_choice=cats,
                                  novel=opt.novel, random=opt.random,
                                  random_range=opt.random_range, **shape)
        val = datasets.Pascal3D(root_dir, annotation_file, train=False, cat_choice=cats,
                                novel=opt.novel, random=False, **shape)
    else:
        raise SystemExit(f"--dataset {opt.dataset}: training on it is not ported to "
                         "pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
    return train, val


def build_kd_datasets(opt):
    """The KD regimes' train and validation sets, as the JAX CLI builds
    them. `--crd`, `--contrast`, `--vid` and `--stage 2`: Pascal3DContrast
    (three views a sample, with its cloud) on ObjectNet3D's test categories
    or on Pascal3D's; the validation set evaluates the RGB-only student, so
    it loads no clouds (JAX loads and ignores them). `--stage 1`: plain Pascal3D samples with their clouds,
    train (with `--random` / `--random_range`) and validation, since the
    vanilla teacher is what stage 1 evaluates."""
    root_dir = os.path.join(opt.data_root, opt.dataset)
    annotation_file = f"{opt.dataset}.txt"
    if opt.dataset == "ObjectNet3D":
        cats, extra = annotations.OBJECTNET3D_TEST_CATS, dict(keypoint=opt.keypoint)
    elif opt.dataset == "Pascal3D":
        cats, extra = (["bus", "motorbike"] if opt.novel else None), {}
    else:
        raise SystemExit(f"--dataset {opt.dataset}: KD training on it is not ported to "
                         "pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
    if opt.stage == 1:
        shape = dict(shape=opt.shape, shape_dir=opt.shape_dir, input_dim=opt.input_dim,
                     point_num=opt.point_num, cat_choice=cats, novel=opt.novel, **extra)
        return (datasets.Pascal3D(root_dir, annotation_file, train=True, random=opt.random,
                                  random_range=opt.random_range, **shape),
                datasets.Pascal3D(root_dir, annotation_file, train=False, random=False,
                                  **shape))
    train = datasets.Pascal3DContrast(
        root_dir, annotation_file, train=True, cat_choice=cats, novel=opt.novel,
        shot=opt.shot if opt.dataset == "ObjectNet3D" else None, seed=MANUAL_SEED,
        shape=opt.shape, shape_dir=opt.shape_dir, input_dim=opt.input_dim,
        point_num=opt.point_num, **extra)
    val = datasets.Pascal3DContrast(root_dir, annotation_file, train=False, cat_choice=cats,
                                    novel=opt.novel, shape=None, input_dim=opt.input_dim,
                                    **extra)
    return train, val
