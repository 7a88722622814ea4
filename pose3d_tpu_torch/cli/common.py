"""Shared CLI plumbing. Port of `pose3d_tpu/cli/common.py`: the flags of the
evaluation and serving CLIs, the device, and the construction of the
student and of the PointCloud teacher.

Flags of the JAX CLIs whose paths are not ported yet are still accepted
where a user would pass them, and refused with a message that names
ROADMAP.md, so that no flag is silently ignored.
"""

from __future__ import annotations

import argparse

import torch

from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
from pose3d_tpu_torch.train.convert import read_state_dict


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


def build_student(opt, checkpoint: str | None,
                  device: torch.device) -> BaselineEstimator:
    """The student of the flags, with weights from `checkpoint` (a
    reference-layout .pth, loaded strictly) or, without one, a seeded
    random init. In eval mode, on `device`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = BaselineEstimator(
        img_feature_dim=opt.img_feature_dim, azi_classes=azi, ele_classes=ele,
        inp_classes=inp, bin_size=opt.bin_size, width_mult=opt.student_width_mult,
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


def _loaded(model, checkpoint: str | None, device: torch.device):
    if checkpoint:
        model.load_state_dict(read_state_dict(checkpoint), strict=True)
    else:
        print("WARNING: no checkpoint given; evaluating random init")
    return model.to(device).eval()
