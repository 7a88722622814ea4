"""Shared CLI plumbing. Port of `pose3d_tpu/cli/common.py`: the flags of the
evaluation and serving CLIs, the device, the construction of the student,
of the teacher and of the vanilla teacher (each with a PointCloud or a
MultiView shape encoder), and the training datasets (the teacher's and the
KD regimes') and loader.

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
from pose3d_tpu_torch.ops.shape_bank import RenderBank, ShapeBank
from pose3d_tpu_torch.train.convert import read_state_dict

MANUAL_SEED = 46  # the reference's fixed seed
BF16_HELP = ("bfloat16 compute with float32 parameters, optimizer state and "
             "checkpoints (flax's dtype): each layer casts its input and weights to "
             "bf16, BatchNorm statistics and the losses stay float32; the VGG stem "
             "and the eval and train-mode PointNets run in their bf16 kernels on the "
             "card. Serving, evaluation, the teacher's training, KD --crd / "
             "--contrast / --vid / --stage 1 / --stage 2 and the RGB-only baseline "
             "take it")
DEVICE_HELP = ("torch device (default cuda). On a CUDA device the geodesic error, the "
               "VGG stem and the PointNet encoders run in their CUDA kernels; on cpu the "
               "plain PyTorch versions run, and only when asked for. TF32 is turned off "
               "for convolutions and matmuls, and cuBLAS's reduced-precision bf16 "
               "reductions too, matching the JAX package's float32 and bfloat16 "
               "semantics.")
DEVICE_SHAPES_HELP = ("keep every CAD model's shape on the device (ops/shape_bank.py): "
                      "PointCloud clouds in a ShapeBank, sampled in the step from a "
                      "per-sample seed; MultiView renders in a u8 RenderBank, whose "
                      "views the step gathers. The loader then sends a few scalars a "
                      "sample in place of the cloud or the renders")
DEVICE_AUGMENT_HELP = ("run the photometric augmentation and the normalisation in the "
                       "step (ops/augment.py): the loader sends the views' raw pixels as "
                       "uint8")
TEST_CATS = {"ObjectNet3D": annotations.OBJECTNET3D_TEST_CATS,
             "Pascal3D": annotations.PASCAL3D_TEST_CATS,
             "Pix3D": annotations.PIX3D_TEST_CATS,
             "LineMod": annotations.LINEMOD_TEST_CATS}
# JAX's ShapeNetCore cat_choice: the categories --novel leaves out of training
SHAPENET_CATS = ["2818832", "2871439", "2933112", "3001627", "4256520", "4379243"]
# JAX's ShapeNetCore runs validate on Pix3D, whose samples carry no shape:
# its teacher evaluation fails there on the missing 'shape'
SHAPENET_TEACHER = ("--dataset ShapeNetCore validates on Pix3D, whose samples carry no "
                    "shape, so a teacher cannot be evaluated on it (JAX's run fails at its "
                    "first evaluation)")


def add_shape_flags(parser: argparse.ArgumentParser) -> None:
    """The MultiView teacher's render ring: views a sample and rings."""
    parser.add_argument("--view_num", type=int, default=12,
                        help="MultiView: renders a sample (view_num / tour per ring)")
    parser.add_argument("--tour", type=int, default=2,
                        help="MultiView: elevation rings (1 the middle one, 2 the lower "
                             "two, 3 all three)")


def add_student_flags(parser: argparse.ArgumentParser, img_feature_dim: int) -> None:
    parser.add_argument("--img_feature_dim", type=int, default=img_feature_dim)
    parser.add_argument("--bin_size", type=int, default=15)
    parser.add_argument("--input_dim", type=int, default=224)
    parser.add_argument("--student_width_mult", type=float, default=1.0,
                        help="VGG conv width multiplier of the student (the "
                             "JAX KD CLI's --student_width_mult)")
    parser.add_argument("--bf16", action="store_true", help=BF16_HELP)
    parser.add_argument("--device", type=str, default="cuda", help=DEVICE_HELP)


def refuse_unported(opt, flags: tuple[str, ...]) -> None:
    """Exit with a message for each set flag whose path is not ported."""
    for flag in flags:
        if getattr(opt, flag, None):
            raise SystemExit(f"--{flag} is not ported to pose3d_tpu_torch yet; "
                             "see ROADMAP.md Queue 1")


def setup_device(opt) -> torch.device:
    """The device of --device, with TF32 off and bf16 GEMMs reduced in
    float32 (cuBLAS may otherwise reduce them in bf16; flax accumulates in
    float32). A CUDA device that is not there is an error: nothing moves to
    the CPU unasked."""
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {opt.device}: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def compute_dtype(opt) -> torch.dtype | None:
    """The models' compute dtype: bfloat16 under --bf16, else None (the
    parameters' float32), as JAX's `compute_dtype` reads the flag."""
    return torch.bfloat16 if getattr(opt, "bf16", False) else None


def num_classes(bin_size: int) -> tuple[int, int, int]:
    return int(360 / bin_size), int(180 / bin_size), int(360 / bin_size)


def build_student(opt, checkpoint: str | None, device: torch.device,
                  img_feature_dim: int | None = None) -> BaselineEstimator:
    """The student of the flags, with weights from `checkpoint` (a
    reference-layout .pth, loaded strictly) or, without one, a seeded
    random init; its compute dtype from --bf16. In eval mode, on `device`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = BaselineEstimator(
        img_feature_dim=img_feature_dim or opt.img_feature_dim, azi_classes=azi,
        ele_classes=ele, inp_classes=inp, bin_size=opt.bin_size,
        width_mult=opt.student_width_mult,
        input_dim=opt.input_dim, generator=torch.Generator().manual_seed(0),
        compute_dtype=compute_dtype(opt))
    return _loaded(model, checkpoint, device)


def build_teacher(opt, checkpoint: str | None, device: torch.device,
                  img_feature_dim: int | None = None) -> PoseEstimator:
    """The teacher of the flags (--shape PointCloud or MultiView), with
    weights from `checkpoint` (a reference-layout .pth, loaded strictly) or,
    without one, a seeded random init. In eval mode, on `device`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = PoseEstimator(
        shape=opt.shape, view_num=opt.view_num,
        img_feature_dim=img_feature_dim or opt.img_feature_dim,
        shape_feature_dim=opt.shape_feature_dim, azi_classes=azi, ele_classes=ele,
        inp_classes=inp, bin_size=opt.bin_size,
        generator=torch.Generator().manual_seed(0), compute_dtype=compute_dtype(opt))
    return _loaded(model, checkpoint, device)


def build_vanilla(opt, device: torch.device,
                  checkpoint: str | None = None) -> PoseEstimatorVanilla:
    """The vanilla teacher of the flags (ResNet-18, the shape encoder of
    --shape, compress MLP) on `device`. Without `checkpoint`, from a seeded
    random init in train mode: KD `--stage 1` trains it from scratch, as
    JAX's CLI does. With one (KD `--stage 2`'s frozen teacher), loaded strictly and
    in eval mode: the "teacher" train state of the port's stage-1
    `checkpoint.pth`, or a reference-layout vanilla `.pth`."""
    azi, ele, inp = num_classes(opt.bin_size)
    model = PoseEstimatorVanilla(
        shape=opt.shape, view_num=opt.view_num,
        img_feature_dim=opt.img_feature_dim, shape_feature_dim=opt.shape_feature_dim,
        azi_classes=azi, ele_classes=ele, inp_classes=inp, bin_size=opt.bin_size,
        generator=torch.Generator().manual_seed(1), compute_dtype=compute_dtype(opt))
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


def maybe_shape_bank(opt, dataset, device: torch.device) -> ShapeBank | RenderBank | None:
    """--device_shapes (JAX's `maybe_shape_bank`): the device-resident bank
    of `dataset`'s CAD models on `device` (a ShapeBank of clouds, or a
    RenderBank of renders for MultiView), with `dataset` switched to emit
    the bank's scalar references; None without the flag. JAX's refusals,
    with its messages."""
    if not getattr(opt, "device_shapes", False):
        return None
    if opt.shape not in ("PointCloud", "MultiView"):
        raise SystemExit("--device_shapes requires --shape PointCloud or MultiView")
    if not hasattr(dataset, "device_shapes"):
        raise SystemExit("--device_shapes: this dataset has no shape-bank support")
    dataset.device_shapes = True
    if opt.shape == "MultiView":
        renders, id_table = dataset.build_render_bank()
        print(f"render bank: {renders.shape[0]} models x {renders.shape[1]} renders @ "
              f"{renders.shape[2]}px ({renders.nbytes / (1 << 20):.1f} MB u8 device-resident)")
        return RenderBank.from_arrays(renders, id_table, device)
    verts, counts = dataset.build_shape_bank()
    print(f"shape bank: {verts.shape[0]} clouds x {verts.shape[1]} verts "
          f"({verts.nbytes / (1 << 20):.1f} MB device-resident)")
    return ShapeBank.from_arrays(verts, counts, opt.point_num, device)


def make_train_loader(dataset, opt, seed: int = MANUAL_SEED) -> DataLoader:
    """The shuffled train loader. The ragged tail is dropped unless the set
    is smaller than one batch (then its one batch is padded and masked)."""
    return DataLoader(dataset, opt.batch_size, shuffle=True,
                      drop_last=len(dataset) > opt.batch_size, num_workers=opt.workers,
                      seed=seed)


def _shape_kwargs(opt) -> dict:
    return dict(shape=opt.shape, shape_dir=opt.shape_dir, input_dim=opt.input_dim,
                point_num=opt.point_num, view_num=opt.view_num, tour=opt.tour)


def build_train_eval_datasets(opt):
    """The train set and the validation (val_new) set of --dataset, as the
    JAX CLI builds them: ObjectNet3D trains on the contrastive three-view
    samples and validates on Pascal3D-style samples of the test categories;
    Pascal3D trains and validates on Pascal3D samples; ShapeNetCore trains
    on its renders over SUN backgrounds (`<data_root>/SUN`) and validates on
    Pix3D (`<data_root>/Pix3D`)."""
    root_dir = os.path.join(opt.data_root, opt.dataset)
    annotation_file = f"{opt.dataset}.txt"
    shape = _shape_kwargs(opt)
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
    elif opt.dataset == "ShapeNetCore":
        train = datasets.ShapeNet(
            root_dir, annotation_file, bg_dir=os.path.join(opt.data_root, "SUN"), train=True,
            random=opt.random, cat_choice=SHAPENET_CATS, novel=opt.novel, shape=opt.shape,
            shape_dir=opt.shape_dir, view_num=opt.view_num, tour=opt.tour,
            random_range=opt.random_range)
        val = datasets.Pix3D(os.path.join(opt.data_root, "Pix3D"), "Pix3D.txt")
    else:
        raise SystemExit(f"unsupported training dataset {opt.dataset}")  # JAX's
    return train, val


def build_kd_datasets(opt, val_shapes: bool = False):
    """The KD regimes' train and validation sets, as the JAX CLI builds
    them. `--crd`, `--contrast`, `--vid` and `--stage 2`: Pascal3DContrast
    (three views a sample, with its cloud) on ObjectNet3D's test categories
    or on Pascal3D's; the validation set evaluates the RGB-only student, so
    it loads no shapes (JAX loads and ignores them) unless `val_shapes`
    asks for them (the MultiView `--int8_teacher` calibrates its render
    encoder on the first validation batch's renders). `--stage 1`: plain
    Pascal3D samples with their clouds or renders,
    train (with `--random` / `--random_range`) and validation, since the
    vanilla teacher is what stage 1 evaluates."""
    root_dir = os.path.join(opt.data_root, opt.dataset)
    annotation_file = f"{opt.dataset}.txt"
    if opt.dataset == "ObjectNet3D":
        cats, extra = annotations.OBJECTNET3D_TEST_CATS, dict(keypoint=opt.keypoint)
    elif opt.dataset == "Pascal3D":
        cats, extra = (["bus", "motorbike"] if opt.novel else None), {}
    else:
        raise SystemExit(f"unsupported KD training dataset {opt.dataset}")  # JAX's
    if opt.stage == 1:
        shape = dict(_shape_kwargs(opt), cat_choice=cats, novel=opt.novel, **extra)
        return (datasets.Pascal3D(root_dir, annotation_file, train=True, random=opt.random,
                                  random_range=opt.random_range, **shape),
                datasets.Pascal3D(root_dir, annotation_file, train=False, random=False,
                                  **shape))
    train = datasets.Pascal3DContrast(
        root_dir, annotation_file, train=True, cat_choice=cats, novel=opt.novel,
        shot=opt.shot if opt.dataset == "ObjectNet3D" else None, seed=MANUAL_SEED,
        **_shape_kwargs(opt), **extra)
    val_shape = _shape_kwargs(opt) if val_shapes else dict(shape=None, input_dim=opt.input_dim)
    val = datasets.Pascal3DContrast(root_dir, annotation_file, train=False, cat_choice=cats,
                                    novel=opt.novel, **val_shape, **extra)
    return train, val
