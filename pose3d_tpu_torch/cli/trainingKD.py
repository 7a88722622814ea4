"""Student KD training CLI. Port of `pose3d_tpu/cli/trainingKD.py`, on
ObjectNet3D or Pascal3D, with a PointCloud or a MultiView teacher
(`--shape`; a MultiView teacher sees `--view_num` renders a sample, over
`--tour` rings):
  * `--crd`: the RGB-only student (VGG-11) distilled from a frozen
    teacher, with the stem's CUDA kernel (`csrc/vgg_stem.cu`) in every step
    and a PointCloud teacher's PointNet kernel in its forward on the card;
    `--contrast` drops the features' KL (30 epochs), `--vid` takes the VID
    loss instead (60);
  * `--stage 1`: the vanilla teacher (ResNet-18, the shape encoder,
    compress MLP) and the student trained together from scratch, with the
    teacher's pose loss and the symmetric infoNCE-KD at `--tau` (its two
    directions in the NCE kernels with `--fused_nce`), a PointCloud
    teacher's train-mode PointNet kernel (`csrc/pointnet_train.cu`) in
    every step; with
    `--use_memory_bank` a queue of `--memory_bank_size` past teacher
    features joins the negatives, and `--nce pose` (weighted by
    `--weighting`) or `--nce multipose` replaces the infoNCE;
  * `--stage 2`: the student distilled (response KD) from stage 1's frozen
    vanilla teacher, read from `--teacher_model`: the port's stage-1
    `checkpoint.pth` or a reference-layout vanilla `.pth`.

    python -m pose3d_tpu_torch.cli.trainingKD --crd --dataset ObjectNet3D \\
        --shape PointCloud --shape_dir pointcloud --batch_size 46 \\
        --teacher_model result/PointCloud_ObjectNet3D/ckpt/checkpoint.pth
    python -m pose3d_tpu_torch.cli.trainingKD --crd --dataset ObjectNet3D \\
        --shape MultiView --shape_dir Renders_semi_sphere --batch_size 46 \\
        --shape_feature_dim 256 \\
        --teacher_model result/MultiView_ObjectNet3D/ckpt/checkpoint.pth
    python -m pose3d_tpu_torch.cli.trainingKD --stage 1 --fused_nce \\
        --dataset ObjectNet3D --shape PointCloud --shape_dir pointcloud \\
        --batch_size 46 --shape_feature_dim 256
    python -m pose3d_tpu_torch.cli.trainingKD --stage 2 --dataset ObjectNet3D \\
        --shape PointCloud --shape_dir pointcloud --batch_size 46 \\
        --shape_feature_dim 256 \\
        --teacher_model result/KD_ObjectNet3D/ckpt/checkpoint.pth

Runs on the card (`--device cuda`, the default); `--device cpu` runs the
plain versions. `--crd` runs 60 epochs, `--contrast` 30, `--stage 1` 300
and `--stage 2` 90 (`--n_epoch` overrides), lr 1e-4 times 0.1 after
`--decrease` epochs, counted in optimizer steps as JAX does.
`--teacher_model` (--crd) reads a reference-layout .pth or the port's own
teacher `checkpoint.pth`; `--student_model` warm-starts the student from
either kind. Writes, under <result_dir>/KD_<dataset>/, training_log.txt (a
"Student Epoch" line per epoch), config.json, metrics.jsonl and ckpt/
(checkpoint.pth, best.pth, EPOCH; the student regimes' checkpoint.pth is
what the testing CLI's `--model` reads, --stage 1's holds both train states
under "teacher" and "student", and the memory bank under "bank");
`--resume` continues from the last saved epoch; `--export_torch` writes
the final student as a reference-layout .pth. `--int8_teacher` (--crd,
--contrast, --vid, --stage 2) runs the frozen teacher's ResNets int8
(`pose3d_tpu_torch.serving`, the int8 kernel on the card), calibrated on
the first evaluation batch; it is refused with --stage 1 and with a
MultiView --stage 2 teacher, as JAX refuses them. The on-device data
options: `--device_shapes` (every regime: the teacher's clouds or renders
in a device-resident bank, resolved in the step from a few scalars a
sample), `--device_augment` (--crd, --contrast, --vid: the loader sends
raw uint8 views, augmented and normalised in the step) and
`--device_views` (--crd's regimes and --stage 2: the loader sends one raw
view a sample, and the step builds the flipped and rotated views and
augments all three).
The flags of paths not ported yet are refused with a message that names
ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from pose3d_tpu_torch import serving
from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.trainer import KDTrainer
from pose3d_tpu_torch.utils.logging import TxtLogger

EPOCHS = {"contrast": 30, "crd": 60, "stage1": 300, "stage2": 90}  # the reference's regimes


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--loader", type=str, default="thread", choices=["thread", "shm"],
                        help="shm: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--model", type=str, default=None,
                        help="not read by the KD CLI: refused (use --student_model "
                             "or --resume)")
    # the teacher, 1024/1024 as the reference hard-codes it
    parser.add_argument("--img_feature_dim", type=int, default=1024)
    parser.add_argument("--shape_feature_dim", type=int, default=1024)
    parser.add_argument("--bin_size", type=int, default=15)
    parser.add_argument("--dataset", type=str, default=None,
                        choices=["ObjectNet3D", "Pascal3D", "ShapeNetCore", "Pix3D",
                                 "LineMod"])
    parser.add_argument("--data_root", type=str, default="data",
                        help="root containing <dataset>/ trees")
    parser.add_argument("--shape_dir", type=str, default="Renders_semi_sphere",
                        choices=["Renders_semi_sphere", "pointcloud"])
    parser.add_argument("--shape", type=str, default="MultiView",
                        choices=["MultiView", "PointCloud", "None"],
                        help="the teacher's shape encoder: PointCloud (a PointNet over "
                             "the object's cloud) or MultiView (a ResNet-18 over its renders)")
    common.add_shape_flags(parser)
    parser.add_argument("--novel", action="store_true")
    parser.add_argument("--keypoint", action="store_true")
    parser.add_argument("--shot", type=int, default=None)
    parser.add_argument("--random", action="store_true",
                        help="--stage 1's azimuth augmentation of the train set")
    parser.add_argument("--random_range", type=int, default=0,
                        help="--stage 1's azimuth range of --random")
    parser.add_argument("--input_dim", type=int, default=224)
    parser.add_argument("--point_num", type=int, default=2500)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--decrease", type=int, default=44,
                        help="epoch at which the learning rate drops tenfold")
    parser.add_argument("--teacher_model", type=str, default=None,
                        help="the frozen teacher: --crd's (--contrast, --vid) a "
                             "reference-layout .pth or the port's teacher checkpoint.pth; "
                             "--stage 2's a reference-layout vanilla .pth or the port's "
                             "stage-1 checkpoint.pth (--stage 1 trains its own)")
    parser.add_argument("--student_model", type=str, default=None,
                        help="optional student warm start (.pth, loaded strictly)")
    parser.add_argument("--crd", action="store_true",
                        help="the feature-KD regime (the default when no other is set)")
    parser.add_argument("--stage", type=int, default=0,
                        help="1: the vanilla teacher and the student trained together; "
                             "2: the student distilled from stage 1's frozen teacher")
    parser.add_argument("--contrast", action="store_true",
                        help="--crd without the features' KL term, 30 epochs (the "
                             "reference dispatches this flag to a method that does not "
                             "exist; JAX's reading of it)")
    parser.add_argument("--vid", action="store_true",
                        help="--crd with the VID loss: 0.6 CE + 0.2 KL + 0.2 VID")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--weighting", type=str, default=None,
                        choices=["linear", "square", "sqrt", "sin", "sinsin"],
                        help="consumed only by --stage 1 --nce pose; elsewhere it is "
                             "ignored with a warning, as in the JAX CLI")
    parser.add_argument("--n_epoch", type=int, default=None,
                        help=f"override the regime's epochs ({EPOCHS})")
    parser.add_argument("--student_feature_dim", type=int, default=2048)
    parser.add_argument("--student_width_mult", type=float, default=1.0,
                        help="VGG conv width multiplier of the student")
    parser.add_argument("--result_dir", type=str, default="result")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint (--stage 1: both "
                             "models and the memory bank)")
    parser.add_argument("--export_torch", type=str, default=None,
                        help="also write the final student as a reference-layout .pth here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda); cpu runs the plain "
                             "versions and must be asked for")
    parser.add_argument("--int8_teacher", action="store_true",
                        help="--crd / --contrast / --vid / --stage 2: run the frozen teacher's "
                             "conv trunks (the ResNet-50, and a MultiView teacher's per-view "
                             "ResNet-18; --stage 2: the vanilla ResNet-18) through the int8 "
                             "PTQ serving path inside the KD step, calibrated on the first "
                             "eval batch (a deliberate approximation of the teacher)")
    parser.add_argument("--device_augment", action="store_true",
                        help=common.DEVICE_AUGMENT_HELP + "; --crd, --contrast, --vid")
    parser.add_argument("--device_views", action="store_true",
                        help="synthesize the flip/rot contrast views on the device from ONE "
                             "host-decoded crop (about 3x less host work a sample; implies "
                             "--device_augment; --crd and --stage 2 only)")
    parser.add_argument("--device_shapes", action="store_true",
                        help=common.DEVICE_SHAPES_HELP)
    parser.add_argument("--bf16", action="store_true",
                        help=common.BF16_HELP + "; here: the student and its teacher, "
                             "frozen or (--stage 1) trained, in every regime")
    parser.add_argument("--fused_nce", action="store_true",
                        help="--stage 1: both NCE directions in the NCE kernels")
    parser.add_argument("--tau", type=float, default=None,
                        help="--stage 1's NCE temperature (default 0.5)")
    parser.add_argument("--use_memory_bank", action="store_true",
                        help="--stage 1: a FIFO queue of past teacher features joins the "
                             "NCE's negatives (an extension of JAX's; --fused_nce does not "
                             "apply to it)")
    parser.add_argument("--memory_bank_size", type=int, default=4096,
                        help="the queue's length for --use_memory_bank")
    parser.add_argument("--nce", type=str, default="info",
                        choices=["info", "pose", "multipose"],
                        help="--stage 1's NCE: info (the reference's), or the "
                             "pose-weighted pose (weighted by --weighting) and multipose")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="more than 1: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--cache_decoded_mb", type=float, default=0.0,
                        help="above 0: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="not ported yet, refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    if opt.shape == "None":
        raise SystemExit("--shape None: KD distils from a teacher; give its shape encoder, "
                         "--shape PointCloud or MultiView")
    if opt.dataset is None:
        raise SystemExit("--dataset is required")
    if opt.dataset in ("Pix3D", "LineMod"):
        raise SystemExit(f"unsupported KD training dataset {opt.dataset}")  # JAX's
    if opt.dataset == "ShapeNetCore":
        raise SystemExit(common.SHAPENET_TEACHER + "; and its one-view ShapeNet samples "
                         "lack the flipped and rotated views that --crd, --contrast, --vid "
                         "and --stage 2 take (JAX's run fails at their first step)")
    if opt.stage not in (0, 1, 2):
        raise SystemExit(f"--stage {opt.stage}: pose3d_tpu_torch's KD training takes --stage "
                         "1 or 2, or none for --crd (ROADMAP.md Queue 1 lists the regimes)")
    # JAX's refusals, with its messages
    if opt.weighting is not None and not (opt.stage == 1 and opt.nce == "pose"):
        print("WARNING: --weighting has NO consumer outside --stage 1 --nce pose (the "
              "reference ignores it everywhere too, trainingKD.py:128); continuing WITHOUT "
              "pose weighting", file=sys.stderr)
        opt.weighting = None
    if opt.nce != "info" and opt.stage != 1:
        raise SystemExit("--nce pose/multipose applies to --stage 1 (the only regime with a "
                         "contrastive term)")
    if opt.vid and (opt.stage != 0 or opt.contrast):
        raise SystemExit("--vid is a --crd loss variant")
    if opt.fused_nce and opt.nce != "info":
        print("WARNING: the NCE kernels implement the infoNCE term only; --nce "
              "pose/multipose takes the plain lowering (train/steps.py route_info_nce) — "
              "continuing WITHOUT --fused_nce", file=sys.stderr)
        opt.fused_nce = False
    if opt.contrast and (opt.crd or opt.stage != 0):
        raise SystemExit("--contrast is a loss variant of the --crd regime and replaces it: "
                         "JAX runs --crd or --stage and ignores it, so the port refuses the "
                         "pair (ROADMAP.md Queue 1)")
    if opt.use_memory_bank and opt.nce != "info":
        raise SystemExit("--use_memory_bank with --nce pose/multipose: pose-weighted NCE has "
                         "no memory-bank form (the queue holds no pose labels)")
    stage1_only = {"--fused_nce": opt.fused_nce, "--tau": opt.tau is not None,
                   "--random": opt.random, "--random_range > 0": opt.random_range > 0,
                   "--use_memory_bank": opt.use_memory_bank}
    for flag, set_ in stage1_only.items():
        if set_ and opt.stage != 1:
            raise SystemExit(f"{flag} applies to --stage 1 only; the other regimes have no "
                             "use for it (ROADMAP.md Queue 1 lists the ported regimes)")
    if opt.stage == 1 and opt.teacher_model is not None:
        raise SystemExit("--teacher_model: --stage 1 trains its vanilla teacher from "
                         "scratch (ROADMAP.md Queue 1 lists the ported regimes)")
    # JAX's refusals of --int8_teacher, with its messages
    if opt.int8_teacher and opt.stage == 1:
        raise SystemExit("--int8_teacher: not applicable to --stage 1 (the teacher trains "
                         "jointly; nothing is frozen to quantize)")
    if opt.int8_teacher and opt.stage == 2 and opt.shape != "PointCloud":
        raise SystemExit("--int8_teacher --stage 2: PointCloud teachers only (the vanilla int8 "
                         "fwd has no MV variant)")
    # JAX's refusal of --device_views, with its message
    if opt.device_views and opt.stage == 1:
        raise SystemExit("--device_views applies to the 3-view regimes (--crd / --stage 2), "
                         "not --stage 1")
    # where JAX's run ignores --device_augment (stage 1) or trains on raw,
    # unnormalised pixels (stage 2 without --device_views)
    if opt.device_augment and opt.stage != 0 and not (opt.stage == 2 and opt.device_views):
        raise SystemExit(f"--device_augment: --stage {opt.stage}'s step takes no device "
                         "augmentation (JAX's run " + ("ignores the flag" if opt.stage == 1 else
                                                        "trains on raw, unnormalised pixels")
                         + "; ROADMAP.md Queue 3); it applies to --crd / --contrast / --vid, "
                         "and --device_views brings it to --stage 2")
    unported = {"--loader shm": opt.loader != "thread",
                "--n_devices > 1": opt.n_devices is not None and opt.n_devices > 1,
                "--cache_decoded_mb > 0": opt.cache_decoded_mb > 0,
                "--profile_dir": opt.profile_dir is not None, "--model": opt.model is not None}
    for flag, set_ in unported.items():
        if set_:
            raise SystemExit(f"{flag} is not ported to pose3d_tpu_torch's KD training yet; "
                             "see ROADMAP.md Queue 1")
    if opt.tau is None:
        opt.tau = 0.5
    return opt


def int8_teacher(opt, teacher) -> dict:
    """The frozen teacher's quantized tree, calibrated as JAX's CLI does on
    the first evaluation batch: its images' first 32 (always normalized
    crops, as the step feeds the teacher) and, for a MultiView teacher, its
    first 8 samples' renders."""
    val = common.build_kd_datasets(opt, val_shapes=opt.shape == "MultiView")[1]
    batch = next(iter(DataLoader(val, opt.batch_size, shuffle=False, num_workers=0)))
    calib = [np.asarray(batch["im"][:32])]
    if opt.stage == 2:
        print("int8 teacher: vanilla resnet18 quantized")
        return serving.quantize_teacher_vanilla(teacher, calib)
    if opt.shape == "MultiView":
        print("int8 teacher: MV resnet50 + per-view resnet18 quantized")
        return serving.quantize_teacher_mv(teacher, calib, [np.asarray(batch["shape"][:8])])
    print("int8 teacher: resnet50 quantized (52 convs)")
    return serving.quantize_teacher_resnet(teacher, calib)


def main(argv=None):
    opt = parse_args(argv)
    print(opt)
    device = common.setup_device(opt)

    dataset_train, dataset_eval = common.build_kd_datasets(opt)
    if opt.device_augment:  # the train views' raw pixels, augmented in the step
        dataset_train.host_augment = False
    if opt.device_views:  # one raw view a sample, the others built in the step
        dataset_train.device_views = True
    shape_bank = common.maybe_shape_bank(opt, dataset_train, device)
    train_loader = common.make_train_loader(dataset_train, opt)
    eval_loader = DataLoader(dataset_eval, opt.batch_size, shuffle=False,
                             num_workers=opt.workers, seed=common.MANUAL_SEED)

    student = common.build_student(opt, opt.student_model, device,
                                   img_feature_dim=opt.student_feature_dim)
    steps_per_epoch = max(len(train_loader), 1)
    milestones = [opt.decrease * steps_per_epoch]
    state = create_train_state(student, opt.lr, milestones, seed=common.MANUAL_SEED)
    if opt.stage == 1:
        teacher = None
        teacher_state = create_train_state(common.build_vanilla(opt, device), opt.lr,
                                           milestones, seed=common.MANUAL_SEED + 1)
    else:
        if opt.stage == 2:
            if opt.teacher_model is None:
                print("WARNING: no checkpoint given; the model keeps its seeded random init")
            teacher = common.build_vanilla(opt, device, opt.teacher_model).eval()
        else:
            teacher = common.build_teacher(opt, opt.teacher_model, device)
        teacher.requires_grad_(False)
        teacher_state = None
        if opt.int8_teacher:
            teacher = {"model": teacher, "q8": int8_teacher(opt, teacher)}

    result_path = os.path.join(os.getcwd(), opt.result_dir, f"KD_{opt.dataset}")
    os.makedirs(result_path, exist_ok=True)
    log = TxtLogger(os.path.join(result_path, "training_log.txt"))
    log.line(str(opt) + "\n")
    with open(os.path.join(result_path, "config.json"), "w") as f:
        json.dump(vars(opt), f, indent=1)

    trainer = KDTrainer(state, teacher, train_loader, eval_loader,
                        dataset_eval.category_names, result_path, bin_size=opt.bin_size,
                        temperature=opt.temperature, teacher_state=teacher_state,
                        tau=opt.tau, use_fused_nce=opt.fused_nce, nce_variant=opt.nce,
                        nce_weighting=opt.weighting or "linear", int8_teacher=opt.int8_teacher,
                        device_augment=opt.device_augment, device_views=opt.device_views,
                        shape_bank=shape_bank)
    start_epoch = 0
    latest = trainer.ckpt.latest_epoch() if opt.resume else None
    if latest is not None:
        start_epoch = latest + 1
        print(f"resuming from epoch {latest}")
    if opt.stage == 1:  # fit_stage1 restores both train states (and the bank) itself
        best = trainer.fit_stage1(opt.n_epoch or EPOCHS["stage1"], start_epoch=start_epoch,
                                  use_memory_bank=opt.use_memory_bank,
                                  memory_bank_size=opt.memory_bank_size)
    else:
        if latest is not None:
            state.load_state_dict(trainer.ckpt.restore("checkpoint"))
        if opt.stage == 2:
            best = trainer.fit_stage2(opt.n_epoch or EPOCHS["stage2"], start_epoch=start_epoch)
        else:
            variant = "contrast" if opt.contrast else "vid" if opt.vid else "crd"
            best = trainer.fit_crd(opt.n_epoch or EPOCHS["crd" if variant == "vid" else variant],
                                   start_epoch=start_epoch, loss_variant=variant)

    if opt.export_torch:
        torch.save({"state_dict": {k: v.cpu() for k, v in state.model.state_dict().items()}},
                   opt.export_torch)
        print(f"torch checkpoint exported to {opt.export_torch}")
    print(f"best val acc: {best:.2f}")
    return best


if __name__ == "__main__":
    main()
