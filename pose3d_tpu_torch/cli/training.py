"""Teacher and baseline training CLI. Port of `pose3d_tpu/cli/training.py`
on ObjectNet3D and Pascal3D, and (the baseline) ShapeNetCore:
  * `--shape PointCloud` / `--shape MultiView`: the contrastive teacher
    with a PointNet over the object's cloud or a ResNet-18 over its
    `--view_num` renders (`--tour` rings), its NCE the infoNCE-KD (through
    the CUDA kernels of `csrc/info_nce.cu` on the card with `--fused_nce`),
    or `--nce pose` (weighted by `--weighting`) or `--nce multipose`;
  * `--shape None`: the RGB-only supervised baseline, the student
    (`--img_feature_dim`, `--student_width_mult`) under the 4-term pose
    loss alone, its stem in the VGG stem kernel on the card. On
    `--dataset ShapeNetCore` it trains on ShapeNetCore's renders over SUN
    backgrounds (`<data_root>/SUN`) at 224 x 224 and validates on Pix3D
    (`<data_root>/Pix3D`); a teacher is refused there, since Pix3D's
    samples carry no shape to evaluate it with.
`--bf16` computes both in bfloat16 (float32 parameters and checkpoints);
the teacher's PointNet then trains in the train-mode PointNet kernel's
bf16 instance on the card. The teacher takes the on-device data options:
`--device_shapes` (its clouds or renders in a device-resident bank,
resolved in the step from a few scalars a sample) and `--device_augment`
(the loader sends raw uint8 pixels; the photometric augmentation and the
normalisation run in the step; ObjectNet3D, whose contrastive train set
has the raw emission).

    python -m pose3d_tpu_torch.cli.training --dataset ObjectNet3D \\
        --shape PointCloud --shape_dir pointcloud --batch_size 160 \\
        --n_epoch 300 --lr 1e-4 --decrease 200 --fused_nce
    python -m pose3d_tpu_torch.cli.training --dataset ObjectNet3D \\
        --shape MultiView --shape_dir Renders_semi_sphere --batch_size 64 --fused_nce
    python -m pose3d_tpu_torch.cli.training --dataset ObjectNet3D --shape None \\
        --img_feature_dim 2048 --batch_size 64

Runs on the card (`--device cuda`, the default); `--device cpu` runs the
plain versions. Writes, under <result_dir>/<shape>_<dataset>[_novel]/
(the baseline: baseline_<dataset>[_novel]/), training_log.txt,
config.json, metrics.jsonl, the curves and ckpt/ (checkpoint.pth, best.pth,
EPOCH and, for the teacher, the image encoder alone; checkpoint.pth is
what the testing CLI's `--model` reads); `--resume` continues from the last
saved epoch. The flags of paths not ported yet are refused with a message
that names ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import datasets
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.models.estimators import PoseEstimator
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.trainer import SupervisedTrainer, TeacherTrainer
from pose3d_tpu_torch.utils.logging import TxtLogger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--loader", type=str, default="thread", choices=["thread", "shm"],
                        help="shm: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--model", type=str, default=None,
                        help="not read by the training CLI: refused (use --resume)")
    parser.add_argument("--img_feature_dim", type=int, default=1024)
    parser.add_argument("--shape_feature_dim", type=int, default=256)
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
                        help="PointCloud / MultiView: the contrastive teacher with "
                             "that shape encoder; None: the RGB-only supervised baseline")
    common.add_shape_flags(parser)
    parser.add_argument("--student_width_mult", type=float, default=1.0,
                        help="--shape None: the student's VGG conv width multiplier")
    parser.add_argument("--novel", action="store_true")
    parser.add_argument("--keypoint", action="store_true")
    parser.add_argument("--shot", type=int, default=None)
    parser.add_argument("--random", action="store_true")
    parser.add_argument("--random_range", type=int, default=0)
    parser.add_argument("--input_dim", type=int, default=224)
    parser.add_argument("--point_num", type=int, default=2500)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--decrease", type=int, default=130, help="epoch to decrease")
    parser.add_argument("--n_epoch", type=int, default=200)
    parser.add_argument("--print_freq", type=int, default=50)
    parser.add_argument("--result_dir", type=str, default="result")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint")
    parser.add_argument("--fused_nce", action="store_true",
                        help="the infoNCE term through the NCE kernels (the CUDA "
                             "kernels of csrc/info_nce.cu on the card), routed as "
                             "in JAX: the single-block entry for unmasked batches "
                             "of up to 1024, the blocked one above")
    parser.add_argument("--nce", type=str, default="info",
                        choices=["info", "pose", "multipose"],
                        help="the teacher's contrastive term: info (infoNCE-KD, the "
                             "reference's) or the pose-weighted pose and multipose")
    parser.add_argument("--weighting", type=str, default=None,
                        choices=["linear", "square", "sqrt", "sin", "sinsin"],
                        help="the pose distance's weighting; --nce pose only")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda); cpu runs the plain "
                             "versions and must be asked for")
    parser.add_argument("--bf16", action="store_true",
                        help=common.BF16_HELP + "; here: the teacher and the baseline")
    parser.add_argument("--device_shapes", action="store_true",
                        help=common.DEVICE_SHAPES_HELP + "; the teacher only")
    parser.add_argument("--device_augment", action="store_true",
                        help=common.DEVICE_AUGMENT_HELP + "; the teacher on ObjectNet3D")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="more than 1: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--cache_decoded_mb", type=float, default=0.0,
                        help="above 0: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="not ported yet, refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    if opt.dataset is None:
        raise SystemExit("--dataset is required")
    if opt.dataset in ("Pix3D", "LineMod"):
        raise SystemExit(f"unsupported training dataset {opt.dataset}")  # JAX's
    if opt.dataset == "ShapeNetCore":
        if opt.shape != "None":
            raise SystemExit(common.SHAPENET_TEACHER + "; train the RGB-only baseline "
                             "(--shape None) on it")
        if opt.input_dim != 224:
            raise SystemExit("--dataset ShapeNetCore crops its renders to 224 x 224 and "
                             "Pix3D evaluates at 224 whatever --input_dim (as in JAX): "
                             "leave --input_dim at 224")
    # JAX's refusals, with its messages
    if opt.weighting is not None and opt.nce != "pose":
        raise SystemExit("--weighting is consumed only by --nce pose "
                         "(refusing to accept-and-ignore it)")
    if opt.nce != "info" and opt.shape == "None":
        raise SystemExit("--nce pose/multipose applies to teacher training (--shape ...); "
                         "the RGB baseline has no contrastive term")
    if opt.fused_nce and opt.nce != "info":
        print("WARNING: the NCE kernels implement the infoNCE term only; --nce "
              "pose/multipose takes the plain lowering (train/steps.py route_info_nce) — "
              "continuing WITHOUT --fused_nce", file=sys.stderr)
        opt.fused_nce = False
    if opt.shape == "None" and opt.fused_nce:
        raise SystemExit("--fused_nce: the RGB baseline has no contrastive term "
                         "(ROADMAP.md Queue 1 lists the ported regimes)")
    if opt.device_shapes and opt.shape == "None":  # JAX's message (JAX ignores the flag)
        raise SystemExit("--device_shapes requires --shape PointCloud or MultiView")
    if opt.device_augment and opt.shape == "None":
        raise SystemExit("--device_augment: the RGB baseline's step takes no device "
                         "augmentation (JAX's run would train it on raw, unnormalised "
                         "pixels; ROADMAP.md Queue 3)")
    if opt.device_augment and opt.dataset != "ObjectNet3D":
        raise SystemExit(f"--device_augment: --dataset {opt.dataset}'s train samples have no "
                         "raw-pixel emission (JAX's run augments their host-augmented, "
                         "normalised pixels a second time; ROADMAP.md Queue 3); it applies "
                         "to --dataset ObjectNet3D")
    if opt.shape != "None" and opt.student_width_mult != 1.0:
        raise SystemExit("--student_width_mult applies to --shape None, the RGB baseline "
                         "(ROADMAP.md Queue 1 lists the ported regimes)")
    unported = {"--loader shm": opt.loader != "thread",
                "--n_devices > 1": opt.n_devices is not None and opt.n_devices > 1,
                "--cache_decoded_mb > 0": opt.cache_decoded_mb > 0,
                "--profile_dir": opt.profile_dir is not None,
                "--model": opt.model is not None}
    for flag, set_ in unported.items():
        if set_:
            raise SystemExit(f"{flag} is not ported to pose3d_tpu_torch's training yet; "
                             "see ROADMAP.md Queue 1")
    return opt


def main(argv=None):
    opt = parse_args(argv)
    print(opt)
    device = common.setup_device(opt)

    dataset_train, dataset_eval = common.build_train_eval_datasets(opt)
    train_loader = common.make_train_loader(dataset_train, opt)
    eval_loader = DataLoader(dataset_eval, opt.batch_size, shuffle=False,
                             num_workers=opt.workers, seed=common.MANUAL_SEED)
    steps_per_epoch = max(len(train_loader), 1)
    if opt.shape == "None":
        print("Baseline!")
        model = common.build_student(opt, None, device).train()
    else:
        azi, ele, inp = common.num_classes(opt.bin_size)
        model = PoseEstimator(shape=opt.shape, view_num=opt.view_num,
                              img_feature_dim=opt.img_feature_dim,
                              shape_feature_dim=opt.shape_feature_dim, azi_classes=azi,
                              ele_classes=ele, inp_classes=inp, bin_size=opt.bin_size,
                              generator=torch.Generator().manual_seed(common.MANUAL_SEED),
                              compute_dtype=common.compute_dtype(opt))
    state = create_train_state(model.to(device), opt.lr, [opt.decrease * steps_per_epoch],
                               seed=common.MANUAL_SEED)

    training_mode = (f"baseline_{opt.dataset}" if opt.shape == "None"
                     else f"{opt.shape}_{opt.dataset}") + ("_novel" if opt.novel else "")
    result_path = os.path.join(os.getcwd(), opt.result_dir, training_mode)
    os.makedirs(result_path, exist_ok=True)
    log = TxtLogger(os.path.join(result_path, "training_log.txt"))
    log.line(str(opt) + "\n")
    log.line("training set: " + str(len(dataset_train)))
    log.line("evaluation set: " + str(len(dataset_eval)))
    with open(os.path.join(result_path, "config.json"), "w") as f:
        json.dump(vars(opt), f, indent=1)

    if opt.shape == "None":
        # the supervised RGB-only baseline (the reference's train_vanilla)
        trainer = SupervisedTrainer(state, train_loader, eval_loader,
                                    dataset_eval.category_names, result_path, kind="student",
                                    bin_size=opt.bin_size, print_freq=opt.print_freq)
    else:
        # the per-category Acc sweep runs on the contrastive val set without
        # the keypoint filter, as the reference's training.py does
        cat_ds = datasets.Pascal3DContrast(
            os.path.join(opt.data_root, opt.dataset), f"{opt.dataset}.txt", train=False,
            cat_choice=common.TEST_CATS[opt.dataset], keypoint=False, shape=opt.shape,
            shape_dir=opt.shape_dir, input_dim=opt.input_dim, point_num=opt.point_num,
            view_num=opt.view_num, tour=opt.tour)
        cat_eval_loader = DataLoader(cat_ds, opt.batch_size, shuffle=False,
                                     num_workers=opt.workers, seed=common.MANUAL_SEED)
        if opt.device_augment:  # the train views' raw pixels, augmented in the step
            dataset_train.host_augment = False
        trainer = TeacherTrainer(state, train_loader, eval_loader, cat_ds.category_names,
                                 result_path, bin_size=opt.bin_size, print_freq=opt.print_freq,
                                 cat_eval_loader=cat_eval_loader,
                                 use_fused_nce=opt.fused_nce, nce_variant=opt.nce,
                                 nce_weighting=opt.weighting or "linear",
                                 device_augment=opt.device_augment,
                                 shape_bank=common.maybe_shape_bank(opt, dataset_train, device))
    start_epoch = 0
    if opt.resume:
        latest = trainer.ckpt.latest_epoch()
        if latest is not None:
            state.load_state_dict(trainer.ckpt.restore("checkpoint"))
            start_epoch = latest + 1
            print(f"resumed from epoch {latest}")
    best = trainer.fit(opt.n_epoch, start_epoch=start_epoch)
    print(f"best val acc: {best:.2f}")
    return best


if __name__ == "__main__":
    main()
