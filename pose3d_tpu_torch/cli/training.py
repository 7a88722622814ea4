"""Teacher training CLI. Port of `pose3d_tpu/cli/training.py` for the
contrastive PointCloud teacher (`--shape PointCloud`) on ObjectNet3D and
Pascal3D, with `--fused_nce` (the infoNCE term in the CUDA kernels of
`csrc/info_nce.cu` on the card).

    python -m pose3d_tpu_torch.cli.training --dataset ObjectNet3D \\
        --shape PointCloud --shape_dir pointcloud --batch_size 160 \\
        --n_epoch 300 --lr 1e-4 --decrease 200 --fused_nce

Runs on the card (`--device cuda`, the default); `--device cpu` runs the
plain versions. Writes, under <result_dir>/PointCloud_<dataset>[_novel]/,
training_log.txt, config.json, metrics.jsonl, the curves and ckpt/
(checkpoint.pth, best.pth, the image encoder alone, EPOCH); `--resume`
continues from the last saved epoch. The flags of paths not ported yet are
refused with a message that names ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import datasets
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.models.estimators import PoseEstimator
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.trainer import TeacherTrainer
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
                        help="PointCloud: the contrastive teacher; MultiView and "
                             "None are not ported yet")
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
                        help="pose / multipose: not ported yet, refused")
    parser.add_argument("--weighting", type=str, default=None,
                        choices=["linear", "square", "sqrt", "sin", "sinsin"],
                        help="--nce pose only: not ported yet, refused")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda); cpu runs the plain "
                             "versions and must be asked for")
    for flag, what in (("bf16", "bfloat16 compute"),
                       ("device_shapes", "a device-resident cloud bank"),
                       ("device_augment", "on-device photometric augmentation")):
        parser.add_argument(f"--{flag}", action="store_true",
                            help=f"{what}: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="more than 1: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--cache_decoded_mb", type=float, default=0.0,
                        help="above 0: not ported yet, refused (ROADMAP.md)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="not ported yet, refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    if opt.shape != "PointCloud":
        raise SystemExit(f"--shape {opt.shape}: only the PointCloud teacher's training is "
                         "ported to pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
    if opt.dataset in (None, "ShapeNetCore", "Pix3D", "LineMod"):
        raise SystemExit(f"--dataset {opt.dataset}: training on it is not ported to "
                         "pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
    unported = {"--nce pose/multipose": opt.nce != "info",
                "--weighting": opt.weighting is not None,
                "--loader shm": opt.loader != "thread",
                "--n_devices > 1": opt.n_devices is not None and opt.n_devices > 1,
                "--cache_decoded_mb > 0": opt.cache_decoded_mb > 0,
                "--profile_dir": opt.profile_dir is not None,
                "--model": opt.model is not None,
                "--bf16": opt.bf16, "--device_shapes": opt.device_shapes,
                "--device_augment": opt.device_augment}
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
    # the per-category Acc sweep runs on the contrastive val set without the
    # keypoint filter, as the reference's training.py does
    cat_ds = datasets.Pascal3DContrast(
        os.path.join(opt.data_root, opt.dataset), f"{opt.dataset}.txt", train=False,
        cat_choice=common.TEST_CATS[opt.dataset], keypoint=False, shape=opt.shape,
        shape_dir=opt.shape_dir, input_dim=opt.input_dim, point_num=opt.point_num)
    cat_eval_loader = DataLoader(cat_ds, opt.batch_size, shuffle=False,
                                 num_workers=opt.workers, seed=common.MANUAL_SEED)

    azi, ele, inp = common.num_classes(opt.bin_size)
    model = PoseEstimator(img_feature_dim=opt.img_feature_dim,
                          shape_feature_dim=opt.shape_feature_dim, azi_classes=azi,
                          ele_classes=ele, inp_classes=inp, bin_size=opt.bin_size,
                          generator=torch.Generator().manual_seed(common.MANUAL_SEED))
    steps_per_epoch = max(len(train_loader), 1)
    state = create_train_state(model.to(device), opt.lr, [opt.decrease * steps_per_epoch],
                               seed=common.MANUAL_SEED)

    training_mode = f"{opt.shape}_{opt.dataset}" + ("_novel" if opt.novel else "")
    result_path = os.path.join(os.getcwd(), opt.result_dir, training_mode)
    os.makedirs(result_path, exist_ok=True)
    log = TxtLogger(os.path.join(result_path, "training_log.txt"))
    log.line(str(opt) + "\n")
    log.line("training set: " + str(len(dataset_train)))
    log.line("evaluation set: " + str(len(dataset_eval)))
    with open(os.path.join(result_path, "config.json"), "w") as f:
        json.dump(vars(opt), f, indent=1)

    trainer = TeacherTrainer(state, train_loader, eval_loader, cat_ds.category_names,
                             result_path, bin_size=opt.bin_size, print_freq=opt.print_freq,
                             cat_eval_loader=cat_eval_loader, use_fused_nce=opt.fused_nce)
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
