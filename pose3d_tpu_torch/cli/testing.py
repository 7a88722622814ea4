"""Evaluation CLI. Port of `pose3d_tpu/cli/testing.py` for the student
(`--shape None`) and the PointCloud teacher (`--shape PointCloud`).

One pass over the validation set, reduced per category. Writes the same
artifacts as the JAX CLI: testing_log.txt with the per-category lines and
predictions_{cat}.npy dumps. The MultiView teacher, `--int8`,
`--device_shapes`, `--n_devices`, `--bf16` and the LineMod / Pix3D datasets
are refused with a message until they are ported (ROADMAP.md).

    python -m pose3d_tpu_torch.cli.testing --dataset ObjectNet3D --shape None \\
        --img_feature_dim 2048 --model student.pth
    python -m pose3d_tpu_torch.cli.testing --dataset ObjectNet3D \\
        --shape PointCloud --shape_dir pointcloud --model teacher.pth
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import annotations, datasets
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.train import steps
from pose3d_tpu_torch.train.evaluate import evaluate_categories

_TEST_CATS = {"ObjectNet3D": annotations.OBJECTNET3D_TEST_CATS,
              "Pascal3D": annotations.PASCAL3D_TEST_CATS}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--model", type=str, default=None,
                        help="student or teacher weights: a reference-layout .pth")
    parser.add_argument("--dataset", type=str, default=None,
                        choices=["ObjectNet3D", "Pascal3D", "ShapeNetCore", "Pix3D",
                                 "LineMod"])
    parser.add_argument("--data_root", type=str, default="data",
                        help="root containing <dataset>/ trees")
    parser.add_argument("--shape", type=str, default="MultiView",
                        choices=["MultiView", "PointCloud", "None"],
                        help="None evaluates the RGB-only student, PointCloud the "
                             "teacher with its clouds; MultiView is not ported yet")
    parser.add_argument("--shape_dir", type=str, default="Renders_semi_sphere",
                        choices=["Renders_semi_sphere", "pointcloud"])
    parser.add_argument("--shape_feature_dim", type=int, default=256)
    parser.add_argument("--point_num", type=int, default=2500)
    parser.add_argument("--random_model", action="store_true",
                        help="pair each image with another CAD model of its category")
    parser.add_argument("--output_dir", type=str, default=None)
    common.add_student_flags(parser, img_feature_dim=1024)
    for flag in ("int8", "device_shapes"):
        parser.add_argument(f"--{flag}", action="store_true",
                            help="not ported yet: refused (ROADMAP.md)")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="not ported yet: refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    if opt.shape == "MultiView":
        raise SystemExit("--shape MultiView: the MultiView teacher is not ported "
                         "to pose3d_tpu_torch yet; see ROADMAP.md Queue 1 "
                         "(--shape None for the student, PointCloud for the "
                         "PointCloud teacher)")
    common.refuse_unported(opt, ("bf16", "int8", "device_shapes", "n_devices"))
    return opt


def build_eval_dataset(opt):
    if opt.dataset not in _TEST_CATS:
        raise SystemExit(f"--dataset {opt.dataset} is not ported to "
                         "pose3d_tpu_torch yet; see ROADMAP.md Queue 1")
    return datasets.Pascal3DContrast(
        os.path.join(opt.data_root, opt.dataset), f"{opt.dataset}.txt",
        input_dim=opt.input_dim, keypoint=opt.dataset == "Pascal3D",
        cat_choice=_TEST_CATS[opt.dataset], shape=opt.shape, shape_dir=opt.shape_dir,
        point_num=opt.point_num, random_model=opt.random_model)


def main(argv=None):
    opt = parse_args(argv)
    print(opt)
    device = common.setup_device(opt)
    if opt.shape == "None":
        model, kind = common.build_student(opt, opt.model, device), "student"
    else:
        model, kind = common.build_teacher(opt, opt.model, device), "teacher"

    dataset = build_eval_dataset(opt)
    loader = DataLoader(dataset, opt.batch_size, shuffle=False,
                        num_workers=opt.workers)

    predictions_path = opt.output_dir or os.getcwd()
    os.makedirs(predictions_path, exist_ok=True)
    logname = os.path.join(predictions_path, "testing_log.txt")

    result = evaluate_categories(steps.make_eval_step(model, kind, opt.bin_size),
                                 loader, dataset.category_names, device)

    with open(logname, "w") as f:
        f.write("\n")
        name_to_id = {n: i for i, n in enumerate(dataset.category_names)}
        for cat in result.per_category_acc:
            n_cat = int(np.sum(result.cat_ids == name_to_id[cat]))
            f.write("test accuracy for %d images of catgory %s in datatset %s \n"
                    % (n_cat, cat, opt.dataset))
            f.write("Med_Err is %.2f, and Acc_pi/6 is %.2f \n \n"
                    % (result.per_category_med[cat], result.per_category_acc[cat]))
        f.write("Average for all categories  >>>>  Med_Err is %.2f, and Acc_pi/6 is "
                "%.2f \n" % (result.mean_med, result.mean_acc))
        # the reference swaps Acc and Med on this line; they are in their
        # right places here
        f.write("Average for all Samples  >>>>  Med_Err is %.2f, and Acc_pi/6 is "
                "%.2f \n" % (result.sample_med, result.sample_acc))

    for ci, cat in enumerate(dataset.category_names):
        mask = result.cat_ids == ci
        if mask.any():
            np.save(os.path.join(predictions_path, f"predictions_{cat}.npy"),
                    result.predictions[mask])

    print("Average for all categories >>>> Med_Err %.2f, Acc_pi/6 %.2f"
          % (result.mean_med, result.mean_acc))
    print("Average for all samples    >>>> Med_Err %.2f, Acc_pi/6 %.2f"
          % (result.sample_med, result.sample_acc))
    return result


if __name__ == "__main__":
    main()
