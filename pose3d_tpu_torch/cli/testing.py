"""Evaluation CLI. Port of `pose3d_tpu/cli/testing.py` for the student
(`--shape None`) and the teacher (`--shape PointCloud` with its clouds,
`--shape MultiView` with `--view_num` renders over `--tour` rings).

One pass over the validation set, reduced per category: ObjectNet3D's or
Pascal3D's test categories, or (the student) LineMod's objects or Pix3D's
categories. Writes the same artifacts as the JAX CLI: testing_log.txt with
the per-category lines and predictions_{cat}.npy dumps. `--bf16` computes
in bfloat16 (float32 parameters). `--int8` evaluates through the int8
post-training-quantized serving forward (`pose3d_tpu_torch.serving`: the
student's VGG trunk, the teacher's ResNet-50 and, for MultiView, its
per-view ResNet-18), calibrated on the first `--calib_batches` evaluation
batches; its teacher evaluation computes no contrastive loss, as JAX's.
`--device_shapes` evaluates the teacher with its clouds or renders in a
device-resident bank (ops/shape_bank.py), resolved in the step from a few
scalars a sample; it is refused for the student and with `--int8`, as
JAX refuses them. `--n_devices` is refused with a message until it is
ported (ROADMAP.md).

    python -m pose3d_tpu_torch.cli.testing --dataset ObjectNet3D --shape None \\
        --img_feature_dim 2048 --model student.pth
    python -m pose3d_tpu_torch.cli.testing --dataset ObjectNet3D \\
        --shape PointCloud --shape_dir pointcloud --model teacher.pth
    python -m pose3d_tpu_torch.cli.testing --dataset ObjectNet3D \\
        --shape MultiView --shape_dir Renders_semi_sphere --model teacher.pth
    python -m pose3d_tpu_torch.cli.testing --dataset LineMod --shape None \\
        --img_feature_dim 2048 --model student.pth
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pose3d_tpu_torch import geometry, serving
from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import datasets
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.losses.binned import pose_loss_per_sample
from pose3d_tpu_torch.train import steps
from pose3d_tpu_torch.train.evaluate import evaluate_categories

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
                             "teacher with its clouds, MultiView the teacher with its "
                             "renders")
    parser.add_argument("--shape_dir", type=str, default="Renders_semi_sphere",
                        choices=["Renders_semi_sphere", "pointcloud"])
    parser.add_argument("--shape_feature_dim", type=int, default=256)
    parser.add_argument("--point_num", type=int, default=2500)
    common.add_shape_flags(parser)
    parser.add_argument("--random_model", action="store_true",
                        help="pair each image with another CAD model of its category")
    parser.add_argument("--output_dir", type=str, default=None)
    common.add_student_flags(parser, img_feature_dim=1024)
    parser.add_argument("--int8", action="store_true",
                        help="evaluate through the int8 PTQ serving path")
    parser.add_argument("--calib_batches", type=int, default=4,
                        help="eval batches used to calibrate --int8 scales")
    parser.add_argument("--device_shapes", action="store_true",
                        help="teacher eval only: resolve shapes from a device-resident bank "
                             "(ops/shape_bank.py) instead of per-sample host loads and copies")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="not ported yet: refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    common.refuse_unported(opt, ("n_devices",))
    # JAX's refusals of --device_shapes, with its messages
    if opt.device_shapes and opt.shape == "None":
        raise SystemExit("--device_shapes applies to teacher eval (student eval carries no "
                         "shapes)")
    if opt.device_shapes and opt.int8:
        raise SystemExit("--device_shapes is not combinable with --int8 (the int8 "
                         "calibration consumes host shapes)")
    if opt.dataset in ("LineMod", "Pix3D") and opt.shape != "None":
        # JAX builds the teacher and fails on the samples' missing 'shape'
        raise SystemExit(f"--dataset {opt.dataset}: its samples carry no shape, so only the "
                         "RGB-only student (--shape None) is evaluated on it")
    return opt


def build_eval_dataset(opt):
    """The evaluation set of --dataset, as the JAX CLI builds it."""
    if opt.dataset not in common.TEST_CATS:
        raise SystemExit(f"unsupported dataset {opt.dataset}")  # JAX's
    root_dir, annotation_file = os.path.join(opt.data_root, opt.dataset), f"{opt.dataset}.txt"
    cats = common.TEST_CATS[opt.dataset]
    if opt.dataset == "LineMod":
        return datasets.Linemod(root_dir, annotation_file, input_dim=opt.input_dim,
                                cat_choice=cats)
    if opt.dataset == "Pix3D":
        return datasets.Pix3DContrast(root_dir, annotation_file, train=False,
                                      input_dim=opt.input_dim, cls_choice=cats)
    return datasets.Pascal3DContrast(
        root_dir, annotation_file, input_dim=opt.input_dim,
        keypoint=opt.dataset == "Pascal3D", cat_choice=cats, shape=opt.shape,
        shape_dir=opt.shape_dir, point_num=opt.point_num, random_model=opt.random_model,
        view_num=opt.view_num, tour=opt.tour)


def int8_eval_step(opt, model, kind: str, dataset):
    """An evaluation step through the int8 serving forward (JAX's
    `_int8_eval_step`): the quantized tree calibrated on the first
    --calib_batches evaluation batches (their clouds or renders too, for a
    teacher), then per batch the six heads in float32, the per-sample pose
    loss and the train/val decoder, as `steps.make_eval_step` returns them
    without the contrastive loss."""
    ims, shapes = [], []
    for i, b in enumerate(DataLoader(dataset, opt.batch_size, shuffle=False, num_workers=0)):
        if i >= opt.calib_batches:
            break
        ims.append(np.asarray(b["im"]))
        if kind == "teacher":
            shapes.append(np.asarray(b["shape"]))
    if kind == "student":
        q = serving.quantize_student(model, ims)
        dtype = torch.bfloat16 if opt.bf16 else torch.float32

        def infer(batch):
            return serving.student_int8_infer(q, batch["im"], dtype)
    else:
        q = (serving.quantize_teacher_mv(model, ims, shapes) if opt.shape == "MultiView"
             else serving.quantize_teacher_resnet(model, ims))
        teacher_infer = serving.make_teacher_int8_infer(model)

        def infer(batch):
            return teacher_infer(q, batch["im"], batch["shape"])

    @torch.no_grad()
    def step(batch: dict) -> dict:
        outputs = [o.float() for o in infer(batch)]
        per_sample = pose_loss_per_sample(outputs, batch["label"], opt.bin_size)
        preds = geometry.decode_predictions(outputs[:3], outputs[3:], opt.bin_size)
        return {"pred": preds, "loss": per_sample.mean(), "per_sample_loss": per_sample}

    return step


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

    eval_step = (int8_eval_step(opt, model, kind, dataset) if opt.int8
                 else steps.make_eval_step(model, kind, opt.bin_size,
                                           shape_bank=common.maybe_shape_bank(opt, dataset,
                                                                              device)))
    result = evaluate_categories(eval_step, loader, dataset.category_names, device)

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
