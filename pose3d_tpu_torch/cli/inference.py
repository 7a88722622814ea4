"""Single-image inference CLI. Port of `pose3d_tpu/cli/inference.py` for the
student and the PointCloud teacher (`--ply_path`).

Loads a checkpoint (a reference-layout .pth), resize-pads the image to
--input_dim, normalizes it, runs the inference decoder ((bin + raw delta)
* bin_size, clamped to [0, 360]) and converts the result back to the
annotation convention (ele -= 90, inp -= 180). With `--ply_path` the
teacher also takes a cloud of --point_num points sampled from that file
(seed 0, as in JAX). `--bf16` computes in bfloat16 (the stem and the eval
PointNet in their bf16 kernels on the card). The MultiView teacher
(`--render_dir`), `--int8` and the AOT artifacts are refused with a
message until they are ported (ROADMAP.md).

    python -m pose3d_tpu_torch.cli.inference --ckpt student.pth --img_path img.jpg
    python -m pose3d_tpu_torch.cli.inference --ckpt teacher.pth --img_path img.jpg \\
        --ply_path compressed.ply
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import ply
from pose3d_tpu_torch.data import transforms as T


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, default=None,
                        help="student or teacher weights: a reference-layout .pth")
    parser.add_argument("--img_path", type=str, required=True)
    common.add_student_flags(parser, img_feature_dim=2048)
    parser.add_argument("--ply_path", type=str, default=None,
                        help="point cloud for PointCloud-teacher inference")
    parser.add_argument("--shape_feature_dim", type=int, default=1024)
    parser.add_argument("--point_num", type=int, default=2500)
    parser.add_argument("--int8", action="store_true",
                        help="not ported yet: refused (ROADMAP.md)")
    for flag in ("export_aot", "load_aot", "render_dir"):
        parser.add_argument(f"--{flag}", type=str, default=None,
                            help="not ported yet: refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    common.refuse_unported(opt, ("int8", "export_aot", "load_aot", "render_dir"))
    if not opt.ckpt:
        raise SystemExit("--ckpt is required")
    return opt


def prep_image(img_path: str, input_dim: int) -> np.ndarray:
    """Image file -> (1, input_dim, input_dim, 3) normalized float32."""
    im = T.resize_pad(T.load_rgb(img_path), input_dim)
    return T.normalize_image(T.to_float_array(im))[None]


def sample_cloud(ply_path: str, point_num: int) -> np.ndarray:
    """PLY file -> (1, point_num, 3) float32 cloud, drawn with seed 0."""
    return T.sample_pointcloud(ply.load_vertices(ply_path), point_num, 0,
                               np.random.default_rng(0))[None]


def main(argv=None):
    opt = parse_args(argv)
    device = common.setup_device(opt)
    im = torch.from_numpy(prep_image(opt.img_path, opt.input_dim)).to(device)
    if opt.ply_path:
        # the teacher's image feature is 1024 unless set: the student's
        # default 2048 does not carry over (as in JAX)
        model = common.build_teacher(opt, opt.ckpt, device, img_feature_dim=(
            opt.img_feature_dim if opt.img_feature_dim != 2048 else 1024))
        pc = torch.from_numpy(sample_cloud(opt.ply_path, opt.point_num)).to(device)
        vp = model.predict_viewpoint(im, pc)[0].cpu().numpy()
    else:
        model = common.build_student(opt, opt.ckpt, device)
        vp = model.predict_viewpoint(im)[0].cpu().numpy()
    # back to annotation convention
    vp[1] -= 90.0
    vp[2] -= 180.0
    print("pred_azi=%.2f pred_ele=%.2f pred_inp=%.2f" % tuple(vp))
    return vp


if __name__ == "__main__":
    main()
