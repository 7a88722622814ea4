"""Single-image inference CLI. Port of `pose3d_tpu/cli/inference.py` for the
student, the PointCloud teacher (`--ply_path`) and the MultiView teacher
(`--render_dir`).

Loads a checkpoint (a reference-layout .pth), resize-pads the image to
--input_dim, normalizes it, runs the inference decoder ((bin + raw delta)
* bin_size, clamped to [0, 360]) and converts the result back to the
annotation convention (ele -= 90, inp -= 180). With `--ply_path` the
teacher also takes a cloud of --point_num points sampled from that file
(seed 0, as in JAX). With `--render_dir` (a model's `crop/` directory) the
MultiView teacher takes the `--view_num` renders of its sorted files that
`--tour` rings rolled by `--mutation` steps select, each resized to
--input_dim where it is another size, in [0, 1]. `--bf16` computes in
bfloat16 (the stem and the eval PointNet in their bf16 kernels on the
card). `--int8` serves through the int8 post-training-quantized forward
(`pose3d_tpu_torch.serving`; the int8 kernel on the card), calibrated on
the input image itself as JAX does (its renders too, for the MultiView
teacher), or read from a `--load_quantized` .npz of either package;
`--save_quantized` writes the quantized tree in JAX's .npz schema. The
student serves int8 in bfloat16, as JAX's does; a teacher in its dtype.

`--export_aot PATH` also writes the served model, in its dtype (f32,
`--bf16` or `--int8`), as an exported artifact (`serving/aot.py`: one
`torch.export` file, any batch size, the card or the CPU). `--load_aot
PATH` serves such a file with no `--ckpt` and no model flags: the image
size, the point count, the view count, the render size and the ring's
`--tour` come from the artifact; `--mutation` stays a flag of the request.
A teacher artifact's second input tells the teachers apart (rank 3: clouds,
`--ply_path`; rank 5: renders, `--render_dir`).

    python -m pose3d_tpu_torch.cli.inference --ckpt student.pth --img_path img.jpg
    python -m pose3d_tpu_torch.cli.inference --ckpt teacher.pth --img_path img.jpg \\
        --ply_path compressed.ply
    python -m pose3d_tpu_torch.cli.inference --ckpt mv_teacher.pth --img_path img.jpg \\
        --render_dir Renders_semi_sphere/bed/01/crop --shape_feature_dim 256
    python -m pose3d_tpu_torch.cli.inference --ckpt student.pth --img_path img.jpg \\
        --bf16 --export_aot student_bf16.pt2
    python -m pose3d_tpu_torch.cli.inference --load_aot student_bf16.pt2 --img_path img.jpg
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from pose3d_tpu_torch import geometry, serving
from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import ply
from pose3d_tpu_torch.data import transforms as T
from pose3d_tpu_torch.serving import aot


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, default=None,
                        help="student or teacher weights: a reference-layout .pth")
    parser.add_argument("--img_path", type=str, required=True)
    common.add_student_flags(parser, img_feature_dim=2048)
    parser.add_argument("--ply_path", type=str, default=None,
                        help="point cloud for PointCloud-teacher inference")
    parser.add_argument("--render_dir", type=str, default=None,
                        help="a model's render directory for MultiView-teacher inference")
    common.add_shape_flags(parser)
    parser.add_argument("--mutation", type=int, default=0,
                        help="azimuth-ring roll for --render_dir")
    parser.add_argument("--shape_feature_dim", type=int, default=1024)
    parser.add_argument("--point_num", type=int, default=2500)
    parser.add_argument("--int8", action="store_true",
                        help="serve through the int8 PTQ path")
    parser.add_argument("--save_quantized", type=str, default=None,
                        help="with --int8: write the quantized tree to this .npz (JAX's "
                             "schema; int8 on disk) after calibration")
    parser.add_argument("--load_quantized", type=str, default=None,
                        help="with --int8: load a saved .npz instead of calibrating")
    parser.add_argument("--export_aot", type=str, default=None,
                        help="also write the served model (student, or a teacher with "
                             "--ply_path / --render_dir; --bf16 or --int8 honoured) as an "
                             "exported artifact to this path (serving/aot.py)")
    parser.add_argument("--load_aot", type=str, default=None,
                        help="serve from an exported artifact instead of a checkpoint "
                             "(--ckpt not needed; its geometry comes from the artifact)")
    opt = parser.parse_args(argv)
    if (opt.save_quantized or opt.load_quantized) and not opt.int8:
        raise SystemExit("--save_quantized / --load_quantized belong to the int8 path: "
                         "pass --int8")
    if opt.ply_path and opt.render_dir:
        raise SystemExit("--ply_path (PointCloud teacher) and --render_dir "
                         "(MultiView teacher) are mutually exclusive")  # JAX's
    if not opt.ckpt and not opt.load_aot:
        raise SystemExit("--ckpt is required unless --load_aot is given")  # JAX's
    return opt


def prep_image(img_path: str, input_dim: int) -> np.ndarray:
    """Image file -> (1, input_dim, input_dim, 3) normalized float32."""
    im = T.resize_pad(T.load_rgb(img_path), input_dim)
    return T.normalize_image(T.to_float_array(im))[None]


def sample_cloud(ply_path: str, point_num: int) -> np.ndarray:
    """PLY file -> (1, point_num, 3) float32 cloud, drawn with seed 0."""
    return T.sample_pointcloud(ply.load_vertices(ply_path), point_num, 0,
                               np.random.default_rng(0))[None]


def load_renders(render_dir: str, view_num: int, tour: int, mutation: int,
                 size: int) -> np.ndarray:
    """A model's render directory -> (1, view_num, size, size, 3) float32
    in [0, 1]: the `multiview_ids` of its sorted files, each resized
    (bilinear) where it is not size x size."""
    names = sorted(os.listdir(render_dir))
    ids = T.multiview_ids(view_num, tour, mutation)
    if len(names) <= int(ids.max()):
        raise SystemExit(f"--render_dir has {len(names)} files; the view_num={view_num}/"
                         f"tour={tour} ring needs {int(ids.max()) + 1}")
    renders = []
    for i in ids:
        im = T.load_rgb(os.path.join(render_dir, names[int(i)]))
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        renders.append(T.to_float_array(im))
    return np.stack(renders)[None].astype(np.float32)


def int8_tree(opt, model, arr: np.ndarray, shape: np.ndarray | None, device) -> dict:
    """The quantized tree of the int8 serving forward: read from
    --load_quantized or calibrated on the request itself (JAX's), written
    to --save_quantized if asked."""
    if shape is None:
        q = (serving.load_quantized(opt.load_quantized, device) if opt.load_quantized
             else serving.quantize_student(model, [arr]))
    elif opt.load_quantized:
        q = serving.load_quantized_teacher(opt.load_quantized, device)
        if ("img" in q) != (opt.shape == "MultiView"):
            raise SystemExit(f"{opt.load_quantized}: a quantized "
                             f"{'MultiView' if 'img' in q else 'PointCloud'} teacher, not a "
                             f"{opt.shape} one")
    elif opt.shape == "MultiView":
        q = serving.quantize_teacher_mv(model, [arr], [shape])
    else:
        q = serving.quantize_teacher_resnet(model, [arr])
    if opt.save_quantized:
        serving.save_quantized(q, opt.save_quantized)
        print(f"quantized {'student' if shape is None else opt.shape + ' teacher'} saved to "
              f"{opt.save_quantized}")
    return q


def export(opt, model, q: dict | None, shape: np.ndarray | None) -> None:
    """Write the served model (`model`, or the int8 tree `q` where --int8)
    as an exported artifact to --export_aot."""
    image = (opt.input_dim, opt.input_dim, 3)
    if shape is None:
        fn = (aot.student_int8_decode_fn(q, opt.bin_size) if q is not None
              else aot.student_decode_fn(model, opt.bin_size))
        kind, shapes = "student", (image,)
    else:
        fn = (aot.teacher_int8_decode_fn(model, q, opt.bin_size) if q is not None
              else aot.teacher_decode_fn(model, opt.bin_size))
        kind, shapes = opt.shape, (image, shape.shape[1:])
    aot.save_serving(aot.export_fn(fn, shapes), opt.export_aot, kind=kind,
                     dtype="int8" if opt.int8 else "bf16" if opt.bf16 else "f32",
                     tour=opt.tour if kind == "MultiView" else None)
    print(f"AOT serving artifact saved to {opt.export_aot}")


def serve_artifact(opt, device) -> np.ndarray:
    """The prediction of the --load_aot artifact for the request, its
    preprocessing taken from the artifact's geometry."""
    try:
        artifact = aot.load_serving(opt.load_aot, device)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    inputs = [prep_image(opt.img_path, artifact.input_dim)]
    if artifact.n_inputs == 2:
        shape_in = artifact.in_shapes[1]
        if len(shape_in) == 2:  # (P, 3): the PointCloud teacher
            if not opt.ply_path:
                raise SystemExit("this AOT artifact is a PointCloud teacher (image + "
                                 "cloud) — pass --ply_path")  # JAX's
            inputs.append(sample_cloud(opt.ply_path, shape_in[0]))
        elif len(shape_in) == 4:  # (K, h, w, 3): the MultiView teacher
            if not opt.render_dir:
                raise SystemExit("this AOT artifact is a MultiView teacher (image + "
                                 "render ring) — pass --render_dir")  # JAX's
            inputs.append(load_renders(opt.render_dir, shape_in[0], artifact.tour,
                                       opt.mutation, shape_in[1]))
        else:
            raise SystemExit(f"unrecognized teacher artifact: second input shape {shape_in}")
    return artifact(*inputs)[0].cpu().numpy()


def main(argv=None):
    opt = parse_args(argv)
    device = common.setup_device(opt)
    if opt.load_aot:
        return report(serve_artifact(opt, device))
    arr = prep_image(opt.img_path, opt.input_dim)
    im = torch.from_numpy(arr).to(device)
    shape = None
    if opt.ply_path or opt.render_dir:
        # the teacher's image feature is 1024 unless set: the student's
        # default 2048 does not carry over (as in JAX)
        opt.shape = "MultiView" if opt.render_dir else "PointCloud"
        model = common.build_teacher(opt, opt.ckpt, device, img_feature_dim=(
            opt.img_feature_dim if opt.img_feature_dim != 2048 else 1024))
        if opt.render_dir:
            shape = load_renders(opt.render_dir, opt.view_num, opt.tour, opt.mutation,
                                 opt.input_dim)
        else:
            shape = sample_cloud(opt.ply_path, opt.point_num)
    else:
        model = common.build_student(opt, opt.ckpt, device)
    q = int8_tree(opt, model, arr, shape, device) if opt.int8 else None
    if opt.export_aot:
        export(opt, model, q, shape)
    if q is not None:
        outputs = (serving.student_int8_infer(q, im) if shape is None  # bf16, JAX's default
                   else serving.make_teacher_int8_infer(model)(
                       q, im, torch.from_numpy(shape).to(device)))
        outputs = [o.float() for o in outputs]
        vp = geometry.decode_predictions_inference(outputs[:3], outputs[3:],
                                                   opt.bin_size)[0].cpu().numpy()
    elif shape is None:
        vp = model.predict_viewpoint(im)[0].cpu().numpy()
    else:
        vp = model.predict_viewpoint(im, torch.from_numpy(shape).to(device))[0].cpu().numpy()
    return report(vp)


def report(vp: np.ndarray) -> np.ndarray:
    """Print the prediction in the annotation convention and return it."""
    vp = vp.copy()
    vp[1] -= 90.0
    vp[2] -= 180.0
    print("pred_azi=%.2f pred_ele=%.2f pred_inp=%.2f" % tuple(vp))
    return vp


if __name__ == "__main__":
    main()
