"""Single-image inference CLI, student path. Port of
`pose3d_tpu/cli/inference.py` without the teacher modes.

Loads a student checkpoint (a reference-layout .pth), resize-pads the image
to --input_dim, normalizes it, runs the inference decoder ((bin + raw delta)
* bin_size, clamped to [0, 360]) and converts the result back to the
annotation convention (ele -= 90, inp -= 180). The teacher modes
(`--ply_path`, `--render_dir`), `--int8`, the AOT artifacts and `--bf16`
are refused with a message until they are ported (ROADMAP.md).

    python -m pose3d_tpu_torch.cli.inference --ckpt student.pth --img_path img.jpg
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pose3d_tpu_torch.cli import common
from pose3d_tpu_torch.data import transforms as T


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", type=str, default=None,
                        help="student weights: a reference-layout .pth")
    parser.add_argument("--img_path", type=str, required=True)
    common.add_student_flags(parser, img_feature_dim=2048)
    parser.add_argument("--int8", action="store_true",
                        help="not ported yet: refused (ROADMAP.md)")
    for flag in ("export_aot", "load_aot", "ply_path", "render_dir"):
        parser.add_argument(f"--{flag}", type=str, default=None,
                            help="not ported yet: refused (ROADMAP.md)")
    opt = parser.parse_args(argv)
    common.refuse_unported(opt, ("bf16", "int8", "export_aot", "load_aot",
                                 "ply_path", "render_dir"))
    if not opt.ckpt:
        raise SystemExit("--ckpt is required")
    return opt


def prep_image(img_path: str, input_dim: int) -> np.ndarray:
    """Image file -> (1, input_dim, input_dim, 3) normalized float32."""
    im = T.resize_pad(T.load_rgb(img_path), input_dim)
    return T.normalize_image(T.to_float_array(im))[None]


def main(argv=None):
    opt = parse_args(argv)
    device = common.setup_device(opt)
    model = common.build_student(opt, opt.ckpt, device)
    im = torch.from_numpy(prep_image(opt.img_path, opt.input_dim)).to(device)
    vp = model.predict_viewpoint(im)[0].cpu().numpy()
    # back to annotation convention
    vp[1] -= 90.0
    vp[2] -= 180.0
    print("pred_azi=%.2f pred_ele=%.2f pred_inp=%.2f" % tuple(vp))
    return vp


if __name__ == "__main__":
    main()
