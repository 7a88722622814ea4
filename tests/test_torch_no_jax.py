"""The port stands alone: it imports no JAX, takes its plain versions only for
CPU tensors, and never moves to the CPU unasked."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.cli import inference, testing, training, trainingKD
from pose3d_tpu_torch.ops import geodesic, int8_conv, pointnet, vgg_stem
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import pkgutil, sys
import pose3d_tpu_torch
for m in pkgutil.walk_packages(pose3d_tpu_torch.__path__, "pose3d_tpu_torch."):
    __import__(m.name)
banned = {"jax", "jaxlib", "flax", "optax", "orbax", "pose3d_tpu"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not loaded, loaded
serving = {"pose3d_tpu_torch.serving", "pose3d_tpu_torch.serving.quant_student",
           "pose3d_tpu_torch.serving.quant_teacher", "pose3d_tpu_torch.serving.aot",
           "pose3d_tpu_torch.ops.int8_conv"}
assert serving <= set(sys.modules), serving - set(sys.modules)
print(len([m for m in sys.modules if m.startswith("pose3d_tpu_torch")]))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    # every module: data (PLY reader included), models (ResNet, PointNet,
    # DeformNet), the kernels' wrappers (the VGG stem's and the int8
    # convolution's included), losses (KD's included), CLIs (KD training's
    # included) and serving (the int8 student and teachers)
    assert int(proc.stdout) >= 37


def test_geodesic_on_cpu_takes_the_plain_version(rng):
    preds = torch.from_numpy(rng.uniform(0, 360, (50, 3)).astype("float32"))
    labels = torch.from_numpy(rng.integers(0, 180, (50, 3)).astype("float32"))
    before = geodesic.rotation_err.launches
    out = geodesic.rotation_err(preds, labels)
    assert geodesic.rotation_err.launches == before
    assert torch.equal(out, geometry.rotation_err(preds, labels))


@pytest.mark.parametrize("cli", ["testing", "inference", "testing_teacher",
                                 "inference_teacher"])
def test_cli_default_device_refuses_without_cuda(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        if cli.startswith("testing"):
            testing.main(["--dataset", "ObjectNet3D", "--data_root", str(tmp_path),
                          "--shape", "None" if cli == "testing" else "PointCloud"])
        else:
            inference.main(["--ckpt", str(tmp_path / "s.pth"),
                            "--img_path", str(tmp_path / "x.jpg")]
                           + (["--ply_path", "p.ply"] if cli != "inference" else []))


@pytest.mark.parametrize("argv", [
    ["--shape", "MultiView"], ["--shape", "None", "--bf16"],
    ["--shape", "None", "--int8"], ["--shape", "None", "--device_shapes"],
    ["--shape", "None", "--n_devices", "2"], ["--shape", "PointCloud", "--device_shapes"],
    ["--shape", "PointCloud", "--device_shapes", "--int8"]])
def test_testing_cli_refuses_unported_modes(argv):
    """Refused, naming ROADMAP.md; --bf16, --int8, the MultiView teacher and
    the teacher's --device_shapes are ported: parsed; --device_shapes for
    the student and with --int8 are refused with JAX's messages."""
    flags = ["--dataset", "ObjectNet3D", "--device", "cpu"]
    jax_refusals = {("--shape", "None", "--device_shapes"): "applies to teacher eval",
                    ("--shape", "PointCloud", "--device_shapes", "--int8"):
                        "not combinable with --int8"}
    if tuple(argv) in jax_refusals:
        with pytest.raises(SystemExit, match=jax_refusals[tuple(argv)]):
            testing.main(flags + argv)
        return
    if argv == ["--shape", "PointCloud", "--device_shapes"]:
        assert testing.parse_args(flags + argv).device_shapes
        return
    if "--bf16" in argv:
        assert testing.parse_args(flags + argv).bf16
        return
    if "--int8" in argv:
        assert testing.parse_args(flags + argv).int8
        return
    if argv == ["--shape", "MultiView"]:
        assert testing.parse_args(flags + argv).shape == "MultiView"
        return
    with pytest.raises(SystemExit, match="ROADMAP"):
        testing.main(flags + argv)


@pytest.mark.parametrize("argv", [["--bf16"], ["--int8"], ["--load_aot", "a"],
                                  ["--render_dir", "r"], ["--export_aot", "a"]])
def test_inference_cli_refuses_unported_modes(argv):
    """Every mode of JAX's inference CLI is ported: --bf16, --int8,
    --render_dir (the MultiView teacher), --export_aot and --load_aot (the
    exported artifacts; --load_aot without --ckpt) are parsed."""
    flags = ["--ckpt", "s.pth", "--img_path", "x.jpg", "--device", "cpu"]
    if argv[0] == "--load_aot":
        flags = flags[2:]
    opt = inference.parse_args(flags + argv)
    assert getattr(opt, argv[0][2:]) == (argv[1] if len(argv) == 2 else True)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = _run(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("argv", [["--shape", "PointCloud", "--bf16"],
                                  ["--shape", "PointCloud", "--int8"],
                                  ["--shape", "PointCloud", "--n_devices", "2"]])
def test_testing_cli_refuses_unported_teacher_modes(argv):
    """Refused, naming ROADMAP.md; --bf16 and --int8 are ported: parsed."""
    flags = ["--dataset", "ObjectNet3D", "--device", "cpu"]
    if "--bf16" in argv:
        assert testing.parse_args(flags + argv).bf16
        return
    if "--int8" in argv:
        assert testing.parse_args(flags + argv).int8
        return
    with pytest.raises(SystemExit, match="ROADMAP"):
        testing.main(flags + argv)


@pytest.mark.parametrize("argv", [["--int8"], ["--render_dir", "r"],
                                  ["--export_aot", "a"]])
def test_inference_cli_refuses_unported_teacher_modes(argv):
    """--render_dir beside --ply_path is refused with JAX's message (the
    two teachers exclude each other); --int8 and --export_aot are ported:
    parsed."""
    flags = ["--ckpt", "t.pth", "--img_path", "x.jpg", "--ply_path", "p.ply", "--device", "cpu"]
    if argv == ["--int8"]:
        assert inference.parse_args(flags + argv).int8
        return
    if argv == ["--export_aot", "a"]:
        assert inference.parse_args(flags + argv).export_aot == "a"
        return
    with pytest.raises(SystemExit, match="mutually exclusive"):
        inference.main(flags + argv)


def test_pointnet_on_cpu_takes_the_plain_version(rng):
    folded = [(torch.from_numpy(rng.standard_normal((i, o)).astype("float32")),
               torch.from_numpy(rng.standard_normal(o).astype("float32")))
              for i, o in ((3, 64), (64, 128), (128, 16))]
    pts = torch.from_numpy(rng.uniform(0, 1, (3, 40, 3)).astype("float32"))
    before = pointnet.pointnet_eval.launches
    out = pointnet.pointnet_eval(pts, folded)
    assert pointnet.pointnet_eval.launches == before
    assert torch.equal(out, pointnet.pointnet_eval_plain(pts, folded))


def test_training_cli_default_device_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        training.main(["--dataset", "ObjectNet3D", "--shape", "PointCloud",
                       "--data_root", str(tmp_path)])


@pytest.mark.parametrize("argv", [
    ["--shape", "None"], ["--shape", "MultiView"], ["--dataset", "ShapeNetCore"],
    ["--dataset", "Pix3D"], ["--bf16"], ["--device_shapes"], ["--device_augment"],
    ["--nce", "pose"], ["--nce", "multipose"], ["--weighting", "sqrt"],
    ["--loader", "shm"], ["--n_devices", "2"], ["--cache_decoded_mb", "64"],
    ["--profile_dir", "trace"], ["--model", "teacher.pth"],
    ["--shape", "None", "--nce", "pose"], ["--shape", "None", "--fused_nce"],
    ["--student_width_mult", "0.5"], ["--shape", "MultiView", "--device_shapes"],
    ["--shape", "None", "--device_shapes"], ["--shape", "None", "--device_augment"],
    ["--dataset", "Pascal3D", "--device_augment"]])
def test_training_cli_refuses_unported_flags(argv):
    """Each flag of a path not ported is refused, naming ROADMAP.md; --shape
    None, --shape MultiView, --nce pose/multipose, --bf16, --device_shapes,
    --device_augment and the host data options (--loader shm,
    --cache_decoded_mb, --profile_dir) are ported (parsed), and where JAX refuses a
    combination the port refuses it with JAX's message, or, where JAX's run
    fails on it (a teacher on ShapeNetCore, validated on Pix3D's shapeless
    samples) or gives a wrong result (--device_augment where the train set
    has no raw emission or the step no augmentation), says why."""
    outcomes = {("--shape", "None"): None, ("--nce", "pose"): None,
                ("--nce", "multipose"): None, ("--bf16",): None,
                ("--shape", "MultiView"): None,
                ("--loader", "shm"): None, ("--cache_decoded_mb", "64"): None,
                ("--profile_dir", "trace"): None,
                ("--dataset", "ShapeNetCore"): "Pix3D, whose samples carry no shape",
                ("--dataset", "Pix3D"): "unsupported training dataset Pix3D",
                ("--weighting", "sqrt"): "--weighting is consumed only by --nce pose",
                ("--shape", "None", "--nce", "pose"): "applies to teacher training",
                ("--device_shapes",): None, ("--device_augment",): None,
                ("--shape", "MultiView", "--device_shapes"): None,
                ("--shape", "None", "--device_shapes"): "requires --shape PointCloud",
                ("--shape", "None", "--device_augment"): "takes no device augmentation",
                ("--dataset", "Pascal3D", "--device_augment"): "no raw-pixel emission"}
    flags = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--device", "cpu"]
    expected = outcomes.get(tuple(argv), "ROADMAP")
    if expected is None:
        training.parse_args(flags + argv)
    else:
        with pytest.raises(SystemExit, match=expected):
            training.main(flags + argv)


def test_vgg_stem_on_cpu_takes_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 12, 12)).astype("float32"))
    w = torch.from_numpy(rng.standard_normal((16, 3, 3, 3)).astype("float32"))
    b = torch.from_numpy(rng.standard_normal(16).astype("float32"))
    before = vgg_stem.stem_forward.launches
    out = vgg_stem.vgg_stem(x, w, b)
    assert vgg_stem.stem_forward.launches == before
    assert torch.equal(out, vgg_stem.vgg_stem_plain(x, w, b))


def test_kd_cli_default_device_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        trainingKD.main(["--crd", "--dataset", "ObjectNet3D", "--shape", "PointCloud",
                         "--data_root", str(tmp_path)])


def test_int8_conv_on_cpu_takes_the_plain_version(rng):
    """The int8 serving path's wrapper: the plain version for a CPU tensor,
    no launch counted."""
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 16)).astype("float32"))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 16, 8)).astype("int8"))
    a, ws, shift = torch.tensor(0.02), torch.full((8,), 1e-3), torch.zeros(8)
    before = int8_conv.int8_conv.launches
    out = int8_conv.int8_conv(x, a, w, ws, shift, 2, 1, relu=True)
    assert int8_conv.int8_conv.launches == before
    assert torch.equal(out, int8_conv.int8_conv_plain(x, a, w, ws, shift, 2, 1, relu=True))


_SERVE_ALONE = """
import sys
import numpy as np
from pose3d_tpu_torch.serving import aot
art = aot.load_serving(sys.argv[1])
out = art(np.zeros((3,) + art.in_shapes[0], np.float32))
assert tuple(out.shape) == (3, 3), out.shape
banned = {"jax", "jaxlib", "flax", "optax", "orbax", "pose3d_tpu"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned
                or m.startswith("pose3d_tpu_torch.models"))
assert not loaded, loaded
"""


def test_serving_artifact_loads_without_jax_or_the_models(tmp_path):
    """`serving.aot` alone serves a saved artifact: no JAX module and no
    `pose3d_tpu_torch.models` module is loaded (the ops are)."""
    from pose3d_tpu_torch.models.estimators import BaselineEstimator
    from pose3d_tpu_torch.serving import aot

    model = BaselineEstimator(img_feature_dim=16, width_mult=0.125, input_dim=32,
                              generator=torch.Generator().manual_seed(0)).eval()
    path = str(tmp_path / "student.pt2")
    aot.save_serving(aot.export_serving(aot.student_decode_fn(model, 15), 32), path,
                     kind="student", dtype="f32")
    proc = _run(["-c", _SERVE_ALONE, path], REPO)
    os.remove(path)
    assert proc.returncode == 0, proc.stderr
