"""Exported serving (`pose3d_tpu_torch/serving/aot.py`, the inference CLI's
`--export_aot` / `--load_aot`) for the student, on the CPU: its artifact in
f32, bf16 and int8 against the eager port and against JAX's
(`pose3d_tpu/serving/aot.py`), the CLI's round trips and refusals, and each
custom op's fake against its CPU kernel (tests/torch_aot_cases.py says what
the checks hold; the teachers' artifacts are held in
test_torch_aot_pointcloud.py and test_torch_aot_multiview.py).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image
from torch._subclasses.fake_tensor import FakeTensorMode

from pose3d_tpu.serving import aot as jaot
from pose3d_tpu_torch.cli import inference
from pose3d_tpu_torch.ops import int8_conv, pointnet, vgg_stem
from pose3d_tpu_torch.serving import aot
import torch_aot_cases as cases
from torch_aot_cases import artifact  # noqa: F401  (the module's artifacts, a fixture)
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

FAMILY = "student"


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_artifact_serves_any_batch_as_the_eager_port(artifact, dtype):
    cases.check_against_eager(FAMILY, dtype, *artifact(dtype))


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_artifact_matches_jax(artifact, dtype, tmp_path):
    cases.check_against_jax(FAMILY, dtype, artifact(dtype)[0], tmp_path)


@pytest.mark.parametrize("extra", [[], ["--int8"]])
def test_inference_cli_export_then_load(extra, tmp_path):
    cases.check_cli(FAMILY, extra, cases.cli_files(FAMILY, tmp_path))


class _Echo(torch.nn.Module):
    """A stand-in with a teacher's two inputs, for the CLI's refusals."""

    def forward(self, x, shape):
        return x[:, 0, 0, :] + shape.reshape(shape.shape[0], -1)[:, :3]


@pytest.mark.parametrize("case", ["cloud artifact without --ply_path",
                                  "render artifact with --ply_path", "JAX artifact",
                                  "program without the geometry", "cuda without a card"])
def test_inference_cli_load_aot_refusals(case, tmp_path):
    """JAX's messages where the teacher flag is missing; a file that is not
    the port's artifact names the format; --device cuda needs a card."""
    Image.fromarray(np.zeros((8, 8, 3), dtype=np.uint8)).save(tmp_path / "im.png")
    path = str(tmp_path / "a.pt2")
    argv = ["--img_path", str(tmp_path / "im.png"), "--load_aot", path, "--device", "cpu"]
    shapes = {"cloud artifact without --ply_path": ((8, 8, 3), (5, 3)),
              "render artifact with --ply_path": ((8, 8, 3), (2, 4, 4, 3))}.get(
                  case, ((8, 8, 3), (5, 3)))
    program = aot.export_fn(_Echo(), shapes, device="cpu")
    if case == "JAX artifact":
        jaot.save_serving(jaot.export_serving(lambda x: x[:, 0, 0, :], 8, platforms=("cpu",)),
                          path)
        match = "not a pose3d_tpu_torch serving artifact"
    elif case == "program without the geometry":
        torch.export.save(program, path)
        match = "without pose3d_serving.json"
    else:
        aot.save_serving(program, path, kind="teacher", dtype="f32")
        match = {"cloud artifact without --ply_path": "pass --ply_path",
                 "render artifact with --ply_path": "pass --render_dir",
                 "cuda without a card": "no CUDA device"}[case]
    if case == "render artifact with --ply_path":
        argv += ["--ply_path", "/nonexistent.ply"]
    if case == "cuda without a card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        argv[-1] = "cuda"
    with pytest.raises(SystemExit, match=match):
        inference.main(argv)


def test_artifact_records_its_geometry(tmp_path):
    """The extra file holds the kind, the dtype, the per-sample shapes and
    the tour; the batch runs from 1 to MAX_ROWS over the renders a sample."""
    path = str(tmp_path / "a.pt2")
    aot.save_serving(aot.export_fn(_Echo(), ((8, 8, 3), (2, 4, 4, 3)), device="cpu"), path,
                     kind="MultiView", dtype="bf16", tour=1)
    extra = {aot.META: ""}
    torch.export.load(path, extra_files=extra)
    assert json.loads(extra[aot.META]) == {"kind": "MultiView", "dtype": "bf16", "tour": 1,
                                           "in_shapes": [[8, 8, 3], [2, 4, 4, 3]]}
    art = aot.load_serving(path)
    assert [(int(r.lower), int(r.upper)) for r in art.program.range_constraints.values()] == \
        [(1, aot.MAX_ROWS // 2)]
    assert art(np.ones((1, 8, 8, 3)), np.ones((1, 2, 4, 4, 3))).shape == (1, 3)


# --- the custom ops' fakes ----------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(9)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = t(3, 10, 12, 3)
    folded = [(t(3, 64), t(64)), (t(64, 128), t(128)), (t(128, 24), t(24))]
    state = {f"conv{i}.weight": t(o, n, 1) for i, (n, o) in enumerate(((3, 64), (64, 128),
                                                                       (128, 24)), 1)}
    for i, o in enumerate((64, 128, 24), 1):
        state.update({f"conv{i}.bias": t(o), f"bn{i}.weight": t(o), f"bn{i}.bias": t(o),
                      f"bn{i}.running_mean": t(o), f"bn{i}.running_var": t(o).abs() + 0.5})
    layers = pointnet.eval_layers_bf16(state)
    w8 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 16, 8)).astype(np.int8))
    i8 = (torch.tensor(0.02), w8, torch.full((8,), 1e-3), t(8))
    return {
        "stem f32, channels-last view": (vgg_stem.vgg_stem_serve,
                                         (x.permute(0, 3, 1, 2), t(16, 3, 3, 3), t(16))),
        "stem f32, NCHW": (vgg_stem.vgg_stem_serve,
                           (t(2, 3, 9, 8), t(8, 3, 3, 3), t(8))),
        "stem bf16": (vgg_stem.vgg_stem_serve,
                      tuple(a.to(torch.bfloat16) for a in (x.permute(0, 3, 1, 2),
                                                            t(16, 3, 3, 3), t(16)))),
        "pointnet f32": (pointnet.pointnet_eval_op,
                         (t(2, 50, 3), [a for pair in folded for a in pair])),
        "pointnet bf16": (pointnet.pointnet_eval_bf16_op,
                          (t(2, 50, 3).to(torch.bfloat16), [a for lay in layers for a in lay])),
        "int8 conv f32": (int8_conv.int8_conv_op, (t(2, 7, 6, 16), *i8, 2, 1, True)),
        "int8 conv bf16": (int8_conv.int8_conv_op,
                           (t(2, 6, 6, 16).to(torch.bfloat16), *i8, 1, 1, False)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_custom_op_fake_matches_its_cpu_kernel(case):
    op, args = _op_cases()[case]
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                    [mode.from_tensor(b) for b in a] if isinstance(a, list) else a
                    for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
