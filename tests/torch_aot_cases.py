"""Shared cases of the exported-serving tests (tests/test_torch_aot*.py):
the models, the inputs, the int8 trees, the artifacts and the checks, one
file of tests a family so that each module stays short on one xdist worker.

Small sizes, as tests/test_torch_int8.py sizes them: the student at width
1/8 on 64x64 images (feature 64), the teachers at 32x32 (features 64; the
MultiView teacher 16 over 4 renders), 64-point clouds. Weights are
chip_smoke.py's seeded numpy trees carried into the port by
`train/convert.py`; the int8 trees are JAX's own, written by JAX's
`save_quantized` and read by the port.

What the checks hold:
  * `check_against_eager`: an artifact of the family and dtype, exported,
    saved and loaded, serves batch 1, 3 and 5 from one file bit-equal to
    the eager port (the graph runs the same ops; the stem, the eval
    PointNet and the int8 convolution as the port's custom ops, whose CPU
    kernels are the plain versions), and its graph holds those ops;
  * `check_against_jax`: the port's artifact against JAX's artifact of the
    same weights, in f32 within 1e-5 of max|ref|, in bf16 by the oracle
    rule against JAX's f64 decode (tests/torch_bf16_rules.py); int8 against
    JAX's int8 forward run op by op (jitted, XLA fuses the dequantization
    into an FMA: tests/test_torch_int8_kd.py), within 1e-5 (the f32
    teachers) and 2^-6 (the bf16 student) of max|ref|, test_torch_int8.py's
    rules;
  * `check_cli`: --export_aot then --load_aot with no --ckpt and no
    geometry flags give the same prediction.
"""

import functools
import importlib.util
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pose3d_tpu import geometry as jgeometry
from pose3d_tpu.data import ply as jply
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.serving import aot as jaot
from pose3d_tpu.serving import quant_student as jqs
from pose3d_tpu.serving import quant_teacher as jqt
from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.cli import inference
from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
from pose3d_tpu_torch.serving import aot
from pose3d_tpu_torch.serving import quant_student as pqs
from pose3d_tpu_torch.serving import quant_teacher as pqt
from pose3d_tpu_torch.train import convert
from torch_bf16_rules import oracle

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

STUDENT_DIM, WIDTH_MULT, STUDENT_SIZE = 64, 0.125, 64
TEACHER_DIM, MV_DIM, MV_VIEWS, TEACHER_SIZE, POINTS = 64, 16, 4, 32, 64
BIN = 15
F32_REL, BF16_REL = 1e-5, 2.0 ** -6
FAMILIES = ("student", "PointCloud", "MultiView")
DTYPES = ("f32", "bf16", "int8")
SHAPES = {"student": ((STUDENT_SIZE, STUDENT_SIZE, 3),),
          "PointCloud": ((TEACHER_SIZE, TEACHER_SIZE, 3), (POINTS, 3)),
          "MultiView": ((TEACHER_SIZE, TEACHER_SIZE, 3),
                        (MV_VIEWS, TEACHER_SIZE, TEACHER_SIZE, 3))}
# the custom ops each artifact's graph must hold
OPS = {("student", "f32"): {"vgg_stem_serve"}, ("student", "bf16"): {"vgg_stem_serve"},
       ("student", "int8"): {"vgg_stem_serve", "int8_conv", "int8_conv_pool"},
       ("PointCloud", "f32"): {"pointnet_eval"}, ("PointCloud", "bf16"): {"pointnet_eval_bf16"},
       ("PointCloud", "int8"): {"pointnet_eval", "int8_conv"},
       ("MultiView", "f32"): set(), ("MultiView", "bf16"): set(),
       ("MultiView", "int8"): {"int8_conv"}}


def _inputs(family, batch, seed):
    rng = np.random.default_rng(seed)
    size = SHAPES[family][0][0]
    out = [rng.standard_normal((batch, size, size, 3)).astype(np.float32)]
    if family != "student":
        out.append(rng.uniform(0, 1, (batch,) + SHAPES[family][1]).astype(np.float32))
    return out


@functools.cache
def _variables(family):
    if family == "student":
        return chip_smoke.student_variables(np.random.default_rng(7), STUDENT_DIM, WIDTH_MULT,
                                            STUDENT_SIZE)
    if family == "MultiView":
        return chip_smoke.teacher_variables(np.random.default_rng(21), TEACHER_DIM, MV_DIM,
                                            view_num=MV_VIEWS)
    return chip_smoke.teacher_variables(np.random.default_rng(20), TEACHER_DIM, TEACHER_DIM)


def _port_model(family, dtype):
    cd = torch.bfloat16 if dtype == "bf16" else None
    if family == "student":
        model = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                  input_dim=STUDENT_SIZE, compute_dtype=cd)
        model.load_state_dict(convert.baseline_state_dict(_variables(family)), strict=True)
        return model.eval()
    model = PoseEstimator(shape=family, view_num=MV_VIEWS, img_feature_dim=TEACHER_DIM,
                          shape_feature_dim=MV_DIM if family == "MultiView" else TEACHER_DIM,
                          compute_dtype=cd)
    model.load_state_dict(convert.pose_state_dict(_variables(family), family), strict=True)
    return model.eval()


def _jax_model(family, dtype):
    if family == "student":
        return JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                    dtype=dtype)
    return JaxPoseEstimator(shape=family, view_num=MV_VIEWS, img_feature_dim=TEACHER_DIM,
                            shape_feature_dim=MV_DIM if family == "MultiView" else TEACHER_DIM,
                            dtype=dtype)


@functools.cache
def _jax_q(family):
    """JAX's int8 tree, calibrated on the serving inputs of batch 3."""
    variables, ins = _variables(family), _inputs(family, 3, 3)
    if family == "student":
        return jqs.quantize_student(variables, [ins[0]])
    if family == "MultiView":
        return jqt.quantize_teacher_mv(variables, [ins[0]], [ins[1]])
    return jqt.quantize_teacher_resnet(variables, [ins[0]])


def release():
    """Free the cached weights and int8 trees (at a module's end)."""
    _variables.cache_clear()
    _jax_q.cache_clear()


def _port_q(family, tmp_path):
    """JAX's int8 tree through JAX's .npz, read by the port."""
    path = str(tmp_path / "q.npz")
    jqs.save_quantized(_jax_q(family), path)
    return (pqs.load_quantized(path) if family == "student"
            else pqt.load_quantized_teacher(path))


def _port_fn(family, dtype, model, q):
    if dtype == "int8":
        return (aot.student_int8_decode_fn(q, BIN) if family == "student"
                else aot.teacher_int8_decode_fn(model, q, BIN))
    return (aot.student_decode_fn(model, BIN) if family == "student"
            else aot.teacher_decode_fn(model, BIN))


def _eager(family, dtype, model, q, ins):
    """The eager port's prediction: predict_viewpoint, or the int8 forward
    and the inference decoder."""
    ins = [torch.from_numpy(a) for a in ins]
    if dtype != "int8":
        return model.predict_viewpoint(*ins)
    outputs = (pqs.student_int8_infer(q, ins[0]) if family == "student"
               else pqt.make_teacher_int8_infer(model)(q, *ins))
    outputs = [o.float() for o in outputs]
    return geometry.decode_predictions_inference(outputs[:3], outputs[3:], BIN)


def make_artifact(family, dtype, where):
    """(artifact path, port model, int8 tree) of the family and dtype,
    exported and saved under `where`."""
    model = _port_model(family, "f32" if dtype == "int8" else dtype)
    q = _port_q(family, where) if dtype == "int8" else None
    path = str(where / "serving.pt2")
    aot.save_serving(aot.export_fn(_port_fn(family, dtype, model, q), SHAPES[family]), path,
                     kind=family, dtype=dtype, tour=2 if family == "MultiView" else None)
    return path, model, q


@pytest.fixture(scope="module")
def artifact(request, tmp_path_factory):
    """get(dtype) -> (path, port model, int8 tree) of the test module's
    FAMILY, each exported once a module; the cached weights and trees are
    freed at the module's end."""
    made = {}

    def get(dtype):
        if dtype not in made:
            made[dtype] = make_artifact(request.module.FAMILY, dtype,
                                        tmp_path_factory.mktemp(dtype))
        return made[dtype]

    yield get
    release()
    for path, _, _ in made.values():  # 40-270 MB each: a whole run's /tmp is tight
        shutil.rmtree(os.path.dirname(path))


def check_against_eager(family, dtype, path, model, q):
    """One file, batch 1, 3 and 5: bit-equal to the eager port; the graph
    holds the family's custom ops; the geometry rides in the file."""
    art = aot.load_serving(path)
    assert (art.kind, art.dtype, art.n_inputs) == (family, dtype, len(SHAPES[family]))
    assert art.in_shapes == SHAPES[family] and art.input_dim == SHAPES[family][0][0]
    assert art.tour == (2 if family == "MultiView" else None)
    ops = {str(n.target).split(".")[1] for n in art.program.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("pose3d_torch.")}
    assert ops == OPS[family, dtype]
    for batch in (1, 3, 5):
        ins = _inputs(family, batch, batch)
        got = art(*ins)
        want = _eager(family, dtype, model, q, ins)
        assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 3)
        assert torch.equal(got, want), (batch, (got - want).abs().max())



def _jax_artifact(family, dtype, tmp_path):
    """JAX's artifact of the same weights (lowered for the CPU)."""
    variables = _variables(family)
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    model = _jax_model(family, jdtype)
    fn = (jaot.student_decode_fn(model, variables, BIN) if family == "student"
          else jaot.teacher_decode_fn(model, variables, BIN))
    path = str(tmp_path / "jax.aot")
    jaot.save_serving(jaot.export_fn(fn, SHAPES[family], platforms=("cpu",)), path)
    loaded = jaot.load_serving(path)
    os.remove(path)
    return loaded


def _jax_f64(family, ins):
    """JAX's decode of the same weights in f64: the oracle's reference."""
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                           _variables(family))
        model = _jax_model(family, jnp.float64)
        fn = (jaot.student_decode_fn(model, variables, BIN) if family == "student"
              else jaot.teacher_decode_fn(model, variables, BIN))
        return np.asarray(jax.jit(fn)(*(jnp.asarray(a, jnp.float64) for a in ins)))


def _jax_int8(family, ins):
    """JAX's int8 forward run op by op and its inference decoder."""
    q, x = _jax_q(family), jnp.asarray(ins[0])
    if family == "student":
        outputs = jqs.student_int8_infer(q, x)
    else:
        model = _jax_model(family, jnp.float32)
        outputs = jqt.make_teacher_int8_infer(model)(q, _variables(family), x,
                                                     jnp.asarray(ins[1]))
    return np.asarray(jgeometry.decode_predictions_inference(
        tuple(outputs[:3]), tuple(outputs[3:]), BIN))


def check_against_jax(family, dtype, path, tmp_path):
    """The port's artifact against JAX's for the same weights (module
    docstring)."""
    ins = _inputs(family, 3, 3)
    got = aot.load_serving(path)(*ins).numpy()
    if dtype == "bf16":
        oracle(got, np.asarray(_jax_artifact(family, dtype, tmp_path)(*ins)),
               _jax_f64(family, ins), f"{family} bf16 artifact")
        return
    if dtype == "f32":
        want, rel = np.asarray(_jax_artifact(family, dtype, tmp_path)(*ins)), F32_REL
    else:
        want, rel = _jax_int8(family, ins), BF16_REL if family == "student" else F32_REL
    err = np.abs(got - want).max()
    print(f"{family} {dtype}: max|d| {err:.3g} of max|ref| {np.abs(want).max():.3g}")
    assert err <= rel * np.abs(want).max()


def cli_files(family, root):
    """An image, a cloud, a render directory (two 72-step rings) and the
    family's .pth checkpoint at the CLI's small widths, under `root`."""
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 255, (60, 48, 3), dtype=np.uint8)).save(root / "im.png")
    jply.write_ply(str(root / "cloud.ply"), rng.standard_normal((500, 3)).astype(np.float32))
    (root / "crop").mkdir()
    for i in range(144):
        Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)
                        ).save(root / "crop" / f"r{i:03d}.png")
    torch.save(_port_model(family, "f32").state_dict(), root / f"{family}.pth")
    return root


_CLI_FLAGS = {
    "student": ["--img_feature_dim", str(STUDENT_DIM), "--student_width_mult",
                str(WIDTH_MULT), "--input_dim", str(STUDENT_SIZE)],
    "PointCloud": ["--img_feature_dim", str(TEACHER_DIM), "--shape_feature_dim",
                   str(TEACHER_DIM), "--input_dim", str(TEACHER_SIZE), "--point_num",
                   str(POINTS)],
    "MultiView": ["--img_feature_dim", str(TEACHER_DIM), "--shape_feature_dim", str(MV_DIM),
                  "--input_dim", str(TEACHER_SIZE), "--view_num", str(MV_VIEWS)],
}


def _shape_flags(family, root):
    return {"student": [], "PointCloud": ["--ply_path", str(root / "cloud.ply")],
            "MultiView": ["--render_dir", str(root / "crop")]}[family]


def check_cli(family, extra, root):
    """--export_aot then --load_aot with no --ckpt and no geometry flags:
    the same prediction. A tour-1 MultiView artifact is served without
    --tour: the artifact's ring, not the flag's default 2."""
    artifact = str(root / f"{family}{'_'.join(extra)}.pt2")
    base = ["--img_path", str(root / "im.png"), "--device", "cpu",
            *_shape_flags(family, root)]
    live = inference.main(base + ["--ckpt", str(root / f"{family}.pth"), *_CLI_FLAGS[family],
                                  *extra, "--export_aot", artifact])
    served = inference.main(base + ["--load_aot", artifact])
    np.testing.assert_array_equal(served, live)
    if "--tour" in extra:  # the flag's default ring is another prediction
        other = inference.main(base + ["--ckpt", str(root / f"{family}.pth"),
                                       *_CLI_FLAGS[family]])
        assert not np.array_equal(other, live)
    for name in (artifact, root / f"{family}.pth"):
        os.remove(name)
