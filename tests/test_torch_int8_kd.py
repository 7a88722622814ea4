"""The port's int8 frozen teacher in KD (`--int8_teacher`) and the int8
paths of the CLIs against the JAX package, on the CPU (the int8 product in
`ops.int8_conv`'s plain version).

One `make_kd_crd_step(..., int8_teacher=True)` (the PointCloud teacher's
ResNet-50 int8) and one `make_stage2_step(..., int8_teacher=True)` (the
vanilla teacher's ResNet-18 int8) against JAX's, both sides fed JAX's
quantized tree (written by JAX's `save_quantized`, read by the port). Sizes
and tolerances are tests/test_torch_stage2.py's: the student at width_mult
0.25, input 32, feature 64, no dropout, in f64 on both sides (JAX under
`jax.enable_x64`); the frozen teacher in f32 with its conv trunk int8
(tests/test_torch_int8.py holds its s8 activations equal to JAX's); the
losses in f32. Losses within 1e-5 relative, each student gradient within
1e-3 of its max|ref|, running statistics within 1e-5.

Then the CLIs on the synthetic fixture: `testing --int8` (student and
PointCloud teacher), `inference --int8 --save_quantized` then
`--load_quantized` (the same prediction; the artifact loads in JAX's
loaders), `trainingKD --crd --int8_teacher` and `--stage 2 --int8_teacher`
one epoch each, and JAX's refusals.
"""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pose3d_tpu.data import synthetic
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.serving import quant_student as jqs
from pose3d_tpu.serving import quant_teacher as jqt
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu.train.torch_export import save_torch_checkpoint
from pose3d_tpu_torch.cli import inference, testing, trainingKD
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.ops import int8_conv
from pose3d_tpu_torch.serving import quant_teacher as pqt
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

STUDENT_DIM, WIDTH_MULT, INPUT_DIM = 64, 0.25, 32
TEACHER_DIM, POINT_NUM, BATCH = 64, 100, 4
LR = 1e-4
CATS = ("bed", "bookshelf", "calculator")


def _step_inputs():
    rng = np.random.default_rng(31)
    batch = {}
    for view in ("", "_flip", "_rot"):
        batch["im" + view] = rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3))
        batch["label" + view] = chip_smoke.random_labels(rng, BATCH)
    extent = rng.uniform(0.2, 1.0, (BATCH, 1, 3))
    batch["shape"] = (rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) * extent).astype(np.float32)
    batch["valid"] = np.arange(BATCH) < BATCH - 1
    return batch


def _teacher_variables(kind):
    make = chip_smoke.vanilla_variables if kind == "stage2" else chip_smoke.teacher_variables
    return make(np.random.default_rng(12), TEACHER_DIM, TEACHER_DIM)


def _calibration():
    return [np.random.default_rng(13).standard_normal(
        (8, INPUT_DIM, INPUT_DIM, 3)).astype(np.float32)]


def _eager_teacher(kind, q8, tvars, batch):
    """JAX's int8 teacher forward run op by op on the step's views: the
    outputs JAX's step takes from its teacher, at the rounding points its
    code writes. Jitted inside the step, XLA contracts each dequantization
    `z * (a * s) + h` into a fused multiply-add (1 float32 ulp on about a
    quarter of the outputs, which flips s8 steps downstream: the heads move
    by 0.4 %, the projector by 2.5 %; test_jax_jit_fuses_the_dequantization);
    the port keeps the two roundings, as the op-by-op run does."""
    im = np.concatenate([batch["im"], batch["im_flip"], batch["im_rot"]]).astype(np.float32)
    if kind == "stage2":
        teacher = JaxPoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                          shape_feature_dim=TEACHER_DIM)
        return jqt.make_vanilla_int8_kd_fwd(teacher)(q8, tvars, jnp.asarray(im),
                                                     jnp.asarray(batch["shape"]), 3)
    teacher = JaxPoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
    return jqt.make_teacher_int8_kd_fwd(teacher)(q8, tvars, jnp.asarray(im),
                                                 jnp.asarray(batch["shape"]), 3)


@functools.cache
def _jax_step(kind):
    """JAX's step with `int8_teacher=True` on the student in f64 and the
    teacher in f32 (its tree from JAX's quantize_teacher_resnet /
    quantize_teacher_vanilla), its teacher's outputs those of JAX's int8
    forward run op by op (`_eager_teacher`), plain SGD at lr 1 as the
    update, so that the step's gradient is the parameters' change."""
    svars = chip_smoke.student_variables(np.random.default_rng(11), STUDENT_DIM, WIDTH_MULT,
                                         INPUT_DIM)
    tvars = _teacher_variables(kind)
    q8 = (jqt.quantize_teacher_vanilla(tvars, _calibration()) if kind == "stage2"
          else jqt.quantize_teacher_resnet(tvars, _calibration()))
    batch = _step_inputs()
    eager = _eager_teacher(kind, q8, tvars, batch)
    name = "make_vanilla_int8_kd_fwd" if kind == "stage2" else "make_teacher_int8_kd_fwd"
    original = getattr(jqt, name)
    setattr(jqt, name, lambda teacher: lambda *args, **kw: eager)
    try:
        return _jax_step_with(kind, svars, tvars, q8, batch)
    finally:
        setattr(jqt, name, original)


def _jax_step_with(kind, svars, tvars, q8, batch):
    with jax.enable_x64(True):
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=jnp.float64)
        f64 = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        params, tx = f64(svars["params"]), optax.sgd(1.0)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=f64(svars["batch_stats"]),
                                  opt_state=tx.init(params), rng=jax.random.key(0), tx=tx)
        if kind == "stage2":
            teacher = JaxPoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                              shape_feature_dim=TEACHER_DIM)
            step = jsteps.make_stage2_step(student, teacher, 15, 2.0, int8_teacher=True)
        else:
            teacher = JaxPoseEstimator(img_feature_dim=TEACHER_DIM,
                                       shape_feature_dim=TEACHER_DIM)
            step = jsteps.make_kd_crd_step(student, teacher, 15, 2.0, int8_teacher=True)
        teacher_vars = {"variables": jax.tree_util.tree_map(jnp.asarray, tvars), "q8": q8}
        new_state, metrics = jax.jit(step)(state, teacher_vars,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params,
                                       new_state.params)
        new_stats = jax.device_get(new_state.batch_stats)
        metrics = {k: float(v) for k, v in metrics.items()}
    return svars, tvars, q8, metrics, grads, new_stats


def _port_teacher(kind, tvars):
    if kind == "stage2":
        teacher = PoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                       shape_feature_dim=TEACHER_DIM)
        teacher.load_state_dict(convert.pose_vanilla_state_dict(tvars), strict=True)
    else:
        teacher = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
        teacher.load_state_dict(convert.pose_state_dict(tvars), strict=True)
    return teacher.requires_grad_(False)


def test_jax_jit_fuses_the_dequantization():
    """The divergence `_eager_teacher` works around: JAX's dequantization
    jitted is not the op-by-op one (a fused multiply-add), and the port's
    plain version is the op-by-op one, bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    w = rng.integers(-127, 128, (3, 3, 64, 32), dtype=np.int8)
    a = np.float32(np.abs(x).max() / 127)
    s = rng.uniform(1e-4, 1e-3, 32).astype(np.float32)
    h = rng.standard_normal(32).astype(np.float32)

    def chain(x, a, w, s, h):
        z = jqt._conv(jqs._quantize_act(x, a), w, (1, 1), ((1, 1), (1, 1)), acc=jnp.int32)
        return z.astype(jnp.float32) * (a * s) + h

    args = (jnp.asarray(x), a, jnp.asarray(w), s, h)
    eager, jitted = np.asarray(chain(*args)), np.asarray(jax.jit(chain)(*args))
    port = int8_conv.int8_conv(torch.from_numpy(x), torch.tensor(a), torch.from_numpy(w),
                               torch.from_numpy(s), torch.from_numpy(h), 1, 1).numpy()
    np.testing.assert_array_equal(port, eager)
    assert not np.array_equal(jitted, eager)
    np.testing.assert_allclose(jitted, eager, rtol=0, atol=4 * np.spacing(np.abs(eager).max()))


@pytest.mark.parametrize("kind", ["crd", "stage2"])
def test_int8_teacher_step_matches_jax(kind, tmp_path):
    svars, tvars, q8, want_metrics, want_grads, want_stats = _jax_step(kind)
    path = str(tmp_path / "q8.npz")
    jqs.save_quantized(q8, path)
    teacher = {"model": _port_teacher(kind, tvars), "q8": pqt.load_quantized_teacher(path)}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _step_inputs().items()}
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    state = create_train_state(student.double(), LR, [100], seed=0)
    before = {k: v.clone() for k, v in teacher["model"].state_dict().items()}
    launches = int8_conv.int8_conv.launches
    step = (steps.make_stage2_step(temperature=2.0, int8_teacher=True) if kind == "stage2"
            else steps.make_kd_crd_step(temperature=2.0, int8_teacher=True))

    metrics = step(state, teacher, batch)

    assert int8_conv.int8_conv.launches == launches  # the CPU takes the plain version
    for key in ("loss", "gt_loss"):
        assert float(metrics[key]) == pytest.approx(want_metrics[key], rel=1e-5), key
    assert float(metrics["acc_rot"]) == pytest.approx(want_metrics["acc_rot"], abs=1e-4)
    want_grads = convert.baseline_state_dict({"params": want_grads,
                                              "batch_stats": svars["batch_stats"]})
    grads = {name: p.grad for name, p in student.named_parameters()}
    largest = max(float(want_grads[k].abs().max()) for k in grads)
    for name, got in grads.items():
        want = want_grads[name].double()
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN,
            # or the projector, which the response KD does not reach
            assert float(got.abs().max()) < 1e-6 * largest, name
        else:
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
    want_state = convert.baseline_state_dict({"params": svars["params"],
                                              "batch_stats": want_stats})
    for name, value in student.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), want_state[name].numpy(), atol=1e-5,
                                       err_msg=name)
    for k, v in teacher["model"].state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.step == 1


def test_int8_teacher_step_differs_from_the_float_teacher():
    """The int8 teacher is an approximation: the step's loss moves off the
    float32 teacher's, by little."""
    svars, tvars, q8, want_metrics, _, _ = _jax_step("crd")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _step_inputs().items()}
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    state = create_train_state(student.double(), LR, [100], seed=0)
    metrics = steps.make_kd_crd_step(temperature=2.0)(state, _port_teacher("crd", tvars), batch)
    assert float(metrics["loss"]) != want_metrics["loss"]
    assert float(metrics["loss"]) == pytest.approx(want_metrics["loss"], rel=0.05)


# --- the CLIs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_int8")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    # reference-layout .pth files ({"state_dict": ...}) of seeded weights
    torch.save({"state_dict": convert.baseline_state_dict(chip_smoke.student_variables(
        np.random.default_rng(3), STUDENT_DIM, WIDTH_MULT, INPUT_DIM))}, root / "student.pth")
    save_torch_checkpoint(str(root / "teacher.pth"), _teacher_variables("crd"), arch="pose")
    save_torch_checkpoint(str(root / "vanilla.pth"), _teacher_variables("stage2"),
                          arch="vanilla")
    return root


STUDENT_FLAGS = ["--input_dim", str(INPUT_DIM), "--img_feature_dim", str(STUDENT_DIM),
                 "--student_width_mult", str(WIDTH_MULT), "--device", "cpu"]
TEACHER_FLAGS = ["--input_dim", str(INPUT_DIM), "--img_feature_dim", str(TEACHER_DIM),
                 "--shape_feature_dim", str(TEACHER_DIM), "--point_num", str(POINT_NUM),
                 "--device", "cpu"]


@pytest.mark.parametrize("kind", ["student", "teacher"])
def test_testing_cli_int8(fixture_dir, kind):
    """testing --int8 evaluates through the int8 forward (calibrated on the
    first batch): finite errors for every category, a log, and other
    predictions than the float model's."""
    flags = ["--dataset", "ObjectNet3D", "--data_root", str(fixture_dir / "data"),
             "--batch_size", "4", "--workers", "0", "--calib_batches", "1"]
    if kind == "student":
        flags += ["--shape", "None", "--model", str(fixture_dir / "student.pth")] + STUDENT_FLAGS
    else:
        flags += ["--shape", "PointCloud", "--shape_dir", "pointcloud", "--model",
                  str(fixture_dir / "teacher.pth")] + TEACHER_FLAGS
    out = fixture_dir / f"preds_{kind}"
    result = testing.main(flags + ["--int8", "--output_dir", str(out)])
    plain = testing.main(flags + ["--output_dir", str(out / "f32")])
    assert set(result.per_category_med) == set(CATS)
    assert np.isfinite(result.errors).all() and np.isfinite(result.val_loss)
    assert result.val_nce_loss == 0.0  # no contrastive loss on the int8 path, as JAX's
    assert not np.array_equal(result.predictions, plain.predictions)
    assert np.abs(result.predictions - plain.predictions).max() < 90.0
    assert "Average for all categories" in (out / "testing_log.txt").read_text()


def _vp(capsys):
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("pred_azi")]
    return line[-1]


@pytest.mark.parametrize("kind", ["student", "teacher"])
def test_inference_cli_int8_save_then_load(fixture_dir, capsys, kind):
    """inference --int8 --save_quantized, then --load_quantized: the same
    prediction; the artifact is JAX's schema (JAX's loader of its kind
    reads it)."""
    img = fixture_dir / "data" / "ObjectNet3D" / "Images" / "bed_val_0.jpg"
    npz = str(fixture_dir / f"{kind}_q.npz")
    if kind == "student":
        flags = ["--ckpt", str(fixture_dir / "student.pth"), "--img_path", str(img)] \
            + STUDENT_FLAGS
    else:
        ply = fixture_dir / "data" / "ObjectNet3D" / "pointcloud" / "bed" / "01" / \
            "compressed.ply"
        flags = ["--ckpt", str(fixture_dir / "teacher.pth"), "--img_path", str(img),
                 "--ply_path", str(ply)] + TEACHER_FLAGS
    saved = inference.main(flags + ["--int8", "--save_quantized", npz])
    first = _vp(capsys)
    loaded = inference.main(flags + ["--int8", "--load_quantized", npz])
    assert _vp(capsys) == first
    np.testing.assert_array_equal(saved, loaded)
    q = (jqs.load_quantized if kind == "student" else jqt.load_quantized_teacher)(npz)
    assert q["convs" if kind == "student" else "blocks"]
    with pytest.raises(SystemExit, match="pass --int8"):
        inference.parse_args(flags + ["--load_quantized", npz])
    if kind == "teacher":  # a student artifact is not a teacher's
        with pytest.raises(ValueError, match="not a teacher int8 artifact"):
            inference.main(flags + ["--int8", "--load_quantized",
                                    str(fixture_dir / "student_q.npz")])


KD_FLAGS = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir", "pointcloud",
            "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
            "--point_num", str(POINT_NUM), "--img_feature_dim", str(TEACHER_DIM),
            "--shape_feature_dim", str(TEACHER_DIM), "--student_feature_dim",
            str(STUDENT_DIM), "--student_width_mult", str(WIDTH_MULT), "--decrease", "1",
            "--device", "cpu", "--n_epoch", "1", "--int8_teacher"]


@pytest.mark.parametrize("regime", [["--crd"], ["--stage", "2"]])
def test_kd_cli_int8_teacher(fixture_dir, monkeypatch, capsys, regime):
    """--crd / --stage 2 with --int8_teacher: one epoch from a
    reference-layout teacher, the teacher quantized on the first eval
    batch."""
    monkeypatch.chdir(fixture_dir)
    teacher = fixture_dir / ("vanilla.pth" if "--stage" in regime else "teacher.pth")
    result_dir = "int8_" + regime[-1]
    trainingKD.main(KD_FLAGS + regime + ["--data_root", str(fixture_dir / "data"),
                                         "--teacher_model", str(teacher),
                                         "--result_dir", result_dir])
    out = capsys.readouterr().out
    assert ("vanilla resnet18 quantized" if "--stage" in regime
            else "resnet50 quantized (52 convs)") in out
    run = fixture_dir / result_dir / "KD_ObjectNet3D"
    records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 1 and np.isfinite(records[0]["train_loss"])


@pytest.mark.parametrize("argv,message", [
    (["--stage", "1"], "not applicable to --stage 1"),
    (["--stage", "2", "--shape", "MultiView"], "PointCloud teachers only")])
def test_kd_cli_int8_teacher_refusals(argv, message):
    """JAX's two refusals of --int8_teacher, with its messages."""
    with pytest.raises(SystemExit, match=message):
        trainingKD.parse_args(["--dataset", "ObjectNet3D", "--device", "cpu",
                               "--int8_teacher"] + argv)


def test_aot_flags_stay_refused():
    """--int8 with --export_aot is ported (tests/test_torch_aot.py exports
    and serves it): parsed, no longer refused."""
    opt = inference.parse_args(["--ckpt", "s.pth", "--img_path", "x.jpg", "--device", "cpu",
                                "--int8", "--export_aot", "a"])
    assert opt.int8 and opt.export_aot == "a"
