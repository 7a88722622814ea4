"""The port's bf16 compute (`--bf16`) against the JAX package's
`dtype=jnp.bfloat16`, on the CPU.

The parameters stay float32 on both sides; each layer casts its input and
weights to bf16, BatchNorm takes its statistics and normalises in float32,
the losses are float32. The same seeded weights go through
`pose3d_tpu_torch.train.convert` (unchanged: the parameters are f32).

Tolerances.
  * Per module (BatchNorm in train mode, masked and unmasked; a Dense with
    its dropout keep-mask injected): each element within one bf16 ulp of
    JAX's, 2^-7 of max|ref| (bf16 keeps 8 significant bits), and under 1 %
    of the elements unequal; both printed. The two packages round at the
    same points and differ only in the f32 summation order before a
    rounding.
  * Whole models and one train step (the student, the vanilla teacher and
    the PointCloud teacher in eval mode at the smallest widths of their
    f32 tests; one KD --crd step and one --stage 2 step, their losses and
    every parameter gradient): an oracle rule, since the packages' bf16
    differ in summation order and a flipped rounding carries through
    later layers. Both bf16 results are measured against JAX's float64
    model with the same weights and inputs, and the port's error must be
    at most twice JAX's plus 2^-10 of max|ref| (a gradient that is zero in
    exact arithmetic, a bias before a train-mode BatchNorm, takes the
    largest gradient as its scale), the error read both as the largest
    difference and as the root-mean-square difference; the ratios are
    printed. JAX's own bf16 gradients of the convolutions are over half
    the gradient's RMS away from f64 here, so that rule alone passes a
    zeroed gradient there. Two more conditions hold the port to JAX's
    rounding points: its RMS distance from JAX's bf16 result at most half
    that result's RMS plus the same floor (0.28 of it at most, for the
    gradients), and every gradient of a parameter that a layer casts to
    bf16 (all but BatchNorm's) a bf16 value, as JAX's gradient of
    `kernel.astype(bfloat16)` is. `test_step_rule_fails_planted_faults`
    shows that the rule fails a step with a zeroed stem gradient, with
    BatchNorm statistics taken in bf16, and with the stem's weight gradient
    not rounded to bf16.
The CLIs run on the synthetic fixture: KD --crd, KD --stage 1 and the
teacher's training under --bf16 for one epoch (each checkpoint all f32)
and --resume without it, the testing and inference CLIs with --bf16.
tests/test_torch_bf16_train.py holds the train-mode PointNet in bf16, the
teacher step and the stage-1 step against JAX.
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
from flax import linen as fnn

from pose3d_tpu.data import synthetic
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.cli import common, inference, testing, training, trainingKD
from pose3d_tpu_torch.models import common as model_common
from pose3d_tpu_torch.models import vgg as model_vgg
from pose3d_tpu_torch.models.common import BatchNorm, linear
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.models.vgg import KeepMaskDropout
from pose3d_tpu_torch.ops.vgg_stem import vgg_stem_plain
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location(
    "torch_bf16_rules", pathlib.Path(__file__).resolve().parent / "torch_bf16_rules.py")
rules = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rules)
BF16, ULP, UNEQUAL_MAX, ORACLE_FLOOR, AGREE = (rules.BF16, rules.ULP, rules.UNEQUAL_MAX,
                                               rules.ORACLE_FLOOR, rules.AGREE)
_np, one_ulp, oracle = rules._np, rules.one_ulp, rules.oracle

STUDENT_DIM, WIDTH_MULT, INPUT_DIM = 64, 0.25, 32
TEACHER_DIM, POINT_NUM, BATCH = 64, 100, 4
CATS = ("bed", "bookshelf", "calculator")


def _as(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


# --- per module ---------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_bf16_matches_flax(rng, masked):
    """flax's BatchNorm(dtype=bfloat16) in train mode: statistics from the
    input in f32, normalised in f32, the output rounded to bf16; the
    running statistics (f32) within 1e-6 of JAX's."""
    n, c = 37, 48
    x = (rng.standard_normal((n, c)) * 3 + 1).astype(np.float32)
    mask = np.arange(n) < 30 if masked else None
    scale, bias = rng.uniform(0.5, 2, c).astype(np.float32), rng.standard_normal(c).astype(
        np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16, param_dtype=jnp.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    want, mut = bn.apply(variables, xb, mask=None if mask is None else
                         jnp.asarray(mask)[:, None], mutable=["batch_stats"])
    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    got = port(torch.from_numpy(x).to(BF16), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    rows = slice(None) if mask is None else mask
    one_ulp(got[torch.from_numpy(np.arange(n))[rows]], np.asarray(want.astype(jnp.float32))[rows],
            f"BatchNorm train bf16, masked {masked}")
    for key, buf in (("mean", port.running_mean), ("var", port.running_var)):
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(mut["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)


def test_dense_with_dropout_bf16_matches_flax(rng):
    """flax's Dense(dtype=bfloat16) (x W rounded, + b rounded) and its
    Dropout at rate 0.5 (x / 0.5 where kept, in bf16), the keep-mask read
    off JAX's output (the Dense's outputs are not 0) and handed to the
    port's KeepMaskDropout."""
    x = rng.standard_normal((16, 300)).astype(np.float32)
    w = (rng.standard_normal((300, 96)) * 0.05).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    dense = fnn.Dense(96, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    y = dense.apply(params, jnp.asarray(x))
    out = fnn.Dropout(0.5, deterministic=False).apply({}, y, rngs={"dropout":
                                                                   jax.random.key(3)})
    keep = torch.from_numpy(np.array(out != 0))
    assert 0.3 < float(keep.float().mean()) < 0.7
    layer = torch.nn.Linear(300, 96)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        layer.bias.copy_(torch.from_numpy(b))
    got_y = linear(layer, torch.from_numpy(x), BF16)
    got = KeepMaskDropout(0.5).train()(got_y, keep)
    assert got.dtype == BF16
    one_ulp(got_y, y, "Dense bf16")
    one_ulp(got, out, "Dense + dropout bf16")


# --- whole models in eval mode ------------------------------------------------

def _student_variables(seed):
    return chip_smoke.student_variables(np.random.default_rng(seed), STUDENT_DIM, WIDTH_MULT,
                                        INPUT_DIM)


def _teacher_variables(kind, seed):
    make = chip_smoke.vanilla_variables if kind == "vanilla" else chip_smoke.teacher_variables
    return make(np.random.default_rng(seed), TEACHER_DIM, TEACHER_DIM)


def _jax_model(kind, dtype):
    if kind == "student":
        return JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                    dropout_rate=0.0, dtype=dtype)
    cls = JaxPoseEstimatorVanilla if kind == "vanilla" else JaxPoseEstimator
    return cls(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM, dtype=dtype)


def _port_model(kind, variables, compute_dtype=BF16):
    if kind == "student":
        model = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                  input_dim=INPUT_DIM, dropout_rate=0.0,
                                  compute_dtype=compute_dtype)
        model.load_state_dict(convert.baseline_state_dict(variables), strict=True)
        return model
    if kind == "vanilla":
        model = PoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                     shape_feature_dim=TEACHER_DIM, compute_dtype=compute_dtype)
        model.load_state_dict(convert.pose_vanilla_state_dict(variables), strict=True)
        return model
    model = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM,
                          compute_dtype=compute_dtype)
    model.load_state_dict(convert.pose_state_dict(variables), strict=True)
    return model


def _outputs(out):
    """Heads and features of a forward's output, flat."""
    return list(out[0]) + list(out[1:])


@pytest.mark.parametrize("kind", ["student", "vanilla", "teacher"])
def test_model_bf16_matches_jax(kind):
    """The student, the vanilla teacher and the PointCloud teacher in eval
    mode: every output (the six heads and the features) in bf16, held to the
    oracle rule against JAX's f64 model."""
    variables = (_student_variables(3) if kind == "student" else
                 _teacher_variables(kind, 4))
    rng = np.random.default_rng(5)
    im = rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3)).astype(np.float32)
    inputs = [im]
    if kind != "student":
        inputs.append((rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) *
                       rng.uniform(0.2, 1.0, (BATCH, 1, 3))).astype(np.float32))
    def apply(dtype, *args):  # jitted: 10x faster than op by op here
        return jax.jit(functools.partial(_jax_model(kind, dtype).apply, train=False))(*args)

    want_bf16 = apply(jnp.bfloat16, _as(variables, jnp.float32), *map(jnp.asarray, inputs))
    with jax.enable_x64(True):
        ref = apply(jnp.float64, _as(variables, jnp.float64),
                    *(jnp.asarray(a, jnp.float64) for a in inputs))
        ref = [np.asarray(r) for r in _outputs(ref)]
    port = _port_model(kind, variables).eval()
    with torch.no_grad():
        got = _outputs(port(*map(torch.from_numpy, inputs)))
    assert all(g.dtype == BF16 for g in got) and len(got) == len(ref)
    for i, (g, w, r) in enumerate(zip(got, _outputs(want_bf16), ref)):
        oracle(g, w, r, f"{kind} output {i}")


# --- one KD --crd and one --stage 2 step ---------------------------------------

def _step_batch():
    rng = np.random.default_rng(31)
    batch = {}
    for view in ("", "_flip", "_rot"):
        batch["im" + view] = rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3)).astype(
            np.float32)
        batch["label" + view] = chip_smoke.random_labels(rng, BATCH)
    batch["shape"] = (rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) *
                      rng.uniform(0.2, 1.0, (BATCH, 1, 3))).astype(np.float32)
    batch["valid"] = np.arange(BATCH) < BATCH - 1
    return batch


@functools.cache
def _jax_step(kind, dtype_name):
    """JAX's make_kd_crd_step ("crd", the PointCloud teacher) or
    make_stage2_step ("stage2", the vanilla teacher), both models in
    `dtype_name`, with plain SGD at lr 1, so that the step's gradient is
    the parameters' change. The parameters ride in f64 (their values the
    f32 ones): each layer casts them to its compute dtype, so only the
    gradient's read-out gains the precision."""
    dtype = {"bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype_name]
    svars = _student_variables(11)
    tvars = _teacher_variables("vanilla" if kind == "stage2" else "teacher", 12)
    with jax.enable_x64(True):
        student = _jax_model("student", dtype)
        teacher = _jax_model("vanilla" if kind == "stage2" else "teacher", dtype)
        params, tx = _as(svars["params"], jnp.float64), optax.sgd(1.0)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=_as(svars["batch_stats"], jnp.float64),
                                  opt_state=tx.init(params), rng=jax.random.key(0), tx=tx)
        make = jsteps.make_stage2_step if kind == "stage2" else jsteps.make_kd_crd_step
        new_state, metrics = jax.jit(make(student, teacher, 15, 1.0))(
            state, _as(tvars, jnp.float64), {k: jnp.asarray(v) for k, v in _step_batch().items()})
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params, new_state.params)
        metrics = {k: float(v) for k, v in metrics.items()}
    return svars, tvars, metrics, convert.baseline_state_dict(
        {"params": grads, "batch_stats": svars["batch_stats"]})


def _port_step(kind, plant=None):
    """The port's side of `_jax_step` (Adam, whose update is not read): the
    student and the teacher in bf16, one step; `plant(student)` runs first.
    Returns the metrics, the student's gradients and the names of its
    BatchNorm parameters (used in float32, so not rounded to bf16)."""
    svars, tvars, _, _ = _jax_step(kind, "bfloat16")
    student = _port_model("student", svars)
    if plant is not None:
        plant(student)
    teacher = _port_model("vanilla" if kind == "stage2" else "teacher", tvars).eval()
    teacher.requires_grad_(False)
    state = create_train_state(student, 1e-4, [100], seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _step_batch().items()}
    make = steps.make_stage2_step if kind == "stage2" else steps.make_kd_crd_step
    metrics = make()(state, teacher, batch)
    grads = {name: p.grad for name, p in student.named_parameters()}
    in_bn = {f"{m_name}.{p_name}" for m_name, m in student.named_modules()
             if isinstance(m, BatchNorm) for p_name, _ in m.named_parameters()}
    return metrics, grads, in_bn


def _check_step(kind, metrics, grads, in_bn):
    """The losses and every gradient held to `oracle` against JAX's step;
    the gradients of the parameters a layer casts to bf16 bf16 values."""
    _, _, want, want_grads = _jax_step(kind, "bfloat16")
    _, _, ref, ref_grads = _jax_step(kind, "float64")
    for key in ("loss", "gt_loss"):
        oracle(np.float64(metrics[key]), np.float64(want[key]), np.float64(ref[key]),
               f"{kind} {key}")
    assert all(g.dtype == torch.float32 for g in grads.values())
    largest = max(float(ref_grads[k].abs().max()) for k in grads)
    for name, got in grads.items():
        scale = float(ref_grads[name].abs().max())
        oracle(got, want_grads[name], ref_grads[name], f"{kind} d{name}",
               scale=largest if scale < 1e-6 * largest else None)
        if name not in in_bn:
            assert torch.equal(got, got.to(BF16).float()), f"{kind} d{name} is not bf16"


@pytest.mark.parametrize("kind", ["crd", "stage2"])
def test_step_bf16_matches_jax(kind):
    """One KD --crd step (the PointCloud teacher, frozen) and one --stage 2
    step (the vanilla teacher): the student and the teacher in bf16 on both
    sides, one sample of 4 padded, no dropout; the losses and every
    parameter gradient of the student held to the rule above against JAX's
    f64 and bf16 steps. The port's gradients reach its f32 parameters
    through the bf16 casts."""
    _check_step(kind, *_port_step(kind))


@pytest.mark.parametrize("fault, check", [
    ("zeroed_stem_gradient", "features.0.weight: apart"),
    ("bf16_batch_statistics", "crd loss"),
    ("unrounded_stem_gradient", "features.0.weight is not bf16")])
def test_step_rule_fails_planted_faults(fault, check, monkeypatch):
    """The rule of `test_step_bf16_matches_jax` fails a KD --crd step with a
    planted fault, each at the check that should see it: the stem's weight
    gradient zeroed (JAX's own bf16 error there is over half the gradient's
    RMS, so the oracle passes it; its distance from JAX's bf16 does not);
    BatchNorm's statistics taken from the bf16 input (the losses); the stem
    handed the bf16 values of its parameters with their float32 gradients
    (the forward unchanged; the weight gradient never rounded to bf16)."""
    def plant(student):
        if fault == "bf16_batch_statistics":
            stats = model_common.batch_stats
            monkeypatch.setattr(model_common, "batch_stats", lambda x, dims, mask=None: [
                t.float() for t in stats(x.to(BF16), dims, mask)])
        elif fault == "unrounded_stem_gradient":
            stem = student.img_encoder.features[0]
            rounded = lambda p: p + (p.to(BF16).float() - p).detach()
            monkeypatch.setattr(model_vgg, "vgg_stem", lambda x, w, b: vgg_stem_plain(
                x, rounded(stem.weight), rounded(stem.bias)))

    metrics, grads, in_bn = _port_step("crd", plant)
    if fault == "zeroed_stem_gradient":
        grads["img_encoder.features.0.weight"] = torch.zeros_like(
            grads["img_encoder.features.0.weight"])
    with pytest.raises(AssertionError, match=check):
        _check_step("crd", metrics, grads, in_bn)


# --- the CLIs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_bf16")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    teacher = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM,
                            generator=torch.Generator().manual_seed(2))
    torch.save({"state_dict": teacher.state_dict()}, root / "teacher.pth")
    return root


def _kd_flags(root):
    return ["--crd", "--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir",
            "pointcloud", "--data_root", str(root / "data"), "--batch_size", "4", "--workers",
            "2", "--input_dim", str(INPUT_DIM), "--point_num", str(POINT_NUM),
            "--img_feature_dim", str(TEACHER_DIM), "--shape_feature_dim", str(TEACHER_DIM),
            "--student_feature_dim", str(STUDENT_DIM), "--student_width_mult",
            str(WIDTH_MULT), "--decrease", "1", "--device", "cpu",
            "--teacher_model", str(root / "teacher.pth")]


def test_kd_cli_bf16_epoch_then_resume_without_it(fixture_dir, monkeypatch):
    """KD --crd --bf16 for one epoch: config.json records the flag, the
    checkpoint is all f32; --resume without --bf16 continues from it in f32
    into a second epoch; the testing CLI evaluates the student under
    --bf16 and the inference CLI serves it."""
    monkeypatch.chdir(fixture_dir)
    trainingKD.main(_kd_flags(fixture_dir) + ["--bf16", "--n_epoch", "1"])
    run = fixture_dir / "result" / "KD_ObjectNet3D"
    assert json.loads((run / "config.json").read_text())["bf16"] is True
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    floats = [v for v in saved["model"].values() if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)
    trainingKD.main(_kd_flags(fixture_dir) + ["--n_epoch", "2", "--resume"])
    assert json.loads((run / "config.json").read_text())["bf16"] is False
    assert (run / "ckpt" / "EPOCH").read_text() == "1"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_med"]) for r in records)

    student = ["--input_dim", str(INPUT_DIM), "--img_feature_dim", str(STUDENT_DIM),
               "--student_width_mult", str(WIDTH_MULT), "--device", "cpu", "--bf16"]
    result = testing.main(["--dataset", "ObjectNet3D", "--shape", "None", "--data_root",
                           str(fixture_dir / "data"), "--model",
                           str(run / "ckpt" / "checkpoint.pth"),
                           "--output_dir", str(fixture_dir / "preds")] + student)
    assert len(result.errors) > 0 and np.all(np.isfinite(result.errors))
    image = fixture_dir / "data" / "ObjectNet3D" / "Images" / "bed_val_0.jpg"
    vp = inference.main(["--ckpt", str(run / "ckpt" / "checkpoint.pth"), "--img_path",
                         str(image)] + student)
    assert vp.shape == (3,) and np.all(np.isfinite(vp))


def test_bf16_cli_builds_bf16_models():
    """--bf16 gives every model of the CLIs bfloat16 compute over float32
    parameters; without it the compute dtype is the parameters'."""
    opt = trainingKD.parse_args(["--stage", "2", "--dataset", "ObjectNet3D", "--shape",
                                 "PointCloud", "--device", "cpu", "--bf16",
                                 "--img_feature_dim", "64", "--shape_feature_dim", "64"])
    assert common.compute_dtype(opt) == BF16
    vanilla = common.build_vanilla(opt, torch.device("cpu"))
    assert vanilla.compute_dtype == BF16 and vanilla.shape_encoder.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in vanilla.parameters())
    opt.bf16 = False
    assert common.compute_dtype(opt) is None
    opt = training.parse_args(["--dataset", "ObjectNet3D", "--shape", "None", "--bf16",
                               "--device", "cpu"])
    assert opt.bf16 and common.compute_dtype(opt) == BF16


def _floats(state):
    return [v for v in state.values() if v.is_floating_point()]


@pytest.mark.parametrize("cli", ["stage1", "teacher"])
def test_bf16_cli_trains_where_the_train_mode_pointnet_runs(cli, fixture_dir, monkeypatch):
    """KD --stage 1 and the teacher's training run the train-mode PointNet
    (its bf16 plain version here, the kernel's bf16 instance on the card):
    one epoch under --bf16 (config.json records it, the checkpoint is all
    f32), then --resume without the flag into a second epoch in f32."""
    monkeypatch.chdir(fixture_dir)
    flags = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir", "pointcloud",
             "--data_root", str(fixture_dir / "data"), "--batch_size", "4", "--workers", "2",
             "--input_dim", str(INPUT_DIM), "--point_num", str(POINT_NUM),
             "--img_feature_dim", str(TEACHER_DIM), "--shape_feature_dim", str(TEACHER_DIM),
             "--decrease", "1", "--fused_nce", "--device", "cpu", "--result_dir", f"result_{cli}"]
    if cli == "stage1":
        flags += ["--stage", "1", "--student_feature_dim", str(STUDENT_DIM),
                  "--student_width_mult", str(WIDTH_MULT)]
        main, run = trainingKD.main, fixture_dir / f"result_{cli}" / "KD_ObjectNet3D"
    else:
        main, run = training.main, fixture_dir / f"result_{cli}" / "PointCloud_ObjectNet3D"
    main(flags + ["--bf16", "--n_epoch", "1"])
    assert json.loads((run / "config.json").read_text())["bf16"] is True
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    states = [saved["teacher"]["model"], saved["student"]["model"]] if cli == "stage1" else [
        saved["model"]]
    assert all(_floats(s) and all(v.dtype == torch.float32 for v in _floats(s))
               for s in states)
    main(flags + ["--n_epoch", "2", "--resume"])
    assert json.loads((run / "config.json").read_text())["bf16"] is False
    assert (run / "ckpt" / "EPOCH").read_text() == "1"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in records)
