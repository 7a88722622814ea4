"""The port's KD `--stage 2` slice and the `--crd` loss variants against the
JAX package, on the CPU: the VID losses, one `make_stage2_step` and one
`make_kd_crd_step` for `"contrast"` and `"vid"` against JAX's, the
stage-2 teacher's loader (a stage-1 `checkpoint.pth` or a reference-layout
vanilla `.pth`), and the KD CLI's `--stage 2`, `--contrast` and `--vid` on
the synthetic fixture (2 epochs, then `--resume`; the testing CLI's
`--model` on the result).

Small sizes, as tests/test_torch_kd.py: the student at width_mult 0.25,
input 32, feature 64, no dropout; the teachers (the vanilla ResNet-18 and
the PointCloud ResNet-50) at 32x32 with feature dims 64 and 100 points;
batch 4 samples (12 rows over the three views), one padded in the masked
cases.

Tolerances, tests/test_torch_kd.py's. The losses alone: f32 on both
sides, values and gradients within 1e-6 relative. The steps: the student
in f64 on both sides (JAX under `jax.enable_x64`), the frozen teacher in
f32 (its eval PointNet is f32) and the losses in f32, as JAX's step casts
them; losses within 1e-5 relative, each student gradient within 1e-3 of
its max|ref| (the biases before a train-mode BatchNorm, zero in exact
arithmetic, within 1e-6 of the largest gradient on both sides), running
statistics within 1e-5.
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
from pose3d_tpu.losses import kd as jkd
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu.train.torch_export import save_torch_checkpoint
from pose3d_tpu_torch.cli import common, testing, trainingKD
from pose3d_tpu_torch.losses import kd
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.ops import pointnet, vgg_stem
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


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# --- the VID losses ----------------------------------------------------------

@pytest.mark.parametrize("temperature", [1.0, 4.0])
@pytest.mark.parametrize("masked", [False, True])
def test_vid_losses_match_jax(rng, temperature, masked):
    n = 9
    s_out = [rng.standard_normal((n, c)).astype(np.float32) * 3 for c in (24, 12, 24) * 2]
    t_out = [rng.standard_normal((n, c)).astype(np.float32) * 3 for c in (24, 12, 24) * 2]
    s_feat, t_feat = (rng.standard_normal((n, 200)).astype(np.float32) for _ in range(2))
    var = rng.uniform(0.5, 2.0, (n, 200)).astype(np.float32)
    gt = np.float32(2.5)
    valid = np.arange(n) < 7 if masked else None
    jvalid = None if valid is None else jnp.asarray(valid)

    def jax_losses(s_out, s_feat):
        return (jkd.gaussian_vid_loss(s_feat, jnp.asarray(var), jnp.asarray(t_feat), jvalid),
                jkd.vid_loss(s_out, [jnp.asarray(t) for t in t_out], gt, s_feat,
                             jnp.asarray(t_feat), temperature=temperature, valid=jvalid))

    want = jax_losses([jnp.asarray(s) for s in s_out], jnp.asarray(s_feat))
    want_grads = jax.grad(lambda so, sf: jax_losses(so, sf)[1], argnums=(0, 1))(
        [jnp.asarray(s) for s in s_out], jnp.asarray(s_feat))

    so = [torch.from_numpy(s).requires_grad_() for s in s_out]
    sf = torch.from_numpy(s_feat).requires_grad_()
    tv = None if valid is None else torch.from_numpy(valid)
    got = (kd.gaussian_vid_loss(sf, torch.from_numpy(var), torch.from_numpy(t_feat), tv),
           kd.vid_loss(so, [torch.from_numpy(t) for t in t_out], torch.tensor(gt), sf,
                       torch.from_numpy(t_feat), temperature=temperature, valid=tv))
    for g, w in zip(got, want):
        assert float(g.detach()) == pytest.approx(float(w), rel=1e-6)
    grads = torch.autograd.grad(got[1], so + [sf])
    for g, w in zip(grads, list(want_grads[0]) + [want_grads[1]]):
        assert _rel(g.numpy(), w) <= 1e-6
    if masked:  # padded rows take no gradient
        assert float(grads[-1][~tv].abs().max()) == 0.0


# --- one stage-2 step and one contrast / vid step against JAX ------------------

def _student_variables(seed):
    return chip_smoke.student_variables(np.random.default_rng(seed), STUDENT_DIM, WIDTH_MULT,
                                        INPUT_DIM)


def _teacher_variables(kind, seed):
    make = chip_smoke.vanilla_variables if kind == "stage2" else chip_smoke.teacher_variables
    return make(np.random.default_rng(seed), TEACHER_DIM, TEACHER_DIM)


def _step_inputs(masked):
    rng = np.random.default_rng(31)
    batch = {}
    for view in ("", "_flip", "_rot"):
        batch["im" + view] = rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3))
        batch["label" + view] = chip_smoke.random_labels(rng, BATCH)
    extent = rng.uniform(0.2, 1.0, (BATCH, 1, 3))
    batch["shape"] = (rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) * extent).astype(np.float32)
    if masked:
        batch["valid"] = np.arange(BATCH) < BATCH - 1
    return batch


@functools.cache
def _jax_step(kind, masked):
    """JAX's make_stage2_step (kind "stage2", the vanilla teacher) or
    make_kd_crd_step (kind "contrast" or "vid", the PointCloud teacher), on
    the student in f64 and the teacher in f32, with plain SGD at lr 1 as
    the update, so that the step's gradient is the parameters' change."""
    svars, tvars = _student_variables(11), _teacher_variables(kind, 12)
    batch = _step_inputs(masked)
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
            step = jsteps.make_stage2_step(student, teacher, 15, 2.0)
        else:
            teacher = JaxPoseEstimator(img_feature_dim=TEACHER_DIM,
                                       shape_feature_dim=TEACHER_DIM)
            step = jsteps.make_kd_crd_step(student, teacher, 15, 2.0, loss_variant=kind)
        new_state, metrics = jax.jit(step)(state, jax.tree_util.tree_map(jnp.asarray, tvars),
                                           {k: jnp.asarray(v) for k, v in batch.items()})
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params,
                                       new_state.params)
        new_stats = jax.device_get(new_state.batch_stats)
        metrics = {k: float(v) for k, v in metrics.items()}
    return svars, tvars, metrics, grads, new_stats


def _port_teacher(kind, tvars):
    if kind == "stage2":
        teacher = PoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                       shape_feature_dim=TEACHER_DIM)
        teacher.load_state_dict(convert.pose_vanilla_state_dict(tvars), strict=True)
    else:
        teacher = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
        teacher.load_state_dict(convert.pose_state_dict(tvars), strict=True)
    return teacher.requires_grad_(False)


@pytest.mark.parametrize("kind,masked", [("stage2", False), ("stage2", True),
                                         ("contrast", True), ("vid", True)])
def test_student_step_matches_jax(kind, masked):
    svars, tvars, want_metrics, want_grads, want_stats = _jax_step(kind, masked)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _step_inputs(masked).items()}
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    state = create_train_state(student.double(), LR, [100], seed=0)
    teacher = _port_teacher(kind, tvars)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    launches = (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                pointnet.pointnet_eval.launches)
    step = (steps.make_stage2_step(temperature=2.0) if kind == "stage2" else
            steps.make_kd_crd_step(temperature=2.0, loss_variant=kind))

    metrics = step(state, teacher, batch)

    assert launches == (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                        pointnet.pointnet_eval.launches)  # the CPU takes plain versions
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
    assert all(p.grad is None for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    assert state.step == 1


def test_kd_step_refuses_an_unknown_loss_variant():
    with pytest.raises(ValueError, match="loss_variant"):
        steps.make_kd_crd_step(loss_variant="crd2")


# --- the stage-2 teacher's loader -------------------------------------------

class _Flags:
    img_feature_dim = shape_feature_dim = TEACHER_DIM
    bin_size = 15
    shape, view_num = "PointCloud", 12


def test_build_vanilla_reads_a_stage1_checkpoint_and_a_reference_pth(tmp_path):
    """The vanilla teacher, loaded strictly, in eval mode: from the
    "teacher" train state of a stage-1 checkpoint.pth, and from a
    reference-layout .pth that JAX's torch_export writes; a directory (an
    orbax checkpoint) is refused."""
    variables = _teacher_variables("stage2", 5)
    want = convert.pose_vanilla_state_dict(variables)
    teacher = PoseEstimatorVanilla(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
    teacher.load_state_dict(want, strict=True)
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM)
    stage1 = {"teacher": create_train_state(teacher, LR, [100], seed=1).state_dict(),
              "student": create_train_state(student, LR, [100], seed=0).state_dict()}
    torch.save(stage1, tmp_path / "checkpoint.pth")
    save_torch_checkpoint(str(tmp_path / "vanilla.pth"), variables, arch="vanilla")
    for path in ("checkpoint.pth", "vanilla.pth"):
        model = common.build_vanilla(_Flags, torch.device("cpu"), str(tmp_path / path))
        assert not model.training
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k].to(v.dtype)), (path, k)
    with pytest.raises(SystemExit, match="ROADMAP"):
        common.build_vanilla(_Flags, torch.device("cpu"), str(tmp_path))


# --- the KD CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stage2")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    return root


DATA_FLAGS = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir", "pointcloud",
              "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
              "--point_num", str(POINT_NUM), "--img_feature_dim", str(TEACHER_DIM),
              "--shape_feature_dim", str(TEACHER_DIM), "--student_feature_dim",
              str(STUDENT_DIM), "--student_width_mult", str(WIDTH_MULT), "--decrease", "1",
              "--device", "cpu"]


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _testing_med(fixture_dir, ckpt):
    return testing.main(["--dataset", "ObjectNet3D", "--shape", "None", "--data_root",
                         str(fixture_dir / "data"), "--input_dim", str(INPUT_DIM),
                         "--img_feature_dim", str(STUDENT_DIM), "--student_width_mult",
                         str(WIDTH_MULT), "--model", str(ckpt), "--device", "cpu",
                         "--output_dir", str(fixture_dir / "preds")]).mean_med


def test_stage2_cli_from_stage1_then_resume_export_and_testing(fixture_dir, monkeypatch):
    """The two-stage recipe: --stage 1 writes its checkpoint.pth; --stage 2
    distils from the teacher in it for 2 epochs, then --resume into a third
    with --export_torch; the testing CLI reads the student's checkpoint.pth
    and reports the log's last val_med."""
    monkeypatch.chdir(fixture_dir)
    data = DATA_FLAGS + ["--data_root", str(fixture_dir / "data")]
    trainingKD.main(data + ["--stage", "1", "--n_epoch", "1", "--result_dir", "s1"])
    teacher_ckpt = fixture_dir / "s1" / "KD_ObjectNet3D" / "ckpt" / "checkpoint.pth"
    flags = data + ["--stage", "2", "--teacher_model", str(teacher_ckpt), "--result_dir", "s2"]
    trainingKD.main(flags + ["--n_epoch", "2"])
    run = fixture_dir / "s2" / "KD_ObjectNet3D"
    assert [r["epoch"] for r in _records(run)] == [0, 1]
    export = fixture_dir / "stage2_student.pth"
    trainingKD.main(flags + ["--n_epoch", "3", "--resume", "--export_torch", str(export)])
    records = _records(run)
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["kind"] == "stage2_epoch" and r["train_samples"] == 8 and
               np.isfinite(r["train_loss"]) for r in records)
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert saved["step"] == 6 and (run / "ckpt" / "EPOCH").read_text() == "2"
    log = (run / "training_log.txt").read_text()
    assert log.count("Student Epoch:") == 3
    last_med = float(log.strip().splitlines()[-1].split("val_med")[1])
    assert round(_testing_med(fixture_dir, run / "ckpt" / "checkpoint.pth"), 2) == last_med
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM)
    student.load_state_dict(torch.load(export, weights_only=True)["state_dict"], strict=True)


def test_stage2_cli_from_a_reference_vanilla_pth(fixture_dir, monkeypatch):
    monkeypatch.chdir(fixture_dir)
    path = fixture_dir / "vanilla.pth"
    save_torch_checkpoint(str(path), _teacher_variables("stage2", 6), arch="vanilla")
    trainingKD.main(DATA_FLAGS + ["--data_root", str(fixture_dir / "data"), "--stage", "2",
                                  "--teacher_model", str(path), "--n_epoch", "1",
                                  "--result_dir", "s2ref"])
    records = _records(fixture_dir / "s2ref" / "KD_ObjectNet3D")
    assert len(records) == 1 and records[0]["kind"] == "stage2_epoch"
    assert np.isfinite(records[0]["train_loss"]) and np.isfinite(records[0]["val_med"])


@pytest.mark.parametrize("variant", ["contrast", "vid"])
def test_kd_variant_cli_two_epochs_then_resume(fixture_dir, monkeypatch, variant):
    """--contrast and --vid from a reference-layout teacher .pth: 2 epochs,
    then --resume into a third; the testing CLI reads the checkpoint."""
    monkeypatch.chdir(fixture_dir)
    path = fixture_dir / "teacher.pth"
    if not path.exists():
        save_torch_checkpoint(str(path), _teacher_variables("crd", 7), arch="pose")
    flags = DATA_FLAGS + ["--data_root", str(fixture_dir / "data"), f"--{variant}",
                          "--teacher_model", str(path), "--result_dir", variant]
    trainingKD.main(flags + ["--n_epoch", "2"])
    trainingKD.main(flags + ["--n_epoch", "3", "--resume"])
    run = fixture_dir / variant / "KD_ObjectNet3D"
    records = _records(run)
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["kind"] == f"{variant}_epoch" and np.isfinite(r["train_loss"])
               for r in records)
    assert torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)["step"] == 6
    last_med = float((run / "training_log.txt").read_text().strip().splitlines()[-1]
                     .split("val_med")[1])
    assert round(_testing_med(fixture_dir, run / "ckpt" / "checkpoint.pth"), 2) == last_med
