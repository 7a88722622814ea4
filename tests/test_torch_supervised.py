"""The port's supervised regime and the teacher's pose-weighted NCE against
the JAX package, on the CPU: one `make_vanilla_train_step` (the RGB-only
baseline student, and the vanilla teacher) and one `make_teacher_train_step`
with `--nce pose` against JAX's, and the training CLI's `--shape None`
(2 epochs, then `--resume`; the testing CLI's `--model` on its
checkpoint) and `--shape PointCloud --nce pose --weighting sqrt` on the
synthetic fixture.

Small sizes: the student at width_mult 0.25, input 32, feature 64, no
dropout; the vanilla teacher (ResNet-18) and the PointCloud teacher
(ResNet-50) at 32x32 with feature dims 64 and 100 points; batch 4, one
row padded.

Tolerances, the other step tests': the models in f64 on both sides (JAX
under `jax.enable_x64`) and the losses in f32, as JAX's steps cast them;
losses within 1e-5 relative, each gradient within 1e-3 of its max|ref|
(the biases before a train-mode BatchNorm, zero in exact arithmetic,
within 1e-6 of the largest gradient on both sides), running statistics
within 1e-5. The pose-weighted NCE's distances come from one f64 geodesic
on both sides (tests/torch_pose_geodesic.py; the port's own are held
against JAX's in tests/test_torch_stage1_variants.py).
"""

import contextlib
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
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.cli import testing, training
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_here = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("chip_smoke", _here.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location("torch_pose_geodesic",
                                               _here / "torch_pose_geodesic.py")
torch_pose_geodesic = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_pose_geodesic)

STUDENT_DIM, WIDTH_MULT, INPUT_DIM = 64, 0.25, 32
FEATURE_DIM, POINT_NUM, BATCH = 64, 100, 4
LR = 1e-4
CATS = ("bed", "bookshelf", "calculator")

# kind -> (JAX model, port model, its variables, the state_dict bridge)
MODELS = {
    "student": (lambda dt: JaxBaselineEstimator(img_feature_dim=STUDENT_DIM,
                                                width_mult=WIDTH_MULT, dropout_rate=0.0,
                                                dtype=dt),
                lambda: BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                          input_dim=INPUT_DIM, dropout_rate=0.0),
                lambda rng: chip_smoke.student_variables(rng, STUDENT_DIM, WIDTH_MULT,
                                                         INPUT_DIM),
                convert.baseline_state_dict),
    "vanilla": (lambda dt: JaxPoseEstimatorVanilla(img_feature_dim=FEATURE_DIM,
                                                   shape_feature_dim=FEATURE_DIM, dtype=dt),
                lambda: PoseEstimatorVanilla(img_feature_dim=FEATURE_DIM,
                                             shape_feature_dim=FEATURE_DIM),
                lambda rng: chip_smoke.vanilla_variables(rng, FEATURE_DIM, FEATURE_DIM),
                convert.pose_vanilla_state_dict),
    "teacher": (lambda dt: JaxPoseEstimator(img_feature_dim=FEATURE_DIM,
                                            shape_feature_dim=FEATURE_DIM, dtype=dt),
                lambda: PoseEstimator(img_feature_dim=FEATURE_DIM,
                                      shape_feature_dim=FEATURE_DIM),
                lambda rng: chip_smoke.teacher_variables(rng, FEATURE_DIM, FEATURE_DIM),
                convert.pose_state_dict),
}


def _batch():
    rng = np.random.default_rng(41)
    batch = {"im": rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3)),
             "shape": rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) * rng.uniform(0.2, 1.0,
                                                                          (BATCH, 1, 3)),
             "label": chip_smoke.random_labels(rng, BATCH),
             "valid": np.arange(BATCH) < BATCH - 1}
    batch["label"][2] = batch["label"][0] + 4
    return batch


def _context(kind):
    return torch_pose_geodesic.one_geodesic() if kind == "teacher" else contextlib.nullcontext()


@functools.cache
def _jax_step(kind):
    """JAX's make_vanilla_train_step (kinds "student" and "vanilla") or
    make_teacher_train_step with nce_variant "pose" and sqrt weighting
    ("teacher"), in f64, with plain SGD at lr 1 as the update, so that the
    step's gradient is the parameters' change."""
    make_jax, _, make_vars, _ = MODELS[kind]
    variables = make_vars(np.random.default_rng(17))
    batch = _batch()
    with _context(kind), jax.enable_x64(True):
        model = make_jax(jnp.float64)
        f64 = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        params, tx = f64(variables["params"]), optax.sgd(1.0)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=f64(variables["batch_stats"]),
                                  opt_state=tx.init(params), rng=jax.random.key(0), tx=tx)
        if kind == "teacher":
            step = jsteps.make_teacher_train_step(model, 15, nce_variant="pose",
                                                  nce_weighting="sqrt")
        else:
            step = jsteps.make_vanilla_train_step(model, kind == "vanilla", 15)
        new_state, metrics = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params,
                                       new_state.params)
        stats = jax.device_get(new_state.batch_stats)
        metrics = {k: float(v) for k, v in metrics.items()}
    return variables, metrics, grads, stats


@pytest.mark.parametrize("kind", ["student", "vanilla", "teacher"])
def test_supervised_and_pose_nce_steps_match_jax(kind):
    variables, want_metrics, want_grads, want_stats = _jax_step(kind)
    _, make_port, _, to_sd = MODELS[kind]
    model = make_port()
    model.load_state_dict(to_sd(variables), strict=True)
    state = create_train_state(model.double(), LR, [100], seed=0)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()}
    with _context(kind):
        if kind == "teacher":
            metrics = steps.make_teacher_train_step(nce_variant="pose",
                                                    nce_weighting="sqrt")(state, batch)
        else:
            metrics = steps.make_vanilla_train_step(kind == "vanilla")(state, batch)
    keys = ("loss", "pose_loss", "nce_loss") if kind == "teacher" else ("loss",)
    for key in keys:
        assert float(metrics[key]) == pytest.approx(want_metrics[key], rel=1e-5), key
    assert float(metrics["acc_rot"]) == pytest.approx(want_metrics["acc_rot"], abs=1e-4)
    want_grads = to_sd({"params": want_grads, "batch_stats": variables["batch_stats"]})
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == {k for k in want_grads if "running" not in k
                          and not k.endswith("num_batches_tracked")}
    largest = max(float(want_grads[k].abs().max()) for k in grads)
    for name, got in grads.items():
        want = want_grads[name].double()
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN,
            # or the student's projector, which the pose loss does not reach
            assert float(got.abs().max()) < 1e-6 * largest, name
        else:
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
    want_state = to_sd({"params": variables["params"], "batch_stats": want_stats})
    for name, value in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), want_state[name].numpy(), atol=1e-5,
                                       err_msg=name)
    assert state.step == 1


def test_baseline_step_draws_its_dropout_from_the_state_generator():
    model = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                              input_dim=INPUT_DIM, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, [100], seed=3)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()}
    batch["im"] = batch["im"].float()
    global_state, before = torch.random.get_rng_state(), state.generator.get_state()
    metrics = steps.make_vanilla_train_step(False)(state, batch)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert not torch.equal(state.generator.get_state(), before)
    assert set(metrics) == {"loss", "acc_rot"} and np.isfinite(float(metrics["loss"]))


# --- the training CLI ---------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_supervised")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    return root


DATA_FLAGS = ["--dataset", "ObjectNet3D", "--shape_dir", "pointcloud", "--batch_size", "4",
              "--workers", "2", "--input_dim", str(INPUT_DIM), "--decrease", "1",
              "--device", "cpu"]


def test_baseline_cli_two_epochs_resume_and_testing(fixture_dir, monkeypatch):
    """--shape None: the student under the pose loss for 2 epochs, then
    --resume into a third; baseline_ObjectNet3D/ holds the log, the
    curves, the metrics and the checkpoint (with the optimizer's state),
    which the testing CLI's --model reads, reporting the log's last MedErr
    of the per-category evaluation."""
    monkeypatch.chdir(fixture_dir)
    flags = DATA_FLAGS + ["--data_root", str(fixture_dir / "data"), "--shape", "None",
                          "--img_feature_dim", str(STUDENT_DIM), "--student_width_mult",
                          str(WIDTH_MULT)]
    training.main(flags + ["--n_epoch", "2"])
    training.main(flags + ["--n_epoch", "3", "--resume"])
    run = fixture_dir / "result" / "baseline_ObjectNet3D"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["kind"] == "supervised_epoch" and r["train_samples"] == 8 and
               np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)
    log = (run / "training_log.txt").read_text()
    assert log.count("Epoch: ") == 3 and "val_loss" in log
    assert (run / "curves_losses.csv").exists()
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert saved["step"] == 6 and saved["optimizer"]["state"]
    result = testing.main(["--dataset", "ObjectNet3D", "--shape", "None", "--data_root",
                           str(fixture_dir / "data"), "--input_dim", str(INPUT_DIM),
                           "--img_feature_dim", str(STUDENT_DIM), "--student_width_mult",
                           str(WIDTH_MULT), "--model", str(run / "ckpt" / "checkpoint.pth"),
                           "--device", "cpu", "--output_dir", str(fixture_dir / "preds")])
    assert round(result.mean_med, 2) == round(records[-1]["val_med"], 2)


def test_teacher_cli_with_the_pose_nce(fixture_dir, monkeypatch):
    monkeypatch.chdir(fixture_dir)
    training.main(DATA_FLAGS + ["--data_root", str(fixture_dir / "data"), "--shape",
                                "PointCloud", "--point_num", str(POINT_NUM),
                                "--img_feature_dim", str(FEATURE_DIM), "--shape_feature_dim",
                                str(FEATURE_DIM), "--nce", "pose", "--weighting", "sqrt",
                                "--n_epoch", "1", "--result_dir", "pose"])
    run = fixture_dir / "pose" / "PointCloud_ObjectNet3D"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 1 and records[0]["kind"] == "teacher_epoch"
    assert np.isfinite(records[0]["train_loss"]) and np.isfinite(records[0]["val_nce"])
