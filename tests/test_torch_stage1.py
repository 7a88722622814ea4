"""The port's KD `--stage 1` slice against the JAX package, on the CPU: the
vanilla teacher (`PoseEstimatorVanilla`) from `pose_vanilla_state_dict` of
JAX's variables, one `make_stage1_step` against JAX's, and the stage-1 CLI
on the synthetic fixture.

Small sizes: the vanilla teacher's ResNet-18 at 32x32 with feature dims 64
and 100 points; the student at width_mult 0.25, input 32, feature 64, no
dropout; batch 4, one of them padded in the masked cases.

Tolerances. The eval forward: f32, within 1e-4 of max|ref| (the port
folds the PointNet's BatchNorms into its weights, JAX does not). The train
forward: f64 on both sides, within 1e-4 of max|ref|: JAX's
`dense_bn_forward` takes the PointNet's batch statistics in f32 even in an
f64 model (`pose3d_tpu/models/pointnet.py:58`), which moves the shape
features by about 4e-7, and the compress MLP's batch statistics over 4
valid rows magnify that to about 1e-5. The step, as
tests/test_torch_kd.py holds the KD step: both models in f64 (JAX under
`jax.enable_x64`) and the losses in f32, as JAX's step casts them; the two
sides' f32 losses round differently, so losses within 1e-5 relative, each
gradient within 1e-3 of its max|ref|, the biases before a train-mode
BatchNorm (zero in exact arithmetic) within 1e-6 of the largest gradient on
both sides, running statistics within 1e-5.
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
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu.train.torch_export import export_pose_estimator_vanilla
from pose3d_tpu_torch.cli import trainingKD
from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimatorVanilla
from pose3d_tpu_torch.ops import pointnet_train
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FEATURE_DIM, INPUT_DIM, POINT_NUM, BATCH = 64, 32, 100, 4
STUDENT_DIM, WIDTH_MULT = 64, 0.25
LR = 1e-4
CATS = ("bed", "bookshelf", "calculator")


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _vanilla_variables(seed=3):
    return chip_smoke.vanilla_variables(np.random.default_rng(seed), FEATURE_DIM, FEATURE_DIM)


def _port_vanilla(variables):
    model = PoseEstimatorVanilla(img_feature_dim=FEATURE_DIM, shape_feature_dim=FEATURE_DIM)
    model.load_state_dict(convert.pose_vanilla_state_dict(variables), strict=True)
    return model


def _inputs(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    im = rng.standard_normal((n, INPUT_DIM, INPUT_DIM, 3))
    extent = rng.uniform(0.2, 1.0, (n, 1, 3))
    pc = rng.uniform(0, 1, (n, POINT_NUM, 3)) * extent
    return im, pc, chip_smoke.random_labels(rng, n)


# --- the vanilla teacher ----------------------------------------------------

@pytest.mark.parametrize("img_feature_dim,shape_feature_dim", [(64, 64), (1024, 256)])
def test_chip_smoke_vanilla_variables_have_jax_shapes(img_feature_dim, shape_feature_dim):
    """chip_smoke.py writes the JAX vanilla teacher's shapes out by hand:
    hold them against jax.eval_shape."""
    model = JaxPoseEstimatorVanilla(img_feature_dim=img_feature_dim,
                                    shape_feature_dim=shape_feature_dim)
    want = jax.eval_shape(functools.partial(model.init, train=False), jax.random.key(0),
                          jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2500, 3)))
    got = chip_smoke.vanilla_variables(np.random.default_rng(0), img_feature_dim,
                                       shape_feature_dim)
    assert _shapes(got) == _shapes(dict(want))


def test_state_dict_keys_match_torch_export():
    """The port's keys and shapes are the reference layout that torch_export
    writes for the vanilla teacher (built on the meta device)."""
    shapes = jax.eval_shape(functools.partial(JaxPoseEstimatorVanilla().init, train=False),
                            jax.random.key(0), jnp.zeros((1, 224, 224, 3)),
                            jnp.zeros((1, 2500, 3)))
    exported = export_pose_estimator_vanilla(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), dict(shapes)))
    with torch.device("meta"):
        port = PoseEstimatorVanilla().state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(np.shape(v)) for k, v in exported.items()}


def test_vanilla_eval_forward_matches_jax():
    variables = _vanilla_variables()
    im, pc, _ = _inputs(4)
    want_out, want_x = JaxPoseEstimatorVanilla(
        img_feature_dim=FEATURE_DIM, shape_feature_dim=FEATURE_DIM).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(im, jnp.float32),
        jnp.asarray(pc, jnp.float32), train=False)
    model = _port_vanilla(variables).eval()
    with torch.no_grad():
        out, x = model(torch.from_numpy(im).float(), torch.from_numpy(pc).float())
    for g, w in zip(out + [x], list(want_out) + [want_x]):
        assert _rel(g.numpy(), w) <= 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_vanilla_train_forward_matches_jax(masked):
    """Train mode in f64: batch statistics over the valid rows (the PointNet
    in its train-mode op), the running statistics updated."""
    variables = _vanilla_variables()
    im, pc, _ = _inputs(5, 6)
    valid = np.arange(6) < 4 if masked else None
    with jax.enable_x64(True):
        jmodel = JaxPoseEstimatorVanilla(img_feature_dim=FEATURE_DIM,
                                         shape_feature_dim=FEATURE_DIM, dtype=jnp.float64)
        (want_out, want_x), mut = jmodel.apply(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables),
            jnp.asarray(im), jnp.asarray(pc), train=True,
            mask=None if valid is None else jnp.asarray(valid), mutable=["batch_stats"])
        want_stats = convert.pose_vanilla_state_dict(
            {"params": variables["params"],
             "batch_stats": jax.tree_util.tree_map(np.asarray, mut["batch_stats"])})
    model = _port_vanilla(variables).double().train()
    out, x = model(torch.from_numpy(im), torch.from_numpy(pc),
                   mask=None if valid is None else torch.from_numpy(valid))
    rows = slice(None) if valid is None else valid
    for g, w in zip(out + [x], list(want_out) + [want_x]):
        assert _rel(g.detach().numpy()[rows], np.asarray(w)[rows]) <= 1e-4
    for name, value in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(), atol=1e-5,
                                       err_msg=name)


# --- one stage-1 step against JAX ------------------------------------------

def _student_variables(seed=7):
    return chip_smoke.student_variables(np.random.default_rng(seed), STUDENT_DIM, WIDTH_MULT,
                                        INPUT_DIM)


def _batch(masked):
    im, pc, labels = _inputs(31)
    batch = {"im": im, "shape": pc, "label": labels}
    if masked:
        batch["valid"] = np.arange(BATCH) < BATCH - 1
    return batch


@functools.cache
def _jax_step(masked):
    """JAX's make_stage1_step (use_fused_nce) on both models in f64, with
    plain SGD at lr 1 as each update, so that a step's gradient is the
    parameters' change; and the NCE keep-masks it drew."""
    tvars, svars = _vanilla_variables(13), _student_variables(14)
    batch = _batch(masked)
    with jax.enable_x64(True):
        teacher = JaxPoseEstimatorVanilla(img_feature_dim=FEATURE_DIM,
                                          shape_feature_dim=FEATURE_DIM, dtype=jnp.float64)
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=jnp.float64)

        def state(variables, key):
            f64 = functools.partial(jax.tree_util.tree_map,
                                    lambda a: jnp.asarray(a, jnp.float64))
            params, tx = f64(variables["params"]), optax.sgd(1.0)
            return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                     batch_stats=f64(variables["batch_stats"]),
                                     opt_state=tx.init(params), rng=key, tx=tx)

        t_state, s_state = state(tvars, jax.random.key(1)), state(svars, jax.random.key(0))
        step = jax.jit(jsteps.make_stage1_step(teacher, student, 15, tau=0.5,
                                               use_fused_nce=True))
        new_t, new_s, metrics = step(t_state, s_state,
                                     {k: jnp.asarray(v) for k, v in batch.items()})
        # the keep-masks of the two NCE directions, drawn as the step draws them
        rng, _ = jax.random.split(s_state.rng)
        _, rng1, rng2 = jax.random.split(rng, 3)
        keep = [np.asarray(jax.random.bernoulli(r, 0.7, (BATCH, 200))) for r in (rng1, rng2)]
        out = {"metrics": {k: float(v) for k, v in metrics.items()}, "keep": keep}
        for name, old, new, variables, to_sd in (
                ("teacher", t_state, new_t, tvars, convert.pose_vanilla_state_dict),
                ("student", s_state, new_s, svars, convert.baseline_state_dict)):
            grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), old.params,
                                           new.params)
            out[name] = (to_sd({"params": grads, "batch_stats": variables["batch_stats"]}),
                         to_sd({"params": variables["params"],
                                "batch_stats": jax.device_get(new.batch_stats)}))
    return tvars, svars, out


def _check_model(model, want_grads, want_state):
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == {k for k in want_grads if "running" not in k
                          and not k.endswith("num_batches_tracked")}
    largest = max(float(want_grads[k].abs().max()) for k in grads)
    for name, got in grads.items():
        want = want_grads[name].double()
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN
            assert float(got.abs().max()) < 1e-6 * largest, name
        else:
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
    for name, value in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), want_state[name].numpy(), atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_stage1_step_matches_jax(masked):
    tvars, svars, want = _jax_step(masked)
    teacher = _port_vanilla(tvars).double()
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    t_state = create_train_state(teacher, LR, [100], seed=1)
    s_state = create_train_state(student.double(), LR, [100], seed=0)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(masked).items()}
    launches = (pointnet_train.train_forward.launches, pointnet_train.train_backward.launches)

    metrics = steps.make_stage1_step(use_fused_nce=True)(
        t_state, s_state, batch, keep=[torch.from_numpy(np.array(k)) for k in want["keep"]])

    # the CPU takes the plain versions
    assert launches == (pointnet_train.train_forward.launches,
                        pointnet_train.train_backward.launches)
    for key in ("loss", "teacher_loss"):
        assert float(metrics[key]) == pytest.approx(want["metrics"][key], rel=1e-5), key
    assert float(metrics["acc_rot"]) == pytest.approx(want["metrics"]["acc_rot"], abs=1e-4)
    _check_model(teacher, *want["teacher"])
    _check_model(student, *want["student"])
    assert t_state.step == s_state.step == 1


def test_stage1_step_draws_its_masks_from_the_student_generator():
    """Without injected masks the step draws them (and nothing else) from
    the student's generator, never from torch's global one."""
    teacher = _port_vanilla(_vanilla_variables())
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM)
    t_state = create_train_state(teacher, LR, [100], seed=1)
    s_state = create_train_state(student, LR, [100], seed=0)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(False).items()}
    batch["im"], batch["shape"] = batch["im"].float(), batch["shape"].float()
    global_state = torch.random.get_rng_state()
    before = s_state.generator.get_state()
    metrics = steps.make_stage1_step()(t_state, s_state, batch)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert not torch.equal(s_state.generator.get_state(), before)
    assert all(np.isfinite(float(v)) for v in metrics.values())


# --- the stage-1 CLI ------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stage1")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    return root


FLAGS = ["--stage", "1", "--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir",
         "pointcloud", "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
         "--point_num", str(POINT_NUM), "--img_feature_dim", str(FEATURE_DIM),
         "--shape_feature_dim", str(FEATURE_DIM), "--student_feature_dim", str(STUDENT_DIM),
         "--student_width_mult", str(WIDTH_MULT), "--decrease", "1", "--device", "cpu"]


def test_stage1_cli_two_epochs_then_resume(fixture_dir, monkeypatch):
    """Two epochs of --stage 1 --fused_nce, then --resume into a third:
    both train states come back from checkpoint.pth."""
    monkeypatch.chdir(fixture_dir)
    flags = FLAGS + ["--data_root", str(fixture_dir / "data"), "--fused_nce"]
    trainingKD.main(flags + ["--n_epoch", "2"])
    run = fixture_dir / "result" / "KD_ObjectNet3D"
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert saved["teacher"]["step"] == saved["student"]["step"] == 4
    export = fixture_dir / "student.pth"
    trainingKD.main(flags + ["--n_epoch", "3", "--resume", "--export_torch", str(export)])
    assert (run / "ckpt" / "EPOCH").read_text() == "2"
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert saved["teacher"]["step"] == saved["student"]["step"] == 6
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["kind"] == "stage1_epoch" and r["train_samples"] == 8 and
               np.isfinite(r["train_loss"]) and np.isfinite(r["val_med"]) for r in records)
    assert (run / "training_log.txt").read_text().count("Student Epoch:") == 3
    model = PoseEstimatorVanilla(img_feature_dim=FEATURE_DIM, shape_feature_dim=FEATURE_DIM)
    model.load_state_dict(saved["teacher"]["model"], strict=True)
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM)
    student.load_state_dict(torch.load(export, weights_only=True)["state_dict"], strict=True)


@pytest.mark.parametrize("argv", [
    ["--use_memory_bank"], ["--nce", "pose"], ["--nce", "multipose"],
    ["--teacher_model", "t.pth"], ["--int8_teacher"], ["--bf16"], ["--device_views"],
    ["--n_devices", "2"], ["--shape", "MultiView"],
    ["--use_memory_bank", "--nce", "multipose"], ["--weighting", "sqrt"],
    ["--device_shapes"], ["--device_augment"]])
def test_stage1_cli_refuses_what_is_not_ported(argv):
    """--use_memory_bank, --nce pose/multipose, --bf16, --shape MultiView and
    --device_shapes are ported: parsed (and --weighting without --nce pose
    dropped with JAX's warning); a bank with a pose variant, --int8_teacher
    (nothing is frozen in stage 1) and --device_views (stage 1 has one
    view) are refused with JAX's reasons, --device_augment (JAX's stage 1
    ignores it) with the port's; the rest name ROADMAP.md."""
    outcomes = {("--use_memory_bank",): None, ("--nce", "pose"): None, ("--bf16",): None,
                ("--shape", "MultiView"): None,
                ("--nce", "multipose"): None, ("--weighting", "sqrt"): None,
                ("--use_memory_bank", "--nce", "multipose"): "no memory-bank form",
                ("--int8_teacher",): "not applicable to --stage 1",  # JAX's
                ("--device_views",): "applies to the 3-view regimes",  # JAX's
                ("--device_shapes",): None, ("--device_augment",): "ignores the flag"}
    expected = outcomes.get(tuple(argv), "ROADMAP")
    if expected is None:
        opt = trainingKD.parse_args(FLAGS + argv)
        assert opt.weighting is None
    else:
        with pytest.raises(SystemExit, match=expected):
            trainingKD.main(FLAGS + argv)


@pytest.mark.parametrize("argv", [["--stage", "2"], ["--crd", "--fused_nce"],
                                  ["--crd", "--tau", "0.5"], ["--crd", "--random"],
                                  ["--stage", "2", "--use_memory_bank"],
                                  ["--stage", "2", "--random_range", "2"]])
def test_kd_cli_keeps_stage1_flags_to_stage1(argv):
    """--stage 2 is ported (parsed); the stage-1 flags elsewhere are refused."""
    flags = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--device", "cpu"]
    if argv == ["--stage", "2"]:
        assert trainingKD.parse_args(flags + argv).stage == 2
        return
    with pytest.raises(SystemExit, match="applies to --stage 1 only"):
        trainingKD.main(flags + argv)
