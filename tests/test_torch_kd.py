"""The port's KD `--crd` slice against the JAX package, on the CPU: the KD
losses, the student in train mode (masked BatchNorm, dropout keep-masks
from a generator), one KD step against JAX's `make_kd_crd_step`, the KD
trainer, and the KD CLI on the synthetic fixture.

Small sizes: the student at width_mult 0.25, input 32, feature 64; the
teacher ResNet-50 at 32x32 with feature dims 64 and 100 points; batch 4
samples (12 rows over the three views), one of them padded.

Tolerances. The losses alone: f32 on both sides, values and gradients
within 1e-6 relative. The student's train-mode forward: f64 on both sides
(in f32 its four batch-statistics BatchNorms at 7 valid rows turn the
summation order into 3e-5 relative differences), outputs of the valid
rows within 1e-9 of max|ref|, running statistics within 1e-9. The KD step: the student in f64 on both sides
(JAX under `jax.enable_x64`), the frozen teacher in f32 (its eval
PointNet is f32 only) and the losses in f32, as JAX's step casts them;
the two teachers differ in f32 rounding (folded vs unfolded PointNet BN),
so losses within 1e-5 relative, each student gradient within 1e-3 of its
max|ref| (biases before a train-mode BatchNorm, zero in exact arithmetic:
both within 1e-6 of the largest gradient), running statistics within 1e-5.
"""

import functools
import importlib.util
import json
import os
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
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.cli import testing, training, trainingKD
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.losses import kd
from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
from pose3d_tpu_torch.ops import pointnet, vgg_stem
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.trainer import KDTrainer
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


# --- the KD losses ----------------------------------------------------------

@pytest.mark.parametrize("temperature", [1.0, 4.0])
@pytest.mark.parametrize("masked", [False, True])
def test_kd_losses_match_jax(rng, temperature, masked):
    n = 9
    s_out = [rng.standard_normal((n, c)).astype(np.float32) * 3 for c in (24, 12, 24) * 2]
    t_out = [rng.standard_normal((n, c)).astype(np.float32) * 3 for c in (24, 12, 24) * 2]
    s_feat, t_feat = (rng.standard_normal((n, 200)).astype(np.float32) for _ in range(2))
    gt = np.float32(2.5)
    valid = np.arange(n) < 7 if masked else None
    jvalid = None if valid is None else jnp.asarray(valid)

    def jax_losses(s_out, s_feat):
        kl = jkd.temperature_scaled_kl(s_out[0], jnp.asarray(t_out[0]), temperature, jvalid)
        plain = jkd.kd_loss(s_out, [jnp.asarray(t) for t in t_out], gt, temperature,
                            valid=jvalid)
        crd = jkd.kd_loss_with_features(s_out, [jnp.asarray(t) for t in t_out], s_feat,
                                        jnp.asarray(t_feat), gt, temperature, valid=jvalid)
        return kl, plain, crd

    want = jax_losses([jnp.asarray(s) for s in s_out], jnp.asarray(s_feat))
    want_grads = jax.grad(lambda so, sf: jax_losses(so, sf)[2], argnums=(0, 1))(
        [jnp.asarray(s) for s in s_out], jnp.asarray(s_feat))

    so = [torch.from_numpy(s).requires_grad_() for s in s_out]
    sf = torch.from_numpy(s_feat).requires_grad_()
    to = [torch.from_numpy(t) for t in t_out]
    tv = None if valid is None else torch.from_numpy(valid)
    got = (kd.temperature_scaled_kl(so[0], to[0], temperature, tv),
           kd.kd_loss(so, to, torch.tensor(gt), temperature, valid=tv),
           kd.kd_loss_with_features(so, to, sf, torch.from_numpy(t_feat), torch.tensor(gt),
                                    temperature, valid=tv))
    for g, w in zip(got, want):
        assert float(g.detach()) == pytest.approx(float(w), rel=1e-6)
    grads = torch.autograd.grad(got[2], so + [sf])
    for g, w in zip(grads, list(want_grads[0]) + [want_grads[1]]):
        assert _rel(g.numpy(), w) <= 1e-6
    if masked:  # padded rows take no gradient
        assert float(grads[0][~tv].abs().max()) == 0.0


# --- the student in train mode ----------------------------------------------

def _student_variables(seed=7):
    return chip_smoke.student_variables(np.random.default_rng(seed), STUDENT_DIM,
                                        WIDTH_MULT, INPUT_DIM)


def _port_student(variables, dropout_rate=0.0):
    model = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                              input_dim=INPUT_DIM, dropout_rate=dropout_rate)
    model.load_state_dict(convert.baseline_state_dict(variables), strict=True)
    return model


def test_student_train_mode_with_mask_matches_jax(rng):
    """In f64 on both sides: in f32 the four batch-statistics BatchNorms at
    7 valid rows turn summation order into 3e-5 relative differences."""
    variables = _student_variables()
    im = rng.standard_normal((9, INPUT_DIM, INPUT_DIM, 3))
    valid = np.arange(9) < 7
    with jax.enable_x64(True):
        jmodel = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                      dropout_rate=0.0, dtype=jnp.float64)
        (heads_j, proj_j), mut = jmodel.apply(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables),
            jnp.asarray(im), train=True, mask=jnp.asarray(valid),
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        heads_j, proj_j = [np.asarray(h) for h in heads_j], np.asarray(proj_j)
        stats_j = jax.device_get(mut["batch_stats"])
    port = _port_student(variables).double().train()
    heads, proj = port(torch.from_numpy(im), mask=torch.from_numpy(valid))
    for got, want in zip(heads + [proj], heads_j + [proj_j]):
        assert _rel(got.detach().numpy()[valid], want[valid]) <= 1e-9
    state = port.state_dict()
    for path, want in jax.tree_util.tree_leaves_with_path(stats_j):
        sub, kind = path[0].key, path[-1].key  # DenseBNRelu_k, mean / var
        k = int(sub.split("_")[1])
        name = (f"compress.{3 * k + 1}" if k < 3 else "projector.1") + \
            (".running_mean" if kind == "mean" else ".running_var")
        np.testing.assert_allclose(state[name].numpy(), want, rtol=0, atol=1e-9,
                                   err_msg=name)


def test_student_batchnorm_leaves_padded_rows_out(rng):
    """A padded batch (two rows of garbage, masked) leaves the running
    statistics and the valid rows' outputs where the valid rows alone put
    them: the student hands its mask to the compress MLP's and the
    projector's BatchNorms. In f64, where the masked and the unmasked
    statistics agree to rounding."""
    variables = _student_variables()
    im = rng.standard_normal((6, INPUT_DIM, INPUT_DIM, 3))
    im[4:] = 50.0
    valid = torch.from_numpy(np.arange(6) < 4)
    padded, alone = (_port_student(variables).double().train() for _ in range(2))
    heads, proj = padded(torch.from_numpy(im), mask=valid)
    heads_a, proj_a = alone(torch.from_numpy(im[:4]))
    torch.testing.assert_close(proj[:4], proj_a, rtol=0, atol=1e-9)
    torch.testing.assert_close(heads[0][:4], heads_a[0], rtol=0, atol=1e-9)
    state, want = padded.state_dict(), alone.state_dict()
    for name in want:
        if "running" in name:
            torch.testing.assert_close(state[name], want[name], rtol=0, atol=1e-9)


def test_student_dropout_draws_from_the_given_generator(rng):
    """The classifier dropout's keep-masks come from the caller's
    generator (one seed, one output; torch's global generator untouched) or
    are handed in, as a test hands JAX's masks in."""
    model = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                              input_dim=INPUT_DIM,
                              generator=torch.Generator().manual_seed(0)).train()
    im = torch.from_numpy(rng.standard_normal((5, INPUT_DIM, INPUT_DIM, 3)).astype(np.float32))
    global_state = torch.random.get_rng_state()
    outs = [model(im, generator=torch.Generator().manual_seed(s))[1] for s in (3, 3, 4)]
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    keep = model.img_encoder.keep_masks(5, torch.Generator().manual_seed(3), im.device)
    assert len(keep) == 2 and keep[0].shape == (5, 4096) and keep[0].dtype == torch.bool
    assert 0.4 < float(keep[0].float().mean()) < 0.6  # rate 0.5
    assert torch.equal(model(im, keep=keep)[1], outs[0])
    with pytest.raises(ValueError, match="generator"):
        model(im)


# --- one KD --crd step against JAX ------------------------------------------

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


@functools.cache
def _jax_step():
    """JAX's make_kd_crd_step on the student in f64 and the teacher in f32,
    with plain SGD at lr 1 as the update, so that the step's gradient is
    the parameters' change."""
    svars = _student_variables(11)
    tvars = chip_smoke.teacher_variables(np.random.default_rng(12), TEACHER_DIM, TEACHER_DIM)
    batch = _step_inputs()
    with jax.enable_x64(True):
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=jnp.float64)
        teacher = JaxPoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), svars["params"])
        stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       svars["batch_stats"])
        tx = optax.sgd(1.0)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params),
                                  rng=jax.random.key(0), tx=tx)
        step = jax.jit(jsteps.make_kd_crd_step(student, teacher, 15, 1.0))
        new_state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, tvars),
                                  {k: jnp.asarray(v) for k, v in batch.items()})
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params,
                                       new_state.params)
        new_stats = jax.device_get(new_state.batch_stats)
        metrics = {k: float(v) for k, v in metrics.items()}
    return svars, tvars, metrics, grads, new_stats


def test_kd_crd_step_matches_jax():
    svars, tvars, want_metrics, want_grads, want_stats = _jax_step()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _step_inputs().items()}
    student = _port_student(svars).double()
    state = create_train_state(student, LR, [100], seed=0)
    teacher = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
    teacher.load_state_dict(convert.pose_state_dict(tvars), strict=True)
    teacher.requires_grad_(False)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    launches = (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                pointnet.pointnet_eval.launches)

    metrics = steps.make_kd_crd_step()(state, teacher, batch)

    assert launches == (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                        pointnet.pointnet_eval.launches)  # the CPU takes plain versions
    for key in ("loss", "gt_loss"):
        assert float(metrics[key]) == pytest.approx(want_metrics[key], rel=1e-5), key
    assert float(metrics["acc_rot"]) == pytest.approx(want_metrics["acc_rot"], abs=1e-4)
    want_grads = convert.baseline_state_dict({"params": want_grads,
                                              "batch_stats": svars["batch_stats"]})
    grads = {name: p.grad for name, p in student.named_parameters()}
    assert set(grads) == {k for k in want_grads if "running" not in k
                          and not k.endswith("num_batches_tracked")}
    largest = max(float(want_grads[k].abs().max()) for k in grads)
    for name, got in grads.items():
        want = want_grads[name].double()
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN
            assert float(got.abs().max()) < 1e-6 * largest, name
        else:
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
    want_state = convert.baseline_state_dict({"params": svars["params"],
                                              "batch_stats": want_stats})
    for name, value in student.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), want_state[name].numpy(), atol=1e-5,
                                       err_msg=name)
    # the frozen teacher: no gradient, nothing moved
    assert all(p.grad is None for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    assert state.step == 1


# --- the KD trainer ---------------------------------------------------------

class KDSet:
    """KD samples (three views, their labels, a cloud) made from a seed
    and held in memory, with the dataset interface the loader takes."""

    def __init__(self, n, seed, train=True):
        rng = np.random.default_rng(seed)
        self.batch = {"im": rng.standard_normal((n, INPUT_DIM, INPUT_DIM, 3)).astype(np.float32),
                      "label": chip_smoke.random_labels(rng, n),
                      "cat_id": rng.integers(0, len(CATS), n).astype(np.int32)}
        if train:
            for view in ("_flip", "_rot"):
                self.batch["im" + view] = rng.standard_normal(
                    (n, INPUT_DIM, INPUT_DIM, 3)).astype(np.float32)
                self.batch["label" + view] = chip_smoke.random_labels(rng, n)
            self.batch["shape"] = rng.uniform(0, 1, (n, POINT_NUM, 3)).astype(np.float32)
        self.category_names = list(CATS)

    def __len__(self):
        return len(self.batch["label"])

    def get(self, idx, rng):
        return {k: v[idx] for k, v in self.batch.items()}


def _small_teacher():
    teacher = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM,
                            generator=torch.Generator().manual_seed(2))
    return teacher.eval().requires_grad_(False)


def test_kd_trainer_two_epochs_then_resume(tmp_path):
    def run(epochs, start_epoch, seed):
        student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                    input_dim=INPUT_DIM,
                                    generator=torch.Generator().manual_seed(seed))
        state = create_train_state(student, LR, [100], seed=seed)
        trainer = KDTrainer(state, _small_teacher(),
                            DataLoader(KDSet(10, 1), 4, shuffle=True, drop_last=True,
                                       num_workers=2),
                            DataLoader(KDSet(7, 2, train=False), 4, shuffle=False,
                                       num_workers=2),
                            list(CATS), str(tmp_path))
        if start_epoch:
            state.load_state_dict(trainer.ckpt.restore("checkpoint"))
        trainer.fit_crd(epochs, start_epoch=start_epoch)
        return state, trainer

    state, trainer = run(2, 0, seed=5)
    assert state.step == 4 and trainer.ckpt.latest_epoch() == 1
    assert {"checkpoint.pth", "EPOCH"} <= set(os.listdir(tmp_path / "ckpt"))
    saved = trainer.ckpt.restore("checkpoint")
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k

    resumed, trainer = run(3, 2, seed=9)
    assert resumed.step == 6 and trainer.ckpt.latest_epoch() == 2
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text()
               .splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["kind"] == "crd_epoch" and r["train_samples"] == 8 and
               np.isfinite(r["train_loss"]) and r["train_samples_per_s"] > 0
               for r in records)
    log = (tmp_path / "training_log.txt").read_text()
    assert log.count("Student Epoch:") == 3 and "val_med" in log


# --- the KD CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_kd")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    return root


DATA_FLAGS = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir", "pointcloud",
              "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
              "--point_num", str(POINT_NUM), "--img_feature_dim", str(TEACHER_DIM),
              "--shape_feature_dim", str(TEACHER_DIM), "--decrease", "1", "--device", "cpu"]


def test_kd_cli_two_epochs_resume_and_testing(fixture_dir, monkeypatch):
    """The teacher CLI writes a checkpoint.pth; the KD CLI distils from it
    for 2 epochs, then --resume into a third; the testing CLI reads the
    student's checkpoint.pth and reports the MedErr of the KD log's last
    val_med; --export_torch writes a reference-layout student."""
    monkeypatch.chdir(fixture_dir)
    data = ["--data_root", str(fixture_dir / "data")]
    training.main(DATA_FLAGS + data + ["--fused_nce", "--n_epoch", "1"])
    teacher_ckpt = fixture_dir / "result" / "PointCloud_ObjectNet3D" / "ckpt" / "checkpoint.pth"
    kd_flags = DATA_FLAGS + data + ["--crd", "--teacher_model", str(teacher_ckpt),
                                    "--student_feature_dim", str(STUDENT_DIM),
                                    "--student_width_mult", str(WIDTH_MULT)]
    trainingKD.main(kd_flags + ["--n_epoch", "2"])
    run = fixture_dir / "result" / "KD_ObjectNet3D"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    export = fixture_dir / "student.pth"
    trainingKD.main(kd_flags + ["--n_epoch", "3", "--resume", "--export_torch", str(export)])
    assert (run / "ckpt" / "EPOCH").read_text() == "2"
    assert torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)["step"] == 6
    log = (run / "training_log.txt").read_text()
    assert log.count("Student Epoch:") == 3
    last_med = float(log.strip().splitlines()[-1].split("val_med")[1])

    result = testing.main(["--dataset", "ObjectNet3D", "--shape", "None", "--data_root",
                           str(fixture_dir / "data"), "--input_dim", str(INPUT_DIM),
                           "--img_feature_dim", str(STUDENT_DIM), "--student_width_mult",
                           str(WIDTH_MULT), "--model", str(run / "ckpt" / "checkpoint.pth"),
                           "--device", "cpu", "--output_dir", str(fixture_dir / "preds")])
    assert round(result.mean_med, 2) == last_med
    exported = torch.load(export, weights_only=True)["state_dict"]
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM)
    student.load_state_dict(exported, strict=True)


# what each case now meets, where it is not a refusal naming ROADMAP.md: None
# for a flag that is ported (parsed without complaint), else the message
KD_CLI_OUTCOMES = {
    ("--stage", "1", "--nce", "multipose"): None, ("--stage", "2"): None,
    ("--contrast",): None, ("--vid",): None, ("--bf16",): None,
    ("--use_memory_bank",): "--use_memory_bank applies to --stage 1 only",
    ("--nce", "pose"): "--nce pose/multipose applies to --stage 1",  # JAX's
    ("--vid", "--contrast"): "--vid is a --crd loss variant",  # JAX's
    ("--stage", "1", "--use_memory_bank", "--nce", "pose"): "no memory-bank form",
    ("--shape", "MultiView"): None,
    ("--dataset", "Pix3D"): "unsupported KD training dataset Pix3D",  # JAX's
    ("--int8_teacher",): None, ("--stage", "2", "--int8_teacher"): None,
    ("--device_augment",): None, ("--device_views",): None, ("--device_shapes",): None,
    ("--stage", "2", "--device_views"): None,
    ("--stage", "2", "--device_views", "--device_augment"): None,
    ("--stage", "1", "--device_views"): "applies to the 3-view regimes",  # JAX's
    ("--stage", "1", "--device_augment"): "ignores the flag",
    ("--stage", "2", "--device_augment"): "trains on raw, unnormalised pixels",
}


@pytest.mark.parametrize("argv", [
    ["--stage", "1", "--nce", "multipose"], ["--stage", "2"], ["--contrast"], ["--vid"],
    ["--int8_teacher"],
    ["--device_augment"], ["--device_views"], ["--device_shapes"], ["--use_memory_bank"],
    ["--fused_nce"], ["--bf16"], ["--n_devices", "2"], ["--profile_dir", "trace"],
    ["--tau", "0.5"], ["--nce", "pose"], ["--random"], ["--random_range", "2"],
    ["--loader", "shm"], ["--cache_decoded_mb", "64"], ["--model", "s.pth"],
    ["--shape", "MultiView"], ["--dataset", "Pix3D"],
    ["--stage", "2", "--int8_teacher"], ["--stage", "2", "--device_views"],
    ["--stage", "2", "--fused_nce"], ["--stage", "1", "--use_memory_bank", "--nce", "pose"],
    ["--vid", "--contrast"], ["--contrast", "--crd"], ["--stage", "2", "--contrast"],
    ["--stage", "2", "--device_views", "--device_augment"], ["--stage", "1", "--device_views"],
    ["--stage", "1", "--device_augment"], ["--stage", "2", "--device_augment"]])
def test_kd_cli_refuses_unported_flags(argv):
    """Each flag of a path not ported is refused, naming ROADMAP.md; the
    flags this port has since taken are accepted, or refused with JAX's
    own message where JAX refuses them (KD_CLI_OUTCOMES)."""
    flags = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--device", "cpu"]
    expected = KD_CLI_OUTCOMES.get(tuple(argv), "ROADMAP")
    if expected is None:
        trainingKD.parse_args(flags + argv)
    else:
        with pytest.raises(SystemExit, match=expected):
            trainingKD.main(flags + argv)


def test_kd_cli_refuses_a_checkpoint_directory(fixture_dir, tmp_path, monkeypatch):
    """The JAX package's orbax checkpoints are directories: named, refused."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="ROADMAP"):
        trainingKD.main(DATA_FLAGS + ["--data_root", str(fixture_dir / "data"),
                                      "--teacher_model", str(tmp_path)])
