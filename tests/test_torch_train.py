"""The port's teacher training slice against the JAX package, on the CPU:
masked train-mode BatchNorm, the train-mode PointNet, one teacher train
step (`use_fused_nce=True`, no dropout), the optimizer and its schedule,
the training samples, and the training CLI on the synthetic fixture.

Small sizes: ResNet-50 at 64x64, feature dims 64, 100 points, batch 8.

Tolerances. Module tests run in f32: outputs within 1e-5 of max|ref|,
running statistics within 1e-5. The train step is held in f64 on both
sides (JAX under `jax.enable_x64`, the port's model in double): in f32 the
batch-statistics BatchNorm of a 53-layer network at batch 8 turns the two
frameworks' different summation orders into 1e-3 relative differences of
the features (measured here; in f64 they agree to 1e-12), so an f32
comparison would test the conditioning, not the port. Both steps take
their losses (the NCE included) in f32, as JAX's step casts its outputs,
and JAX's train-mode PointNet takes its statistics in f32. There:
losses within 1e-5 relative; each gradient within 1e-3 of its max|ref|,
except the biases of layers followed by a train-mode BatchNorm, whose
gradient is zero in exact arithmetic (both sides within 1e-6 of the
largest gradient); running statistics within 1e-5; parameters after the
first Adam step within 1e-2 lr where |g| > 1e-6, g the gradient Adam
takes (with its L2 term): the first step is lr g / (|g| + eps), so where
|g| is near eps rounding flips its sign.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from pose3d_tpu import losses as jlosses
from pose3d_tpu.data import datasets as jdatasets
from pose3d_tpu.data import synthetic
from pose3d_tpu.data.annotations import OBJECTNET3D_TEST_CATS
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.common import bn_mask
from pose3d_tpu.models.pointnet import ShapeEncoderPC as JaxShapeEncoderPC
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.cli import testing, training
from pose3d_tpu_torch.data import datasets, transforms
from pose3d_tpu_torch.models.common import BatchNorm
from pose3d_tpu_torch.models.estimators import PoseEstimator
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.ops import nce
from pose3d_tpu_torch.ops.augment import dewire
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train import trainer as trainer_lib
from pose3d_tpu_torch.train.ckpt import Checkpointer
from pose3d_tpu_torch.train.state import create_train_state, multistep_lr, torch_style_adam
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FEATURE_DIM, INPUT_DIM, POINT_NUM, BATCH = 64, 64, 100, 8
LR = 1e-4
CATS = ("bed", "bookshelf", "calculator")


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# --- masked train-mode BatchNorm -------------------------------------------

@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_matches_flax(rng, rank, masked):
    """Output, gradients and the running statistics after one step, against
    flax BatchNorm(momentum 0.9, eps 1e-5) with `bn_mask`."""
    shape = (6, 5) if rank == 2 else (6, 4, 3, 5)  # flax: channels last
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 3, 5) + rng.uniform(-2, 2, 5))
    x = x.astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    valid = np.arange(6) < 4 if masked else None
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    mean0 = rng.standard_normal(5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(xx, params):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mask=None if valid is None else bn_mask(jnp.asarray(valid), xx),
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (dx_j, dp_j) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    to_torch = (lambda a: torch.from_numpy(a)) if rank == 2 else \
        (lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))))
    port = BatchNorm(5)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0),
                          "num_batches_tracked": torch.tensor(0)})
    xt = to_torch(x).requires_grad_()
    y = port.train()(xt, None if valid is None else torch.from_numpy(valid))
    (y * to_torch(cot)).sum().backward()
    back = (lambda a: a) if rank == 2 else (lambda a: a.permute(0, 2, 3, 1))
    rows = slice(None) if valid is None else valid
    # padded rows' outputs are not used downstream; the valid rows' are
    assert _rel(back(y.detach()).numpy()[rows], np.asarray(y_j)[rows]) <= 1e-5
    assert _rel(back(xt.grad).numpy()[rows], np.asarray(dx_j)[rows]) <= 1e-5
    assert _rel(port.weight.grad.numpy(), dp_j["scale"]) <= 1e-5
    assert _rel(port.bias.grad.numpy(), dp_j["bias"]) <= 1e-5
    np.testing.assert_allclose(port.running_mean.numpy(), stats_j["mean"], atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), stats_j["var"], atol=1e-5)


def test_batchnorm_running_variance_is_biased(rng):
    """torch's own BatchNorm moves running_var toward the unbiased
    variance; flax, and the port, toward the biased one."""
    x = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    port = BatchNorm(3).train()
    port(x)
    want = 0.9 + 0.1 * x.var(dim=0, unbiased=False)
    torch.testing.assert_close(port.running_var, want, rtol=0, atol=1e-6)
    assert not torch.allclose(port.running_var, 0.9 + 0.1 * x.var(dim=0, unbiased=True))


def test_batchnorm_one_value_per_channel():
    """A batch of one row: flax's variance is 0 (torch's library BN refuses
    it in training), so the output is the bias."""
    port = BatchNorm(3).train()
    with torch.no_grad():
        port.bias.copy_(torch.tensor([0.5, -1.0, 2.0]))
    y = port(torch.tensor([[3.0, -4.0, 7.0]]))
    torch.testing.assert_close(y, port.bias.detach()[None], rtol=0, atol=1e-6)
    torch.testing.assert_close(port.running_var, torch.full((3,), 0.9))


@pytest.mark.parametrize("masked", [False, True])
def test_pointnet_train_matches_jax(rng, masked):
    pts = rng.uniform(0, 1, (6, POINT_NUM, 3)).astype(np.float32)
    pts *= rng.uniform(0.2, 1.0, (6, 1, 3)).astype(np.float32)
    valid = np.arange(6) < 5 if masked else None
    jmodel = JaxShapeEncoderPC(FEATURE_DIM)
    variables = jax.tree_util.tree_map(np.asarray, dict(
        jmodel.init(jax.random.key(0), jnp.asarray(pts), train=False)))
    for i, fan_in in enumerate((3, 64, 128)):  # He-scaled: outputs of order one
        k = variables["params"][f"Dense_{i}"]["kernel"]
        variables["params"][f"Dense_{i}"] = {
            "kernel": (rng.standard_normal(k.shape) * np.sqrt(2 / fan_in)).astype(np.float32),
            "bias": (rng.standard_normal(k.shape[1]) * 0.1).astype(np.float32)}
    want, mut = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(pts),
                             train=True, mask=None if valid is None else jnp.asarray(valid),
                             mutable=["batch_stats"])
    port = ShapeEncoderPC(FEATURE_DIM)
    state = {}
    for i in range(3):
        convert._conv1d(variables["params"][f"Dense_{i}"], state, f"conv{i + 1}")
        convert._bn(variables["params"][f"BatchNorm_{i}"],
                    variables["batch_stats"][f"BatchNorm_{i}"], state, f"bn{i + 1}")
    port.load_state_dict(convert._to_tensors(state), strict=True)
    got = port.train()(torch.from_numpy(pts), None if valid is None else torch.from_numpy(valid))
    rows = slice(None) if valid is None else valid
    assert _rel(got.detach().numpy()[rows], np.asarray(want)[rows]) <= 1e-5
    for i in range(3):
        stats = mut["batch_stats"][f"BatchNorm_{i}"]
        bn = getattr(port, f"bn{i + 1}")
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-5)


# --- one teacher train step, in f64 -----------------------------------------

def _step_inputs(masked):
    rng = np.random.default_rng(21)
    im = rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3))
    # clouds of different extents, so that the shape features differ
    # between samples as real objects' do
    extent = rng.uniform(0.2, 1.0, (BATCH, 1, 3))
    pc = rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) * extent
    labels = chip_smoke.random_labels(rng, BATCH)
    valid = np.arange(BATCH) < BATCH - 2 if masked else None
    return im, pc, labels, valid


@functools.cache
def _jax_step(masked):
    """JAX's teacher loss and gradients (the body of its train step, with
    `use_fused_nce=True` and no dropout) and the state after one update of
    its torch-style Adam, in f64."""
    variables = chip_smoke.teacher_variables(np.random.default_rng(3), FEATURE_DIM,
                                             FEATURE_DIM)
    im, pc, labels, valid = _step_inputs(masked)
    with jax.enable_x64(True):
        model = JaxPoseEstimator(img_feature_dim=FEATURE_DIM, shape_feature_dim=FEATURE_DIM,
                                 dtype=jnp.float64)
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        vmask = None if valid is None else jnp.asarray(valid)

        def loss_fn(params):
            (outputs, fused, img_proj), mut = model.apply(
                {"params": params, "batch_stats": jv["batch_stats"]}, jnp.asarray(im),
                jnp.asarray(pc), train=True, mask=vmask, mutable=["batch_stats"])
            gt = jlosses.pose_loss(outputs, jnp.asarray(labels), 15, valid=vmask)
            nce_loss = jsteps.route_info_nce(img_proj, fused, 0.1, None, 0.0, vmask, True)
            return gt + 0.5 * nce_loss, (gt, nce_loss, mut["batch_stats"])

        (loss, (gt, nce_loss, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
        tx = jstate.torch_style_adam(jstate.multistep_lr(LR, [100]), weight_decay=5e-4)
        updates, _ = tx.update(grads, tx.init(jv["params"]), jv["params"])
        new_params = optax.apply_updates(jv["params"], updates)
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        return (variables, [float(loss), float(gt), float(nce_loss)],
                convert.pose_state_dict({"params": to_np(grads),
                                         "batch_stats": variables["batch_stats"]}),
                convert.pose_state_dict({"params": to_np(new_params),
                                         "batch_stats": to_np(stats)}))


def _port_step(masked):
    variables, *_ = _jax_step(masked)
    im, pc, labels, valid = _step_inputs(masked)
    model = PoseEstimator(img_feature_dim=FEATURE_DIM, shape_feature_dim=FEATURE_DIM)
    model.load_state_dict(convert.pose_state_dict(variables), strict=True)
    state = create_train_state(model.double(), LR, [100], seed=0)
    batch = {"im": torch.from_numpy(im), "shape": torch.from_numpy(pc),
             "label": torch.from_numpy(labels)}
    if valid is not None:
        batch["valid"] = torch.from_numpy(valid)
    step = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)
    metrics = step(state, batch)
    return model, metrics


@pytest.mark.parametrize("masked", [False, True])
def test_teacher_train_step_matches_jax(masked):
    _, want_losses, want_grads, want_state = _jax_step(masked)
    model, metrics = _port_step(masked)
    for key, want in zip(("loss", "pose_loss", "nce_loss"), want_losses):
        assert float(metrics[key]) == pytest.approx(want, rel=1e-5), key
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == {k for k in want_grads if "running" not in k
                          and not k.endswith("num_batches_tracked")}
    largest = max(float(np.abs(want_grads[k]).max()) for k in grads)
    for name, got in grads.items():
        want = np.asarray(want_grads[name], np.float64)
        if np.abs(want).max() < 1e-6 * largest:  # a bias before a train-mode BN
            assert float(got.abs().max()) < 1e-6 * largest, name
        else:
            assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max(), name
    state = model.state_dict()
    start = convert.pose_state_dict(_jax_step(masked)[0])
    for name, want in want_state.items():
        if name.endswith("num_batches_tracked"):
            assert int(state[name]) == 1, name
        elif "running" in name:
            np.testing.assert_allclose(state[name].numpy(), want, atol=1e-5, err_msg=name)
        else:
            # the gradient Adam takes: the loss's plus the L2 term
            g = np.asarray(want_grads[name]) + 5e-4 * start[name].numpy()
            moved = np.abs(g) > 1e-6
            np.testing.assert_allclose(state[name].numpy()[moved], np.asarray(want)[moved],
                                       rtol=0, atol=1e-2 * LR, err_msg=name)


def test_train_step_on_cpu_makes_no_kernel_launch_and_draws_its_dropout():
    """On the CPU the NCE takes its plain version; the dropout mask comes
    from the state's generator, so one seed gives one loss."""
    losses = []
    for seed in (7, 7, 8):
        model = PoseEstimator(img_feature_dim=32, shape_feature_dim=32,
                              generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, LR, [100], seed=seed)
        rng = np.random.default_rng(0)
        batch = {"im": torch.from_numpy(rng.standard_normal((4, 32, 32, 3),
                                                            dtype=np.float32)),
                 "shape": torch.from_numpy(rng.uniform(0, 1, (4, 50, 3)).astype(np.float32)),
                 "label": torch.from_numpy(chip_smoke.random_labels(rng, 4))}
        before = nce.nce_forward.launches, nce.nce_backward.launches
        metrics = steps.make_teacher_train_step(use_fused_nce=True)(state, batch)
        assert (nce.nce_forward.launches, nce.nce_backward.launches) == before
        assert state.step == 1 and np.isfinite(float(metrics["loss"]))
        losses.append(float(metrics["nce_loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_u8_wire_is_dewired_as_the_host_float():
    raw = (np.arange(16 * 16 * 3) % 256).astype(np.uint8).reshape(16, 16, 3)
    np.testing.assert_array_equal(dewire(torch.from_numpy(raw)).numpy(),
                                  transforms.to_float_array(Image.fromarray(raw)))
    x = torch.rand(3)
    assert dewire(x) is x


# --- optimizer and schedule -------------------------------------------------

def test_adam_and_schedule_match_optax(rng):
    """torch Adam with L2 decay and the step-counted MultiStepLR against
    JAX's torch_style_adam over multistep_lr, five updates across the
    milestone."""
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(5)]
    tx = jstate.torch_style_adam(jstate.multistep_lr(1e-2, [3]), weight_decay=5e-4)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch_style_adam([p], 1e-2)
    sched = multistep_lr(opt, [3])
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=0, atol=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)


def test_train_state_checkpoint_round_trip(tmp_path):
    model = PoseEstimator(img_feature_dim=32, shape_feature_dim=32,
                          generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, [2], seed=5)
    p = next(model.parameters())
    p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state.step = 1
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_epoch(0, state.state_dict(), 12.5, is_best=True)
    draw = torch.rand(4, generator=state.generator)

    other = create_train_state(PoseEstimator(img_feature_dim=32, shape_feature_dim=32),
                               LR, [2], seed=9)
    saved = ckpt.restore("checkpoint")
    other.load_state_dict(saved)
    assert ckpt.latest_epoch() == 0 and ckpt.exists("best") and ckpt.best_acc() == 12.5
    assert other.step == 1
    for a, b in zip(model.state_dict().values(), other.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(other.optimizer.state_dict()["state"][0]["exp_avg"],
                       state.optimizer.state_dict()["state"][0]["exp_avg"])
    assert other.scheduler.last_epoch == 1
    assert torch.equal(torch.rand(4, generator=other.generator), draw)


# --- training samples -------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    synthetic.make_objectnet3d_fixture(str(root / "data" / "Pascal3D"),
                                       categories=("bus", "car"), n_train_per_cat=3,
                                       n_val_per_cat=2, image_size=48,
                                       dataset_name="Pascal3D")
    return root


@pytest.mark.parametrize("kind", ["contrast_train", "pascal_train_random", "pascal_val"])
def test_training_samples_match_jax(fixture_dir, kind):
    """One seed, the same samples (every array equal) as the JAX datasets."""
    common = dict(input_dim=INPUT_DIM, shape="PointCloud", shape_dir="pointcloud",
                  point_num=POINT_NUM)
    if kind == "contrast_train":
        root, name = str(fixture_dir / "data" / "ObjectNet3D"), "ObjectNet3D.txt"
        jds = jdatasets.Pascal3DContrast(root, name, train=True, cat_choice=OBJECTNET3D_TEST_CATS,
                                         keypoint=False, seed=46, **common)
        ds = datasets.Pascal3DContrast(root, name, train=True, cat_choice=OBJECTNET3D_TEST_CATS,
                                       keypoint=False, seed=46, **common)
    else:
        root, name = str(fixture_dir / "data" / "Pascal3D"), "Pascal3D.txt"
        kw = dict(train=kind == "pascal_train_random", random=kind == "pascal_train_random",
                  random_range=2, **common)
        jds, ds = jdatasets.Pascal3D(root, name, **kw), datasets.Pascal3D(root, name, **kw)
    assert len(ds) == len(jds) > 0 and ds.category_names == jds.category_names
    for i in range(len(ds)):
        want = jds.get(i, np.random.default_rng((46, 1, i)))
        got = ds.get(i, np.random.default_rng((46, 1, i)))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")


# --- the training CLI --------------------------------------------------------

CLI_FLAGS = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir", "pointcloud",
             "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
             "--point_num", str(POINT_NUM), "--img_feature_dim", str(FEATURE_DIM),
             "--shape_feature_dim", str(FEATURE_DIM), "--decrease", "1", "--fused_nce",
             "--device", "cpu", "--print_freq", "1"]


def test_training_cli_two_epochs_then_resume(fixture_dir, monkeypatch):
    """2 epochs on the fixture (9 train samples: batches of 4 and 4), then
    --resume to a third; the testing CLI reads the saved teacher."""
    monkeypatch.chdir(fixture_dir)
    flags = CLI_FLAGS + ["--data_root", str(fixture_dir / "data")]
    training.main(flags + ["--n_epoch", "2"])
    run = fixture_dir / "result" / "PointCloud_ObjectNet3D"
    assert {"training_log.txt", "config.json", "metrics.jsonl", "curves_losses.csv",
            "curves_accuracies.csv"} <= set(os.listdir(run))
    assert {"checkpoint.pth", "checkpoint_img_encoder.pth", "EPOCH"} <= \
        set(os.listdir(run / "ckpt"))
    log = (run / "training_log.txt").read_text()
    assert "Epoch: 000" in log and "Epoch: 001" in log and "val_contrastive_loss" in log
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and r["train_samples"] == 8 for r in records)

    training.main(flags + ["--n_epoch", "3", "--resume"])
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert (run / "ckpt" / "EPOCH").read_text() == "2"
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert saved["step"] == 6  # three epochs of two steps

    result = testing.main(["--dataset", "ObjectNet3D", "--shape", "PointCloud",
                           "--shape_dir", "pointcloud", "--data_root",
                           str(fixture_dir / "data"), "--input_dim", str(INPUT_DIM),
                           "--img_feature_dim", str(FEATURE_DIM), "--shape_feature_dim",
                           str(FEATURE_DIM), "--point_num", str(POINT_NUM), "--model",
                           str(run / "ckpt" / "checkpoint.pth"), "--device", "cpu",
                           "--output_dir", str(fixture_dir / "preds")])
    assert len(result.cat_ids) == 6


def test_resume_into_a_worse_epoch_keeps_the_best(fixture_dir, monkeypatch):
    """Epochs scoring 40, 60, then (resumed) 50: the resumed epoch is not
    the best, so best.pth keeps epoch 1's state and the run returns 60."""
    monkeypatch.chdir(fixture_dir)
    scores = [40.0, 60.0, 50.0]
    evaluate = trainer_lib.TeacherTrainer._eval

    def scripted(self, loader):
        return dataclasses.replace(evaluate(self, loader),
                                   mean_acc=scores[self.train_loader.epoch])

    monkeypatch.setattr(trainer_lib.TeacherTrainer, "_eval", scripted)
    flags = CLI_FLAGS + ["--data_root", str(fixture_dir / "data"), "--result_dir",
                         str(fixture_dir / "worse")]
    assert training.main(flags + ["--n_epoch", "2"]) == 60.0
    ckpt = fixture_dir / "worse" / "PointCloud_ObjectNet3D" / "ckpt"
    best = (ckpt / "best.pth").read_bytes()
    assert training.main(flags + ["--n_epoch", "3", "--resume"]) == 60.0
    assert (ckpt / "EPOCH").read_text() == "2"
    assert (ckpt / "best.pth").read_bytes() == best


def test_training_cli_masked_batch_on_a_small_set(fixture_dir, monkeypatch, tmp_path):
    """A train set smaller than one batch gives one padded, masked batch:
    the step and the metrics honour the mask."""
    monkeypatch.chdir(tmp_path)
    flags = [f if f != "4" else "16" for f in CLI_FLAGS]
    training.main(flags + ["--data_root", str(fixture_dir / "data"), "--n_epoch", "1"])
    run = tmp_path / "result" / "PointCloud_ObjectNet3D"
    (record,) = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert record["train_samples"] == 9 and np.isfinite(record["train_loss"])
