"""The port's stage-1 variants against the JAX package, on the CPU: the
pose-weighted NCE family (`losses/nce.py`), the memory bank
(`losses/memory_bank.py`), one `make_stage1_step` with the bank and with
`--nce pose` / `--nce multipose`, and the KD CLI's `--stage 1
--use_memory_bank` (2 epochs, then `--resume` with the bank) and `--nce
pose --weighting sqrt` on the synthetic fixture.

Small sizes: as tests/test_torch_stage1.py (the vanilla teacher's
ResNet-18 at 32x32 with feature dims 64 and 100 points; the student at
width_mult 0.25, feature 64, no dropout; batch 4, one row padded in the
masked cases).

Pose distances. Both packages take the pairwise pose distance from their
f32 geodesic error, whose rounding at 0 degrees differs between them (0
against 0.028 degrees on the same label pair): the diagonal's distance
weights the positive itself among the negatives, so that noise moves a
pose-weighted loss by up to 1e-3. The port's distances are held against
JAX's within the geodesic tolerance (rtol 1e-4, atol 0.05 degrees, as
tests/test_torch_geometry.py); every loss and step comparison then gives
both sides one f64 geodesic, rounded to f32
(tests/torch_pose_geodesic.py `one_geodesic`, which sets the modules'
attributes for the test's duration; no file changes).

Tolerances. The losses alone: f32 on both sides, values within 1e-5
relative and gradients within 1e-6 of max|ref| (`rel=1e-5` for a value,
`atol=1e-6` relative to the largest gradient). `enqueue`: exactly equal
queue, ptr and filled. The steps: tests/test_torch_stage1.py's (both models
in f64, the losses in f32; losses within 1e-5 relative, each gradient
within 1e-3 of its max|ref|, the biases before a train-mode BatchNorm
within 1e-6 of the largest gradient, running statistics within 1e-5); the
bank after the step holds the teacher's normalised features, within 1e-4
of max|ref| as the train forward's in tests/test_torch_stage1.py (JAX's
PointNet takes its batch statistics in f32 in an f64 model), its ptr and
filled equal.
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

from pose3d_tpu import losses as jlosses
from pose3d_tpu.losses import nce as jnce
from pose3d_tpu.data import synthetic
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.cli import trainingKD
from pose3d_tpu_torch.losses import memory_bank, nce
from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimatorVanilla
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location(
    "torch_pose_geodesic", pathlib.Path(__file__).resolve().parent / "torch_pose_geodesic.py")
torch_pose_geodesic = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_pose_geodesic)
_one_geodesic = torch_pose_geodesic.one_geodesic

FEATURE_DIM, INPUT_DIM, POINT_NUM, BATCH = 64, 32, 100, 4
STUDENT_DIM, WIDTH_MULT = 64, 0.25
LR = 1e-4
CATS = ("bed", "bookshelf", "calculator")
WEIGHTINGS = ("linear", "square", "sqrt", "sin", "sinsin")


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _feats(seed, n=9, d=200):
    """Query and key features and label triples, some labels within 30
    degrees of each other so that multipose finds several positives."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(2))
    labels = chip_smoke.random_labels(rng, n).astype(np.float32)
    labels[1] = labels[0] + np.float32(5.0)
    labels[4] = labels[3]
    return q, k, labels


def test_pairwise_pose_distance_within_the_geodesic_tolerance():
    """Each package's own f32 distances, and every weighting of them."""
    _, _, labels = _feats(2, n=24)
    got = nce._pairwise_pose_distance_raw(torch.from_numpy(labels)).numpy()
    want = np.asarray(jnce._pairwise_pose_distance_raw(jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)
    np.testing.assert_allclose(np.diagonal(got), 0.0, atol=0.05)
    with _one_geodesic():
        exact = nce._pairwise_pose_distance_raw(torch.from_numpy(labels)).numpy()
        np.testing.assert_allclose(
            exact, np.asarray(jnce._pairwise_pose_distance_raw(jnp.asarray(labels))),
            rtol=1e-6, atol=0)
    assert np.all(np.diagonal(exact) == 0.0)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=0.05)
    for weighting in WEIGHTINGS:
        np.testing.assert_allclose(
            nce._pairwise_pose_distance(torch.from_numpy(labels), weighting).numpy(),
            np.asarray(jnce._pairwise_pose_distance(jnp.asarray(labels), weighting)),
            rtol=1e-4, atol=0.02)


def _check(port_fn, jax_fn, *args, pose=True):
    """Value and both gradients of port_fn against jax_fn on f32 inputs;
    `pose`: under `_one_geodesic`."""
    q, k = args[:2]
    with _one_geodesic() if pose else contextlib.nullcontext():
        want, want_grads = jax.value_and_grad(jax_fn, argnums=(0, 1))(
            jnp.asarray(q), jnp.asarray(k), *args[2:])
        tq, tk = (torch.from_numpy(a).requires_grad_() for a in (q, k))
        got = port_fn(tq, tk, *args[2:])
        grads = torch.autograd.grad(got, (tq, tk))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    largest = max(float(np.abs(g).max()) for g in want_grads)
    for g, w in zip(grads, want_grads):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-6 * largest
    return grads


# --- the NCE family ----------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weighting", WEIGHTINGS)
@pytest.mark.parametrize("which", ["pose_nce", "pose_nce_kd"])
def test_pose_nce_matches_jax(which, weighting, masked):
    q, k, labels = _feats(3)
    valid = np.arange(9) < 7 if masked else None
    grads = _check(
        lambda a, b: getattr(nce, which)(a, b, torch.from_numpy(labels), 0.5, weighting,
                                         None if valid is None else torch.from_numpy(valid)),
        lambda a, b: getattr(jlosses, which)(a, b, jnp.asarray(labels), 0.5, weighting,
                                             None if valid is None else jnp.asarray(valid)),
        q, k)
    if masked:  # padded rows take no gradient as queries
        assert float(grads[0][~torch.from_numpy(valid)].abs().max()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_multi_pose_nce_kd_matches_jax(masked):
    q, k, labels = _feats(4)
    valid = np.arange(9) < 7 if masked else None
    _check(lambda a, b: nce.multi_pose_nce_kd(
               a, b, torch.from_numpy(labels), 0.5,
               valid=None if valid is None else torch.from_numpy(valid)),
           lambda a, b: jlosses.multi_pose_nce_kd(
               a, b, jnp.asarray(labels), 0.5,
               valid=None if valid is None else jnp.asarray(valid)),
           q, k)


def test_info_nce_and_single_info_nce_kd_match_jax():
    q, k, _ = _feats(5)
    _check(lambda a, b: nce.info_nce(a, b, 0.1), lambda a, b: jlosses.info_nce(a, b, 0.1), q, k,
           pose=False)
    _check(lambda a, b: nce.single_info_nce_kd(a, b, 0.1),
           lambda a, b: jlosses.single_info_nce_kd(a, b, 0.1), q, k, pose=False)


def test_unknown_weighting_raises():
    q, k, labels = _feats(6)
    with pytest.raises(ValueError, match="weighting"):
        nce.pose_nce_kd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(labels),
                        weighting="cubic")


# --- the memory bank ---------------------------------------------------------

def _bank_jax(bank):
    return jlosses.MemoryBank(queue=jnp.asarray(bank.queue.numpy()),
                              ptr=jnp.asarray(int(bank.ptr), jnp.int32),
                              filled=jnp.asarray(int(bank.filled), jnp.int32))


def test_enqueue_matches_jax_exactly_over_a_wrapping_sequence():
    """Seven enqueues into a queue of 11: full and padded batches (padded
    rows anywhere, one batch all padded), wrapping twice; queue, ptr and
    filled equal to JAX's after every call. The rows are +-0.25 in 16
    columns, of norm 1 exactly, so that the normalisation is exact in both
    packages and the queue shows where each row went, bit for bit."""
    rng = np.random.default_rng(8)
    port = memory_bank.init_memory_bank(11, 16)
    want = jlosses.init_memory_bank(11, 16)
    for n, valid in ((4, None), (5, [1, 0, 1, 1, 0]), (4, None), (3, [0, 0, 0]),
                     (6, [0, 1, 1, 0, 1, 1]), (5, None), (4, [1, 1, 0, 1])):
        feats = rng.choice(np.float32([-0.25, 0.25]), (n, 16))
        v = None if valid is None else np.asarray(valid, bool)
        want = jlosses.enqueue(want, jnp.asarray(feats), None if v is None else jnp.asarray(v))
        port = memory_bank.enqueue(port, torch.from_numpy(feats),
                                   None if v is None else torch.from_numpy(v))
        assert np.array_equal(port.queue.numpy(), np.asarray(want.queue))
        assert int(port.ptr) == int(want.ptr) and int(port.filled) == int(want.filled)
    assert int(port.filled) == 11 and int(port.ptr) == (4 + 3 + 4 + 0 + 4 + 5 + 3) % 11


def test_enqueue_normalises_its_rows_as_jax():
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((5, 200)).astype(np.float32) * 3
    got = memory_bank.enqueue(memory_bank.init_memory_bank(8, 200), torch.from_numpy(feats))
    want = jlosses.enqueue(jlosses.init_memory_bank(8, 200), jnp.asarray(feats))
    np.testing.assert_allclose(got.queue.numpy(), np.asarray(want.queue), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dropout", [False, True])
def test_info_nce_memory_matches_jax(masked, dropout):
    """A part-filled queue (its empty slots masked out), padded rows out
    of the in-batch keys and the mean, the key dropout's mask handed over."""
    q, k, _ = _feats(9)
    bank = memory_bank.init_memory_bank(32, 200)
    bank = memory_bank.enqueue(bank, torch.from_numpy(_feats(10, n=13)[1]))
    valid = np.arange(9) < 7 if masked else None
    key = jax.random.key(3)
    keep = np.array(jax.random.bernoulli(key, 0.7, k.shape)) if dropout else None
    _check(lambda a, b: memory_bank.info_nce_memory(
               a, b, bank, 0.5, valid=None if valid is None else torch.from_numpy(valid),
               keep=None if keep is None else torch.from_numpy(keep)),
           lambda a, b: jlosses.info_nce_memory(
               a, b, _bank_jax(bank), 0.5, valid=None if valid is None else jnp.asarray(valid),
               dropout_rng=key if dropout else None),
           q, k, pose=False)


# --- one stage-1 step with the bank or a pose variant ------------------------

def _vanilla_variables(seed):
    return chip_smoke.vanilla_variables(np.random.default_rng(seed), FEATURE_DIM, FEATURE_DIM)


def _student_variables(seed):
    return chip_smoke.student_variables(np.random.default_rng(seed), STUDENT_DIM, WIDTH_MULT,
                                        INPUT_DIM)


def _batch(masked):
    rng = np.random.default_rng(31)
    batch = {"im": rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3)),
             "shape": rng.uniform(0, 1, (BATCH, POINT_NUM, 3)) * rng.uniform(0.2, 1.0,
                                                                          (BATCH, 1, 3)),
             "label": chip_smoke.random_labels(rng, BATCH)}
    batch["label"][1] = batch["label"][0] + 7  # a pair within multipose's 30 degrees
    if masked:
        batch["valid"] = np.arange(BATCH) < BATCH - 1
    return batch


def _bank_in():
    bank = memory_bank.init_memory_bank(16, 200)
    return memory_bank.enqueue(bank, torch.from_numpy(_feats(12, n=6)[1]))


@functools.cache
def _jax_step(variant, masked):
    """JAX's make_stage1_step ("bank", "pose" with sqrt weighting, or
    "multipose") on both models in f64, with plain SGD at lr 1 as each
    update, so that a step's gradient is the parameters' change; the NCE
    keep-masks it drew, and its bank after the step."""
    tvars, svars = _vanilla_variables(13), _student_variables(14)
    batch = _batch(masked)
    kw = ({"use_memory_bank": True} if variant == "bank" else
          {"nce_variant": variant, "nce_weighting": "sqrt"})
    with _one_geodesic():
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
        step = jax.jit(jsteps.make_stage1_step(teacher, student, 15, tau=0.5, **kw))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if variant == "bank":
            new_t, new_s, metrics, bank = step(t_state, s_state, jbatch, _bank_jax(_bank_in()))
            bank = {k: np.asarray(v) for k, v in bank._asdict().items()}
        else:
            (new_t, new_s, metrics), bank = step(t_state, s_state, jbatch), None
        rng, _ = jax.random.split(s_state.rng)
        _, rng1, rng2 = jax.random.split(rng, 3)
        keep = [np.asarray(jax.random.bernoulli(r, 0.7, (BATCH, 200))) for r in (rng1, rng2)]
        out = {"metrics": {k: float(v) for k, v in metrics.items()}, "keep": keep, "bank": bank}
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


@pytest.mark.parametrize("variant,masked", [("bank", True), ("pose", True),
                                            ("multipose", True)])
def test_stage1_step_variants_match_jax(variant, masked):
    tvars, svars, want = _jax_step(variant, masked)
    teacher = PoseEstimatorVanilla(img_feature_dim=FEATURE_DIM, shape_feature_dim=FEATURE_DIM)
    teacher.load_state_dict(convert.pose_vanilla_state_dict(tvars), strict=True)
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    t_state = create_train_state(teacher.double(), LR, [100], seed=1)
    s_state = create_train_state(student.double(), LR, [100], seed=0)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(masked).items()}
    kw = ({"use_memory_bank": True} if variant == "bank" else
          {"nce_variant": variant, "nce_weighting": "sqrt"})
    step = steps.make_stage1_step(tau=0.5, **kw)
    keep = [torch.from_numpy(np.array(k)) for k in want["keep"]]
    if variant == "bank":
        metrics, bank = step(t_state, s_state, batch, keep=keep, bank=_bank_in())
        assert _rel(bank.queue.numpy(), want["bank"]["queue"]) <= 1e-4
        assert int(bank.ptr) == int(want["bank"]["ptr"])
        assert int(bank.filled) == int(want["bank"]["filled"]) == 6 + int(
            batch.get("valid", torch.ones(BATCH, dtype=torch.bool)).sum())
    else:
        with _one_geodesic():
            metrics = step(t_state, s_state, batch)  # no dropout: no mask drawn
    for key in ("loss", "teacher_loss"):
        assert float(metrics[key]) == pytest.approx(want["metrics"][key], rel=1e-5), key
    assert float(metrics["acc_rot"]) == pytest.approx(want["metrics"]["acc_rot"], abs=1e-4)
    _check_model(teacher, *want["teacher"])
    _check_model(student, *want["student"])


def test_stage1_step_refuses_a_bank_with_a_pose_variant():
    with pytest.raises(ValueError, match="memory-bank"):
        steps.make_stage1_step(use_memory_bank=True, nce_variant="pose")
    with pytest.raises(ValueError, match="nce_variant"):
        steps.make_stage1_step(nce_variant="cosine")


# --- the CLI -----------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stage1_variants")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48)
    return root


FLAGS = ["--stage", "1", "--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir",
         "pointcloud", "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
         "--point_num", str(POINT_NUM), "--img_feature_dim", str(FEATURE_DIM),
         "--shape_feature_dim", str(FEATURE_DIM), "--student_feature_dim", str(STUDENT_DIM),
         "--student_width_mult", str(WIDTH_MULT), "--decrease", "1", "--device", "cpu"]


def test_stage1_memory_bank_cli_two_epochs_then_resume(fixture_dir, monkeypatch):
    """--use_memory_bank for 2 epochs (2 steps of 4 an epoch) into a queue
    of 20, then --resume into a third: the bank comes back from
    checkpoint.pth and goes on filling (8 a step pair would restart it)."""
    monkeypatch.chdir(fixture_dir)
    flags = FLAGS + ["--data_root", str(fixture_dir / "data"), "--use_memory_bank",
                     "--memory_bank_size", "20", "--result_dir", "bank"]
    trainingKD.main(flags + ["--n_epoch", "2"])
    run = fixture_dir / "bank" / "KD_ObjectNet3D"
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert (int(saved["bank"]["ptr"]), int(saved["bank"]["filled"])) == (16, 16)
    assert saved["bank"]["queue"].shape == (20, 200)
    assert torch.allclose(saved["bank"]["queue"][:16].norm(dim=1), torch.ones(16))
    trainingKD.main(flags + ["--n_epoch", "3", "--resume"])
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert (int(saved["bank"]["ptr"]), int(saved["bank"]["filled"])) == (4, 20)
    assert saved["teacher"]["step"] == saved["student"]["step"] == 6
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["kind"] == "stage1_epoch" and np.isfinite(r["train_loss"]) for r in records)
    assert "memory bank" not in (run / "training_log.txt").read_text()


def test_stage1_pose_nce_cli_and_a_resume_without_a_bank(fixture_dir, monkeypatch):
    """--nce pose --weighting sqrt (with --fused_nce, which the CLI clears
    with a warning) for one epoch; then a --use_memory_bank --resume from
    its checkpoint, which holds no bank: JAX's warning goes to the log."""
    monkeypatch.chdir(fixture_dir)
    flags = FLAGS + ["--data_root", str(fixture_dir / "data"), "--result_dir", "pose"]
    assert trainingKD.parse_args(flags + ["--nce", "pose", "--fused_nce"]).fused_nce is False
    trainingKD.main(flags + ["--nce", "pose", "--weighting", "sqrt", "--n_epoch", "1"])
    run = fixture_dir / "pose" / "KD_ObjectNet3D"
    config = json.loads((run / "config.json").read_text())
    assert (config["nce"], config["weighting"]) == ("pose", "sqrt")
    trainingKD.main(flags + ["--use_memory_bank", "--n_epoch", "2", "--resume"])
    assert "without a saved memory bank" in (run / "training_log.txt").read_text()
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert int(saved["bank"]["filled"]) == 8 and saved["student"]["step"] == 4
