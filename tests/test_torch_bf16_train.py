"""The train-mode PointNet under `--bf16`, and the two training paths that
run it (the contrastive teacher's step and KD `--stage 1`), against the
JAX package's `dtype=jnp.bfloat16`, on the CPU.

The port's bf16 train-mode encoder is `ops.pointnet_train`'s plain bf16
version here (the kernel's bf16 instance runs only on the card, where
chip_smoke.py phase 39 holds it against this plain version). JAX's
counterpart is `ShapeEncoderPC(dtype=bfloat16)` in train mode, its XLA
path (`dense_bn_forward`, then `jnp.max`), which is what JAX's teacher
step and stage-1 step run on every platform but one TPU.

Tolerances (tests/torch_bf16_rules.py, the rules of tests/test_torch_bf16.py).
  * The encoder: out within one bf16 ulp (2^-7 of max|ref|) of JAX's
    chain with exactly rounded batch statistics, under 1 % of the elements
    unequal (`one_ulp`), and within one ulp of JAX's own result, under 1 %
    plus the share by which JAX's result differs from that chain (JAX's
    float32 E[a^2] - E[a]^2 is ill-conditioned where a channel's mean
    dwarfs its spread, and its sums land further from the exact ones than
    the port's); the three (mean, var), float32 on both sides, and the
    running statistics within one bf16 ulp of max|ref|; every parameter gradient held
    to the oracle rule against JAX's float64 encoder (`oracle`: the port's
    error, largest and RMS, at most twice JAX's bf16 error plus 2^-10 of
    max|ref|, and within half an RMS of JAX's bf16 gradient); the dense
    biases' gradients (zero in exact arithmetic: rounding noise on both
    sides, JAX's the larger, as it sums the bf16 terms of 480 points in
    bf16) take the largest weight gradient as their scale and are held to
    the error conditions alone; the gradient of every weight and dense bias (a
    parameter cast to bf16) a bf16 value. The same forward against JAX's
    fused Pallas kernel with `dtype=bfloat16` in interpret mode (the same
    rounding chain), within one bf16 ulp. JAX is jitted with XLA's excess
    precision off wherever it is jitted: by default XLA keeps fused bf16
    chains in f32 and skips roundings flax's dtype names
    (`test_jax_reference_rounds_at_flax_points`).
  * Planted ties (clouds of nearby points, so that about a fifth of the
    maxima tie after rounding, several between points whose h2 differ):
    each weight, gamma and beta gradient within one bf16 ulp (2^-7) of
    max|JAX's bf16 gradient| of JAX's `jax.grad` (op by op: flax's rounding
    points), whose VJP of `jnp.max` splits a tie evenly; the forward is the
    same bits. Two planted faults fail it: the max's gradient sent to the first
    tied point (as the f32 kernel routes it), and the weights' gradients not
    rounded to bf16.
  * One teacher step (`--fused_nce`, no dropout) and one stage-1 step
    (`--fused_nce`, JAX's NCE keep-masks handed in), both models in bf16 on
    both sides, a batch of 4 with one padded: the losses and every
    parameter gradient by the oracle rule against JAX's float64 step, as
    tests/test_torch_bf16.py holds the KD steps.
The CLIs (`training --shape PointCloud --bf16`, `trainingKD --stage 1
--bf16`, one epoch, then `--resume` without the flag) are in
tests/test_torch_bf16.py, beside the other regimes' bf16 CLI runs.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pose3d_tpu.ops.pointnet_train_fused as ptf
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.models.pointnet import ShapeEncoderPC as JaxShapeEncoderPC
from pose3d_tpu.models.pointnet import dense_bn_forward
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.models.common import BatchNorm
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.ops import pointnet_train
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_here = pathlib.Path(__file__).resolve()
_spec = importlib.util.spec_from_file_location("chip_smoke", _here.parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location("torch_bf16_rules",
                                               _here.parent / "torch_bf16_rules.py")
rules = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rules)

BF16 = torch.bfloat16
D = 64
STUDENT_DIM, WIDTH_MULT, INPUT_DIM = 64, 0.25, 32
TEACHER_DIM, POINT_NUM, BATCH = 64, 100, 8
TEACHER_INPUT = 64  # the teacher step's images (ResNet-50)
# the ResNets' residual branches damped (chip_smoke.damp_residuals): at
# the seeded init the train-mode ResNet in bf16 is chaotic at these sizes
DAMPING = 0.2
STEP_SEEDS = (41, 42, 43)  # the steps' batches, over which the rule pools


def _as(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _encoder_variables(rng, d=D):
    """ShapeEncoderPC's flax variables: He-scaled Dense kernels, BN scales
    near 1, biases and shifts of 0.1, running statistics (0, 1)."""
    params, stats = {}, {}
    for i, (fan_in, out) in enumerate(((3, 64), (64, 128), (128, d))):
        params[f"Dense_{i}"] = {
            "kernel": (rng.standard_normal((fan_in, out)) * np.sqrt(2 / fan_in)).astype(
                np.float32),
            "bias": (0.1 * rng.standard_normal(out)).astype(np.float32)}
        params[f"BatchNorm_{i}"] = {
            "scale": (1 + 0.1 * rng.standard_normal(out)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(out)).astype(np.float32)}
        stats[f"BatchNorm_{i}"] = {"mean": np.zeros(out, np.float32),
                                   "var": np.ones(out, np.float32)}
    return {"params": params, "batch_stats": stats}


def _port_encoder(variables, d=D):
    state = {}
    for i in range(3):
        convert._conv1d(variables["params"][f"Dense_{i}"], state, f"conv{i + 1}")
        convert._bn(variables["params"][f"BatchNorm_{i}"],
                    variables["batch_stats"][f"BatchNorm_{i}"], state, f"bn{i + 1}")
    enc = ShapeEncoderPC(d, compute_dtype=BF16)
    enc.load_state_dict(convert._to_tensors(state), strict=True)
    return enc


def _port_layers(enc):
    return [(getattr(enc, f"conv{i}").weight[:, :, 0], getattr(enc, f"conv{i}").bias,
             getattr(enc, f"bn{i}").weight, getattr(enc, f"bn{i}").bias) for i in (1, 2, 3)]


def _port_grads(enc, pts, wvec, valid=None):
    """The port's train-mode encoder in bf16 on (N, P, 3) float32 points:
    (out, its 12 parameter gradients of sum(out * wvec), in (weight, bias,
    gamma, beta) x 3 order)."""
    flat = [t for i in (1, 2, 3) for t in (getattr(enc, f"conv{i}").weight,
                                           getattr(enc, f"conv{i}").bias,
                                           getattr(enc, f"bn{i}").weight,
                                           getattr(enc, f"bn{i}").bias)]
    out = enc.train()(torch.from_numpy(pts), None if valid is None else torch.from_numpy(valid))
    grads = torch.autograd.grad((out.float() * torch.from_numpy(wvec)).sum(), flat)
    return out, [g[:, :, 0] if i % 4 == 0 else g for i, g in enumerate(grads)]


def _jax_grads(variables, pts, wvec, valid, dtype):
    """JAX's ShapeEncoderPC(dtype) in train mode: (out, batch_stats after
    the update, the 12 gradients in the port's order, each (out, in) for a
    kernel)."""
    model = JaxShapeEncoderPC(D, dtype=dtype)
    mask = None if valid is None else jnp.asarray(valid)

    def apply(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(pts), train=True, mask=mask, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32 if dtype == jnp.bfloat16 else dtype) * wvec), (
            out, mut["batch_stats"])

    grads, (out, stats) = jax.grad(apply, has_aux=True)(variables["params"])
    flat = [g for i in range(3) for g in (grads[f"Dense_{i}"]["kernel"].T,
                                          grads[f"Dense_{i}"]["bias"],
                                          grads[f"BatchNorm_{i}"]["scale"],
                                          grads[f"BatchNorm_{i}"]["bias"])]
    return out, stats, [np.asarray(g) for g in flat]


def _exact_statistics_chain(variables, pts, valid):
    """JAX's bf16 rounding chain (`dense_bn_forward`'s, then `jnp.max`)
    with each layer's batch statistics computed in float64 from the
    rounded values and then rounded to float32."""
    x = jnp.asarray(pts)
    for i in range(3):
        dense, bn = variables["params"][f"Dense_{i}"], variables["params"][f"BatchNorm_{i}"]
        a = (jnp.dot(x.astype(jnp.bfloat16), jnp.asarray(dense["kernel"], jnp.bfloat16))
             + jnp.asarray(dense["bias"], jnp.bfloat16))
        af = np.asarray(a.astype(jnp.float32), np.float64)
        rows = af.reshape(-1, af.shape[-1])
        if valid is not None:
            rows = af[valid].reshape(-1, af.shape[-1])
        mu, mu2 = rows.mean(0), (rows * rows).mean(0)
        mu, var = jnp.asarray(mu, jnp.float32), jnp.asarray(np.maximum(0, mu2 - mu * mu),
                                                             jnp.float32)
        y = ((a - mu) * (jax.lax.rsqrt(var + 1e-5) * bn["scale"]) + bn["bias"]).astype(
            jnp.bfloat16)
        x = jax.nn.relu(y) if i < 2 else y
    return jnp.max(x, axis=1)


def _clouds(rng, n, p):
    return (rng.uniform(0, 1, (n, p, 3)) * rng.uniform(0.2, 1.0, (n, 1, 3))).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_train_bf16_matches_jax(masked):
    """ShapeEncoderPC(compute_dtype=bf16) in train mode against JAX's
    ShapeEncoderPC(dtype=bfloat16): out, the batch statistics and the
    running statistics to one bf16 ulp; the 12 gradients by the oracle rule
    against JAX's f64 encoder; the cast parameters' gradients bf16 values."""
    rng = np.random.default_rng(7)
    n, p = 6, 80
    variables = _encoder_variables(rng)
    pts = _clouds(rng, n, p)
    valid = np.arange(n) < n - 2 if masked else None
    wvec = rng.standard_normal((n, D)).astype(np.float32)
    want_out, want_stats, want = _jax_grads(_as(variables, jnp.float32), pts, wvec, valid,
                                            jnp.bfloat16)
    with jax.enable_x64(True):
        _, _, ref = _jax_grads(_as(variables, jnp.float64), pts.astype(np.float64), wvec,
                               valid, jnp.float64)

    enc = _port_encoder(variables)
    out, grads = _port_grads(enc, pts, wvec, valid)
    assert out.dtype == BF16 and want_out.dtype == jnp.bfloat16
    # JAX's E[a^2] - E[a]^2 in float32 is ill-conditioned where a channel's
    # mean dwarfs its spread (layer 3); JAX's and the port's float32 sums
    # differ, and where JAX's lands further from the exact statistics a few
    # outputs round to the next bf16 value: the port is held to JAX's own
    # chain with exactly rounded statistics, and to JAX within that share
    exact = _exact_statistics_chain(variables, pts, valid)
    own = float(np.mean(rules._np(want_out) != rules._np(exact)))
    rules.one_ulp(out, exact, f"encoder out vs exact statistics, masked {masked}")
    rules.one_ulp(out, want_out, f"encoder out, masked {masked}",
                  unequal_max=rules.UNEQUAL_MAX + own)
    for i in range(3):
        bn, st = getattr(enc, f"bn{i + 1}"), want_stats[f"BatchNorm_{i}"]
        assert bn.running_mean.dtype == torch.float32
        rules.one_ulp(bn.running_mean, st["mean"], f"running mean {i + 1}", None)
        rules.one_ulp(bn.running_var, st["var"], f"running var {i + 1}", None)
    # the batch statistics themselves (float32 on both sides)
    _, stats = pointnet_train.pointnet_train(
        torch.from_numpy(pts).to(BF16), _port_layers(enc),
        None if valid is None else torch.from_numpy(valid))
    x = jnp.asarray(pts)
    for i, (mean, var) in enumerate(stats):
        x, (want_mean, want_var) = dense_bn_forward(
            x, variables["params"][f"Dense_{i}"], variables["params"][f"BatchNorm_{i}"], None,
            True, jnp.bfloat16, mask=None if valid is None else jnp.asarray(valid), relu=i < 2)
        assert mean.dtype == var.dtype == torch.float32
        rules.one_ulp(mean, want_mean, f"mean {i + 1}", None)
        rules.one_ulp(var, want_var, f"var {i + 1}", None)

    largest = max(float(np.abs(ref[4 * i]).max()) for i in range(3))
    for i, (got, w, r) in enumerate(zip(grads, want, ref)):
        assert got.dtype == torch.float32
        rules.oracle(got, w, r, f"d{i}", scale=largest if i % 4 == 1 else None,
                     agree=i % 4 != 1)
        if i % 4 < 2:  # the dense weights and biases, cast to bf16
            assert torch.equal(got, got.to(BF16).float()), f"d{i} is not bf16"


def _strict(fn, *args):
    """fn(*args) jitted with XLA's excess precision off (`_compiled`)."""
    return _compiled(fn, *args)(*args)


def test_jax_reference_rounds_at_flax_points(monkeypatch):
    """What the reference is. JAX's ShapeEncoderPC(dtype=bfloat16) in train
    mode and JAX's fused Pallas kernel with dtype=bfloat16 (interpret
    mode), each jitted with XLA's excess precision off, round where the
    model does op by op (flax's points, which the port follows), bit for
    bit. Jitted as XLA compiles by default, both keep fused bf16 chains in
    f32 and part from them (the shares printed, not held: they are JAX's)."""
    monkeypatch.setattr(ptf, "_INTERPRET", True)
    rng = np.random.default_rng(7)
    variables = _encoder_variables(rng)
    pts = jnp.asarray(_clouds(rng, 5, 40))
    model = JaxShapeEncoderPC(D, dtype=jnp.bfloat16)
    apply = lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"])[0]
    params = tuple((variables["params"][f"Dense_{i}"], variables["params"][f"BatchNorm_{i}"])
                   for i in range(3))
    fused = lambda p, x: ptf.pointnet_train_fused(x, p, jnp.bfloat16)[0]
    eager = rules._np(apply(variables, pts))
    default = [rules._np(jax.jit(f)(a, pts)) for f, a in ((apply, variables),
                                                          (fused, _as(params, jnp.float32)))]
    print(f"unequal to op by op, jitted by default: the model {np.mean(default[0] != eager):.3g}, "
          f"the fused kernel {np.mean(default[1] != eager):.3g}")
    np.testing.assert_array_equal(rules._np(_strict(apply, variables, pts)), eager)
    np.testing.assert_array_equal(rules._np(_strict(fused, _as(params, jnp.float32), pts)), eager)


def test_encoder_train_bf16_forward_matches_the_pallas_kernel(monkeypatch):
    """JAX's fused train-mode kernel with dtype=bfloat16 (interpret mode,
    XLA's excess precision off) takes the same rounding chain: out and the
    statistics to one bf16 ulp of the port's plain version (out under 1 %
    unequal)."""
    monkeypatch.setattr(ptf, "_INTERPRET", True)
    rng = np.random.default_rng(8)
    variables = _encoder_variables(rng)
    pts = _clouds(rng, 5, 40)
    params = tuple((variables["params"][f"Dense_{i}"], variables["params"][f"BatchNorm_{i}"])
                   for i in range(3))
    want_out, want_stats = _strict(lambda p, x: ptf.pointnet_train_fused(x, p, jnp.bfloat16),
                                   _as(params, jnp.float32), jnp.asarray(pts))
    out, stats = pointnet_train.pointnet_train(torch.from_numpy(pts).to(BF16),
                                               _port_layers(_port_encoder(variables)))
    rules.one_ulp(out, want_out, "pallas bf16 out")
    for i, ((mean, var), (wm, wv)) in enumerate(zip(stats, want_stats)):
        rules.one_ulp(mean, wm, f"pallas mean {i + 1}", None)
        rules.one_ulp(var, wv, f"pallas var {i + 1}", None)


def _tied_clouds(seed):
    """Clouds of 48 points on a 2^-8 grid, 3 steps each way around one point
    each, in bf16's values: about a fifth of the (cloud, channel) maxima
    tie after rounding, a dozen of them between points whose h2 differ."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 1.0, (4, 1, 3))
    pts = base + rng.integers(-3, 4, (4, 48, 3)) * 2.0**-8
    return np.asarray(torch.from_numpy(pts).to(BF16).float()), rng


def _tie_rule(grads, want):
    """Each weight, gamma and beta gradient within one bf16 ulp (2^-7) of
    max|JAX's|; every weight and dense bias gradient a bf16 value (the dense
    biases' are rounding noise, zero in exact arithmetic, and JAX sums
    theirs in bf16)."""
    for i, (got, w) in enumerate(zip(grads, want)):
        if i % 4 != 1:
            err = float(np.abs(got.numpy().astype(np.float64) - w).max()) / np.abs(w).max()
            print(f"d{i}: max|d| {err:.3g} of max|ref|")
            assert err <= rules.ULP, f"tie split d{i}"
        if i % 4 < 2:
            assert torch.equal(got, got.to(BF16).float()), f"d{i} is not bf16"


@pytest.mark.parametrize("fault", [None, "first_argmax", "unrounded_weight_gradient"])
def test_planted_ties_split_as_jax_grad(fault, monkeypatch):
    """Tied maxima: the port's gradient is jax.grad's even split over the
    tied points (the forward is the same bits). The rule fails the max's
    gradient sent to the first tied point, and weight gradients taken
    without their rounding to bf16 (the forward unchanged)."""
    pts, rng = _tied_clouds(9)
    variables = _encoder_variables(rng, 32)
    wvec = rng.standard_normal((4, 32)).astype(np.float32)
    model = JaxShapeEncoderPC(32, dtype=jnp.bfloat16)
    apply = lambda p: model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(pts), train=True, mutable=["batch_stats"])[0]
    want_out = apply(_as(variables["params"], jnp.float32))
    g = jax.grad(lambda p: jnp.sum(apply(p).astype(jnp.float32) * wvec))(
        _as(variables["params"], jnp.float32))
    want = [np.asarray(t, np.float64) for i in range(3)
            for t in (g[f"Dense_{i}"]["kernel"].T, g[f"Dense_{i}"]["bias"],
                      g[f"BatchNorm_{i}"]["scale"], g[f"BatchNorm_{i}"]["bias"])]
    if fault == "first_argmax":
        monkeypatch.setattr(pointnet_train, "_max_over_points", lambda y: y.gather(
            1, y.detach().argmax(1, keepdim=True))[:, 0])
    elif fault == "unrounded_weight_gradient":
        # the product in float32 on the bf16 values, rounded once: the same
        # forward, a weight gradient that never passes through a bf16 cast
        monkeypatch.setattr(pointnet_train, "_dense_bf16", lambda x, w, b: (
            torch.nn.functional.linear(x.float(), w + (w.to(BF16).float() - w).detach())
            .to(BF16) + b.to(BF16)))
    enc = _port_encoder(variables, 32)
    out, grads = _port_grads(enc, pts, wvec)
    share, distinct = _ties(enc, pts)
    print(f"tied maxima {share:.3f} of the (cloud, channel) entries, {distinct} between points "
          f"whose h2 differ")
    assert 0.1 < share < 0.5 and distinct >= 5, (share, distinct)
    assert torch.equal(out.float(), torch.from_numpy(np.array(want_out.astype(jnp.float32))))
    if fault is None:
        _tie_rule(grads, want)
    else:
        with pytest.raises(AssertionError, match="tie split|is not bf16"):
            _tie_rule(grads, want)


def _ties(enc, pts):
    """In the port's bf16 forward: the share of (cloud, channel) maxima that
    more than one point reaches, and how many of those tie points whose h2
    differ (where sending the gradient to one of them changes it)."""
    layers = _port_layers(enc)
    with torch.no_grad():
        _, stats, (_, a2, a3) = pointnet_train.plain_bf16_parts(torch.from_numpy(pts), layers)
        h2 = pointnet_train._bn_relu_bf16(a2, *stats[1], *layers[1][2:], True)
        x = pointnet_train._bn_relu_bf16(a3, *stats[2], *layers[2][2:], False)
    tied = x == x.amax(1, keepdim=True)
    distinct = sum(
        1 for n in range(x.shape[0]) for c in range(x.shape[2])
        if len(at := torch.nonzero(tied[n, :, c]).flatten()) > 1
        and any(not torch.equal(h2[n, at[0]], h2[n, j]) for j in at[1:]))
    return float((tied.sum(1) > 1).float().mean()), distinct


# --- the teacher step and the stage-1 step ---------------------------------------

def _batch(seed, input_dim=INPUT_DIM):
    rng = np.random.default_rng(seed)
    return {"im": rng.standard_normal((BATCH, input_dim, input_dim, 3)).astype(np.float32),
            "shape": _clouds(rng, BATCH, POINT_NUM),
            "label": chip_smoke.random_labels(rng, BATCH),
            "valid": np.arange(BATCH) < BATCH - 1}


def _sgd_state(variables, key):
    """JAX's train state with plain SGD at lr 1, so that a step's gradient
    is the parameters' change; the parameters ride in f64 (their values
    the f32 ones): each layer casts them to its compute dtype."""
    params, tx = _as(variables["params"], jnp.float64), optax.sgd(1.0)
    return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=_as(variables["batch_stats"], jnp.float64),
                             opt_state=tx.init(params), rng=key, tx=tx)


def _grads(old, new):
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), old.params, new.params)


def _compiled(step, *args):
    """`step` jitted for `args`, with XLA's excess precision off: by default
    XLA may keep a fused chain of bf16 operations in float32 and skip
    roundings that flax's dtype puts there (`test_jax_reference_rounds_at_
    flax_points`: the jitted PointNet then parts from the same code run op
    by op, and a jitted step lies closer to float64 than its own rounding
    points allow);
    without it the jitted step rounds where the eager one does, at flax's
    points, which the port follows."""
    return jax.jit(step).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


@functools.cache
def _jax_teacher_steps(dtype_name):
    """JAX's make_teacher_train_step (use_fused_nce, no dropout) on the
    PointCloud teacher in `dtype_name`, from the same state on each batch
    of STEP_SEEDS: (variables, [(metrics, gradients as a port state_dict)]
    a batch)."""
    dtype = {"bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype_name]
    variables = chip_smoke.damp_residuals(chip_smoke.teacher_variables(
        np.random.default_rng(12), TEACHER_DIM, TEACHER_DIM), DAMPING)
    runs = []
    with jax.enable_x64(True):
        model = JaxPoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM,
                                 dtype=dtype)
        state = _sgd_state(variables, jax.random.key(0))
        step = None
        for seed in STEP_SEEDS:
            batch = {k: jnp.asarray(v) for k, v in _batch(seed, TEACHER_INPUT).items()}
            step = step or _compiled(jsteps.make_teacher_train_step(
                model, 15, nce_dropout=0.0, use_fused_nce=True), state, batch)
            new, metrics = step(state, batch)
            runs.append(({k: float(v) for k, v in metrics.items()}, convert.pose_state_dict(
                {"params": _grads(state, new), "batch_stats": variables["batch_stats"]})))
    return variables, runs


@functools.cache
def _jax_stage1_steps(dtype_name):
    """JAX's make_stage1_step (use_fused_nce) on the vanilla teacher and the
    student in `dtype_name`, from the same states on each batch of
    STEP_SEEDS: (variables, [(metrics, the NCE keep-masks it drew, each
    model's gradients as a port state_dict)] a batch)."""
    dtype = {"bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype_name]
    tvars = chip_smoke.damp_residuals(chip_smoke.vanilla_variables(
        np.random.default_rng(13), TEACHER_DIM, TEACHER_DIM), DAMPING)
    svars = chip_smoke.student_variables(np.random.default_rng(14), STUDENT_DIM, WIDTH_MULT,
                                         INPUT_DIM)
    runs = []
    with jax.enable_x64(True):
        teacher = JaxPoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                          shape_feature_dim=TEACHER_DIM, dtype=dtype)
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=dtype)
        t_state, s_state = (_sgd_state(tvars, jax.random.key(1)),
                            _sgd_state(svars, jax.random.key(0)))
        rng, _ = jax.random.split(s_state.rng)
        _, rng1, rng2 = jax.random.split(rng, 3)
        keep = [np.asarray(jax.random.bernoulli(r, 0.7, (BATCH, 200))) for r in (rng1, rng2)]
        step = None
        for seed in STEP_SEEDS:
            batch = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
            step = step or _compiled(jsteps.make_stage1_step(
                teacher, student, 15, tau=0.5, use_fused_nce=True), t_state, s_state, batch)
            new_t, new_s, metrics = step(t_state, s_state, batch)
            grads = {"teacher": convert.pose_vanilla_state_dict(
                         {"params": _grads(t_state, new_t), "batch_stats": tvars["batch_stats"]}),
                     "student": convert.baseline_state_dict(
                         {"params": _grads(s_state, new_s), "batch_stats": svars["batch_stats"]})}
            runs.append(({k: float(v) for k, v in metrics.items()}, keep, grads))
    return (tvars, svars), runs


def _check_losses(got, want, ref, keys, what):
    """The steps' losses held to the pooled oracle rule, each step's losses
    as one vector: the loss and its parts are one function's outputs, and
    a part's bf16 error (a few 1e-3 of it here, on either side) can cancel
    another's in the sum on one side and not on the other."""
    vector = lambda m: np.array([float(m[k]) for k in keys], np.float64)
    rules.pooled_oracle([(vector(g), vector(w), vector(r), None)
                         for g, w, r in zip(got, want, ref)], f"{what} losses {keys}")


def _check_grads(got, want, ref, what, skip=(), in_bn=()):
    """Every parameter gradient (but `skip`) of the steps, `got` the port's
    {name: gradient} a step, held to the pooled oracle rule against JAX's
    bf16 (`want`) and f64 (`ref`) gradients; a gradient zero in exact
    arithmetic (a bias before a train-mode BatchNorm: its f64 one under
    1e-3 of the step's largest gradient) takes that largest as its scale
    and, rounding noise on both sides, only the error conditions; the cast
    parameters' gradients (all but BatchNorm's, `in_bn`) bf16 values."""
    names = [k for k in got[0] if k not in skip]
    largest = [max(float(r[k].abs().max()) for k in names) for r in ref]
    for name in names:
        zero = all(float(r[name].abs().max()) < 1e-3 * top for r, top in zip(ref, largest))
        rules.pooled_oracle([(g[name], w[name], r[name], top if zero else None)
                             for g, w, r, top in zip(got, want, ref, largest)],
                            f"{what} d{name}", agree=not zero)
        for g in got:
            assert g[name].dtype == torch.float32
            if name not in in_bn:
                assert torch.equal(g[name], g[name].to(BF16).float()), f"{what} d{name} not bf16"


def _bn_params(model):
    return {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
            if isinstance(m, BatchNorm) for p_name, _ in m.named_parameters()}


def test_teacher_step_bf16_matches_jax():
    """Teacher steps (--fused_nce, no dropout), each from the same weights
    on one of three batches, with the teacher in bf16 on both sides: the
    three losses and every gradient by the pooled oracle rule; the
    train-mode PointNet in its bf16 plain version here, no kernel."""
    variables, want = _jax_teacher_steps("bfloat16")
    _, ref = _jax_teacher_steps("float64")
    metrics, grads = [], []
    launches = (pointnet_train.train_forward_bf16.launches,
                pointnet_train.train_backward_bf16.launches)
    for seed in STEP_SEEDS:
        model = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM,
                              compute_dtype=BF16)
        model.load_state_dict(convert.pose_state_dict(variables), strict=True)
        state = create_train_state(model, 1e-4, [100], seed=0)
        batch = {k: torch.from_numpy(v) for k, v in _batch(seed, TEACHER_INPUT).items()}
        metrics.append(steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)(
            state, batch))
        grads.append({name: p.grad for name, p in model.named_parameters()})
        assert model.shape_encoder.bn3.num_batches_tracked == 1
    assert launches == (pointnet_train.train_forward_bf16.launches,
                        pointnet_train.train_backward_bf16.launches)
    _check_losses(metrics, [m for m, _ in want], [m for m, _ in ref],
                  ("loss", "pose_loss", "nce_loss"), "teacher")
    _check_grads(grads, [g for _, g in want], [g for _, g in ref], "teacher",
                 in_bn=_bn_params(model))


def test_stage1_step_bf16_matches_jax():
    """KD --stage 1 steps (--fused_nce), each from the same weights on one
    of three batches, with the vanilla teacher and the student in bf16 on
    both sides and JAX's two NCE keep-masks handed in: the losses and every
    gradient of both models by the pooled oracle rule."""
    (tvars, svars), want = _jax_stage1_steps("bfloat16")
    _, ref = _jax_stage1_steps("float64")
    heads = {f"fc_{k}.{p}" for k in ("cls_azi", "cls_ele", "cls_inp", "reg_azi", "reg_ele",
                                     "reg_inp") for p in ("weight", "bias")}
    metrics, grads = [], {"teacher": [], "student": []}
    for seed, (_, keep, _) in zip(STEP_SEEDS, want):
        teacher = PoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                       shape_feature_dim=TEACHER_DIM, compute_dtype=BF16)
        teacher.load_state_dict(convert.pose_vanilla_state_dict(tvars), strict=True)
        student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                    input_dim=INPUT_DIM, dropout_rate=0.0, compute_dtype=BF16)
        student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
        t_state = create_train_state(teacher, 1e-4, [100], seed=1)
        s_state = create_train_state(student, 1e-4, [100], seed=0)
        batch = {k: torch.from_numpy(v) for k, v in _batch(seed).items()}
        metrics.append(steps.make_stage1_step(use_fused_nce=True)(
            t_state, s_state, batch, keep=[torch.from_numpy(np.array(k)) for k in keep]))
        grads["teacher"].append({n: p.grad for n, p in teacher.named_parameters()})
        grads["student"].append({n: p.grad for n, p in student.named_parameters()})
        # the student's heads take no part in the loss: zero on both sides
        for name in heads:
            assert float(student.get_parameter(name).grad.abs().max()) == 0.0, name
    _check_losses(metrics, [m for m, _, _ in want], [m for m, _, _ in ref],
                  ("loss", "teacher_loss"), "stage 1")
    for role, model in (("teacher", teacher), ("student", student)):
        _check_grads(grads[role], [g[role] for _, _, g in want],
                     [g[role] for _, _, g in ref], f"stage-1 {role}",
                     skip=heads if role == "student" else (), in_bn=_bn_params(model))
