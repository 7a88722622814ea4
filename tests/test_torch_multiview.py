"""The port's MultiView teacher against the JAX package, on the CPU: the
render ring's ids (`multiview_ids`), the render encoder (`ShapeEncoderMV`,
`ShapeEncoderMVRaw`), both MultiView teachers with the weights that
`train/convert.py` carries, one teacher step, one KD --crd step with a
frozen MultiView teacher and one KD --stage 1 step with the MultiView
vanilla teacher, and a bf16 teacher step.

Small sizes: ResNet-18 over 4 views (`tour` 2) of 24x24 renders, feature
16; the image ResNets at 32x32, feature 32; batch 6, one or two of them
padded where masked; the student at width_mult 0.25, input 32, feature 32.

Tolerances.
  * `multiview_ids`: equal, at every mutation 0-71.
  * The encoder: eval mode in f32 within 1e-5 of max|ref| (summation order
    only), in f64 within 1e-12; train mode with a padded batch (its renders
    left out of every BatchNorm's statistics) in f32 within 1e-4 of max|ref|
    for the valid rows (24 renders of batch statistics over 18 layers turn
    the summation order into up to about 2e-5), the running statistics
    within 1e-5; in f64 within 1e-10 and 1e-12. In bf16, eval mode: each
    output within one bf16 ulp (2^-7 of max|ref|) of JAX's dtype=bfloat16
    (tests/torch_bf16_rules.py one_ulp; the share of unequal outputs is
    printed, not held: the two packages sum each convolution in another
    order, and an f32 sum that lands on the other side of a bf16 rounding
    boundary carries through later layers). Masked train mode: the oracle
    rule against JAX's f64 encoder (tests/torch_bf16_rules.py oracle): its
    18 batch-statistics BatchNorms carry one flipped rounding to many ulps
    on either side, so that JAX's own bf16 output lies 5 % of max|ref| from
    f64 (measured here) and no one-ulp rule can hold.
  * The teachers in eval mode, f32: within 1e-4 of max|ref| (ResNet-50 and
    the DeformNet's folded-away order); `view_tile=3` against the renders
    tiled by hand within 1e-6.
  * The steps, as tests/test_torch_train.py, test_torch_kd.py and
    test_torch_stage1.py hold theirs: the trained models in f64 on both
    sides (JAX under `jax.enable_x64`), the frozen teacher in f32, the
    losses in f32; losses within 1e-5 relative, each gradient within 1e-3
    of its max|ref| (the biases before a train-mode BatchNorm, zero in
    exact arithmetic, within 1e-6 of the largest gradient on both sides),
    running statistics within 1e-5.
  * The bf16 teacher step: tests/torch_bf16_rules.py's pooled oracle rule
    over three batches against JAX's f64 step, as
    tests/test_torch_bf16_train.py holds the PointCloud teacher's, the
    ResNets' residual branches damped (chip_smoke.damp_residuals).
`test_masked_encoder_fails_with_the_mask_repeated` plants the fold's
likeliest fault (the mask tiled with `repeat`, not `repeat_interleave`)
and shows that the masked test fails on it.
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

from pose3d_tpu.data.transforms import multiview_ids as jax_multiview_ids
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.models.multiview import ShapeEncoderMV as JaxShapeEncoderMV
from pose3d_tpu.models.multiview import ShapeEncoderMVRaw as JaxShapeEncoderMVRaw
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu.train.torch_export import (export_pose_estimator,
                                           export_pose_estimator_vanilla,
                                           save_torch_checkpoint)
from pose3d_tpu_torch.data import transforms
from pose3d_tpu_torch.models.common import BatchNorm
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.models.multiview import ShapeEncoderMV, ShapeEncoderMVRaw
from pose3d_tpu_torch.ops import nce, vgg_stem
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
VIEW_NUM, TOUR, RENDER = 4, 2, 24
SHAPE_DIM, IMG_DIM, INPUT_DIM, BATCH = 16, 32, 32, 6
STUDENT_DIM, WIDTH_MULT = 32, 0.25
LR = 1e-4
BF16_SEEDS = (41, 42, 43)
# the bf16 step's images and renders: at 32 and 24 the deepest
# batch-statistics BatchNorms take one value a sample, and both packages'
# bf16 gradients are rounding noise
BF16_INPUT, BF16_RENDER, BF16_BATCH = 64, 32, 8


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _as(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _renders(rng, n=BATCH, size=RENDER):
    return rng.uniform(0, 1, (n, VIEW_NUM, size, size, 3)).astype(np.float32)


def _mask(n=BATCH, padded=2):
    return np.arange(n) < n - padded


# --- the render ring ----------------------------------------------------------

@pytest.mark.parametrize("view_num,tour", [(12, 2), (4, 2), (6, 1), (12, 3)])
def test_multiview_ids_match_jax(view_num, tour):
    for mutation in range(72):
        np.testing.assert_array_equal(transforms.multiview_ids(view_num, tour, mutation),
                                      jax_multiview_ids(view_num, tour, mutation))


# --- the render encoder -------------------------------------------------------

def _encoder_variables(seed=3):
    """He-scaled ResNet-18 variables with random BatchNorm statistics, in
    ShapeEncoderMV's flax layout."""
    params, stats = chip_smoke._Init(np.random.default_rng(seed)).resnet((2, 2, 2, 2), False,
                                                                         SHAPE_DIM)
    return {"params": {"ResNet_0": params}, "batch_stats": {"ResNet_0": stats}}


def _port_encoder(variables, cls=ShapeEncoderMV, compute_dtype=None):
    sd: dict = {}
    convert._resnet(variables["params"]["ResNet_0"], variables["batch_stats"]["ResNet_0"], sd,
                    "render_encoder", (2, 2, 2, 2), "BasicBlock", 2)
    encoder = cls(SHAPE_DIM, compute_dtype=compute_dtype)
    encoder.load_state_dict(convert._to_tensors(sd), strict=True)
    return encoder


def _jax_encoder(variables, renders, train, mask, dtype, cls=JaxShapeEncoderMV):
    """JAX's encoder's output and (train mode) updated statistics; the
    variables in f64 for an f64 model."""
    model = cls(SHAPE_DIM, dtype=dtype)
    v = _as(variables, jnp.float64 if dtype == jnp.float64 else jnp.float32)
    x = jnp.asarray(renders, jnp.float64 if dtype == jnp.float64 else jnp.float32)
    m = None if mask is None else jnp.asarray(mask)
    if not train:
        return np.asarray(jax.jit(functools.partial(model.apply, train=False))(v, x)), None
    out, mut = jax.jit(functools.partial(model.apply, train=True, mutable=["batch_stats"]))(
        v, x, mask=m)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, mut["batch_stats"])


def _encoder_matches(train, f64, cls=ShapeEncoderMV, jcls=JaxShapeEncoderMV):
    variables = _encoder_variables()
    renders = _renders(np.random.default_rng(4))
    mask = _mask() if train else None
    out_tol, stat_tol = {(False, False): (1e-5, None), (False, True): (1e-12, None),
                         (True, False): (1e-4, 1e-5), (True, True): (1e-10, 1e-12)}[train, f64]
    with jax.enable_x64(f64):
        want, want_stats = _jax_encoder(variables, renders, train, mask,
                                        jnp.float64 if f64 else jnp.float32, jcls)
    port = _port_encoder(variables, cls)
    x = torch.from_numpy(renders)
    if f64:
        port, x = port.double(), x.double()
    got = port.train(train)(x, None if mask is None else torch.from_numpy(mask))
    rows = slice(None) if mask is None else mask
    assert got.shape == want.shape
    assert _rel(got.detach().numpy()[rows], want[rows]) <= out_tol
    if train:
        sd: dict = {}
        convert._resnet(variables["params"]["ResNet_0"], want_stats["ResNet_0"], sd,
                        "render_encoder", (2, 2, 2, 2), "BasicBlock", 2)
        for name, value in port.state_dict().items():
            if "running" in name:
                np.testing.assert_allclose(value.numpy(), sd[name], rtol=0, atol=stat_tol,
                                           err_msg=name)


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_encoder_matches_jax(train, f64):
    """ShapeEncoderMV in eval mode, and in train mode with two of six
    samples padded: the valid rows' (N, K * D) features and every running
    statistic after the step, in f32 and in f64."""
    _encoder_matches(train, f64)


def test_raw_encoder_matches_jax():
    """ShapeEncoderMVRaw keeps the (N, K, D) layout: masked train mode, f64."""
    _encoder_matches(True, True, ShapeEncoderMVRaw, JaxShapeEncoderMVRaw)


def test_masked_encoder_fails_with_the_mask_repeated(monkeypatch):
    """The planted fault: the (N,) mask folded with `repeat` (the whole mask
    K times over) in place of `repeat_interleave` takes the wrong renders
    into every BatchNorm's statistics, and the masked test fails."""
    forward = ShapeEncoderMVRaw.forward

    def tiled_mask(self, renders, mask=None):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "repeat_interleave", lambda t, r: t.repeat(r))
            return forward(self, renders, mask)

    monkeypatch.setattr(ShapeEncoderMVRaw, "forward", tiled_mask)
    with pytest.raises(AssertionError):
        _encoder_matches(True, True)
    # the fault touches the fold alone: unmasked, the encoder still agrees
    _encoder_matches(False, True)


@pytest.mark.parametrize("train", [False, True])
def test_encoder_bf16_matches_jax(train):
    """ShapeEncoderMV(compute_dtype=bf16) against JAX's dtype=bfloat16: in
    eval mode each output within one bf16 ulp of max|ref| (the unequal
    share printed); in masked train mode by the oracle rule against JAX's
    f64 encoder (18 batch-statistics BatchNorms in bf16 carry one flipped
    rounding to many ulps, on either side: JAX's own bf16 output lies 5 %
    of max|ref| from f64 here)."""
    variables = _encoder_variables(5)
    renders = _renders(np.random.default_rng(6))
    mask = _mask() if train else None
    want, _ = _jax_encoder(variables, renders, train, mask, jnp.bfloat16)
    port = _port_encoder(variables, compute_dtype=BF16).train(train)
    got = port(torch.from_numpy(renders), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == BF16
    if not train:
        rules.one_ulp(got, want, "ShapeEncoderMV bf16 eval", unequal_max=None)
        return
    with jax.enable_x64(True):
        ref, _ = _jax_encoder(variables, renders, True, mask, jnp.float64)
    rules.oracle(got.detach()[torch.from_numpy(mask)], want[mask], ref[mask],
                 "ShapeEncoderMV bf16 train, masked")


# --- the MultiView teachers with convert.py's weights ---------------------------

def _teacher_variables(kind, seed):
    make = chip_smoke.vanilla_variables if kind == "vanilla" else chip_smoke.teacher_variables
    return make(np.random.default_rng(seed), IMG_DIM, SHAPE_DIM, view_num=VIEW_NUM)


def _jax_teacher(kind, dtype=jnp.float32):
    cls = JaxPoseEstimatorVanilla if kind == "vanilla" else JaxPoseEstimator
    return cls(shape="MultiView", view_num=VIEW_NUM, img_feature_dim=IMG_DIM,
               shape_feature_dim=SHAPE_DIM, dtype=dtype)


def _port_teacher(kind, variables, compute_dtype=None):
    cls, to_sd = ((PoseEstimatorVanilla, convert.pose_vanilla_state_dict) if kind == "vanilla"
                  else (PoseEstimator, convert.pose_state_dict))
    model = cls(shape="MultiView", view_num=VIEW_NUM, img_feature_dim=IMG_DIM,
                shape_feature_dim=SHAPE_DIM, compute_dtype=compute_dtype)
    model.load_state_dict(to_sd(variables, "MultiView"), strict=True)
    return model


def _outputs(out):
    return [np.asarray(o.detach() if isinstance(o, torch.Tensor) else o, np.float64)
            for o in list(out[0]) + list(out[1:])]


@pytest.mark.parametrize("kind", ["teacher", "vanilla"])
@pytest.mark.parametrize("width", ["small", "full"])
def test_chip_smoke_variables_have_jax_shapes(kind, width):
    """chip_smoke.py writes the MultiView teachers' variables out by hand
    (the card's machine has no JAX): their shapes are jax.eval_shape's, at
    these tests' width and at the card's (ResNet-50 1024, 12 views of 256,
    224x224)."""
    img, shape_dim, views, dim = ((IMG_DIM, SHAPE_DIM, VIEW_NUM, INPUT_DIM) if width == "small"
                                  else (1024, 256, 12, 224))
    cls = JaxPoseEstimatorVanilla if kind == "vanilla" else JaxPoseEstimator
    model = cls(shape="MultiView", view_num=views, img_feature_dim=img,
                shape_feature_dim=shape_dim)
    want = jax.eval_shape(functools.partial(model.init, train=False), jax.random.key(0),
                          jnp.zeros((1, dim, dim, 3)), jnp.zeros((1, views, dim, dim, 3)))
    make = chip_smoke.vanilla_variables if kind == "vanilla" else chip_smoke.teacher_variables
    got = make(np.random.default_rng(0), img, shape_dim, view_num=views)
    shapes = functools.partial(jax.tree_util.tree_map, lambda x: tuple(np.shape(x)))
    assert shapes(got) == shapes(dict(want))


@pytest.mark.parametrize("kind", ["teacher", "vanilla"])
def test_state_dict_keys_match_torch_export(kind):
    """The port's MultiView keys and shapes are the reference layout that
    torch_export writes (`shape_encoder.render_encoder.*`), at full width
    (the port built on the meta device)."""
    variables = chip_smoke.teacher_variables if kind == "teacher" else chip_smoke.vanilla_variables
    exported = (export_pose_estimator if kind == "teacher" else export_pose_estimator_vanilla)(
        variables(np.random.default_rng(0), 1024, 256, view_num=12), "MultiView")
    cls = PoseEstimator if kind == "teacher" else PoseEstimatorVanilla
    with torch.device("meta"):
        port = cls(shape="MultiView", view_num=12, img_feature_dim=1024,
                   shape_feature_dim=256).state_dict()
    assert {k: tuple(np.shape(v)) for k, v in exported.items()} == \
        {k: tuple(v.shape) for k, v in port.items()}
    assert any(k.startswith("shape_encoder.render_encoder.layer4.1.") for k in port)


@pytest.mark.parametrize("kind", ["teacher", "vanilla"])
def test_teacher_eval_matches_jax(kind):
    """Both MultiView teachers in eval mode, f32, every output; then
    `view_tile=3`: three stacked image views with each sample's renders
    encoded once, against the renders tiled by hand and against JAX's
    view_tile."""
    variables = _teacher_variables(kind, 7)
    rng = np.random.default_rng(8)
    im = rng.standard_normal((3 * BATCH, INPUT_DIM, INPUT_DIM, 3)).astype(np.float32)
    renders = _renders(rng)
    apply = jax.jit(functools.partial(_jax_teacher(kind).apply, train=False),
                    static_argnames="view_tile")
    want = _outputs(apply(_as(variables, jnp.float32), jnp.asarray(im[:BATCH]),
                          jnp.asarray(renders)))
    want_tiled = _outputs(apply(_as(variables, jnp.float32), jnp.asarray(im),
                                jnp.asarray(renders), view_tile=3))
    port = _port_teacher(kind, variables).eval()
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(im[:BATCH]), torch.from_numpy(renders)))
        tiled = _outputs(port(torch.from_numpy(im), torch.from_numpy(renders), view_tile=3))
        by_hand = _outputs(port(torch.from_numpy(im),
                                torch.from_numpy(renders).repeat(3, 1, 1, 1, 1)))
    assert len(got) == len(want) == (8 if kind == "teacher" else 7)
    for g, w in zip(got + tiled, want + want_tiled):
        assert _rel(g, w) <= 1e-4
    for a, b in zip(tiled, by_hand):
        assert _rel(a, b) <= 1e-6


def test_reference_layout_pth_loads_strictly(tmp_path):
    """A MultiView teacher `.pth` as torch_export writes it loads strictly
    into the port's MultiView teacher through `read_state_dict`, and
    gives JAX's outputs; the PointCloud teacher refuses it."""
    variables = _teacher_variables("teacher", 9)
    path = str(tmp_path / "mv_teacher.pth")
    save_torch_checkpoint(path, variables, "pose", "MultiView")
    sd = convert.read_state_dict(path)
    port = PoseEstimator(shape="MultiView", view_num=VIEW_NUM, img_feature_dim=IMG_DIM,
                         shape_feature_dim=SHAPE_DIM)
    port.load_state_dict(sd, strict=True)
    want = convert.pose_state_dict(variables, "MultiView")
    assert all(torch.equal(port.state_dict()[k], v.to(port.state_dict()[k].dtype))
               for k, v in want.items())
    with pytest.raises(RuntimeError, match="shape_encoder"):
        PoseEstimator(img_feature_dim=IMG_DIM, shape_feature_dim=SHAPE_DIM).load_state_dict(
            sd, strict=True)


# --- one step each against JAX's, in f64 -----------------------------------------

def _sgd_state(variables, key, dtype=jnp.float64):
    """JAX's train state with plain SGD at lr 1, so that a step's gradient
    is the parameters' change."""
    params, tx = _as(variables["params"], dtype), optax.sgd(1.0)
    return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=_as(variables["batch_stats"], dtype),
                             opt_state=tx.init(params), rng=key, tx=tx)


def _grads(old, new):
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), old.params, new.params)


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


def _teacher_batch(seed, masked, input_dim=INPUT_DIM, render=RENDER, n=BATCH):
    rng = np.random.default_rng(seed)
    batch = {"im": rng.standard_normal((n, input_dim, input_dim, 3)).astype(np.float32),
             "shape": _renders(rng, n, render), "label": chip_smoke.random_labels(rng, n)}
    if masked:
        batch["valid"] = _mask(n, padded=1)
    return batch


@functools.cache
def _jax_teacher_step(masked):
    """JAX's make_teacher_train_step (use_fused_nce, no dropout) on the
    MultiView teacher in f64."""
    variables = _teacher_variables("teacher", 11)
    batch = _teacher_batch(21, masked)
    with jax.enable_x64(True):
        state = _sgd_state(variables, jax.random.key(0))
        step = jax.jit(jsteps.make_teacher_train_step(_jax_teacher("teacher", jnp.float64), 15,
                                                      nce_dropout=0.0, use_fused_nce=True))
        new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        to_sd = functools.partial(convert.pose_state_dict, shape="MultiView")
        return (variables, {k: float(v) for k, v in metrics.items()},
                to_sd({"params": _grads(state, new), "batch_stats": variables["batch_stats"]}),
                to_sd({"params": variables["params"],
                       "batch_stats": jax.device_get(new.batch_stats)}))


@pytest.mark.parametrize("masked", [False, True])
def test_teacher_step_matches_jax(masked):
    """One MultiView teacher step (--fused_nce: unmasked, the NCE's kernel
    entry, its plain version on the CPU; masked, the plain NCE), both in
    f64: losses, every gradient, every running statistic."""
    variables, want_metrics, want_grads, want_state = _jax_teacher_step(masked)
    model = _port_teacher("teacher", variables).double()
    state = create_train_state(model, LR, [100], seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _teacher_batch(21, masked).items()}
    batch["im"], batch["shape"] = batch["im"].double(), batch["shape"].double()
    launches = nce.nce_forward.launches, nce.nce_backward.launches
    metrics = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)(state, batch)
    assert launches == (nce.nce_forward.launches, nce.nce_backward.launches)
    for key in ("loss", "pose_loss", "nce_loss"):
        assert float(metrics[key]) == pytest.approx(want_metrics[key], rel=1e-5), key
    _check_model(model, want_grads, want_state)
    assert model.shape_encoder.render_encoder.bn1.num_batches_tracked == 1


def _student_variables(seed):
    return chip_smoke.student_variables(np.random.default_rng(seed), STUDENT_DIM, WIDTH_MULT,
                                        INPUT_DIM)


def _kd_batch():
    rng = np.random.default_rng(31)
    batch = {}
    for view in ("", "_flip", "_rot"):
        batch["im" + view] = rng.standard_normal((BATCH, INPUT_DIM, INPUT_DIM, 3))
        batch["label" + view] = chip_smoke.random_labels(rng, BATCH)
    batch["shape"] = _renders(rng)
    batch["valid"] = _mask(padded=1)
    return batch


@functools.cache
def _jax_kd_step():
    """JAX's make_kd_crd_step: the student in f64, the frozen MultiView
    teacher in f32 (encoding each sample's renders once, view_tile 3)."""
    svars, tvars = _student_variables(12), _teacher_variables("teacher", 13)
    batch = _kd_batch()
    with jax.enable_x64(True):
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=jnp.float64)
        state = _sgd_state(svars, jax.random.key(0))
        step = jax.jit(jsteps.make_kd_crd_step(student, _jax_teacher("teacher"), 15, 1.0))
        new, metrics = step(state, _as(tvars, jnp.float32),
                            {k: jnp.asarray(v) for k, v in batch.items()})
        return (svars, tvars, {k: float(v) for k, v in metrics.items()},
                convert.baseline_state_dict({"params": _grads(state, new),
                                             "batch_stats": svars["batch_stats"]}),
                convert.baseline_state_dict({"params": svars["params"],
                                             "batch_stats": jax.device_get(new.batch_stats)}))


def test_kd_crd_step_with_a_multiview_teacher_matches_jax():
    """One KD --crd step, the student in f64 distilled from a frozen f32
    MultiView teacher: losses, every student gradient and statistic; the
    teacher untouched; on the CPU the stem's plain version."""
    svars, tvars, want_metrics, want_grads, want_state = _jax_kd_step()
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    state = create_train_state(student.double(), LR, [100], seed=0)
    teacher = _port_teacher("teacher", tvars).eval().requires_grad_(False)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _kd_batch().items()}
    launches = vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches
    metrics = steps.make_kd_crd_step()(state, teacher, batch)
    assert launches == (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches)
    for key in ("loss", "gt_loss"):
        assert float(metrics[key]) == pytest.approx(want_metrics[key], rel=1e-5), key
    _check_model(student, want_grads, want_state)
    assert all(p.grad is None for p in teacher.parameters())
    assert all(torch.equal(v, before[k]) for k, v in teacher.state_dict().items())


@functools.cache
def _jax_stage1_step():
    """JAX's make_stage1_step (use_fused_nce) on the MultiView vanilla
    teacher and the student, both in f64, and the NCE keep-masks it drew."""
    tvars, svars = _teacher_variables("vanilla", 14), _student_variables(15)
    batch = _teacher_batch(32, True)
    with jax.enable_x64(True):
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=jnp.float64)
        t_state, s_state = _sgd_state(tvars, jax.random.key(1)), _sgd_state(svars,
                                                                            jax.random.key(0))
        step = jax.jit(jsteps.make_stage1_step(_jax_teacher("vanilla", jnp.float64), student,
                                               15, tau=0.5, use_fused_nce=True))
        new_t, new_s, metrics = step(t_state, s_state,
                                     {k: jnp.asarray(v) for k, v in batch.items()})
        rng, _ = jax.random.split(s_state.rng)
        _, rng1, rng2 = jax.random.split(rng, 3)
        keep = [np.asarray(jax.random.bernoulli(r, 0.7, (BATCH, 200))) for r in (rng1, rng2)]
        to_t = functools.partial(convert.pose_vanilla_state_dict, shape="MultiView")
        out = {"metrics": {k: float(v) for k, v in metrics.items()}, "keep": keep}
        for name, old, new, variables, to_sd in (
                ("teacher", t_state, new_t, tvars, to_t),
                ("student", s_state, new_s, svars, convert.baseline_state_dict)):
            out[name] = (to_sd({"params": _grads(old, new),
                                "batch_stats": variables["batch_stats"]}),
                         to_sd({"params": variables["params"],
                                "batch_stats": jax.device_get(new.batch_stats)}))
    return tvars, svars, out


def test_stage1_step_with_the_multiview_vanilla_teacher_matches_jax():
    """One KD --stage 1 step (--fused_nce, one sample padded), the MultiView
    vanilla teacher and the student in f64, JAX's NCE keep-masks handed in:
    losses, every gradient and statistic of both models."""
    tvars, svars, want = _jax_stage1_step()
    teacher = _port_teacher("vanilla", tvars).double()
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, dropout_rate=0.0)
    student.load_state_dict(convert.baseline_state_dict(svars), strict=True)
    t_state = create_train_state(teacher, LR, [100], seed=1)
    s_state = create_train_state(student.double(), LR, [100], seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _teacher_batch(32, True).items()}
    metrics = steps.make_stage1_step(use_fused_nce=True)(
        t_state, s_state, batch, keep=[torch.from_numpy(np.array(k)) for k in want["keep"]])
    for key in ("loss", "teacher_loss"):
        assert float(metrics[key]) == pytest.approx(want["metrics"][key], rel=1e-5), key
    _check_model(teacher, *want["teacher"])
    _check_model(student, *want["student"])


# --- one bf16 teacher step ---------------------------------------------------------

def _bf16_variables():
    return chip_smoke.damp_residuals(_teacher_variables("teacher", 16))


@functools.cache
def _jax_bf16_steps(dtype_name):
    """JAX's MultiView teacher step (use_fused_nce, no dropout) in
    `dtype_name` from the same state on each batch of BF16_SEEDS, compiled
    with XLA's excess precision off (tests/test_torch_bf16_train.py
    _compiled): [(metrics, gradients as a port state_dict)]."""
    dtype = {"bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype_name]
    variables = _bf16_variables()
    runs, step = [], None
    with jax.enable_x64(True):
        state = _sgd_state(variables, jax.random.key(0))
        for seed in BF16_SEEDS:
            batch = {k: jnp.asarray(v) for k, v in _teacher_batch(
                seed, True, BF16_INPUT, BF16_RENDER, BF16_BATCH).items()}
            step = step or jax.jit(jsteps.make_teacher_train_step(
                _jax_teacher("teacher", dtype), 15, nce_dropout=0.0, use_fused_nce=True)
            ).lower(state, batch).compile(compiler_options={"xla_allow_excess_precision": False})
            new, metrics = step(state, batch)
            runs.append(({k: float(v) for k, v in metrics.items()}, convert.pose_state_dict(
                {"params": _grads(state, new), "batch_stats": variables["batch_stats"]},
                "MultiView")))
    return runs


def test_teacher_step_bf16_matches_jax():
    """MultiView teacher steps in bf16 (parameters f32), each from the same
    weights on one of three batches with one sample padded: the three
    losses and every gradient by the pooled oracle rule against JAX's f64
    step, JAX's bf16 step beside it; the cast parameters' gradients bf16
    values, BatchNorm's statistics in f32."""
    want, ref = _jax_bf16_steps("bfloat16"), _jax_bf16_steps("float64")
    metrics, grads = [], []
    for seed in BF16_SEEDS:
        model = _port_teacher("teacher", _bf16_variables(), compute_dtype=BF16)
        state = create_train_state(model, LR, [100], seed=0)
        batch = {k: torch.from_numpy(v) for k, v in _teacher_batch(
            seed, True, BF16_INPUT, BF16_RENDER, BF16_BATCH).items()}
        metrics.append(steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)(
            state, batch))
        grads.append({name: p.grad for name, p in model.named_parameters()})
        assert model.shape_encoder.render_encoder.bn1.running_mean.dtype == torch.float32
    keys = ("loss", "pose_loss", "nce_loss")
    vector = lambda m: np.array([float(m[k]) for k in keys], np.float64)
    rules.pooled_oracle([(vector(g), vector(w), vector(r), None)
                         for g, (w, _), (r, _) in zip(metrics, want, ref)],
                        f"MultiView teacher losses {keys}")
    in_bn = {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
             if isinstance(m, BatchNorm) for p_name, _ in m.named_parameters()}
    largest = [max(float(r[k].abs().max()) for k in grads[0]) for _, r in ref]
    for name in grads[0]:
        zero = all(float(r[name].abs().max()) < 1e-3 * top for (_, r), top in zip(ref, largest))
        rules.pooled_oracle([(g[name], w[name], r[name], top if zero else None)
                             for g, (_, w), (_, r), top in zip(grads, want, ref, largest)],
                            f"MultiView teacher d{name}", agree=not zero)
        for g in grads:
            if name not in in_bn:
                assert torch.equal(g[name], g[name].to(BF16).float()), f"d{name} not bf16"
