"""The port's int8 post-training-quantized serving against the JAX
package's (`pose3d_tpu.serving`), on the CPU, where the int8 product is
`ops.int8_conv`'s plain version.

Small sizes: the student at width_mult 1/8 on 64x64 images (feature 64),
the ResNets at 32x32 (features 64, MultiView 16 over 4 renders), 64-point
clouds. Weights are seeded numpy trees (chip_smoke.py's, He-scaled, so
that activations and heads are of order one) carried into the port by
`train/convert.py`.

What is held, and why:
  * the quantized weights, their scales and the folded affines are
    bit-equal: both sides quantize the same float32 values in numpy float32;
  * the calibrated activation scales `a` within 1e-5 relative: they come
    from each side's float32 forward, whose sums run in another order;
  * each int8 product's int32 sums are bit-equal to XLA's on JAX's s8
    input, and its dequantization (float32(z) * (a * ws) + shift, two
    roundings) too;
  * the whole int8 forwards fed JAX's own artifact (written by JAX's
    `save_quantized`, read by the port): in float32 within 1e-5 of
    max|ref| (the float32 stem convolution, the mean and the dense layers
    sum in another order), in bfloat16 within 2^-6 of max|ref| (a bf16
    ulp is 2^-8 relative: a bf16 rounding of the mean or a dense layer
    that falls the other way moves a head by a few ulps). The test prints,
    layer by layer, how many s8 activations differ from JAX's: an
    activation that lands next to a rounding boundary of its quantizer
    flips one s8 step, and in bfloat16 one flip early in a ResNet spreads
    through the bf16 roundings of the layers after it (a bf16 ResNet stem
    convolution on torch's CPU kernel, which rounds 1-3 of 32,768 sums
    unlike float32 sums rounded once, flipped up to 14 % of a later
    layer's activations and moved the heads by 2 %: the port's stem
    therefore sums in float32 and rounds once, as JAX's does);
  * JAX's drift rule (tests/test_quant_student.py, test_quant_teacher.py)
    between the port's int8 forward and the port's own float32 model;
  * `.npz` artifacts round trip across the two packages, and each loader
    refuses the other kind.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.estimators import PoseEstimatorVanilla as JaxPoseEstimatorVanilla
from pose3d_tpu.serving import quant_student as jqs
from pose3d_tpu.serving import quant_teacher as jqt
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.ops import int8_conv as i8
from pose3d_tpu_torch.serving import quant_student as pqs
from pose3d_tpu_torch.serving import quant_teacher as pqt
from pose3d_tpu_torch.train import convert
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

STUDENT_DIM, WIDTH_MULT, STUDENT_SIZE = 64, 0.125, 64
TEACHER_DIM, MV_DIM, MV_VIEWS, TEACHER_SIZE, POINTS = 64, 16, 4, 32, 64
A_REL = 1e-5            # calibrated scales: float32 forwards, other summation order
F32_REL = 1e-5          # int8 forwards on JAX's artifact, float32
BF16_REL = 2.0 ** -6    # the same in bfloat16
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _walk(tree, path=""):
    """(path, leaf) of a quantized tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def _assert_trees(jax_tree, port_tree, a_rel=A_REL):
    """Every leaf bit-equal (dtype and shape too), the scales `a` within
    a_rel."""
    got = dict(_walk(port_tree))
    want = dict(_walk(jax_tree))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key.endswith("/a"):
            assert abs(float(g) - float(w)) <= a_rel * float(w), key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# --- models and trees --------------------------------------------------------

@functools.cache
def _student():
    variables = chip_smoke.student_variables(np.random.default_rng(7), STUDENT_DIM, WIDTH_MULT,
                                             STUDENT_SIZE)
    model = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                              input_dim=STUDENT_SIZE)
    model.load_state_dict(convert.baseline_state_dict(variables), strict=True)
    rng = np.random.default_rng(8)
    calib = [rng.standard_normal((4, STUDENT_SIZE, STUDENT_SIZE, 3)).astype(np.float32)
             for _ in range(2)]
    return variables, model.eval(), calib


def _teacher_variables(shape):
    if shape == "MultiView":
        return chip_smoke.teacher_variables(np.random.default_rng(21), TEACHER_DIM, MV_DIM,
                                            view_num=MV_VIEWS)
    if shape == "vanilla":
        return chip_smoke.vanilla_variables(np.random.default_rng(22), TEACHER_DIM, TEACHER_DIM)
    return chip_smoke.teacher_variables(np.random.default_rng(20), TEACHER_DIM, TEACHER_DIM)


@functools.cache
def _teacher(shape):
    """(variables, port model, JAX model, calibration images, shapes) of
    the PointCloud, MultiView or vanilla (PointCloud) teacher."""
    variables = _teacher_variables(shape)
    rng = np.random.default_rng(23)
    ims = rng.standard_normal((6, TEACHER_SIZE, TEACHER_SIZE, 3)).astype(np.float32)
    if shape == "MultiView":
        shapes = rng.uniform(0, 1, (6, MV_VIEWS, TEACHER_SIZE, TEACHER_SIZE, 3)).astype(np.float32)
        model = PoseEstimator(shape="MultiView", view_num=MV_VIEWS, img_feature_dim=TEACHER_DIM,
                              shape_feature_dim=MV_DIM)
        model.load_state_dict(convert.pose_state_dict(variables, "MultiView"), strict=True)
        jmodel = JaxPoseEstimator(shape="MultiView", view_num=MV_VIEWS,
                                  img_feature_dim=TEACHER_DIM, shape_feature_dim=MV_DIM)
    else:
        shapes = rng.uniform(0, 1, (6, POINTS, 3)).astype(np.float32)
        if shape == "vanilla":
            model = PoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                         shape_feature_dim=TEACHER_DIM)
            model.load_state_dict(convert.pose_vanilla_state_dict(variables), strict=True)
            jmodel = JaxPoseEstimatorVanilla(img_feature_dim=TEACHER_DIM,
                                             shape_feature_dim=TEACHER_DIM)
        else:
            model = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
            model.load_state_dict(convert.pose_state_dict(variables), strict=True)
            jmodel = JaxPoseEstimator(img_feature_dim=TEACHER_DIM,
                                      shape_feature_dim=TEACHER_DIM)
    return variables, model.eval(), jmodel, ims, shapes


def _jax_quantize(shape, variables, ims, shapes):
    if shape == "MultiView":
        return jqt.quantize_teacher_mv(variables, [ims], [shapes])
    if shape == "vanilla":
        return jqt.quantize_teacher_vanilla(variables, [ims])
    return jqt.quantize_teacher_resnet(variables, [ims])


def _port_quantize(shape, model, ims, shapes):
    if shape == "MultiView":
        return pqt.quantize_teacher_mv(model, [ims], [shapes])
    if shape == "vanilla":
        return pqt.quantize_teacher_vanilla(model, [ims])
    return pqt.quantize_teacher_resnet(model, [ims])


@functools.cache
def _jax_teacher_q(shape):
    variables, _, _, ims, shapes = _teacher(shape)
    return _jax_quantize(shape, variables, ims, shapes)


def _through_npz(jax_tree, tmp_path, loader):
    """JAX's tree written by JAX's save_quantized, read by the port."""
    path = str(tmp_path / "q.npz")
    jqs.save_quantized(jax_tree, path)
    return loader(path)


# --- quantization --------------------------------------------------------------

def test_quantize_student_matches_jax():
    variables, model, calib = _student()
    _assert_trees(jqs.quantize_student(variables, calib), pqs.quantize_student(model, calib))


@pytest.mark.parametrize("shape", ["PointCloud", "MultiView", "vanilla"])
def test_quantize_teacher_matches_jax(shape):
    """quantize_resnet on ResNet-50 (and, for MultiView, the render
    ResNet-18) and on the vanilla ResNet-18: int8 weights, s = ws * g, h,
    the stem's g and h and the fc bit-equal; 52 (19) int8 convs."""
    _, model, _, ims, shapes = _teacher(shape)
    want = _jax_teacher_q(shape)
    got = _port_quantize(shape, model, ims, shapes)
    _assert_trees(want, got)
    for q, n_convs in ((got["img"], 52), (got["shape"], 19)) if shape == "MultiView" else \
            ((got, 19 if shape == "vanilla" else 52),):
        assert sum(len(b) for b in q["blocks"]) == n_convs
        assert all(c["w"].dtype == torch.int8 for b in q["blocks"] for c in b)


# --- the int8 product ----------------------------------------------------------

CONVS = [  # (n, h, w, c, k, co, stride, padding): VGG, ResNet and dense shapes, ragged too
    (2, 16, 16, 16, 3, 32, 1, 1), (2, 8, 8, 64, 1, 256, 1, 0), (2, 8, 8, 256, 1, 128, 2, 0),
    (2, 9, 9, 32, 3, 48, 2, 1), (3, 5, 7, 20, 3, 30, 1, 1), (1, 1, 1, 4096, 1, 64, 1, 0),
    (5, 1, 1, 1000, 1, 7, 1, 0),
]


@pytest.mark.parametrize("n,h,w,c,k,co,stride,padding", CONVS)
def test_int8_sums_and_dequantization_match_xla(n, h, w, c, k, co, stride, padding):
    rng = np.random.default_rng(n * 1000 + c)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, k, c, co), dtype=np.int8)
    a = np.float32(np.abs(x).max() / 127.0)
    ws = rng.uniform(1e-4, 1e-2, co).astype(np.float32)
    shift = rng.standard_normal(co).astype(np.float32)
    xq = jqs._quantize_act(jnp.asarray(x), a)
    np.testing.assert_array_equal(
        i8.quantize_act(torch.from_numpy(x), torch.tensor(a)).numpy(), np.asarray(xq))
    pad = ((padding, padding), (padding, padding))
    want = jqt._conv(xq, jnp.asarray(wq), (stride, stride), pad, acc=jnp.int32)
    got = i8.int8_sums(torch.from_numpy(np.asarray(xq)), torch.from_numpy(wq), stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y_want = np.asarray(jax.nn.relu((want.astype(jnp.float32) * (a * ws) + shift)))
    y_got = i8.int8_conv(torch.from_numpy(x), torch.tensor(a), torch.from_numpy(wq),
                         torch.from_numpy(ws), torch.from_numpy(shift), stride, padding,
                         relu=True)
    np.testing.assert_array_equal(y_got.numpy(), y_want)


def test_int8_conv_counts_no_launch_on_the_cpu():
    before = i8.int8_conv.launches
    x = torch.randn(1, 4, 4, 16)
    i8.int8_conv(x, torch.tensor(0.01), torch.ones(3, 3, 16, 8, dtype=torch.int8),
                 torch.ones(8), torch.zeros(8), 1, 1)
    assert i8.int8_conv.launches == before


# --- the forwards on JAX's artifact --------------------------------------------

def _record_s8(monkeypatch):
    """The s8 inputs of every int8 product on both sides, in call order:
    JAX's `_quantize_act` and the port's int8 convolution wrapped."""
    jax_q, port_q = [], []
    orig = jqs._quantize_act

    def jax_rec(x, a):
        q = orig(x, a)
        jax_q.append(np.asarray(q))
        return q

    monkeypatch.setattr(jqs, "_quantize_act", jax_rec)
    monkeypatch.setattr(jqt, "_quantize_act", jax_rec)
    conv = i8.int8_conv

    def port_rec(x, a, *args, **kw):
        port_q.append(i8.quantize_act(x, a).numpy())
        return conv(x, a, *args, **kw)

    monkeypatch.setattr(i8, "int8_conv", port_rec)
    return jax_q, port_q


def _report(name, jax_q, port_q):
    assert len(jax_q) == len(port_q), (len(jax_q), len(port_q))
    diffs = [int(np.sum(j.reshape(-1) != p.reshape(-1))) for j, p in zip(jax_q, port_q)]
    print(f"{name}: s8 activations unlike JAX's, layer by layer: {diffs} of "
          f"{[int(j.size) for j in jax_q]}")
    return diffs


def _close(got, want, rel):
    for g, w in zip(got, want):
        g = np.asarray(g.float().numpy() if isinstance(g, torch.Tensor) else g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()), (err, float(np.abs(w).max()))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_student_int8_forward_matches_jax(dt, monkeypatch, tmp_path):
    variables, _, calib = _student()
    tdt, jdt = DTYPES[dt]
    qj = jqs.quantize_student(variables, calib)
    qp = _through_npz(qj, tmp_path, pqs.load_quantized)
    im = np.random.default_rng(9).standard_normal(
        (3, STUDENT_SIZE, STUDENT_SIZE, 3)).astype(np.float32)
    jax_q, port_q = _record_s8(monkeypatch)
    want = jqs.student_int8_infer(qj, jnp.asarray(im), jdt)
    got = pqs.student_int8_infer(qp, torch.from_numpy(im), tdt)
    _report(f"student {dt}", jax_q, port_q)
    assert all(o.dtype == torch.float32 for o in got)
    assert [o.shape[-1] for o in got] == [24, 12, 24, 24, 12, 24]
    _close(got, want, F32_REL if dt == "f32" else BF16_REL)


def _set_dtype(model, jmodel, dt):
    """The port model switched to the dtype, and the JAX model in it."""
    tdt, jdt = DTYPES[dt]
    chip_smoke.set_compute_dtype(model, None if dt == "f32" else tdt)
    return jmodel.clone(dtype=jdt)


@pytest.mark.parametrize("shape", ["PointCloud", "MultiView"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_teacher_int8_forwards_match_jax(shape, dt, monkeypatch, tmp_path):
    """make_teacher_int8_infer and make_teacher_int8_kd_fwd (view_tile 3)
    on JAX's artifact."""
    variables, model, jmodel, ims, shapes = _teacher(shape)
    jm = _set_dtype(model, jmodel, dt)
    try:
        qp = _through_npz(_jax_teacher_q(shape), tmp_path, pqt.load_quantized_teacher)
        qj = _jax_teacher_q(shape)
        jax_q, port_q = _record_s8(monkeypatch)
        want = jqt.make_teacher_int8_infer(jm)(qj, variables, jnp.asarray(ims[:2]),
                                               jnp.asarray(shapes[:2]))
        got = pqt.make_teacher_int8_infer(model)(qp, torch.from_numpy(ims[:2]),
                                                 torch.from_numpy(shapes[:2]))
        _report(f"{shape} teacher {dt}", jax_q, port_q)
        rel = F32_REL if dt == "f32" else BF16_REL
        _close(got, want, rel)
        want_out, want_feat = jqt.make_teacher_int8_kd_fwd(jm)(
            qj, variables, jnp.asarray(ims), jnp.asarray(shapes[:2]), 3)
        got_out, got_feat = pqt.make_teacher_int8_kd_fwd(model)(
            qp, torch.from_numpy(ims), torch.from_numpy(shapes[:2]), 3)
        assert tuple(got_feat.shape) == (6, 200)
        _close(list(got_out) + [got_feat], list(want_out) + [want_feat], rel)
    finally:
        _set_dtype(model, jmodel, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_vanilla_int8_kd_forward_matches_jax(dt, monkeypatch, tmp_path):
    variables, model, jmodel, ims, shapes = _teacher("vanilla")
    jm = _set_dtype(model, jmodel, dt)
    try:
        qj = _jax_teacher_q("vanilla")
        qp = _through_npz(qj, tmp_path, pqt.load_quantized_teacher)
        jax_q, port_q = _record_s8(monkeypatch)
        want = jqt.make_vanilla_int8_kd_fwd(jm)(qj, variables, jnp.asarray(ims),
                                               jnp.asarray(shapes[:2]), 3)
        got = pqt.make_vanilla_int8_kd_fwd(model)(qp, torch.from_numpy(ims),
                                                  torch.from_numpy(shapes[:2]), 3)
        _report(f"vanilla teacher {dt}", jax_q, port_q)
        _close(got, want, F32_REL if dt == "f32" else BF16_REL)
    finally:
        _set_dtype(model, jmodel, "f32")


def test_vanilla_int8_refuses_multiview():
    model = PoseEstimatorVanilla(shape="MultiView", view_num=2, img_feature_dim=8,
                                 shape_feature_dim=8)
    with pytest.raises(NotImplementedError, match="PointCloud only"):
        pqt.make_vanilla_int8_kd_fwd(model)


# --- drift against the port's own float32 model --------------------------------

def _drift(got, want, cos_min, rel_max, argmax_heads):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float().numpy(), b.float().numpy()
        cos = float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
        rel = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
        assert cos > cos_min, (i, cos)
        assert rel < rel_max, (i, rel)
        if i in argmax_heads:
            assert np.mean(np.argmax(a, 1) == np.argmax(b, 1)) >= 0.75, i


def test_student_drift_rule():
    """JAX's rule (test_quant_student.py): cosine > 0.995, argmax
    agreement >= 0.75, max relative error < 0.1, each head."""
    _, model, calib = _student()
    q = pqs.quantize_student(model, calib)
    im = torch.from_numpy(calib[0])
    with torch.no_grad():
        want = model(im)[0]
    _drift(pqs.student_int8_infer(q, im, torch.float32), want, 0.995, 0.1, range(6))


@pytest.mark.parametrize("shape", ["PointCloud", "MultiView"])
def test_teacher_drift_rule(shape):
    """JAX's rule (test_quant_teacher.py): cosine > 0.985, max relative
    error < 0.25, top-bin agreement >= 0.75 on the three class heads."""
    _, model, _, ims, shapes = _teacher(shape)
    q = _port_quantize(shape, model, ims, shapes)
    im, sh = torch.from_numpy(ims), torch.from_numpy(shapes)
    with torch.no_grad():
        want = model(im, sh)[0]
    _drift(pqt.make_teacher_int8_infer(model)(q, im, sh), want, 0.985, 0.25, range(3))


# --- artifacts ------------------------------------------------------------------

def test_student_artifact_round_trips(tmp_path):
    """Port saves, JAX loads (and serves); JAX saves, the port loads."""
    variables, model, calib = _student()
    qp = pqs.quantize_student(model, calib)
    pqs.save_quantized(qp, str(tmp_path / "port.npz"))
    from_port = jqs.load_quantized(str(tmp_path / "port.npz"))
    _assert_trees(from_port, qp, a_rel=0.0)
    outs = jqs.student_int8_infer(from_port, jnp.asarray(calib[0][:1]), jnp.float32)
    assert [o.shape for o in outs] == [(1, n) for n in (24, 12, 24, 24, 12, 24)]
    qj = jqs.quantize_student(variables, calib)
    _assert_trees(qj, _through_npz(qj, tmp_path, pqs.load_quantized), a_rel=0.0)


@pytest.mark.parametrize("shape", ["PointCloud", "MultiView"])
def test_teacher_artifact_round_trips(shape, tmp_path):
    _, model, _, ims, shapes = _teacher(shape)
    qp = _port_quantize(shape, model, ims, shapes)
    pqs.save_quantized(qp, str(tmp_path / "port.npz"))
    _assert_trees(jqt.load_quantized_teacher(str(tmp_path / "port.npz")), qp, a_rel=0.0)
    qj = _jax_teacher_q(shape)
    _assert_trees(qj, _through_npz(qj, tmp_path, pqt.load_quantized_teacher), a_rel=0.0)


def test_artifact_kinds_are_refused(tmp_path):
    """A student artifact through the teacher loader and a teacher one
    through the student loader fail at load time, with JAX's messages, in
    both packages."""
    _, model, calib = _student()
    student_path = str(tmp_path / "student.npz")
    pqs.save_quantized(pqs.quantize_student(model, calib[:1]), student_path)
    teacher_path = str(tmp_path / "teacher.npz")
    jqs.save_quantized(_jax_teacher_q("vanilla"), teacher_path)
    for load in (pqt.load_quantized_teacher, jqt.load_quantized_teacher):
        with pytest.raises(ValueError, match="not a teacher int8 artifact"):
            load(student_path)
    for load in (pqs.load_quantized, jqs.load_quantized):
        with pytest.raises(ValueError, match="not a student int8 artifact"):
            load(teacher_path)
