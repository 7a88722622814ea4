"""The port's kernel wrappers and build, without JAX.

The tests marked `cuda` need an NVIDIA GPU and skip without one; on the GPU
machine run them with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.ops import (_build, geodesic, int8_conv, nce, pointnet, pointnet_train,
                                  vgg_stem)
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shapes,dtypes,exc", [
    (((4, 3), (5, 3)), (torch.float32, torch.float32), ValueError),
    (((4, 2), (4, 2)), (torch.float32, torch.float32), ValueError),
    (((4, 3, 1), (4, 3, 1)), (torch.float32, torch.float32), ValueError),
    (((4, 3), (4, 3)), (torch.float32, torch.int32), TypeError),
    (((4, 3), (4, 3)), (torch.float64, torch.float64), TypeError),
])
def test_rotation_err_rejects_bad_inputs(shapes, dtypes, exc):
    a, b = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises(exc):
        geodesic.rotation_err(a, b)


def test_rotation_err_rejects_devices_without_a_kernel():
    a = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        geodesic.rotation_err(a, a)
    with pytest.raises(ValueError, match="different devices"):
        geodesic.rotation_err(a, torch.zeros((4, 3)))


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("geodesic")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_geodesic_kernel_matches_plain_on_cuda(cuda, n):
    rng = np.random.default_rng(n)
    preds = torch.from_numpy(rng.uniform(0, 360, (n, 3)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 360, (n, 3)).astype(np.float32)).to(cuda)
    before = geodesic.rotation_err.launches
    out = geodesic.rotation_err(preds, labels)
    torch.cuda.synchronize()
    assert geodesic.rotation_err.launches == before + 1
    torch.testing.assert_close(out, geometry.rotation_err(preds, labels),
                               rtol=1e-4, atol=0.05)


@pytest.mark.cuda
def test_geodesic_kernel_rejects_non_contiguous(cuda):
    a = torch.zeros((3, 8), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        geodesic.rotation_err(a[:, :3], a[:, :3])


def _folded(d, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((i, o), dtype=np.float32)
                              * np.float32(np.sqrt(2.0 / i))).to(device),
             torch.from_numpy(rng.standard_normal(o, dtype=np.float32) * np.float32(0.1))
             .to(device))
            for i, o in ((3, 64), (64, 128), (128, d))]


@pytest.mark.parametrize("change,exc", [
    (lambda pts, f: (pts.double(), f), TypeError),
    (lambda pts, f: (pts, [f[0], f[1], (f[2][0].half(), f[2][1])]), TypeError),
    (lambda pts, f: (pts[..., :2], f), ValueError),
    (lambda pts, f: (pts[0], f), ValueError),
    (lambda pts, f: (pts, [f[0], (f[1][0][:, :64], f[1][1]), f[2]]), ValueError),
    (lambda pts, f: (pts, f[:2]), ValueError),
    (lambda pts, f: (pts[:, :0], f), ValueError),  # P = 0: a max over nothing
])
def test_pointnet_rejects_bad_inputs(change, exc):
    pts, folded = change(torch.rand((2, 10, 3)), _folded(32))
    with pytest.raises(exc):
        pointnet.pointnet_eval(pts, folded)


def test_pointnet_rejects_devices_without_a_kernel():
    folded = _folded(32)
    with pytest.raises(ValueError, match="no kernel"):
        pointnet.pointnet_eval(torch.zeros((2, 10, 3), device="meta"),
                               [(w.to("meta"), b.to("meta")) for w, b in folded])
    with pytest.raises(ValueError, match="different devices"):
        pointnet.pointnet_eval(torch.zeros((2, 10, 3), device="meta"), folded)


def test_cpu_teacher_forward_makes_no_pointnet_launch():
    model = PoseEstimator(img_feature_dim=32, shape_feature_dim=32,
                          generator=torch.Generator().manual_seed(0)).eval()
    before = pointnet.pointnet_eval.launches
    heads, fused, proj = model(torch.rand((2, 32, 32, 3)), torch.rand((2, 50, 3)))
    assert pointnet.pointnet_eval.launches == before
    assert fused.shape == (2, 200) and proj.shape == (2, 200)


@pytest.mark.cuda
def test_pointnet_kernel_rejects_non_contiguous(cuda):
    pts = torch.rand((2, 3, 10), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pointnet.pointnet_eval(pts, _folded(32, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 46, 64])
@pytest.mark.parametrize("p", [1, 511, 2500, 2501])
@pytest.mark.parametrize("d", [256, 1000, 1024])  # 1000: a ragged column chunk
def test_pointnet_kernel_matches_plain_on_cuda(cuda, n, p, d):
    folded = _folded(d, cuda, seed=n + p + d)
    pts = torch.rand((n, p, 3), generator=torch.Generator().manual_seed(p)).to(cuda)
    before = pointnet.pointnet_eval.launches
    out = pointnet.pointnet_eval(pts, folded)
    torch.cuda.synchronize()
    assert pointnet.pointnet_eval.launches == before + 1
    ref = pointnet.pointnet_eval_plain(pts, folded)
    # f32 sums of 128 products in another order
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_pointnet_kernel_all_negative_and_identical_points(cuda):
    (w1, b1), (w2, b2), (w3, b3) = _folded(256, cuda)
    folded = [(w1, b1), (w2, b2), (w3, torch.full_like(b3, -100.0))]
    pts = torch.rand((3, 1, 3), device=cuda).expand(3, 700, 3).contiguous()
    out = pointnet.pointnet_eval(pts, folded)
    ref = pointnet.pointnet_eval_plain(pts, folded)
    assert float(out.max()) < 0
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert pointnet.pointnet_eval(pts[:0], folded).shape == (0, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d", [
    (2, 128, 256), (2, 129, 520), (3, 256, 1000), (2, 2500, 600), (8, 2500, 1024),
    (132, 300, 256)])
def test_pointnet_kernel_tiles_and_groups_on_cuda(cuda, n, p, d):
    """Clouds at and one past the 128-point tile, D no multiple of the
    256-column pass, and splits over point segments and column groups
    (segments_for), against the plain version in f32 and in f64: split TF32
    leaves about 2^-21 of each product (one TF32 product 2^-11, which would
    miss 1e-5 of max|ref|), and the same bits on a second call."""
    folded = _folded(d, cuda, seed=n * p + d)
    pts = torch.rand((n, p, 3), generator=torch.Generator().manual_seed(d)).to(cuda)
    out = pointnet.pointnet_eval(pts, folded)
    ref = pointnet.pointnet_eval_plain(pts, folded)
    ref64 = pointnet.pointnet_eval_plain(pts.double(), [(w.double(), b.double())
                                                        for w, b in folded])
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert float((out.double() - ref64).abs().max()) <= 1e-5 * float(ref64.abs().max())
    assert torch.equal(out, pointnet.pointnet_eval(pts, folded))


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d,b3", [
    (1, 1, 256, None), (2, 100, 256, None), (3, 511, 1000, None), (46, 2500, 256, None),
    (64, 2500, 1024, None), (46, 2501, 1024, None), (3, 2500, 256, -100.0)])
def test_pointnet_bf16_kernel_matches_plain_on_cuda(cuda, n, p, d, b3):
    """The bf16 instance against pointnet_eval_bf16_plain on the same
    inputs (the BN multipliers of either sign): each element within one bf16
    ulp of max|ref| (2^-7), under 1 % unequal; every output negative where
    b3 is -100; the same bits on a second call."""
    layers = chip_smoke.pointnet_bf16_params(np.random.default_rng(n + p), d, cuda, b3)
    pts = torch.rand((n, p, 3), generator=torch.Generator().manual_seed(p)).to(cuda)
    pts = (2 * pts - 1).to(torch.bfloat16)
    before = pointnet.pointnet_eval_bf16.launches
    out = pointnet.pointnet_eval_bf16(pts, layers)
    ref = pointnet.pointnet_eval_bf16_plain(pts, layers)
    torch.cuda.synchronize()
    assert pointnet.pointnet_eval_bf16.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (n, d)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= chip_smoke.BF16_ULP * float(ref.float().abs().max())
    assert float((out != ref).float().mean()) < 0.01
    if b3 is not None:
        assert float(out.float().max()) < 0
    assert torch.equal(out, pointnet.pointnet_eval_bf16(pts, layers))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p,d", [(64, 2500, 1024), (46, 2500, 1024), (1, 2500, 1024),
                                   (2, 1, 256), (46, 2500, 256)])
def test_pointnet_eval_launches_per_call(cuda, n, p, d, dtype):
    """Two CUDA launches a call (W3's split, or its bf16 packing, and the
    encoder) and three with point segments (the max over them), as a CUDA
    graph that captures one call counts them: at serving's and the KD
    step's shapes (segments) and at a single tile (none). One count on the
    wrapper a call, f32's and bf16's apart."""
    pts = torch.rand((n, p, 3), generator=torch.Generator().manual_seed(n)).to(cuda)
    call = pointnet.pointnet_eval
    if dtype == torch.bfloat16:
        pts, call = pts.to(dtype), pointnet.pointnet_eval_bf16
        layers = chip_smoke.pointnet_bf16_params(np.random.default_rng(d), d, cuda)
    else:
        layers = _folded(d, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    segments, _ = pointnet.segments_for(n, p, d, sms)
    assert (segments > 1) == (p > pointnet.TILE_P)
    before = call.launches
    counted = chip_smoke.graph_kernel_launches(lambda: call(pts, layers))
    assert counted == 2 + (segments > 1)
    assert call.launches == before + 2  # the run before the capture, and it


def _nce_inputs(n, d, kind, device, seed=0):
    """(s, t, valid_rows, valid_cols, row_offset): all valid ("fused"), a
    masked tail ("masked"), or a shard of rows against more columns with
    its own offset ("partial")."""
    g = torch.Generator().manual_seed(seed)
    nc = n + 60 if kind == "partial" else n
    s = torch.randn(n, d, generator=g).to(device)
    t = torch.randn(nc, d, generator=g).to(device)
    vrow = vcol = None
    if kind == "masked":
        vrow = vcol = torch.arange(n, device=device) < max(n - 3, 1)
    elif kind == "partial":
        vrow = torch.arange(n, device=device) < n - 5
        vcol = torch.arange(nc, device=device) < nc - 2
    return s, t, vrow, vcol, 37 if kind == "partial" else 0


def _nce_call(s, t, vrow, vcol, off, kind):
    if kind == "fused":
        return nce.fused_info_nce(s, t, 0.1)
    if kind == "masked":
        return nce.blocked_info_nce(s, t, 0.1, valid=vrow)
    return nce.blocked_info_nce_partial(s, t, vrow, vcol, off, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,kind", [
    (1, 64, "fused"), (7, 200, "fused"), (160, 200, "fused"), (160, 64, "masked"),
    (1025, 200, "masked"), (2500, 64, "fused"), (100, 200, "partial"), (40, 512, "fused")])
def test_nce_kernel_matches_plain_on_cuda(cuda, n, d, kind):
    s, t, vrow, vcol, off = _nce_inputs(n, d, kind, cuda)
    s.requires_grad_()
    t.requires_grad_()
    counters = (nce.nce_forward, nce.nce_backward)
    before = [(c.launches, c.blocked_launches) for c in counters]
    loss = _nce_call(s, t, vrow, vcol, off, kind)
    ds, dt = torch.autograd.grad(loss, (s, t))
    torch.cuda.synchronize()
    blocked = int(kind != "fused")  # the blocked entries: JAX's nce_blocked.py kernel
    assert [(c.launches, c.blocked_launches) for c in counters] == \
        [(a + 1, b + blocked) for a, b in before]
    ref = nce.info_nce_plain(s, t, 0.1, vrow, vcol, off)
    if kind != "partial":
        ref = ref / (n if vrow is None else vrow.sum())
    rs, rt = torch.autograd.grad(ref, (s, t))
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    for got, want in ((ds, rs), (dt, rt)):
        assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-4)


@pytest.mark.cuda
def test_nce_kernel_is_deterministic_and_checks_its_inputs(cuda):
    s, t, *_ = _nce_inputs(300, 200, "fused", cuda)
    runs = []
    for _ in range(2):
        a, b = s.clone().requires_grad_(), t.clone().requires_grad_()
        loss = nce.fused_info_nce(a, b)
        runs.append((loss.detach(), *torch.autograd.grad(loss, (a, b))))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="contiguous"):
        nce.fused_info_nce(s.t().contiguous().t(), t)
    with pytest.raises(ValueError, match="D <= 512"):
        wide = torch.zeros((4, 513), device=cuda)
        nce.fused_info_nce(wide, wide)


@pytest.mark.cuda
def test_nce_forward_on_two_streams_at_once(cuda):
    """Each forward call takes its ticket in its own workspace: calls on two
    streams may overlap, and each loss is its own."""
    rng = np.random.default_rng(12)
    pairs = [tuple(torch.from_numpy(rng.standard_normal((n, 200)).astype("float32")).to(cuda)
                   for _ in range(2)) for n in (2500, 4096)]
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in side:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    with torch.no_grad():
        for _ in range(10):
            for st, (s, t) in zip(side, pairs):
                with torch.cuda.stream(st):
                    got.append(nce.fused_info_nce(s, t))
        for st in side:
            torch.cuda.current_stream().wait_stream(st)
        want = [nce.info_nce_plain(s, t) / s.shape[0] for s, t in pairs]
    for i, loss in enumerate(got):
        assert float(loss) == pytest.approx(float(want[i % 2]), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,kind", [(46, "fused"), (160, "masked"), (4096, "partial")])
def test_nce_launches_per_call(cuda, n, kind):
    """One CUDA launch a forward call and one a backward call, as the library
    says and as a CUDA graph that captures one call counts them, at the
    stage-1 step's, the teacher step's and the blocked regime's sizes."""
    assert nce.kernel_launches_per_call() == (1, 1)
    s, t, vrow, vcol, off = _nce_inputs(n, 200, kind, cuda)
    vrow, vcol = (None if v is None else v.float() for v in (vrow, vcol))
    divide = kind != "partial"
    _, saved = nce.nce_forward(s, t, vrow, vcol, off, 0.1, divide)
    g = torch.ones((), device=cuda)
    shape = (s.shape[0], t.shape[0], s.shape[1])
    counted = (
        chip_smoke.graph_kernel_launches(
            lambda: nce.nce_forward(s, t, vrow, vcol, off, 0.1, divide)),
        chip_smoke.graph_kernel_launches(
            lambda: nce.nce_backward(saved, vrow, vcol, g, shape, off, 0.1, divide)))
    assert counted == (1, 1)


def _stem_inputs(n, hw, f, kind, device, dtype=torch.float32, seed=0):
    """NCHW image (a channels-last view of NHWC memory), weight, bias and
    an upstream gradient: random ("rand"), ties in every pooling window (an
    image constant on each 2x2 cell, the kernel's centre tap only), or
    every output masked by the ReLU ("negative")."""
    g = torch.Generator().manual_seed(seed)
    if kind == "ties":
        x = torch.randn((n, hw // 2, hw // 2, 3), generator=g)
        x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        w = torch.zeros((f, 3, 3, 3))
        w[:, :, 1, 1] = torch.randn((f, 3), generator=g)
    else:
        x = torch.randn((n, hw, hw, 3), generator=g)
        w = torch.randn((f, 3, 3, 3), generator=g) * (2.0 / 27) ** 0.5
        if kind == "negative":  # positive weights on a negative image
            x, w = -100.0 - x.abs(), w.abs()
    b = torch.randn(f, generator=g) * 0.1
    cot = torch.randn((n, f, hw // 2, hw // 2), generator=g)
    return (x.to(device, dtype).permute(0, 3, 1, 2), w.to(device, dtype).requires_grad_(),
            b.to(device, dtype).requires_grad_(), cot.to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,f,kind,dtype", [
    (1, 224, 64, "rand", torch.float32), (7, 64, 16, "rand", torch.float32),
    (7, 30, 64, "rand", torch.float32), (2, 31, 16, "rand", torch.float32),
    (3, 48, 64, "ties", torch.float32), (3, 48, 64, "negative", torch.float32),
    (2, 32, 24, "rand", torch.float32), (4, 32, 16, "rand", torch.float64)])
def test_vgg_stem_kernel_matches_plain_on_cuda(cuda, n, hw, f, kind, dtype):
    torch.backends.cudnn.allow_tf32 = False
    x, w, b, cot = _stem_inputs(n, hw, f, kind, cuda, dtype)
    before = vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches
    y = vgg_stem.vgg_stem(x, w, b)
    dw, db = torch.autograd.grad(y, (w, b), cot)
    torch.cuda.synchronize()
    assert (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    assert y.shape == (n, f, hw // 2, hw // 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y_ref = vgg_stem.vgg_stem_plain(x, w, b)
    dw_ref, db_ref = torch.autograd.grad(y_ref, (w, b), cot)
    # f32 sums of 27 products, and of the gradient over the image, in
    # another order; the floor keeps the all-masked case's zeros exact
    assert float((y - y_ref).abs().max()) <= 1e-5 * max(float(y_ref.abs().max()), 1e-6)
    for got, want in ((dw, dw_ref), (db, db_ref)):
        assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-6)
    if kind == "negative":
        assert float(y.abs().max()) == 0.0 and float(dw.abs().max()) == 0.0
    y2 = vgg_stem.vgg_stem(x, w, b)
    assert torch.equal(y, y2) and all(torch.equal(a, c) for a, c in zip(
        (dw, db), torch.autograd.grad(y2, (w, b), cot)))


@pytest.mark.cuda
def test_vgg_stem_kernel_checks_its_inputs(cuda):
    x, w, b, _ = _stem_inputs(2, 16, 16, "rand", cuda)
    # an NCHW-contiguous image is read through one copy; the result agrees
    with torch.no_grad():
        assert torch.equal(vgg_stem.vgg_stem(x.contiguous(), w, b), vgg_stem.vgg_stem(x, w, b))
    with pytest.raises(ValueError, match="multiple of 8"):
        vgg_stem.vgg_stem(x, w[:12], b[:12])
    with pytest.raises(TypeError, match="float32 or float64"):
        vgg_stem.vgg_stem(x.half(), w.detach().half(), b.detach().half())
    with pytest.raises(ValueError, match="no gradient for the image"):
        vgg_stem.vgg_stem(x.clone().requires_grad_(), w, b)
    # without a gradient wanted no window indices are written, nothing is kept
    before = vgg_stem.stem_backward.launches
    with torch.no_grad():
        assert not vgg_stem.vgg_stem(x, w, b).requires_grad
    assert vgg_stem.stem_backward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,f,kind", [
    (1, 224, 64, "rand"), (7, 64, 16, "rand"), (7, 30, 64, "rand"), (2, 31, 16, "rand"),
    (3, 48, 64, "ties"), (3, 48, 64, "negative"), (2, 32, 24, "rand"), (2, 64, 256, "rand")])
def test_vgg_stem_bf16_kernels_match_plain_on_cuda(cuda, n, hw, f, kind):
    """The bf16 instances against the plain bf16 version on the same
    inputs (chip_smoke.stem_bf16_vs_plain): y within one bf16 ulp of
    max|ref| (2^-7), no window index differing where the plain version's
    decision is more than an ulp clear, dW and db within one ulp of max|ref|
    of the gradient routed by the kernel's own index; one forward and one
    backward launch through the wrapper, counted apart from f32's."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, b, cot = _stem_inputs(n, hw, f, kind, cuda, torch.bfloat16)
    before = (vgg_stem.stem_forward.launches, vgg_stem.stem_forward.bf16_launches,
              vgg_stem.stem_backward.bf16_launches)
    r = chip_smoke.stem_bf16_vs_plain(vgg_stem, x, w, b, cot)
    torch.cuda.synchronize()
    assert (vgg_stem.stem_forward.launches, vgg_stem.stem_forward.bf16_launches,
            vgg_stem.stem_backward.bf16_launches) == (before[0], before[1] + 2, before[2] + 1)
    assert r["y_err"] <= chip_smoke.BF16_ULP and r["index_bad"] == 0, r
    assert r["dw_err"] <= chip_smoke.BF16_ULP and r["db_err"] <= chip_smoke.BF16_ULP, r
    with torch.no_grad():
        y = vgg_stem.vgg_stem(x, w, b)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    if kind == "negative":
        assert float(y.float().abs().max()) == 0.0


@pytest.mark.cuda
def test_vgg_stem_bf16_pools_before_the_bias_on_cuda(cuda):
    """Two window sums that round to one value after the bias (1.5 and 1.75,
    + 256 -> 258 in bf16): the kernel routes to the larger sum, as the plain
    version and JAX's bf16 stem do."""
    x = torch.zeros((1, 2, 2, 3))
    x[0, 0, 0, 0], x[0, 0, 1, 0] = 1.5, 1.75
    w = torch.zeros((8, 3, 3, 3))
    w[:, 0, 1, 1] = 1.0
    x = x.to(cuda, torch.bfloat16).permute(0, 3, 1, 2)
    w = w.to(cuda, torch.bfloat16).requires_grad_()
    b = torch.full((8,), 256.0, device=cuda, dtype=torch.bfloat16).requires_grad_()
    y = vgg_stem.vgg_stem(x, w, b)
    assert float(y[0, 0, 0, 0]) == 258.0
    dw, = torch.autograd.grad(y[0, 0, 0, 0], (w,))
    assert float(dw[0, 0, 1, 1]) == 1.75 and float(dw[0, 0, 1, 0]) == 1.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_vgg_stem_launches_per_call(cuda, dtype):
    """One CUDA launch a forward call (f32: the split-TF32 product on the
    tensor cores; f64: the CUDA-core kernel; bf16: the bf16 product on the
    tensor cores) and two a backward call (the weight gradient's partials,
    then their fixed-order sum), counted as the kernel nodes of a CUDA graph
    that captures one call."""
    x, w, b, cot = _stem_inputs(3, 40, 64, "rand", cuda, dtype)
    x_nhwc, w, b = x.permute(0, 2, 3, 1), w.detach(), b.detach()
    _, index = vgg_stem.stem_forward(x_nhwc, w, b, with_index=True)
    g = cot.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    counted = (
        chip_smoke.graph_kernel_launches(
            lambda: vgg_stem.stem_forward(x_nhwc, w, b, with_index=True)),
        chip_smoke.graph_kernel_launches(lambda: vgg_stem.stem_backward(x_nhwc, index, g)))
    assert counted == (1, 2)


def test_bf16_pointnet_rejects_bad_inputs():
    layers = chip_smoke.pointnet_bf16_params(np.random.default_rng(0), 32, "cpu")
    pts = torch.rand((2, 10, 3)).to(torch.bfloat16)
    with pytest.raises(TypeError):
        pointnet.pointnet_eval_bf16(pts.float(), layers)
    with pytest.raises(TypeError):
        pointnet.pointnet_eval_bf16(pts, [layers[0], layers[1], (layers[2][0].float(),
                                                                 *layers[2][1:])])
    with pytest.raises(ValueError):
        pointnet.pointnet_eval_bf16(pts, layers[:2])
    with pytest.raises(ValueError, match="no kernel"):
        pointnet.pointnet_eval_bf16(pts.to("meta"), [tuple(t.to("meta") for t in layer)
                                                     for layer in layers])
    before = pointnet.pointnet_eval_bf16.launches
    out = pointnet.pointnet_eval_bf16(pts, layers)  # the CPU takes the plain version
    assert pointnet.pointnet_eval_bf16.launches == before
    assert torch.equal(out, pointnet.pointnet_eval_bf16_plain(pts, layers))


def test_cpu_student_forward_makes_no_stem_launch():
    model = BaselineEstimator(img_feature_dim=32, width_mult=0.25, input_dim=32,
                              generator=torch.Generator().manual_seed(0)).eval()
    before = vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches
    heads, proj = model(torch.rand((2, 32, 32, 3)))
    proj.sum().backward()
    assert (vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches) == before
    assert model.img_encoder.features[0].weight.grad is not None


# --- the train-mode PointNet ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d,kw", [
    (1, 100, 64, {}), (7, 2500, 256, {}), (7, 100, 1024, {}), (46, 2500, 256, {}),
    (5, 40, 256, {}), (46, 700, 256, {"masked": True}), (7, 500, 256, {"ties": True}),
    (7, 500, 256, {"gamma0": True}), (8, 300, 128, {"masked": True, "dtype": torch.float64})])
def test_pointnet_train_kernels_match_plain_on_cuda(cuda, n, p, d, kw):
    """Against the plain version in f64, with chip_smoke.py's tolerances."""
    res = chip_smoke.pt_kernel_vs_plain(pointnet_train, *chip_smoke.pt_inputs(
        np.random.default_rng(n * p + d), n, p, d, cuda, **kw))
    assert res["same"] and res["launches"] == (1, 1), res
    assert res["out"] <= chip_smoke.PT_OUT_TOL and res["stats"] <= chip_smoke.PT_OUT_TOL, res
    assert res["grads"] <= chip_smoke.PT_GRAD_TOL and res["bias"] <= chip_smoke.PT_BIAS_TOL, res
    assert res["tie_gap"] <= chip_smoke.PT_TIE_TOL, res
    assert res["relu_gap"] <= chip_smoke.PT_RELU_TOL, res
    assert res["flips"] <= 2 * res["plain_flips"] + 2, res


@pytest.mark.cuda
def test_pointnet_train_launches_per_call(cuda):
    """Layer 3 in its Gram form: 9 CUDA launches a forward call and 10 a
    backward call, as the library says and as a CUDA graph that captures
    one call counts them."""
    assert pointnet_train.kernel_launches_per_call() == (9, 10)
    pts, layers, _, g = chip_smoke.pt_inputs(np.random.default_rng(1), 3, 300, 128, cuda)
    prm = pointnet_train.pack_params(layers)
    saved = pointnet_train.train_forward(pts, prm, 128, None)
    counted = (
        chip_smoke.graph_kernel_launches(
            lambda: pointnet_train.train_forward(pts, prm, 128, None)),
        chip_smoke.graph_kernel_launches(
            lambda: pointnet_train.train_backward(pts, prm, 128, None, *saved[1:], g)))
    assert counted == (9, 10)


@pytest.mark.cuda
def test_pointnet_train_kernels_check_their_inputs(cuda):
    pts, layers, _, _ = chip_smoke.pt_inputs(np.random.default_rng(0), 2, 50, 96, cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        pointnet_train.pointnet_train(pts, layers)
    pts, layers, _, _ = chip_smoke.pt_inputs(np.random.default_rng(0), 2, 50, 64, cuda)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        pointnet_train.pointnet_train(pts.half(), [[t.half() for t in layer]
                                                   for layer in layers])
    # a non-contiguous cloud is read through one copy; the result agrees
    strided = pts.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(pointnet_train.pointnet_train(strided, layers)[0],
                       pointnet_train.pointnet_train(pts, layers)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_shape_encoder_train_mode_launches_the_kernels(cuda, masked):
    """Train mode on the card runs the train-mode kernels, masked batches
    included, and moves the running statistics as on the CPU."""
    torch.manual_seed(0)
    enc_cpu = ShapeEncoderPC(64, generator=torch.Generator().manual_seed(0))
    enc = ShapeEncoderPC(64, generator=torch.Generator().manual_seed(0)).to(cuda)
    pts = torch.rand((6, 200, 3))
    valid = (torch.arange(6) < 4) if masked else None
    before = (pointnet_train.train_forward.launches, pointnet_train.train_backward.launches)
    out = enc.train()(pts.to(cuda), None if valid is None else valid.to(cuda))
    out.sum().backward()
    assert (pointnet_train.train_forward.launches - before[0],
            pointnet_train.train_backward.launches - before[1]) == (1, 1)
    want = enc_cpu.train()(pts, valid)
    want.sum().backward()
    torch.testing.assert_close(out.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-5)
    for (name, a), b in zip(enc.state_dict().items(), enc_cpu.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d,masked", [(1, 100, 64, False), (7, 2500, 256, True),
                                          (46, 2500, 256, False), (7, 511, 1024, False)])
def test_pointnet_train_bf16_kernels_match_plain_on_cuda(cuda, monkeypatch, n, p, d, masked):
    """The bf16 instance against the plain bf16 version with chip_smoke.py's
    rule (phase 39): statistics within one bf16 ulp, each layer within an
    ulp on its own input (out: an ulp of a3 through BN3's multiplier plus
    one of out), the gradients
    by the oracle rule at each side's own decisions, the differing
    decisions bounded, the weights' and biases' gradients bf16 values.
    cuBLAS's reduced-precision bf16 reductions off, as the CLIs set the card,
    for this test only."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        False)
    pts, layers, valid, g = chip_smoke.pt_inputs(np.random.default_rng(n * p + d), n, p, d,
                                                 cuda, masked=masked)
    r = chip_smoke.pt_bf16_vs_plain(pointnet_train, pts.to(torch.bfloat16), layers, valid,
                                    g.to(torch.bfloat16))
    assert r["same"] and r["launches"] == (1, 1) and r["bf16_grads"], r
    assert max(r["a1_share"], r["a2_share"], r["out_share"]) <= 1, r
    assert r["stats"] <= chip_smoke.BF16_ULP, r
    assert r["grad_share"] <= 1, r
    assert max(r["ties_moved"], r["count_moved"]) <= chip_smoke.PT16_MOVED * n * d + 2, r
    assert r["relu_flips"] <= chip_smoke.PT16_FLIPS * n * p * 192 + 2, r


@pytest.mark.cuda
def test_pointnet_train_bf16_launches_per_call(cuda):
    """The bf16 instance: 8 CUDA launches a forward call and 10 a backward
    call, as the library says and as a CUDA graph of one call counts them."""
    assert pointnet_train.kernel_launches_per_call(torch.bfloat16) == (8, 10)
    pts, layers, _, g = chip_smoke.pt_inputs(np.random.default_rng(1), 3, 300, 128, cuda)
    pts, g = pts.to(torch.bfloat16), g.to(torch.bfloat16)
    prm = pointnet_train.pack_params(layers)
    out, stats, *rest = pointnet_train.train_forward_bf16(pts, prm, 128, None)
    counted = (
        chip_smoke.graph_kernel_launches(
            lambda: pointnet_train.train_forward_bf16(pts, prm, 128, None)),
        chip_smoke.graph_kernel_launches(
            lambda: pointnet_train.train_backward_bf16(pts, prm, 128, None, stats, out, *rest,
                                                       g)))
    assert counted == (8, 10)


@pytest.mark.cuda
def test_shape_encoder_train_mode_bf16_launches_the_kernels(cuda):
    """Train mode under bf16 on the card runs the bf16 instance, once each
    way, and moves the running statistics as on the CPU to one bf16 ulp."""
    enc_cpu = ShapeEncoderPC(64, generator=torch.Generator().manual_seed(0),
                             compute_dtype=torch.bfloat16)
    enc = ShapeEncoderPC(64, generator=torch.Generator().manual_seed(0),
                         compute_dtype=torch.bfloat16).to(cuda)
    pts = torch.rand((6, 200, 3))
    valid = torch.arange(6) < 4
    before = (pointnet_train.train_forward_bf16.launches,
              pointnet_train.train_backward_bf16.launches)
    out = enc.train()(pts.to(cuda), valid.to(cuda))
    out.float().sum().backward()
    assert (pointnet_train.train_forward_bf16.launches - before[0],
            pointnet_train.train_backward_bf16.launches - before[1]) == (1, 1)
    assert out.dtype == torch.bfloat16
    want = enc_cpu.train()(pts, valid)
    scale = float(want.float().abs().max())
    assert float((out.cpu().float() - want.float()).abs().max()) <= chip_smoke.BF16_ULP * scale
    for (name, a), b in zip(enc.state_dict().items(), enc_cpu.state_dict().values()):
        if a.is_floating_point():
            assert float((a.cpu() - b).abs().max()) <= chip_smoke.BF16_ULP * max(
                float(b.abs().max()), 1e-6), name


def test_cpu_vanilla_teacher_train_forward_makes_no_kernel_launch():
    model = PoseEstimatorVanilla(img_feature_dim=32, shape_feature_dim=64,
                                 generator=torch.Generator().manual_seed(0)).train()
    before = (pointnet_train.train_forward.launches, pointnet_train.train_backward.launches,
              pointnet.pointnet_eval.launches)
    heads, x = model(torch.rand((3, 32, 32, 3)), torch.rand((3, 50, 3)))
    x.sum().backward()
    assert before == (pointnet_train.train_forward.launches,
                      pointnet_train.train_backward.launches, pointnet.pointnet_eval.launches)
    assert model.shape_encoder.conv3.weight.grad is not None and x.shape == (3, 200)


# --- the int8 convolution (int8 serving) -------------------------------------

def _int8_args(dev, n=2, h=9, w=9, c=32, k=3, co=48, dtype=torch.float32, seed=0):
    """Seeded inputs; the weights stored K-major, as the quantized trees
    store them (`int8_conv.k_major`: no copy on the call)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (k, k, c, co), generator=g, device=dev, dtype=torch.int8)
    a = (x.float().abs().max() / 127.0).reshape(())
    ws = torch.rand((co,), generator=g, device=dev) * 1e-2 + 1e-4
    return x, a, int8_conv.k_major(wq), ws, torch.randn((co,), generator=g, device=dev)


@pytest.mark.parametrize("change,exc", [
    ("w_float", TypeError), ("ws_shape", ValueError), ("channels", ValueError),
    ("a_f64", TypeError), ("stride", ValueError), ("window", ValueError)])
def test_int8_conv_rejects_bad_inputs(change, exc):
    x, a, w, ws, shift = _int8_args("cpu")
    stride, padding = 1, 1
    if change == "w_float":
        w = w.float()
    elif change == "ws_shape":
        ws = ws[:-1]
    elif change == "channels":
        x = x[..., :-1]
    elif change == "a_f64":
        a = a.double()
    elif change == "stride":
        stride = 0
    else:
        x, padding = x[:, :2, :2], 0
    with pytest.raises(exc):
        int8_conv.int8_conv(x, a, w, ws, shift, stride, padding)


def test_int8_conv_rejects_devices_without_a_kernel():
    x, a, w, ws, shift = (t.to("meta") for t in _int8_args("cpu"))
    with pytest.raises(ValueError, match="no kernel"):
        int8_conv.int8_conv(x, a, w, ws, shift)
    with pytest.raises(ValueError, match="different devices"):
        int8_conv.int8_conv(x, torch.zeros(()), w, ws, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k,co,stride,padding", [
    (2, 56, 56, 64, 3, 128, 1, 1), (2, 28, 28, 256, 1, 64, 2, 0), (3, 13, 13, 48, 3, 40, 2, 1),
    (2, 9, 11, 20, 3, 30, 1, 1), (1, 1, 1, 25088, 1, 4096, 1, 0), (256, 1, 1, 4096, 1, 64, 1, 0)])
def test_int8_conv_matches_plain_on_cuda(cuda, n, h, w, c, k, co, stride, padding, dtype):
    """Bit for bit: the same s32 sums, the same two roundings."""
    args = _int8_args(cuda, n, h, w, c, k, co, dtype)
    before = int8_conv.int8_conv.launches
    for relu in (False, True):
        got = int8_conv.int8_conv(*args, stride, padding, relu)
        want = int8_conv.int8_conv_plain(*args, stride, padding, relu)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, want)
    assert int8_conv.int8_conv.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k,co,stride,padding", [
    (2, 56, 56, 64, 3, 128, 1, 1), (2, 9, 11, 64, 3, 128, 1, 1), (3, 13, 13, 48, 3, 40, 2, 1),
    (2, 9, 11, 20, 3, 30, 1, 1), (1, 14, 14, 512, 3, 512, 1, 1), (2, 8, 8, 256, 1, 64, 1, 0)])
def test_int8_conv_pool_matches_plain_on_cuda(cuda, n, h, w, c, k, co, stride, padding, dtype):
    """The 2x2 max-pool on the s32 sums, bit for bit, on both routes (C 20:
    mma.sync through the workspace), odd sizes and a K split (batch 1)."""
    args = _int8_args(cuda, n, h, w, c, k, co, dtype)
    routes = dict(int8_conv.int8_conv.route_launches)
    for relu in (False, True):
        got = int8_conv.int8_conv(*args, stride, padding, relu, pool=True)
        want = int8_conv.int8_conv_pool_plain(*args, stride, padding, relu)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, want)
    assert int8_conv.int8_conv.route_launches[int8_conv.route(c)] == \
        routes[int8_conv.route(c)] + 2


@pytest.mark.cuda
def test_int8_conv_copies_hwio_weights_per_call(cuda):
    """Weights stored HWIO (as artifacts exported with HWIO leaves hold them) give the
    same bits through a K-major copy the call makes, which is counted."""
    x, a, wk, ws, shift = _int8_args(cuda)
    before = int8_conv.int8_conv.weight_copies
    got = int8_conv.int8_conv(x, a, wk.contiguous(), ws, shift, 1, 1)
    assert int8_conv.int8_conv.weight_copies == before + 1
    assert torch.equal(got, int8_conv.int8_conv(x, a, wk, ws, shift, 1, 1))
    assert int8_conv.int8_conv.weight_copies == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pool,launches", [
    ((64, 56, 56, 64, 3, 64), False, 2),      # the quantization, the product
    ((64, 56, 56, 64, 3, 128), True, 2),      # the pool in the product's epilogue
    ((1, 1, 1, 25088, 1, 4096), False, 3),    # and the split-K epilogue
    ((2, 9, 11, 20, 3, 30), True, 3)])        # the mma.sync route's pool
def test_int8_conv_launches_per_call(cuda, shape, pool, launches):
    n, h, w, c, k, co = shape
    args = _int8_args(cuda, n, h, w, c, k, co, torch.bfloat16)
    assert chip_smoke.graph_kernel_launches(
        lambda: int8_conv.int8_conv(*args, 1, (k - 1) // 2, pool=pool)) == launches


@pytest.mark.cuda
def test_dewire_and_banks_on_cuda_equal_the_cpu(cuda):
    """The u8 wire's dewire is correctly rounded on the card, as on the CPU
    and in data.transforms.to_float_array (CUDA divides by a Python scalar
    as a product with its reciprocal, one ulp off for some pixel values);
    a RenderBank's gather and a ShapeBank's subsets are the CPU's bit for
    bit."""
    from pose3d_tpu_torch.ops import augment, shape_bank

    u8 = torch.arange(256, dtype=torch.uint8).reshape(16, 16, 1)
    want = np.asarray(u8.numpy(), np.float32) / 255.0
    np.testing.assert_array_equal(augment.dewire(u8.to(cuda)).cpu().numpy(), want)
    rng = np.random.default_rng(0)
    renders = rng.integers(0, 256, (3, 144, 16, 16, 3), dtype=np.uint8)
    table = rng.integers(0, 144, (72, 12))
    ids, mut = torch.tensor([2, 0, 1, 2]), torch.tensor([0, 71, 5, 36])
    got = [shape_bank.gather_renders(shape_bank.RenderBank.from_arrays(renders, table, d),
                                     ids.to(d), mut.to(d)).cpu() for d in ("cpu", cuda)]
    assert torch.equal(got[0], got[1])
    counts = torch.tensor([3000, 2500, 1000])
    seeds = torch.from_numpy(rng.integers(0, 2**32, 3))
    idx = [shape_bank.sample_indices(counts.to(d), seeds.to(d), 3000, 2500).cpu()
           for d in ("cpu", cuda)]
    assert torch.equal(idx[0], idx[1])
