"""The port's kernel wrappers and build, without JAX.

The tests marked `cuda` need an NVIDIA GPU and skip without one; on the GPU
machine run them with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks).
"""

import numpy as np
import pytest
import torch

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.models.estimators import PoseEstimator
from pose3d_tpu_torch.ops import _build, geodesic, pointnet


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
