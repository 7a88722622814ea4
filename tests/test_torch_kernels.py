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
from pose3d_tpu_torch.ops import _build, geodesic


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
