"""The port's fused VGG stem against the JAX package, on the CPU.

`ops.vgg_stem.vgg_stem` takes its plain version on CPU tensors (conv,
ReLU, max pool, differentiated by autograd). It is held against JAX's
stem functions (`xla_vgg_stem`, and the Pallas kernels `fused_vgg_stem` and
`fused_vgg_stem_cf` in interpret mode, as tests/test_ops.py runs them), its
weight and bias gradients against `jax.grad` through JAX's student block
(`_ConvPool2x2` then ReLU), and, where every pooling window ties, against
the gradient routed to each window's first position.

Tolerances: f32 on both sides, the convolutions' summation orders differ:
outputs within 1e-5 of max|ref| (JAX's own stem test holds its kernels to
1e-5), gradients within 1e-5 of max|ref|. In the tie case the values are
exact sums of one product, so the routing is held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu.models.vgg import _ConvPool2x2
from pose3d_tpu.ops.vgg_stem import fused_vgg_stem, fused_vgg_stem_cf, xla_vgg_stem
from pose3d_tpu_torch.models.estimators import BaselineEstimator
from pose3d_tpu_torch.ops import vgg_stem as stem

TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _inputs(n, hw, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, f)) * np.sqrt(2 / 27)).astype(np.float32)  # HWIO
    b = (rng.standard_normal(f) * 0.1).astype(np.float32)
    return x, k, b


def _port(x, k, b, requires_grad=False):
    """NHWC numpy -> the port's NCHW view, (F, 3, 3, 3) weight, bias."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    bt = torch.from_numpy(b)
    return xt, wt.requires_grad_(requires_grad), bt.requires_grad_(requires_grad)


@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("f", [16, 64])
def test_stem_forward_matches_jax(hw, f):
    x, k, b = _inputs(2, hw, f, seed=hw + f)
    with torch.no_grad():
        got = stem.vgg_stem(*_port(x, k, b)).permute(0, 2, 3, 1).numpy()
    xj, kj, bj = jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)
    for want in (xla_vgg_stem(xj, kj, bj), fused_vgg_stem(xj, kj, bj, interpret=True),
                 fused_vgg_stem_cf(xj, kj, bj, interpret=True)):
        assert got.shape == (2, hw // 2, hw // 2, f)
        assert _rel(got, want) <= TOL


def _jax_block_grads(x, k, b, cot):
    """dW, db of sum(relu(_ConvPool2x2(x)) * cot): JAX's student stem."""
    block = _ConvPool2x2(features=k.shape[-1])

    def f(params):
        y = jax.nn.relu(block.apply({"params": params}, jnp.asarray(x)))
        return jnp.sum(y * cot)

    g = jax.grad(f)({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)})
    return np.asarray(g["kernel"]).transpose(3, 2, 0, 1), np.asarray(g["bias"])


@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("f", [16, 64])
def test_stem_weight_gradient_matches_jax(hw, f):
    x, k, b = _inputs(2, hw, f, seed=100 + hw + f)
    cot = np.random.default_rng(hw * f).standard_normal(
        (2, hw // 2, hw // 2, f)).astype(np.float32)
    xt, wt, bt = _port(x, k, b, requires_grad=True)
    y = stem.vgg_stem(xt, wt, bt)
    dw, db = torch.autograd.grad(y, (wt, bt), torch.from_numpy(cot).permute(0, 3, 1, 2))
    want_dw, want_db = _jax_block_grads(x, k, b, cot)
    assert _rel(dw.numpy(), want_dw) <= TOL
    assert _rel(db.numpy(), want_db) <= TOL


def test_stem_ties_route_the_gradient_to_the_first_position():
    """Each pooling window ties: the image is constant on every 2x2 cell and
    the kernel has its centre tap only, so the four conv values of a window
    are one and the same product. The off-centre taps then read different
    pixels from the four positions, so dW shows where the gradient went: to
    the first position (0, 0), as torch's MaxPool2d and JAX's where-chain
    send it."""
    rng = np.random.default_rng(5)
    n, hw, f = 2, 16, 16
    cells = rng.standard_normal((n, hw // 2, hw // 2, 3)).astype(np.float32)
    x = np.repeat(np.repeat(cells, 2, axis=1), 2, axis=2)
    k = np.zeros((3, 3, 3, f), np.float32)
    k[1, 1] = rng.standard_normal((3, f)).astype(np.float32)
    b = (rng.standard_normal(f) * 0.1).astype(np.float32)
    cot = rng.standard_normal((n, hw // 2, hw // 2, f)).astype(np.float32)

    xt, wt, bt = _port(x, k, b, requires_grad=True)
    y = stem.vgg_stem(xt, wt, bt)
    dw, db = torch.autograd.grad(y, (wt, bt), torch.from_numpy(cot).permute(0, 3, 1, 2))

    # the gradient of each unmasked output at its window's first position
    pre = np.einsum("nhwc,cf->nhwf", cells, k[1, 1]) + b
    g = cot * (pre > 0)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    first = np.zeros((f, 3, 3, 3), np.float64)
    for ky in range(3):
        for kx in range(3):
            window = xp[:, ky:ky + hw:2, kx:kx + hw:2, :]  # (n, hw/2, hw/2, 3)
            first[:, :, ky, kx] = np.einsum("nhwf,nhwc->fc", g, window)
    np.testing.assert_allclose(dw.numpy(), first, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), g.sum(axis=(0, 1, 2)), rtol=1e-5, atol=1e-5)
    want_dw, want_db = _jax_block_grads(x, k, b, cot)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-5, atol=1e-5)
    # another routing would move the off-centre taps' gradient
    last = np.zeros_like(first)
    for ky in range(3):
        for kx in range(3):
            window = xp[:, ky + 1:ky + 1 + hw:2, kx + 1:kx + 1 + hw:2, :]
            last[:, :, ky, kx] = np.einsum("nhwf,nhwc->fc", g, window)
    assert np.abs(last - first).max() > 1e-2 * np.abs(first).max()


def test_stem_odd_size_pools_with_floor():
    x, k, b = _inputs(1, 15, 16, seed=3)
    with torch.no_grad():
        got = stem.vgg_stem(*_port(x, k, b))
    want = xla_vgg_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    assert got.shape == (1, 16, 7, 7)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), want) <= TOL


def test_student_forward_goes_through_the_stem():
    """The student's first block is the stem call: its forward equals the
    layer-by-layer features (conv, ReLU, pool) bit for bit on the CPU, and
    makes no kernel launch there."""
    model = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                              generator=torch.Generator().manual_seed(0)).eval()
    im = torch.randn((3, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    before = stem.stem_forward.launches, stem.stem_backward.launches
    with torch.no_grad():
        heads, proj = model(im)
        vgg = model.img_encoder
        feats = vgg.features(im.permute(0, 3, 1, 2))
        x = vgg.classifier(torch.flatten(feats, 1))
        x = model.compress(x)
        want_proj = model.projector(x)
    assert (stem.stem_forward.launches, stem.stem_backward.launches) == before
    assert torch.equal(proj, want_proj)
    assert torch.equal(heads[0], model.fc_cls_azi(x))


@pytest.mark.parametrize("change,exc", [
    (lambda x, w, b: (x[:, :2], w, b), ValueError),           # not 3 channels
    (lambda x, w, b: (x[0], w, b), ValueError),               # not 4-d
    (lambda x, w, b: (x[:, :, :1], w, b), ValueError),        # H < 2
    (lambda x, w, b: (x, w[:, :, :2], b), ValueError),        # not a 3x3 kernel
    (lambda x, w, b: (x, w, b[:8]), ValueError),              # bias of another width
    (lambda x, w, b: (x, w.double(), b), TypeError),          # mixed dtypes
    (lambda x, w, b: (x.int(), w.int(), b.int()), TypeError),
    (lambda x, w, b: (x.requires_grad_(), w, b), ValueError),  # the image gets no gradient
])
def test_stem_rejects_bad_inputs(change, exc):
    x = torch.zeros((2, 3, 8, 8))
    w, b = torch.zeros((16, 3, 3, 3)), torch.zeros(16)
    with pytest.raises(exc):
        stem.vgg_stem(*change(x, w, b))


def test_stem_rejects_devices_without_a_kernel():
    w, b = torch.zeros((16, 3, 3, 3)), torch.zeros(16)
    with pytest.raises(ValueError, match="no kernel"):
        stem.vgg_stem(torch.zeros((2, 3, 8, 8), device="meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        stem.vgg_stem(torch.zeros((2, 3, 8, 8), device="meta"), w, b)
