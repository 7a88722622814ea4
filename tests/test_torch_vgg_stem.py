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

The CUDA kernels' arithmetic, which no CPU run reaches, is emulated here in
numpy and held against JAX: the f32 forward's split-TF32 im2col product
(`split_tf32_stem`: cvt.rna as rounding the f32 bit pattern to 10 mantissa
bits, half away from zero; mma.m16n8k8's 16-row tiles in the kernel's
window-position order; each mma an exact 8-term dot product added to f32
accumulators) and the weight gradient's branch-free form (`branch_free_wgrad`:
g zeroed at masked outputs and taken at window position 0, the patch at C 3
as the kernel keeps it, or padded to 4). One TF32 product instead of three
fails the output tolerance, which is why the kernel splits.
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
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

TOL = 1e-5
TAPS, K = 27, 32  # the taps, padded to four k-steps of 8


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


# --- bf16 (--bf16) ---------------------------------------------------------------

BF16_ULP = 2.0**-7  # one bf16 ulp, relative to max|ref|


def _bf16_values(a):
    """The bf16 values of an f32 array, as f32 (so each side casts exactly)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _within_ulps(got, want, ulps, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    unequal = float(np.mean(got != want))
    print(f"{name}: max|d|/max|ref| {err:.3g} (tol {ulps} x {BF16_ULP:.3g}), unequal "
          f"{unequal:.3g}")
    assert err <= ulps * BF16_ULP, name
    return unequal


@pytest.mark.parametrize("hw,f", [(16, 16), (32, 64)])
def test_stem_bf16_matches_jax(hw, f):
    """The plain bf16 version (the CPU's: each window sum rounded to bf16,
    the first maximum, + bias rounded, ReLU) against JAX's bf16 student
    stem, relu(_ConvPool2x2(dtype=bfloat16)), on the same bf16 image and
    weights: within one bf16 ulp of max|ref|, under 1 % unequal. Against
    the Pallas fused_vgg_stem in interpret mode on the same bf16 input
    (its sums in f32, rounded once where the model rounds three times):
    within 2 ulps. The weight and bias gradients against the f64 sums of
    the routed gradient (the forward's own maxima and ReLU decisions): the
    port rounds one f32 sum of exact products to bf16, so within one ulp;
    and against jax.grad through JAX's bf16 block by the oracle rule (the
    port's error at most twice JAX's plus 2^-10 of max|ref|): JAX sums its
    weight gradient from four phase kernels' bf16 gradients and reduces its
    bias gradient in bf16, each rounded."""
    x, k, b = (_bf16_values(a) for a in _inputs(2, hw, f, seed=7 + hw + f))
    cot = _bf16_values(np.random.default_rng(hw * f + 1).standard_normal(
        (2, hw // 2, hw // 2, f)))
    xt, wt, bt = _port(x.copy(), k, b)
    wt, bt = wt.to(torch.bfloat16).requires_grad_(), bt.to(torch.bfloat16).requires_grad_()
    y = stem.vgg_stem(xt.to(torch.bfloat16), wt, bt)
    assert y.dtype == torch.bfloat16
    dw, db = torch.autograd.grad(y, (wt, bt), torch.from_numpy(cot).permute(0, 3, 1, 2)
                                 .to(torch.bfloat16))
    got = y.detach().float().permute(0, 2, 3, 1).numpy()
    block = _ConvPool2x2(features=f, dtype=jnp.bfloat16)

    def jax_stem(params):
        return jax.nn.relu(block.apply({"params": params}, jnp.asarray(x)))

    params = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
    want = jax_stem(params)
    assert want.dtype == jnp.bfloat16
    unequal = _within_ulps(got, want.astype(jnp.float32), 1, f"stem bf16 {hw} {f}")
    assert unequal < 0.01
    fused = fused_vgg_stem(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b),
                           interpret=True)
    _within_ulps(got, fused.astype(jnp.float32), 2, f"stem bf16 vs Pallas {hw} {f}")
    g = jax.grad(lambda p: jnp.sum(jax_stem(p).astype(jnp.float32) * cot))(params)
    # the f64 gradient routed as the forward decided: each window's first
    # maximum of the bf16 sums, where the output passed the ReLU
    conv = torch.nn.functional.conv2d(xt.double(), wt.detach().double(), padding=1)
    _, where = torch.nn.functional.max_pool2d(conv.to(torch.bfloat16).float(), 2,
                                              return_indices=True)
    g_out = torch.from_numpy(cot).permute(0, 3, 1, 2).double() * (y.detach() > 0)
    g_conv = torch.zeros_like(conv).flatten(2).scatter_(2, where.flatten(2), g_out.flatten(2))
    exact_dw = torch.nn.grad.conv2d_weight(xt.double(), tuple(wt.shape),
                                           g_conv.view_as(conv), padding=1)
    exact_db = g_out.sum((0, 2, 3))
    for name, got_g, jax_g, exact in (
            ("dW", dw, np.asarray(g["kernel"]).transpose(3, 2, 0, 1), exact_dw),
            ("db", db, np.asarray(g["bias"]), exact_db)):
        got_g, exact = got_g.double().numpy(), exact.numpy()
        _within_ulps(got_g, exact, 1, f"stem bf16 {name} vs f64 {hw} {f}")
        port_err, jax_err = np.abs(got_g - exact).max(), np.abs(jax_g - exact).max()
        print(f"stem bf16 {name}: port {port_err:.3g}, JAX {jax_err:.3g} of max|ref| "
              f"{np.abs(exact).max():.3g}")
        assert port_err <= 2 * jax_err + 2.0**-10 * np.abs(exact).max()


def test_stem_bf16_pools_before_the_bias():
    """In bf16 two window sums that differ can round to one value after the
    bias: the first maximum is taken on the rounded sums before the bias
    (JAX's order), so the gradient goes to the larger sum, not to the first
    of the tied sums after it."""
    # window sums 1.5 (position 0) and 1.75 (position 1); + bias 256 rounds
    # both to 258 (bf16's ulp there is 2)
    x = np.zeros((1, 2, 2, 3), np.float32)
    x[0, 0, 0, 0], x[0, 0, 1, 0] = 1.5, 1.75
    w = torch.zeros((8, 3, 3, 3))
    w[:, 0, 1, 1] = 1.0  # the centre tap of channel 0
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    w_t = w.to(torch.bfloat16).requires_grad_()
    b_t = torch.full((8,), 256.0).to(torch.bfloat16).requires_grad_()
    y = stem.vgg_stem(x_t, w_t, b_t)
    assert float(y[0, 0, 0, 0]) == 258.0
    dw, = torch.autograd.grad(y[0, 0, 0, 0], (w_t,))
    # the window sum at position 1 took the gradient: its centre reads x[0, 1]
    assert float(dw[0, 0, 1, 1]) == 1.75
    assert float(dw[0, 0, 1, 0]) == 1.5  # its left tap reads x[0, 0]


# --- the CUDA kernels' arithmetic, emulated -----------------------------------

def _rna(a):
    """cvt.rna.tf32.f32: the f32 bit pattern rounded to 10 mantissa bits,
    half away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """a = big + small, both TF32: small is the remainder (exact in f32), rounded."""
    big = _rna(a)
    return big, _rna(np.asarray(a, np.float32) - big)


def _windows(x, c_pad=3):
    """(N, Ho, Wo, 4, 4, c_pad): each pooled output's 4 x 4 input window
    (the SAME halo zero, the channels zero-padded to c_pad)."""
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    xp = np.zeros((n, h + 2, w + 2, c_pad), np.float32)
    xp[:, 1:h + 1, 1:w + 1, :c] = x
    rows = np.arange(ho)[:, None] * 2 + np.arange(4)[None, :]   # (Ho, 4)
    cols = np.arange(wo)[:, None] * 2 + np.arange(4)[None, :]   # (Wo, 4)
    return xp[:, rows[:, None, :, None], cols[None, :, None, :]]  # (N, Ho, Wo, 4, 4, C)


def _im2col(x):
    """(N, Ho, Wo, 4, K): window position (dy, dx) in row-major order, tap
    k = (ky * 3 + kx) * 3 + c, zero past 27."""
    win = _windows(x)
    a = np.zeros(win.shape[:3] + (4, K), np.float32)
    for s in range(4):
        dy, dx = divmod(s, 2)
        a[..., s, :TAPS] = win[:, :, :, dy:dy + 3, dx:dx + 3, :].reshape(win.shape[:3] + (TAPS,))
    return a


def split_tf32_sums(x, k, products=3):
    """The f32 forward kernel's window sums in numpy, (N * Ho * Wo, 4, F).
    Eight pooled outputs make two m16 tiles: rows g and g + 8 of tile 0 are
    window positions 0 and 1 of output g, of tile 1 positions 2 and 3. Each
    k-step adds small.big, big.small, big.big (products=3) or big.big alone
    (products=1) to f32 accumulators."""
    f = k.shape[-1]
    a = _im2col(x).reshape(-1, 4, K)
    outputs = a.shape[0]
    a = np.concatenate([a, np.zeros(((-outputs) % 8, 4, K), np.float32)])
    # (groups of 8 outputs, m-tile, 16 rows, K): row g + 8 * (s % 2) of tile s // 2
    tiles = a.reshape(-1, 8, 2, 2, K).transpose(0, 2, 3, 1, 4).reshape(-1, 2, 16, K)
    wmat = np.zeros((K, f), np.float32)
    wmat[:TAPS] = k.reshape(TAPS, f)  # HWIO raveled: (ky, kx, c)
    a_big, a_small = _split(tiles)
    w_big, w_small = _split(wmat)
    terms = [(a_small, w_big), (a_big, w_small), (a_big, w_big)][3 - products:]
    acc = np.zeros(tiles.shape[:3] + (f,), np.float32)
    for j in range(K // 8):
        ks = slice(8 * j, 8 * j + 8)
        for ta, tw in terms:  # one mma: an exact 8-term dot product, then f32
            acc = (acc + ta[..., ks].astype(np.float64) @ tw[ks].astype(np.float64)
                   ).astype(np.float32)
    # back from the C fragment: tile m's rows g, g + 8 -> positions 2m, 2m + 1
    return acc.reshape(-1, 2, 2, 8, f).transpose(0, 3, 1, 2, 4).reshape(-1, 4, f)[:outputs]


def split_tf32_stem(x, k, b, products=3):
    """The f32 forward kernel's output in numpy: y (N, Ho, Wo, F) and the
    index byte (window position of the first maximum, 4 where the ReLU
    masked it), from `split_tf32_sums`."""
    n, h, w, _ = x.shape
    ho, wo, f = h // 2, w // 2, k.shape[-1]
    vals = split_tf32_sums(x, k, products) + b.astype(np.float32)
    pos = np.argmax(vals, axis=1)  # the first maximum in position order
    best = np.max(vals, axis=1)
    y = np.where(best > 0, best, 0).astype(np.float32)
    index = np.where(best > 0, pos, 4).astype(np.uint8)
    return y.reshape(n, ho, wo, f), index.reshape(n, ho, wo, f)


def branch_free_wgrad(x, index, g, c_pad=3):
    """The f32 weight-gradient kernel's arithmetic in numpy: every output
    adds g times its routed position's 27 inputs, from a patch with C
    channels (3, or padded to 4 for 16-byte loads); a masked output adds
    g = 0 at position 0. Returns dW (F, 3, 3, 3) torch layout and db (F,)."""
    win = _windows(x, c_pad=c_pad)                           # (N, Ho, Wo, 4, 4, C)
    on = index != 4
    gz = np.where(on, g, 0).astype(np.float32)               # (N, Ho, Wo, F)
    s = np.where(on, index, 0)
    f = g.shape[-1]
    dw = np.zeros((f, 3, 3, c_pad), np.float32)
    for sp in range(4):  # the four routed positions' sums, one after another
        dy, dx = divmod(sp, 2)
        gs = np.where(s == sp, gz, 0)
        dw += np.einsum("nhwf,nhwyxc->fyxc", gs, win[:, :, :, dy:dy + 3, dx:dx + 3, :])
    assert not dw[..., 3:].any()  # a padded channel adds nothing
    return dw[..., :3].transpose(0, 3, 1, 2), gz.sum(axis=(0, 1, 2))


@pytest.mark.parametrize("hw", [30, 31])
@pytest.mark.parametrize("f", [8, 64])
def test_split_tf32_forward_matches_jax(hw, f):
    """Three TF32 products per f32 product keep the output within 1e-5 of
    max|ref| (phase 5's STEM_Y_TOL); one does not."""
    x, k, b = _inputs(2, hw, f, seed=200 + hw + f)
    want = np.asarray(xla_vgg_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    y, index = split_tf32_stem(x, k, b)
    assert y.shape == want.shape == (2, hw // 2, hw // 2, f)
    assert _rel(y, want) <= TOL
    assert np.array_equal(index == 4, want <= 0)
    y1, _ = split_tf32_stem(x, k, b, products=1)
    assert _rel(y1, want) > TOL


def test_split_tf32_forward_routes_ties_to_the_first_position():
    """Every pooling window ties (an image constant on each 2x2 cell, the
    centre tap only): the four rows are one and the same through the same k
    order, so each unmasked output routes to position 0."""
    rng = np.random.default_rng(6)
    n, hw, f = 2, 30, 64
    cells = rng.standard_normal((n, hw // 2, hw // 2, 3)).astype(np.float32)
    x = np.repeat(np.repeat(cells, 2, axis=1), 2, axis=2)
    k = np.zeros((3, 3, 3, f), np.float32)
    k[1, 1] = rng.standard_normal((3, f)).astype(np.float32)
    b = (rng.standard_normal(f) * 0.1).astype(np.float32)
    y, index = split_tf32_stem(x, k, b)
    want = np.asarray(xla_vgg_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    assert _rel(y, want) <= TOL
    assert set(np.unique(index)) == {0, 4} and np.array_equal(index == 4, want <= 0)


@pytest.mark.parametrize("c_pad", [3, 4])
@pytest.mark.parametrize("hw,f", [(30, 16), (31, 64)])
def test_branch_free_weight_gradient_matches_jax(hw, f, c_pad):
    """The kernel's gradient form, routed by the split-TF32 forward's index,
    against jax.grad through _ConvPool2x2 then ReLU: the patch at C 3, the
    kernel's, and at C 4, the 16-byte-load layout the card ran slower."""
    x, k, b = _inputs(2, hw, f, seed=300 + hw + f)
    cot = np.random.default_rng(hw + f).standard_normal(
        (2, hw // 2, hw // 2, f)).astype(np.float32)
    _, index = split_tf32_stem(x, k, b)
    assert (index == 4).any() and (index < 4).any()
    dw, db = branch_free_wgrad(x, index, cot, c_pad)
    want_dw, want_db = _jax_block_grads(x, k, b, cot)
    assert _rel(dw, want_dw) <= TOL
    assert _rel(db, want_db) <= TOL


def test_split_tf32_error_is_within_the_recompute_margin():
    """The kernel makes a routing decision again in f32 FMA where it lies
    within 2^-14 max|x| sum|w| of its threshold (kNear in csrc/vgg_stem.cu),
    on the claim that a split-TF32 window sum is within 2^-15 max|x| sum|w|
    of the exact sum: held here against f64 on seeded inputs, where the
    largest error is far inside it, and farther decisions agree with f64's."""
    x, k, b = _inputs(2, 31, 64, seed=400)
    sums = split_tf32_sums(x, k)
    exact = np.einsum("osk,kf->osf", _im2col(x).reshape(-1, 4, K)[..., :TAPS].astype(np.float64),
                      k.reshape(TAPS, -1).astype(np.float64))
    x_max = np.abs(_windows(x)).reshape(sums.shape[0], -1).max(axis=1)[:, None, None]
    scale = x_max * np.abs(k).reshape(TAPS, -1).sum(axis=0)   # max|x| sum|w|
    err = np.abs(sums - exact) / scale
    assert err.max() <= 2.0**-15 and err.max() > 0
    vals, ref = sums + b, exact + b
    best, best_ref = vals.max(axis=1), ref.max(axis=1)
    gap = np.abs(best)
    for s in range(4):
        other = np.where(np.argmax(vals, axis=1) == s, np.inf, best - vals[:, s])
        gap = np.minimum(gap, other)
    far = gap >= 2.0**-14 * scale[:, 0]
    assert far.mean() > 0.99
    routed = np.where(best > 0, np.argmax(vals, axis=1), 4)
    routed_ref = np.where(best_ref > 0, np.argmax(ref, axis=1), 4)
    assert np.array_equal(routed[far], routed_ref[far])


def split_tf32_routing(x, k, b):
    """The f32 forward kernel's index byte with its margin, in numpy. A
    decision within 2^-14 max|x| sum|w| of its threshold (the ReLU's, and
    where the output passes it the maximum's against each other position)
    is first taken again with the positions that tie exactly as one (their
    sums are equal in any order: the kernel takes neighbouring positions, 0
    and 1, 2 and 3, 0 and 2, 1 and 3, whose windows are equal, bit for bit,
    on every tap that some channel weighs, and what follows from them), the
    first of them winning; a decision still that near is made again from
    exact sums (the kernel: f32 FMA). Returns the index (outputs, F), the
    near decisions and those made again."""
    vals = split_tf32_sums(x, k) + b                                  # (O, 4, F)
    first, best = np.argmax(vals, axis=1), np.max(vals, axis=1)       # (O, F)
    a = _im2col(x).reshape(-1, 4, K)[..., :TAPS]                      # (O, 4, 27)
    w = k.reshape(TAPS, -1)
    x_max = np.abs(_windows(x)).reshape(a.shape[0], -1).max(axis=1)
    margin = 2.0**-14 * x_max[:, None] * np.abs(w).sum(axis=0)
    bits, weighed = a.view(np.uint32), (w != 0).any(axis=1)
    ties = np.stack([~((bits[:, s0] != bits[:, s1]) & weighed).any(axis=1)
                     for s0, s1 in ((0, 1), (2, 3), (0, 2), (1, 3))], -1)  # (O, 4)
    tie = lambda i: np.take_along_axis(ties, i, axis=1)  # noqa: E731
    row, col = tie(first >> 1), tie(2 + (first & 1))                  # (O, F)
    diag = (row & tie(2 + ((first & 1) ^ 1))) | (col & tie((first >> 1) ^ 1))
    at = lambda i: np.arange(4) == i[..., None]  # noqa: E731
    in_class = (at(first) | (row[..., None] & at(first ^ 1)) | (col[..., None] & at(first ^ 2))
                | (diag[..., None] & at(first ^ 3)))                  # (O, F, 4)
    gaps = np.where(np.arange(4)[None, :, None] == first[:, None, :], np.inf,
                    best[:, None, :] - vals)
    gap = np.minimum(np.abs(best), np.where(best > 0, gaps.min(axis=1), np.inf))
    gap_class = np.minimum(np.abs(best), np.where(
        best > 0, np.where(in_class.transpose(0, 2, 1), np.inf, gaps).min(axis=1), np.inf))
    near = gap < margin
    again = near & (gap_class < margin)
    exact = (a[..., None].astype(np.float64) * w[None, None].astype(np.float64)).sum(axis=2) + b
    pos = np.where(near, np.argmax(in_class, axis=2), first)  # the class's first position
    pos = np.where(again, np.argmax(exact, axis=1), pos)
    passes = np.where(again, exact.max(axis=1), best) > 0
    return np.where(passes, pos, 4), near, again


@pytest.mark.parametrize("kind", ["ties", "bars"])
def test_exact_ties_are_routed_without_the_f32_recompute(kind):
    """Windows that tie exactly, every window of the "ties" image (constant
    2x2 cells, the centre tap only) and the constant bars that resize_pad
    puts around a crop that is not square (normalised black, half of the
    rows of one image and the columns of the other): their decisions lie
    within the margin, yet taken as one class they route to the first
    position as exact sums do, so the kernel makes few decisions again."""
    rng = np.random.default_rng(7)
    n, hw, f = 2, 30, 64
    if kind == "ties":
        cells = rng.standard_normal((n, hw // 2, hw // 2, 3)).astype(np.float32)
        x = np.repeat(np.repeat(cells, 2, axis=1), 2, axis=2)
        k = np.zeros((3, 3, 3, f), np.float32)
        k[1, 1] = rng.standard_normal((3, f)).astype(np.float32)
    else:
        x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
        colour = -np.array([0.485, 0.456, 0.406], np.float32) / np.array([0.229, 0.224, 0.225],
                                                                          np.float32)
        for view in (x[0], x[1].transpose(1, 0, 2)):
            view[:hw // 4] = colour
            view[hw - hw // 4:] = colour
        k = (rng.standard_normal((3, 3, 3, f)) * np.sqrt(2 / 27)).astype(np.float32)
    b = (rng.standard_normal(f) * 0.1).astype(np.float32)
    index, near, again = split_tf32_routing(x, k, b)
    a = _im2col(x).reshape(-1, 4, K)[..., :TAPS].astype(np.float64)
    exact = (a[..., None] * k.reshape(TAPS, -1)[None, None].astype(np.float64)).sum(axis=2) + b
    want = np.where(exact.max(axis=1) > 0, np.argmax(exact, axis=1), 4)
    assert np.array_equal(index, want)
    assert near.mean() > (0.4 if kind == "ties" else 0.1)
    assert again.mean() < 0.01
    y, _ = split_tf32_stem(x, k, b)
    assert _rel(y, np.asarray(xla_vgg_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))) <= TOL
    if kind == "ties":
        assert set(np.unique(index)) == {0, 4}


# --- the bf16 kernels' arithmetic, emulated -----------------------------------
#
# csrc/vgg_stem.cu's bf16 forward reads a tile's patch as TMA lays it out: the
# image viewed as (N, H, W x 3), a box of 34 rows x 112 values from row
# 2 ty0 - 1 and value 6 tx0 - 8 (TMA takes a box only from a multiple of 8
# values), so the patch row's first value, 6 tx0 - 3, sits at value 5. A pair
# of neighbouring values is then one aligned 4-byte word at window positions
# 1 and 3, and straddles two words at 0 and 2 (joined by a funnel shift).
# Its k order is (ky, j), k = 10 ky + j, j = 3 kx + c, with j = 9 and
# k >= 30 weighing nothing (their half masked). The weight gradient is four
# products a tile, one a window position s: the gradient where the index is s
# times position s's 27 window values and a ones column (db).

PITCH16, LEAD16, K16 = 112, 5, 32


def _tma_box(x, img, r0, c0):
    """One TMA box of the NHWC image x viewed as (N, H, W * 3): 34 rows x 112
    values from (r0, c0), zero outside."""
    n, h, w, c = x.shape
    flat = x.reshape(n, h, w * c)
    box = np.zeros((34, PITCH16), x.dtype)
    rows = np.arange(r0, r0 + 34)
    cols = np.arange(c0, c0 + PITCH16)
    rin, cin = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w * c)
    box[np.ix_(rin, cin)] = flat[img][np.ix_(rows[rin], cols[cin])]
    return box


def _pair_offset(k):
    """The forward's pair (k, k + 1), k even: its value offset from a
    window's corner in the patch (rows of PITCH16) and whether the high
    half is kept (j = 9 is masked); None past the 30 taps."""
    if k >= 30:
        return None
    ky, j = divmod(k, 10)
    return ky * PITCH16 + j, j != 8


def bf16_forward_rows(x, ty0, tx0):
    """The bf16 forward's A rows for tile (ty0, tx0) of image 0, as the
    kernel loads them: (16, 16, 4, 32) for the tile's pooled outputs (ly,
    lx), window positions s, k, from 4-byte words of the patch (pairs of
    values at even offsets): one word at positions 1 and 3, the high half
    of one and the low half of the next at 0 and 2."""
    assert 6 * tx0 % 8 == 0
    patch = _tma_box(x, 0, 2 * ty0 - 1, 6 * tx0 - 8).ravel()
    words = patch.reshape(-1, 2)  # the aligned 4-byte words
    rows = np.zeros((16, 16, 4, K16), x.dtype)
    for ly in range(16):
        for lx in range(16):
            corner = 2 * ly * PITCH16 + 6 * lx + LEAD16
            for s in range(4):
                base = corner + (s >> 1) * PITCH16 + 3 * (s & 1)
                for k in range(0, K16, 2):
                    pair = _pair_offset(k)
                    if pair is None:
                        continue
                    at = base + pair[0]
                    assert at % 2 == (0 if s & 1 else 1)
                    lo, hi = ((words[at // 2, 0], words[at // 2, 1]) if at % 2 == 0 else
                              (words[at // 2, 1], words[at // 2 + 1, 0]))  # the funnel shift
                    rows[ly, lx, s, k] = lo
                    rows[ly, lx, s, k + 1] = hi if pair[1] else 0
    return rows


def _forward_weights(k):
    """The (32, F) weight matrix in the forward's k order, from HWIO k."""
    wm = np.zeros((K16, k.shape[-1]), np.float32)
    for kk in range(30):
        ky, j = divmod(kk, 10)
        if j < 9:
            wm[kk] = k[ky, j // 3, j % 3]
    return wm


def _bf16_ties_inputs(n, hw, f, seed):
    """Phase 33's "ties" image in bf16 values: constant 2 x 2 cells, the
    centre tap only, so that every pooling window ties exactly."""
    rng = np.random.default_rng(seed)
    cells = rng.standard_normal((n, hw // 2, hw // 2, 3)).astype(np.float32)
    x = np.repeat(np.repeat(cells, 2, axis=1), 2, axis=2)
    k = np.zeros((3, 3, 3, f), np.float32)
    k[1, 1] = rng.standard_normal((3, f)).astype(np.float32)
    b = (rng.standard_normal(f) * 0.1).astype(np.float32)
    return tuple(_bf16_values(a) for a in (x, k, b))


def bf16_kernel_stem(x, k, b):
    """The bf16 forward kernel's output for image 0 of x (H, W multiples of
    32): the A rows of every tile times the weights in k order, one f32 sum
    of exact products a k-step of 16, each window sum rounded to bf16, the
    first maximum, + bias in f32 rounded to bf16, the ReLU. Returns y
    (Ho, Wo, F) and the index (4: masked)."""
    _, h, w, _ = x.shape
    wm = _forward_weights(k).astype(np.float64)
    f = k.shape[-1]
    sums = np.zeros((h // 2, w // 2, 4, f), np.float32)
    for ty in range(h // 32):
        for tx in range(w // 32):
            a = bf16_forward_rows(x, 16 * ty, 16 * tx).astype(np.float64)
            acc = np.zeros((16, 16, 4, f), np.float32)
            for j in range(K16 // 16):
                ks = slice(16 * j, 16 * j + 16)
                acc = (acc + a[..., ks] @ wm[ks]).astype(np.float32)
            sums[16 * ty:16 * ty + 16, 16 * tx:16 * tx + 16] = acc
    rounded = _bf16_values(sums)
    best, pos = rounded.max(axis=2), np.argmax(rounded, axis=2)  # the first maximum
    out = _bf16_values(best + b)
    return np.where(out > 0, out, 0), np.where(out > 0, pos, 4).astype(np.uint8)


@pytest.mark.parametrize("kind", ["rand", "ties"])
def test_bf16_forward_rows_read_the_window_in_k_order(kind):
    """The forward's A rows from the TMA box (a 112-value pitch from an
    aligned start, the row at value 5): each row holds its window's 27
    values at the k order's slots and 0 at the masked ones, the SAME halo
    from TMA's zero fill; on
    the tied image the four positions' rows are identical wherever their
    windows are equal, so their products tie bit for bit."""
    if kind == "ties":
        x, _, _ = _bf16_ties_inputs(1, 64, 8, seed=41)
    else:
        x, _, _ = (_bf16_values(a) for a in _inputs(1, 64, 8, seed=41))
    win = _windows(x)  # (1, 32, 32, 4, 4, 3): the zero-padded SAME windows
    for ty0, tx0 in ((0, 0), (16, 16), (0, 16)):  # the image's corners and edges
        rows = bf16_forward_rows(x, ty0, tx0)
        for s in range(4):
            dy, dx = divmod(s, 2)
            want = np.zeros((16, 16, K16), np.float32)
            for kk in range(30):
                ky, j = divmod(kk, 10)
                if j < 9:
                    want[..., kk] = win[0, ty0:ty0 + 16, tx0:tx0 + 16, dy + ky, dx + j // 3, j % 3]
            assert np.array_equal(rows[:, :, s], want)
        if kind == "ties":
            # constant 2 x 2 cells: the four windows of an output share the
            # weighed taps (ky, kx) = (1, 1), k 13-15, so those slots of the
            # four rows are equal, value for value
            centre = [10 + 3 + c for c in range(3)]
            for s in range(1, 4):
                assert np.array_equal(rows[:, :, s, centre], rows[:, :, 0, centre])


def test_bf16_forward_emulation_matches_the_plain_version():
    """The bf16 forward's emulated arithmetic against the port's plain bf16
    version (each window sum rounded to bf16, the first maximum, + bias,
    ReLU): y within one bf16 ulp of max|ref|; on the tied image the index
    equal to the plain version's first maximum everywhere (identical rows
    give identical sums, so the first of the tied windows wins)."""
    for kind in ("rand", "ties"):
        if kind == "ties":
            x, k, b = _bf16_ties_inputs(1, 64, 16, seed=43)
        else:
            x, k, b = (_bf16_values(a) for a in _inputs(1, 64, 16, seed=43))
        y, index = bf16_kernel_stem(x, k, b)
        xt, wt, bt = (t.to(torch.bfloat16) for t in _port(x, k, b))
        plain = stem.vgg_stem_plain(xt, wt, bt).float().permute(0, 2, 3, 1).numpy()[0]
        _within_ulps(y, plain, 1, f"bf16 forward emulation, {kind}")
        if kind == "ties":
            conv = torch.nn.functional.conv2d(xt.float(), wt.float(), padding=1)
            _, where = torch.nn.functional.max_pool2d(conv.to(torch.bfloat16).float(), 2,
                                                      return_indices=True)
            w_out = conv.shape[-1]
            pos = ((where // w_out) % 2 * 2 + where % w_out % 2)[0].permute(1, 2, 0).numpy()
            want = np.where(plain > 0, pos, 4)
            assert np.array_equal(index, want)
            assert set(np.unique(index)) <= {0, 4}


def tensor_core_wgrad(x, index, g):
    """The bf16 weight gradient's first pass in numpy: for each window
    position s, the gradient where the index is s (F x outputs) times the
    outputs' position-s windows with a ones column, (outputs x 32: the 27
    taps in (ky, kx, c) order, 1, zeros); the four products add into one
    set of f32 sums, 16 outputs (one mma k-step) at a time. Returns dW
    (F, 3, 3, 3) torch layout and db (F,), in f32 before the bf16 store."""
    win = _windows(x)                                         # (N, Ho, Wo, 4, 4, 3)
    f = g.shape[-1]
    g2 = g.reshape(-1, f).astype(np.float64)
    idx = index.reshape(-1, f)
    acc = np.zeros((f, K16), np.float32)
    for s in range(4):
        dy, dx = divmod(s, 2)
        bmat = np.zeros((g2.shape[0], K16))
        bmat[:, :TAPS] = win[:, :, :, dy:dy + 3, dx:dx + 3, :].reshape(-1, TAPS)
        bmat[:, TAPS] = 1.0
        a_s = np.where(idx == s, g2, 0.0).T                   # (F, outputs)
        for p0 in range(0, a_s.shape[1], 16):
            acc = (acc + a_s[:, p0:p0 + 16] @ bmat[p0:p0 + 16]).astype(np.float32)
    dw = acc[:, :TAPS].reshape(f, 3, 3, 3).transpose(0, 3, 1, 2)  # (ky, kx, c) -> torch
    return dw, acc[:, TAPS]


@pytest.mark.parametrize("hw,f", [(16, 8), (32, 64)])
def test_tensor_core_weight_gradient_matches_the_plain_version_and_jax(hw, f):
    """The bf16 weight gradient's decomposition (four position-masked
    products, the ones column as db), routed by the plain bf16 forward's
    index, rounded to bf16 as the store rounds it: against the plain bf16
    version's autograd within one bf16 ulp of max|ref|, and against
    jax.grad through JAX's bf16 student block (_ConvPool2x2 in bfloat16,
    then ReLU) by the rule test_stem_bf16_matches_jax holds the port to:
    one ulp of the f64 sum, and the error at most twice JAX's plus 2^-10
    of max|ref|."""
    x, k, b = (_bf16_values(a) for a in _inputs(2, hw, f, seed=500 + hw + f))
    cot = _bf16_values(np.random.default_rng(hw * f + 5).standard_normal(
        (2, hw // 2, hw // 2, f)))
    xt, wt, bt = (t.to(torch.bfloat16) for t in _port(x, k, b))
    wt, bt = wt.requires_grad_(), bt.requires_grad_()
    y = stem.vgg_stem_plain(xt, wt, bt)
    conv = torch.nn.functional.conv2d(xt.float(), wt.detach().float(), padding=1)
    _, where = torch.nn.functional.max_pool2d(conv.to(torch.bfloat16).float(), 2,
                                              return_indices=True)
    w_out = conv.shape[-1]
    pos = ((where // w_out) % 2 * 2 + where % w_out % 2).permute(0, 2, 3, 1).numpy()
    on = (y.detach() > 0).permute(0, 2, 3, 1).numpy()
    index = np.where(on, pos, 4).astype(np.uint8)
    assert (index == 4).any() and (index < 4).any()
    dw, db = tensor_core_wgrad(x, index, cot)
    dw, db = _bf16_values(dw), _bf16_values(db)
    g_t = torch.from_numpy(cot).permute(0, 3, 1, 2).to(torch.bfloat16)
    plain_dw, plain_db = torch.autograd.grad(y, (wt, bt), g_t)
    _within_ulps(dw, plain_dw.float().numpy(), 1, f"tensor-core dW vs plain {hw} {f}")
    _within_ulps(db, plain_db.float().numpy(), 1, f"tensor-core db vs plain {hw} {f}")
    block = _ConvPool2x2(features=f, dtype=jnp.bfloat16)
    params = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
    jg = jax.grad(lambda p: jnp.sum(jax.nn.relu(block.apply({"params": p}, jnp.asarray(x)))
                                    .astype(jnp.float32) * cot))(params)
    g_conv = torch.zeros_like(conv).flatten(2).scatter_(
        2, where.flatten(2), (g_t.float() * torch.from_numpy(on).permute(0, 3, 1, 2))
        .double().float().flatten(2)).view_as(conv)
    exact_dw = torch.nn.grad.conv2d_weight(xt.double(), tuple(wt.shape), g_conv.double(),
                                           padding=1).numpy()
    exact_db = (cot * on).sum((0, 1, 2))
    for name, got, jax_g, exact in (
            ("dW", dw, np.asarray(jg["kernel"]).transpose(3, 2, 0, 1), exact_dw),
            ("db", db, np.asarray(jg["bias"]), exact_db)):
        _within_ulps(got, exact, 1, f"tensor-core {name} vs f64 {hw} {f}")
        err, jax_err = np.abs(got - exact).max(), np.abs(jax_g - exact).max()
        assert err <= 2 * jax_err + 2.0**-10 * np.abs(exact).max()


def test_chip_smoke_takes_another_stem_source(tmp_path):
    """chip_smoke.py --source vgg_stem=FILE (an earlier commit's
    csrc/vgg_stem.cu, timed in turns in phases 22, 33 and 37) parses."""
    import chip_smoke

    other = tmp_path / "vgg_stem_other.cu"
    other.write_text("// another version\n")
    assert chip_smoke.parse_source(f"vgg_stem={other}") == ("vgg_stem", str(other))
    with pytest.raises(Exception):
        chip_smoke.parse_source("vgg_stem=" + str(tmp_path / "missing.cu"))
