"""The port's train-mode PointNet (`ops/pointnet_train.py`) against the JAX
package, on the CPU: the plain version and its autograd path against JAX's
fused train-mode kernel (`pointnet_train_fused`, in interpret mode, as
tests/test_ops.py runs it) and JAX's XLA path (`dense_bn_forward`), a
masked batch against JAX's masked XLA path, exact ties, and the running
statistics of `ShapeEncoderPC` after one train forward against flax's.

Tolerances, JAX's own for its kernel (tests/test_ops.py): outputs within
1e-5 (rtol and atol); statistics rtol 1e-4, atol 1e-6; weight and BN
gradients within 1e-4 of the largest weight gradient; the dense biases'
gradients, zero in exact arithmetic (BatchNorm absorbs a shift), below 1e-2
of it on both sides. All in f32: the sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pose3d_tpu.ops.pointnet_train_fused as ptf
from pose3d_tpu.models.pointnet import ShapeEncoderPC as JaxShapeEncoderPC
from pose3d_tpu.models.pointnet import dense_bn_forward
from pose3d_tpu_torch.models.common import batch_stats
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.ops import pointnet, pointnet_train
from pose3d_tpu_torch.train import convert
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)

D = 256


def _params(rng, d=D):
    """JAX's layers: ({"kernel" (in, out), "bias"}, {"scale", "bias"}) x 3,
    He-scaled, as numpy."""
    params = []
    for fan_in, out in ((3, 64), (64, 128), (128, d)):
        params.append((
            {"kernel": (rng.standard_normal((fan_in, out))
                        * np.sqrt(2 / fan_in)).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(out)).astype(np.float32)},
            {"scale": (1 + 0.1 * rng.standard_normal(out)).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(out)).astype(np.float32)}))
    return params


def _port_layers(params):
    """The port's (weight (out, in), bias, gamma, beta) layers, needing a
    gradient."""
    return [[torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
             for a in (dense["kernel"].T, dense["bias"], bn["scale"], bn["bias"])]
            for dense, bn in params]


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, tuple(params))


def _xla(pts, params, mask=None):
    x, stats = pts, []
    for i, (dense_p, bn_p) in enumerate(params):
        x, st = dense_bn_forward(x, dense_p, bn_p, None, True, jnp.float32, mask=mask,
                                 relu=i < 2)
        stats.append(st)
    return jnp.max(x, axis=1), tuple(stats)


def _reference(kind, monkeypatch):
    if kind == "pallas_interpret":
        monkeypatch.setattr(ptf, "_INTERPRET", True)
        return lambda pts, p, mask=None: ptf.pointnet_train_fused(pts, p, jnp.float32)
    return _xla


def _port_grads(pts, layers, wvec, valid=None):
    out, stats = pointnet_train.pointnet_train(torch.from_numpy(pts), layers, valid)
    flat = [t for layer in layers for t in layer]
    return out, stats, torch.autograd.grad((out * torch.from_numpy(wvec)).sum(), flat)


def _check_grads(got, want_tree):
    """got: the port's 12 gradients; want_tree: JAX's gradient tree."""
    want = [g for dense, bn in want_tree
            for g in (dense["kernel"].T, dense["bias"], bn["scale"], bn["bias"])]
    scale = max(float(np.abs(want[4 * i]).max()) for i in range(3))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if i % 4 == 1:  # dense bias: noise around zero on both sides
            assert float(g.abs().max()) < 1e-2 * scale, i
            assert float(np.abs(w).max()) < 1e-2 * scale, i
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * scale, err_msg=str(i))


@pytest.mark.parametrize("kind", ["pallas_interpret", "xla"])
def test_plain_matches_jax(rng, monkeypatch, kind):
    """A ragged (5, 40) batch at D 256 (JAX's kernel pads it to its 8 x 640
    blocks): outputs, statistics and gradients."""
    params = _params(rng)
    pts = rng.random((5, 40, 3)).astype(np.float32)
    wvec = rng.standard_normal((5, D)).astype(np.float32)
    ref = _reference(kind, monkeypatch)
    want_out, want_stats = ref(jnp.asarray(pts), _jax(params))
    want_grads = jax.grad(lambda p: jnp.sum(ref(jnp.asarray(pts), p)[0] * wvec))(_jax(params))

    out, stats, grads = _port_grads(pts, _port_layers(params), wvec)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for (m, v), (wm, wv) in zip(stats, want_stats):
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(wm), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(wv), rtol=1e-4, atol=1e-6)
    _check_grads(grads, want_grads)


def test_masked_batch_matches_jax_masked_xla(rng):
    """Two padded clouds of 6: statistics over the valid clouds' points;
    every cloud, padded or not, gets its output and passes its gradient."""
    params = _params(rng)
    pts = rng.random((6, 50, 3)).astype(np.float32)
    valid = np.arange(6) < 4
    wvec = rng.standard_normal((6, D)).astype(np.float32)
    mask = jnp.asarray(valid)
    want_out, want_stats = _xla(jnp.asarray(pts), _jax(params), mask)
    want_grads = jax.grad(lambda p: jnp.sum(_xla(jnp.asarray(pts), p, mask)[0] * wvec))(
        _jax(params))

    out, stats, grads = _port_grads(pts, _port_layers(params), wvec, torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for (m, v), (wm, wv) in zip(stats, want_stats):
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(wm), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(wv), rtol=1e-4, atol=1e-6)
    _check_grads(grads, want_grads)
    # the padded clouds change nothing in the statistics
    _, unpadded = pointnet_train.pointnet_train(torch.from_numpy(pts[:4]),
                                                _port_layers(params))
    for (m, v), (um, uv) in zip(stats, unpadded):
        torch.testing.assert_close(m, um, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v, uv, rtol=1e-5, atol=1e-6)


def test_tied_points_route_the_gradient_once(rng, monkeypatch):
    """Every point of cloud 0 the same: each output ties over all 40 points.
    The gradient goes to the first of them alone, as JAX's kernel routes it
    (a gradient that reached every tied point would be 40 times larger)."""
    monkeypatch.setattr(ptf, "_INTERPRET", True)
    params = _params(rng)
    pts = rng.random((3, 40, 3)).astype(np.float32)
    pts[0] = pts[0, :1]
    wvec = rng.standard_normal((3, D)).astype(np.float32)
    want_grads = jax.grad(lambda p: jnp.sum(
        ptf.pointnet_train_fused(jnp.asarray(pts), p, jnp.float32)[0] * wvec))(_jax(params))
    out, _, grads = _port_grads(pts, _port_layers(params), wvec)
    _check_grads(grads, want_grads)
    _, _, index = pointnet_train.pointnet_train_plain(torch.from_numpy(pts),
                                                      _port_layers(params))
    assert int(index[0].max()) == 0  # the first maximum


@pytest.mark.parametrize("masked", [False, True])
def test_shape_encoder_running_statistics_match_flax(rng, masked):
    """One train forward of ShapeEncoderPC moves its running statistics as
    flax's batch_stats move (momentum 0.9 toward the biased variance)."""
    pts = rng.random((5, 30, 3)).astype(np.float32)
    valid = np.arange(5) < 3 if masked else None
    jmodel = JaxShapeEncoderPC(64)
    variables = jax.tree_util.tree_map(np.asarray, dict(
        jmodel.init(jax.random.key(0), jnp.asarray(pts), train=False)))
    for i, (dense, bn) in enumerate(_params(rng, 64)):
        variables["params"][f"Dense_{i}"] = dense
        variables["params"][f"BatchNorm_{i}"] = bn
        variables["batch_stats"][f"BatchNorm_{i}"] = {
            "mean": (0.1 * rng.standard_normal(dense["bias"].shape)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, dense["bias"].shape).astype(np.float32)}
    want, mut = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(pts),
                             train=True, mask=None if valid is None else jnp.asarray(valid),
                             mutable=["batch_stats"])
    state = {}
    for i in range(3):
        convert._conv1d(variables["params"][f"Dense_{i}"], state, f"conv{i + 1}")
        convert._bn(variables["params"][f"BatchNorm_{i}"],
                    variables["batch_stats"][f"BatchNorm_{i}"], state, f"bn{i + 1}")
    enc = ShapeEncoderPC(64)
    enc.load_state_dict(convert._to_tensors(state), strict=True)
    got = enc.train()(torch.from_numpy(pts), None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for i in range(3):
        bn, stats = getattr(enc, f"bn{i + 1}"), mut["batch_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-6)
        assert int(bn.num_batches_tracked) == 1


def test_plain_index_is_each_outputs_first_maximum(rng):
    """The index the plain version returns names, for each output, the
    first point where the layer-3 activation takes its maximum."""
    layers = _port_layers(_params(rng, 64))
    pts = torch.from_numpy(rng.random((2, 20, 3)).astype(np.float32))
    pts[1, 5:10] = pts[1, 3]  # points 3 and 5-9 of cloud 1 tie
    out, _, index = pointnet_train.pointnet_train_plain(pts, layers)
    x = pts
    for i, (w, b, gamma, beta) in enumerate(layers):
        a = torch.nn.functional.linear(x, w, b)
        mean, var = a.mean((0, 1)), a.var((0, 1), unbiased=False)
        x = (a - mean) * (torch.rsqrt(var + 1e-5) * gamma) + beta
        x = torch.relu(x) if i < 2 else x
    x = x.detach()
    torch.testing.assert_close(out.detach(), x.amax(1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x.gather(1, index[:, None, :])[:, 0], out.detach(), rtol=1e-5,
                               atol=1e-6)
    # identical points give identical values: the first of them is taken
    assert int((index[1] == 3).sum()) > 0 and int(((index[1] >= 5) & (index[1] < 10)).sum()) == 0


def test_pack_and_unpack_round_trip(rng):
    layers = [[t.detach() for t in layer] for layer in _port_layers(_params(rng, 128))]
    flat = pointnet_train.pack_params(layers)
    # per layer W, then b, gamma, beta
    assert flat.shape == (3 * 64 + 3 * 64 + 64 * 128 + 3 * 128 + 128 * 128 + 3 * 128,)
    back = pointnet_train.unpack_grads(flat, 128)
    assert all(torch.equal(a, b) for a, b in zip(back, [t for layer in layers for t in layer]))
    stats = torch.arange(2 * (64 + 128 + 128), dtype=torch.float32)
    split = pointnet_train.split_stats(stats, 128)
    assert [tuple(t.shape) for pair in split for t in pair] == [(64,), (64,), (128,), (128,),
                                                              (128,), (128,)]
    assert float(split[2][1][-1]) == float(stats[-1])


def test_cpu_takes_the_plain_version_and_launches_nothing(rng):
    layers = _port_layers(_params(rng, 64))
    pts = torch.from_numpy(rng.random((3, 20, 3)).astype(np.float32))
    before = (pointnet_train.train_forward.launches, pointnet_train.train_backward.launches,
              pointnet.pointnet_eval.launches)
    out, stats = pointnet_train.pointnet_train(pts, layers)
    out.sum().backward()
    assert before == (pointnet_train.train_forward.launches,
                      pointnet_train.train_backward.launches, pointnet.pointnet_eval.launches)
    want, want_stats, _ = pointnet_train.pointnet_train_plain(pts, layers)
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for pa, pb in zip(stats, want_stats) for a, b in zip(pa, pb))


@pytest.mark.parametrize("change,exc", [
    (lambda pts, layers, v: (pts.double(), layers, v), TypeError),
    (lambda pts, layers, v: (pts[..., :2], layers, v), ValueError),
    (lambda pts, layers, v: (pts[:, :0], layers, v), ValueError),
    (lambda pts, layers, v: (pts, layers[:2], v), ValueError),
    (lambda pts, layers, v: (pts, [layers[0], [layers[1][0][:, :32]] + layers[1][1:],
                                   layers[2]], v), ValueError),
    (lambda pts, layers, v: (pts, layers, v[:2]), ValueError),
    (lambda pts, layers, v: (pts, layers, v.float()), ValueError),
])
def test_rejects_bad_inputs(rng, change, exc):
    layers = [[t.detach() for t in layer] for layer in _port_layers(_params(rng, 64))]
    pts = torch.from_numpy(rng.random((3, 20, 3)).astype(np.float32))
    pts, layers, valid = change(pts, layers, torch.ones(3, dtype=torch.bool))
    with pytest.raises(exc):
        pointnet_train.pointnet_train(pts, layers, valid)


def test_rejects_devices_without_a_kernel(rng):
    layers = [[t.detach().to("meta") for t in layer] for layer in _port_layers(_params(rng, 64))]
    with pytest.raises(ValueError, match="no kernel"):
        pointnet_train.pointnet_train(torch.zeros((2, 10, 3), device="meta"), layers)
    with pytest.raises(ValueError, match="different devices"):
        pointnet_train.pointnet_train(torch.zeros((2, 10, 3)), layers)


# --- layer 3 from h2's Gram matrix (csrc/pointnet_train.cu's algebra) -------

def _gram_closed_forms(h2, w3, b3, gamma, beta, valid, index, g):
    """Layer 3's statistics and gradients from G = sum h2 h2^T, s = sum h2
    and m over the valid rows, and the argmax index: the kernels' formulas
    (csrc/pointnet_train.cu's header), in the inputs' dtype. w3 is
    (D, 128), out x in. Returns (mu3, var3, dW3 (D, 128), db3, dh2)."""
    rows = h2 if valid is None else h2[valid]
    flat = rows.reshape(-1, h2.shape[-1])
    gram, s, m = flat.T @ flat, flat.sum(0), flat.shape[0]
    w = w3.T                                        # (128, D), in x out
    hbar = s / m
    mu = hbar @ w + b3
    cov = gram / m - torch.outer(hbar, hbar)
    var = torch.einsum("kc,kl,lc->c", w, cov, w).clamp_min(0)
    r = torch.rsqrt(var + 1e-5)
    n = h2.shape[0]
    at = h2[torch.arange(n)[:, None], index]        # (N, D, 128): h2 at each argmax
    xhat = (torch.einsum("ndk,kd->nd", at, w) + b3 - mu) * r
    dbeta, dgamma = g.sum(0), (g * xhat).sum(0)
    u, v = gamma * r * dbeta / m, gamma * r * dgamma / m
    rv, shift = r * v, b3 - mu
    big_s = torch.einsum("nd,ndk->kd", gamma * r * g, at)
    dw3 = big_s - torch.outer(s, u) - (gram @ w + torch.outer(s, shift)) * rv
    db3 = gamma * r * dbeta - m * u - rv * (s @ w + m * shift)
    mat, k0 = (w * rv) @ w.T, w @ (u + rv * shift)
    dh2 = torch.zeros_like(h2)
    dh2.index_put_((torch.arange(n)[:, None].expand_as(index), index),
                   (gamma * r * g)[..., None] * w.T, accumulate=True)
    keep = torch.ones(n, dtype=h2.dtype) if valid is None else valid.to(h2.dtype)
    dh2 = dh2 - keep[:, None, None] * (k0 + h2 @ mat)
    return mu, var, dw3.T, db3, dh2


@pytest.mark.parametrize("d,case", [(64, "plain"), (256, "plain"), (64, "masked"),
                                    (256, "masked"), (256, "ties")])
def test_layer3_from_the_gram_matrix_matches_autograd(d, case):
    """In f64 on a ragged (5, 40) batch: mu3 and var3 from G, s and m, and
    dW3, db3 and dh2 from the closed forms with the argmax index, against
    the plain version's statistics and autograd (dh2 with h2 as a leaf),
    within 1e-10 of max|ref|."""
    rng = np.random.default_rng(d + len(case))
    pts = rng.random((5, 40, 3)) * rng.uniform(0.2, 1.0, (5, 1, 3))
    if case == "ties":
        pts[0] = pts[0, :1]
    layers = [[torch.from_numpy(np.ascontiguousarray(a).astype(np.float64)).requires_grad_()
               for a in (dense["kernel"].T, dense["bias"], bn["scale"], bn["bias"])]
              for dense, bn in _params(rng, d)]
    valid = torch.from_numpy(np.arange(5) < 3) if case == "masked" else None
    g = torch.from_numpy(rng.standard_normal((5, d)))
    pts = torch.from_numpy(pts)
    out, stats, index = pointnet_train.pointnet_train_plain(pts, layers, valid)
    want_w3, want_b3 = torch.autograd.grad(out, layers[2][:2], g)

    x = pts  # layers 1-2 as the plain version runs them, then h2 as a leaf
    for w, b, gamma, beta in layers[:2]:
        x = torch.nn.functional.linear(x, w, b)
        mean, var = batch_stats(x, (0, 1), valid)
        x = torch.relu((x - mean) * (torch.rsqrt(var + 1e-5) * gamma) + beta)
    h2 = x.detach().requires_grad_()
    w3, b3, gamma3, beta3 = layers[2]
    y = torch.nn.functional.linear(h2, w3, b3)
    mean, var = batch_stats(y, (0, 1), valid)
    y = (y - mean) * (torch.rsqrt(var + 1e-5) * gamma3) + beta3
    leaf_out = y.gather(1, index[:, None, :])[:, 0]
    assert torch.equal(leaf_out, out.detach())
    (want_dh2,) = torch.autograd.grad(leaf_out, h2, g)

    with torch.no_grad():
        got = _gram_closed_forms(h2, w3, b3, gamma3, beta3, valid, index, g)
    want = (*stats[2], want_w3, want_b3, want_dh2)
    scale = max(float(want_w3.abs().max()), 1e-30)
    for name, a, ref in zip(("mu3", "var3", "dW3", "db3", "dh2"), got, want):
        ref = ref.detach()
        # db3 is 0 in exact arithmetic: held against the weight gradient's scale
        tol = 1e-10 * (scale if name == "db3" else float(ref.abs().max()))
        assert float((a - ref).abs().max()) <= tol, name
