"""The port's infoNCE-KD (`pose3d_tpu_torch.ops.nce`, the plain version the
CPU takes, and the router of `train/steps.py`) against the JAX package's
Pallas kernels run in interpret mode, on the CPU.

Tolerances: the loss within 1e-5 relative, each gradient within 1e-4 of
its max|ref| (f32; the Pallas kernels sum in block order, the plain
version in one matmul).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu import losses as jlosses
from pose3d_tpu.ops import nce_blocked as jnce_blocked
from pose3d_tpu.ops import nce_fused as jnce_fused
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.ops import nce
from pose3d_tpu_torch.train import steps

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
TAU = 0.1


def _pair(seed, n, d, nc=None, identical=False):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, d)).astype(np.float32)
    t = rng.standard_normal((nc or n, d)).astype(np.float32)
    if identical:  # every row the same: all logits tie
        s[:] = s[0]
        t[:] = t[0]
    return s, t


def _port(fn, s, t):
    st, tt = (torch.from_numpy(x).requires_grad_() for x in (s, t))
    loss = fn(st, tt)
    loss.backward()
    return float(loss.detach()), st.grad.numpy(), tt.grad.numpy()


def _jax(fn, s, t):
    loss, (ds, dt) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    return float(loss), np.asarray(ds), np.asarray(dt)


def _assert_close(got, want):
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
    for g, w in zip(got[1:], want[1:]):
        # N = 1 has a zero gradient: an absolute floor for its rounding
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-4)


@pytest.mark.parametrize("n,d,identical", [(1, 64, False), (7, 200, False), (46, 200, False),
                                           (160, 200, False), (33, 64, True)])
def test_fused_matches_jax_interpret(n, d, identical):
    s, t = _pair(n + d, n, d, identical=identical)
    want = _jax(lambda a, b: jnce_fused.fused_info_nce(a, b, TAU, True), s, t)
    _assert_close(_port(lambda a, b: nce.fused_info_nce(a, b, TAU), s, t), want)


@pytest.mark.parametrize("n,d,n_valid", [(48, 64, 41), (50, 200, 50), (26, 64, 20),
                                         (7, 64, 7), (1, 64, 1), (33, 64, 1)])
def test_blocked_matches_jax_interpret(n, d, n_valid):
    """Block 16: N not a multiple of it, the padded tail masked; `valid`
    keeps rows out of the mean and out of every row's keys."""
    s, t = _pair(n * d + n_valid, n, d)
    valid = np.arange(n) < n_valid
    want = _jax(lambda a, b: jnce_blocked.blocked_info_nce(a, b, TAU, 16, True,
                                                           valid=jnp.asarray(valid)), s, t)
    got = _port(lambda a, b: nce.blocked_info_nce(a, b, TAU, valid=torch.from_numpy(valid)),
                s, t)
    _assert_close(got, want)
    assert np.all(got[1][n_valid:] == 0.0)  # invalid rows get no gradient


@pytest.mark.parametrize("rows,nc,row_offset,n_valid_rows,n_valid_cols", [
    (8, 24, 0, 8, 24), (16, 24, 8, 14, 24), (5, 40, 30, 5, 37), (12, 30, 3, 10, 20)])
def test_partial_matches_jax_interpret(rows, nc, row_offset, n_valid_rows, n_valid_cols):
    """The rectangular core: local rows against all columns, the positive of
    local row r at column row_offset + r, separate row and column masks
    (each valid row's own column valid)."""
    s, t = _pair(rows + nc + row_offset, rows, 32, nc)
    vrow = np.arange(rows) < n_valid_rows
    vcol = np.arange(nc) < n_valid_cols
    want = _jax(lambda a, b: jnce_blocked.blocked_info_nce_partial(
        a, b, jnp.asarray(vrow), jnp.asarray(vcol), row_offset, tau=TAU, block=16,
        interpret=True), s, t)
    got = _port(lambda a, b: nce.blocked_info_nce_partial(
        a, b, torch.from_numpy(vrow), torch.from_numpy(vcol), row_offset, TAU), s, t)
    _assert_close(got, want)


def test_partials_sum_to_the_whole():
    s, t = _pair(5, 24, 32)
    st, tt = torch.from_numpy(s), torch.from_numpy(t)
    ones = torch.ones(24, dtype=torch.bool)
    whole = float(nce.fused_info_nce(st, tt, TAU)) * 24
    parts = sum(float(nce.blocked_info_nce_partial(st[a:b], tt, ones[a:b], ones, a, TAU))
                for a, b in ((0, 8), (8, 24)))
    assert parts == pytest.approx(whole, rel=LOSS_RTOL)


def test_plain_matches_the_xla_loss():
    """The plain version against JAX's losses.info_nce_kd (no dropout)."""
    s, t = _pair(9, 30, 200)
    valid = np.arange(30) < 27
    want = _jax(lambda a, b: jlosses.info_nce_kd(a, b, TAU, dropout_rng=None,
                                                 valid=jnp.asarray(valid)), s, t)
    got = _port(lambda a, b: nce.blocked_info_nce(a, b, TAU, valid=torch.from_numpy(valid)),
                s, t)
    _assert_close(got, want)


ROUTES = [  # (use_fused, n, masked) -> the function both routers call
    (False, 8, False, "xla"), (False, 8, True, "xla"), (False, 1030, False, "xla"),
    (True, 8, False, "fused"), (True, 1024, False, "fused"), (True, 8, True, "xla"),
    (True, 1025, False, "blocked"), (True, 1030, True, "blocked")]


@pytest.mark.parametrize("use_fused,n,masked,route", ROUTES)
def test_route_info_nce_table_is_jaxs(monkeypatch, use_fused, n, masked, route):
    """Each case reaches the same entry in JAX and in the port."""
    calls = []

    def record(name):
        return lambda *a, **k: calls.append(name) or 0.0

    monkeypatch.setattr(jsteps, "info_nce_kd", record("jax:xla"))
    monkeypatch.setattr(jnce_fused, "fused_info_nce", record("jax:fused"))
    monkeypatch.setattr(jnce_blocked, "blocked_info_nce", record("jax:blocked"))
    monkeypatch.setattr(steps, "info_nce_kd", record("port:xla"))
    monkeypatch.setattr(nce, "fused_info_nce", record("port:fused"))
    monkeypatch.setattr(nce, "blocked_info_nce", record("port:blocked"))
    s, t = _pair(n, n, 8)
    valid = np.arange(n) < n - 1 if masked else None
    jsteps.route_info_nce(jnp.asarray(s), jnp.asarray(t), TAU, None, 0.0,
                          None if valid is None else jnp.asarray(valid), use_fused)
    steps.route_info_nce(torch.from_numpy(s), torch.from_numpy(t), TAU, None, 0.0,
                         None if valid is None else torch.from_numpy(valid), use_fused)
    assert calls == [f"jax:{route}", f"port:{route}"]


@pytest.mark.parametrize("use_fused,masked", [(False, False), (True, False), (True, True)])
def test_route_values_match_jax_without_dropout(use_fused, masked):
    s, t = _pair(3, 40, 200)
    valid = np.arange(40) < 33 if masked else None
    want = _jax(lambda a, b: jsteps.route_info_nce(
        a, b, TAU, None, 0.0, None if valid is None else jnp.asarray(valid), use_fused), s, t)
    got = _port(lambda a, b: steps.route_info_nce(
        a, b, TAU, None, 0.3, None if valid is None else torch.from_numpy(valid),
        use_fused), s, t)
    _assert_close(got, want)


def test_route_applies_dropout_outside_the_kernel(rng):
    """With a keep-mask, the fused route is the kernel's loss on the
    dropped-out, rescaled keys, and equals the non-fused loss."""
    s, t = (torch.from_numpy(x) for x in _pair(4, 16, 200))
    keep = torch.from_numpy(rng.random((16, 200)) < 0.7)
    fused = steps.route_info_nce(s, t, TAU, keep, 0.3, None, True)
    dropped = torch.where(keep, t / 0.7, torch.zeros_like(t))
    assert float(fused) == pytest.approx(float(nce.fused_info_nce(s, dropped, TAU)),
                                         rel=1e-6)
    assert float(fused) == pytest.approx(
        float(steps.route_info_nce(s, t, TAU, keep, 0.3, None, False)), rel=LOSS_RTOL)


@pytest.mark.parametrize("change,exc", [
    (lambda s, t: (s.half(), t.half()), TypeError),
    (lambda s, t: (s.double(), t.double()), TypeError),
    (lambda s, t: (s, t.double()), TypeError),
    (lambda s, t: (s, t[:, :8]), ValueError),
    (lambda s, t: (s[0], t), ValueError),
    (lambda s, t: (s[:0], t), ValueError),
])
def test_wrappers_reject_bad_inputs(change, exc):
    s, t = change(torch.zeros((4, 16)), torch.zeros((4, 16)))
    with pytest.raises(exc):
        nce.fused_info_nce(s, t)


def test_wrappers_reject_devices_without_a_kernel_and_bad_masks():
    s = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        nce.fused_info_nce(s, s)
    with pytest.raises(ValueError, match="different devices"):
        nce.fused_info_nce(s, torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="mask"):
        nce.blocked_info_nce(s, s, valid=torch.ones(3, dtype=torch.bool, device="meta"))


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    s, t = (torch.from_numpy(x).requires_grad_() for x in _pair(1, 12, 64))
    before = nce.nce_forward.launches, nce.nce_backward.launches
    loss = nce.fused_info_nce(s, t)
    loss.backward()
    assert (nce.nce_forward.launches, nce.nce_backward.launches) == before
    with torch.no_grad():
        plain = float(nce.info_nce_plain(s, t)) / 12
    assert float(loss.detach()) == pytest.approx(plain, rel=1e-7)
