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
from tests.test_torch_vgg_stem import _split
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)

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


# --- the CUDA kernels' arithmetic, emulated -----------------------------------

def _row_dots(a, b):
    """Each row's dot product as csrc/info_nce.cu takes it: four threads a
    row, thread p over columns p, p + 4, ... in f32 FMA, the four partial
    sums added as (0 + 1) + (2 + 3)."""
    parts = []
    for p in range(4):
        acc = np.zeros(a.shape[0], np.float32)
        for k in range(p, a.shape[1], 4):
            acc = (a[:, k].astype(np.float64) * b[:, k] + acc).astype(np.float32)
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _normalized(x):
    """The kernel's normalised rows and norms: x times 1 / max(|x|, 1e-12)."""
    nrm = np.maximum(np.sqrt(_row_dots(x, x)), np.float32(1e-12)).astype(np.float32)
    return x * (np.float32(1.0) / nrm)[:, None], nrm


def _split_product(a, b, products=3):
    """a (M, K) . b (K, N) as the kernel's mma.m16n8k8 k-steps: each k-step's
    small.big, big.small, big.big (products=3; big.big alone with 1) into a
    fresh f32 accumulator, each mma an exact 8-term sum rounded to f32, then
    added to the running f32 sum."""
    k_pad = -a.shape[1] % 8
    a = np.pad(a, ((0, 0), (0, k_pad)))
    b = np.pad(b, ((0, k_pad), (0, 0)))
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    terms = [(a_small, b_big), (a_big, b_small), (a_big, b_big)][3 - products:]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for j in range(0, a.shape[1], 8):
        ks = slice(j, j + 8)
        part = np.zeros_like(acc)
        for ta, tb in terms:
            part = (part + ta[:, ks].astype(np.float64) @ tb[ks].astype(np.float64)
                    ).astype(np.float32)
        acc = acc + part
    return acc


def emulated_info_nce(s, t, tau, vrow=None, vcol=None, off=0, divide=True, splits=3,
                      products=3):
    """The loss, ds and dt of csrc/info_nce.cu in numpy (f32): the rows
    normalised as above; z in split TF32; the forward's per-row (m, se, pos)
    over `splits` column ranges of whole 8-column n-tiles, each walked in
    32-column tiles by the online rule, merged in split order; the loss
    summed in row order; dz; ds_n = dz t_n over 32-column tiles and dt_n =
    dz^T s_n over 16-row tiles, four and two k-steps a tile, in split TF32;
    the pullback through the normalisation."""
    nr, nc = s.shape[0], t.shape[0]
    tau = np.float32(tau)
    sn, s_nrm = _normalized(s)
    tn, t_nrm = _normalized(t)
    cols = np.arange(nc)
    z = np.where(np.ones(nc, bool) if vcol is None else vcol,
                 _split_product(sn, tn.T, products) / tau, np.float32(NEG32))
    per = -(-(-(-nc // 8)) // splits)  # n-tiles a split
    ms, ses, poss = [], [], []
    for lo in range(0, nc, 8 * per):
        m = np.full(nr, -np.inf, np.float32)
        se = np.zeros(nr, np.float32)
        pos = np.zeros(nr, np.float32)
        for c0 in range(lo, min(lo + 8 * per, nc), 32):
            zt = z[:, c0:min(c0 + 32, lo + 8 * per, nc)]
            m_new = np.maximum(m, zt.max(axis=1))
            e = np.exp(zt - m_new[:, None]).sum(axis=1, dtype=np.float32)
            se = se * np.exp(m - m_new) + e
            m = m_new
            hit = (np.arange(nr) + off >= c0) & (np.arange(nr) + off < c0 + zt.shape[1])
            pos = pos + np.where(hit, zt[np.arange(nr), np.clip(np.arange(nr) + off - c0, 0,
                                                               zt.shape[1] - 1)], 0)
        ms.append(m), ses.append(se), poss.append(pos)
    m = np.full(nr, -np.inf, np.float32)
    se = np.zeros(nr, np.float32)
    pos = np.zeros(nr, np.float32)
    for mk, sek, posk in zip(ms, ses, poss):  # in split order
        m_new = np.maximum(m, mk)
        se = se * np.exp(m - m_new) + sek * np.exp(mk - m_new)
        m, pos = m_new, pos + posk
    denom = np.exp(pos - m) + se
    row_ok = np.ones(nr, bool) if vrow is None else vrow
    row_loss = np.where(row_ok, -(pos - m) + np.log(denom), 0).astype(np.float32)
    count = np.float32(row_ok.sum())
    loss = np.float32(0)
    for x in row_loss:
        loss = np.float32(loss + x)
    g_eff = np.float32(1.0) / max(count, np.float32(1.0)) if divide else np.float32(1.0)
    if divide:
        loss = loss / max(count, np.float32(1.0))
    q_pos = np.exp(pos - m) / denom
    dz = np.exp(z - m[:, None]) / denom[:, None] * g_eff
    dz = dz + np.where(cols[None, :] == np.arange(nr)[:, None] + off,
                       (q_pos - 1)[:, None] * g_eff, 0)
    dz = np.where(row_ok[:, None], dz, 0).astype(np.float32)

    def tiled(a, b, step):  # sum over k in tiles of `step`, each tile's k-steps fresh
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k0 in range(0, a.shape[1], step):
            acc = acc + _split_product(a[:, k0:k0 + step], b[k0:k0 + step], products)
        return acc

    def pullback(acc, xn, nrm):
        g_n = acc / tau
        dot = _row_dots(g_n, xn)
        return (g_n - dot[:, None] * xn) / nrm[:, None]

    ds = pullback(tiled(dz, tn, 32), sn, s_nrm)
    dt = pullback(tiled(dz.T.copy(), sn, 16), tn, t_nrm)
    return float(loss), ds, dt


NEG32 = -1e30


def _dropped_keys(seed, t):
    """30 % of the entries zeroed, the rest scaled by 1 / 0.7 (route_info_nce)."""
    keep = np.random.default_rng(seed).random(t.shape) < 0.7
    return np.where(keep, t / np.float32(0.7), 0).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 46, 160])
@pytest.mark.parametrize("tau", [0.1, 0.5])
def test_emulated_kernel_matches_jax_fused(n, tau):
    """The kernel's arithmetic against JAX's fused kernel in interpret mode,
    at D 200 and the port's tolerances."""
    s, t = _pair(n + 200, n, 200)
    want = _jax(lambda a, b: jnce_fused.fused_info_nce(a, b, tau, True), s, t)
    _assert_close(emulated_info_nce(s, t, tau), want)


@pytest.mark.parametrize("kind", ["masked", "identical", "dropout"])
def test_emulated_kernel_matches_jax_blocked(kind):
    """Masked rows and columns, identical rows, and keys under dropout
    (stage 1's tau 0.5), against JAX's blocked kernel in interpret mode."""
    n, tau = (46, 0.5) if kind == "dropout" else (48, 0.1)
    s, t = _pair(n, n, 200, identical=kind == "identical")
    if kind == "dropout":
        t = _dropped_keys(n, t)
    valid = np.arange(n) < (41 if kind == "masked" else n)
    want = _jax(lambda a, b: jnce_blocked.blocked_info_nce(a, b, tau, 16, True,
                                                           valid=jnp.asarray(valid)), s, t)
    got = emulated_info_nce(s, t, tau, valid, valid, splits=2)
    _assert_close(got, want)


def test_emulated_kernel_matches_jax_partial():
    """A shard's rows against all the keys with a row offset and separate
    row and column masks."""
    rows, nc, off = 12, 40, 3
    s, t = _pair(7, rows, 200, nc)
    vrow, vcol = np.arange(rows) < 10, np.arange(nc) < 37
    want = _jax(lambda a, b: jnce_blocked.blocked_info_nce_partial(
        a, b, jnp.asarray(vrow), jnp.asarray(vcol), off, tau=TAU, block=16, interpret=True),
        s, t)
    _assert_close(emulated_info_nce(s, t, TAU, vrow, vcol, off, divide=False, splits=4), want)


def test_one_tf32_product_misses_the_gradient_tolerance():
    """Why the split: with one TF32 product per f32 product (big.big) the
    same arithmetic misses the gradients' 1e-4 of max|ref| at the teacher
    step's shape (about 5e-4), where the split keeps them near 1e-6. The
    loss alone would pass: it stays within 1e-5 (about 2e-6) either way."""
    s, t = _pair(160 + 200, 160, 200)
    want = _jax(lambda a, b: jnce_fused.fused_info_nce(a, b, TAU, True), s, t)
    for products, misses in ((1, True), (3, False)):
        loss, *grads = emulated_info_nce(s, t, TAU, products=products)
        assert loss == pytest.approx(want[0], rel=LOSS_RTOL)
        worst = max(np.abs(g - w).max() / np.abs(w).max() for g, w in zip(grads, want[1:]))
        assert (worst > GRAD_TOL) == misses, (products, worst)
