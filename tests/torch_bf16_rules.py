"""The bf16 rules of the port's CPU tests against JAX's dtype=bfloat16
(tests/test_torch_bf16.py's header states them): `one_ulp` for a module,
`oracle` for a whole model or step against JAX's float64 result."""

import jax.numpy as jnp
import numpy as np
import torch

BF16 = torch.bfloat16
ULP = 2.0**-7        # one bf16 ulp, relative to max|ref|
UNEQUAL_MAX = 0.01   # the share of elements allowed to differ by that ulp
ORACLE_FLOOR = 2.0**-10
AGREE = 0.5          # the port's RMS distance from JAX's bf16, over that result's RMS


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32), np.float64)


def one_ulp(got, want, name="", unequal_max=UNEQUAL_MAX):
    """Each element of `got` within 2^-7 max|want| of `want`, and under 1 %
    (`unequal_max`) of them unequal; `unequal_max` None for float32 values
    (sums in another order: most of them differ in their last bits)."""
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    err, unequal = np.abs(got - want).max() / scale, float(np.mean(got != want))
    print(f"{name}: max|d|/max|ref| {err:.3g} (one ulp {ULP:.3g}), unequal {unequal:.3g} "
          f"(under {unequal_max})")
    assert err <= ULP and (unequal_max is None or unequal < unequal_max), name


def oracle(got, jax_bf16, ref, name, scale=None, agree=True):
    """The port's bf16 error against the f64 `ref` at most twice JAX's bf16
    error plus 2^-10 of max|ref| (or of `scale`), as the largest and as the
    root-mean-square difference; and, with `agree`, the port's RMS distance
    from JAX's bf16 result at most AGREE of that result's RMS plus the same
    floor (without it for a value that is zero in exact arithmetic, where
    both results are rounding noise)."""
    got, jax_bf16, ref = _np(got), _np(jax_bf16), _np(ref)
    scale = np.abs(ref).max() if scale is None else scale
    floor = ORACLE_FLOOR * scale
    rms = lambda a: np.sqrt(np.mean(a**2))
    port_max, jax_max = np.abs(got - ref).max(), np.abs(jax_bf16 - ref).max()
    port_rms, jax_rms = rms(got - ref), rms(jax_bf16 - ref)
    apart, size = rms(got - jax_bf16), rms(jax_bf16)
    print(f"{name}: largest port {port_max:.3g}, JAX {jax_max:.3g} (ratio "
          f"{port_max / max(jax_max, 1e-300):.3g}); RMS port {port_rms:.3g}, JAX "
          f"{jax_rms:.3g} (ratio {port_rms / max(jax_rms, 1e-300):.3g}); apart "
          f"{apart / max(size, 1e-300):.3g} of JAX's RMS; max|ref| {scale:.3g}")
    assert port_max <= 2 * jax_max + floor, f"{name}: largest difference"
    assert port_rms <= 2 * jax_rms + floor, f"{name}: RMS difference"
    assert not agree or apart <= AGREE * size + floor, f"{name}: apart from JAX's bf16"


def pooled_oracle(entries, name, agree=True):
    """`oracle` with each statistic and floor summed over several steps:
    `entries` holds one (got, jax_bf16, ref, scale) a step (scale None:
    max|ref|). One small bf16 step's error against f64 is too noisy a
    yardstick for one tensor (the rule fails between two correct runs on
    some batches); summed over a few, the noise averages out, as
    chip_smoke.py's card-vs-CPU rule sums them."""
    rms = lambda a: np.sqrt(np.mean(a**2))
    sums = np.zeros(7)
    for got, jax_bf16, ref, scale in entries:
        got, jax_bf16, ref = _np(got), _np(jax_bf16), _np(ref)
        scale = np.abs(ref).max() if scale is None else scale
        sums += [np.abs(got - ref).max(), np.abs(jax_bf16 - ref).max(), rms(got - ref),
                 rms(jax_bf16 - ref), rms(got - jax_bf16), rms(jax_bf16), ORACLE_FLOOR * scale]
    port_max, jax_max, port_rms, jax_rms, apart, size, floor = sums
    print(f"{name} over {len(entries)} steps: largest port {port_max:.3g}, JAX {jax_max:.3g}; "
          f"RMS port {port_rms:.3g}, JAX {jax_rms:.3g}; apart {apart / max(size, 1e-300):.3g} "
          f"of JAX's RMS")
    assert port_max <= 2 * jax_max + floor, f"{name}: largest difference"
    assert port_rms <= 2 * jax_rms + floor, f"{name}: RMS difference"
    assert not agree or apart <= AGREE * size + floor, f"{name}: apart from JAX's bf16"
