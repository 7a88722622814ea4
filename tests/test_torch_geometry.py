"""The port's geometry, decoders and loss against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. The port runs its
plain versions (CPU tensors); the JAX side runs as its own tests run it,
the Pallas kernel in interpret mode.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu import geometry as jgeometry
from pose3d_tpu.losses.binned import pose_loss_per_sample as jpose_loss_per_sample
from pose3d_tpu.ops.geodesic import rotation_err_pallas
from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses.binned import pose_loss_per_sample
from pose3d_tpu_torch.ops import geodesic
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# degrees; the atol covers arccos's ill-conditioning near 0 (as tests/test_ops.py)
RTOL, ATOL = 1e-4, 0.05


def _triples(rng, n=300):
    preds = rng.integers(0, 360, (n, 3)).astype(np.float32)
    labels = rng.integers(0, 360, (n, 3)).astype(np.float32)
    preds = np.concatenate([preds, [p for p, _ in chip_smoke.EDGE_ROWS]]).astype(np.float32)
    labels = np.concatenate([labels, [g for _, g in chip_smoke.EDGE_ROWS]]).astype(np.float32)
    return preds, labels


@pytest.mark.parametrize("reference", ["geometry", "pallas_interpret"])
def test_rotation_err_matches_jax(rng, reference):
    preds, labels = _triples(rng)
    if reference == "geometry":
        ref = jgeometry.rotation_err(jnp.asarray(preds), jnp.asarray(labels))
    else:
        ref = rotation_err_pallas(jnp.asarray(preds), jnp.asarray(labels), interpret=True)
    out = geodesic.rotation_err(torch.from_numpy(preds), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # the edge rows: identical triples (0 deg) and half turns (180 deg)
    edge = out.numpy()[-len(chip_smoke.EDGE_ROWS):]
    np.testing.assert_allclose(edge, [0, 0, 0, 180, 180], atol=ATOL)


def test_rotation_acc_and_angle_err_match_jax(rng):
    preds, labels = _triples(rng)
    valid = rng.random(len(preds)) < 0.7
    for v in (None, valid):
        ref = jgeometry.rotation_acc(jnp.asarray(preds), jnp.asarray(labels),
                                     valid=None if v is None else jnp.asarray(v))
        out = geometry.rotation_acc(torch.from_numpy(preds), torch.from_numpy(labels),
                                    valid=None if v is None else torch.from_numpy(v))
        assert float(out) == pytest.approx(float(ref), abs=1e-4)
    np.testing.assert_allclose(
        geometry.angle_err(torch.from_numpy(preds), torch.from_numpy(labels)).numpy(),
        np.asarray(jgeometry.angle_err(jnp.asarray(preds), jnp.asarray(labels))),
        atol=1e-6)


def _heads(rng, n=16, classes=(24, 12, 24)):
    """Six head outputs; each logit row has one maximum well above the rest."""
    cls = []
    for c in classes:
        logits = rng.standard_normal((n, c)).astype(np.float32)
        logits[np.arange(n), rng.integers(0, c, n)] += 5.0
        cls.append(logits)
    reg = [rng.standard_normal((n, c)).astype(np.float32) for c in classes]
    return cls, reg


@pytest.mark.parametrize("decoder", ["decode_predictions",
                                     "decode_predictions_inference"])
def test_decoders_match_jax(rng, decoder):
    cls, reg = _heads(rng)
    ref = np.asarray(getattr(jgeometry, decoder)(
        tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg)), 15))
    out = getattr(geometry, decoder)(
        tuple(map(torch.from_numpy, cls)), tuple(map(torch.from_numpy, reg)), 15).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    bins = np.stack([c.argmax(-1) for c in cls], -1)
    if decoder == "decode_predictions":  # (bin + tanh/2 + 0.5) * 15 lies in its bin
        np.testing.assert_array_equal(np.floor(out / 15), bins)
    else:
        assert out.min() >= 0 and out.max() <= 360


def test_pose_loss_per_sample_matches_jax(rng):
    cls, reg = _heads(rng, n=32)
    labels = chip_smoke.random_labels(rng, 32)
    ref = jpose_loss_per_sample([jnp.asarray(o) for o in cls + reg], jnp.asarray(labels), 15)
    out = pose_loss_per_sample([torch.from_numpy(o) for o in cls + reg],
                               torch.from_numpy(labels), 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
