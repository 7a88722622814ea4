"""One f64 geodesic error for the pose-weighted NCE's comparisons of the
port against JAX (tests/test_torch_stage1_variants.py and
tests/test_torch_supervised.py).

Both packages take the pairwise pose distance from their f32 geodesic
error, whose rounding at 0 degrees differs between them (0 against 0.028
degrees on the same label pair). The diagonal's distance weights the
positive itself among the negatives, so that noise moves a pose-weighted
loss by up to 1e-3. Inside `one_geodesic()` both sides take the distance
from one f64 geodesic in its well-conditioned form, rounded to f32.
"""

import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import torch

from pose3d_tpu import geometry as jgeometry
from pose3d_tpu.losses import nce as jnce
from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.losses import nce


def _geodesic64(mat, xp, dtype, preds, targets):
    """The geodesic error in f64 from label triples, rounded to f32, in its
    well-conditioned form 2 arcsin(|R_p - R_g|_F / 2 sqrt 2): exactly 0 for
    a pair of equal labels, where arccos((trace - 1) / 2) is not."""
    def to_matrix(labels):
        labels = labels.astype(dtype) if xp is jnp else labels.to(dtype)
        shifted = xp.stack([labels[..., 0], labels[..., 1] - 180.0, labels[..., 2] - 180.0],
                           -1)
        return mat(shifted * (math.pi / 180.0))

    dist = xp.sqrt(((to_matrix(preds) - to_matrix(targets)) ** 2).sum(-1))
    err = 2.0 * xp.arcsin(xp.clip(dist / (2.0 * math.sqrt(2.0)), 0.0, 1.0)) * (180.0 / math.pi)
    return err.astype(jnp.float32) if xp is jnp else err.to(torch.float32)


def _port_distances64(labels):
    n = labels.shape[0]
    a = labels[:, None, :].expand(n, n, 3).reshape(-1, 3)
    b = labels[None, :, :].expand(n, n, 3).reshape(-1, 3)
    return _geodesic64(geometry.angles_to_matrix, torch, torch.float64, a, b).reshape(n, n)


@contextlib.contextmanager
def one_geodesic():
    """Both packages' pose distances from one f64 geodesic: the port's
    `losses.nce._pairwise_pose_distance_raw` and JAX's `losses.nce`
    `rotation_err` are swapped for it until the block ends (JAX's under
    x64, where it is traced)."""
    port_raw, jax_err = nce._pairwise_pose_distance_raw, jnce.rotation_err
    nce._pairwise_pose_distance_raw = _port_distances64
    jnce.rotation_err = functools.partial(_geodesic64, jgeometry.angles_to_matrix, jnp,
                                          jnp.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        nce._pairwise_pose_distance_raw, jnce.rotation_err = port_raw, jax_err
