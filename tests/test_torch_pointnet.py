"""The port's PointNet encoder (`ops.pointnet`, `models.pointnet`) against the
JAX package, on the CPU.

The same seeded weights go through JAX's fold, its plain XLA version and its
Pallas kernel in interpret mode, and through the port's fold and plain
version; the port's ShapeEncoderPC is held against JAX's eval forward.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu.models.pointnet import ShapeEncoderPC as JaxShapeEncoderPC
from pose3d_tpu.ops.pointnet_fused import _xla_pointnet_eval, pallas_pointnet_interpret
from pose3d_tpu.ops.pointnet_fused import fold_pointnet_params as jax_fold
from pose3d_tpu.train.torch_export import export_pointnet
from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC
from pose3d_tpu_torch.ops import pointnet

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FEATURE_DIM = 64
# fold: the same three f32 operations in both frameworks, up to one rounding
FOLD_RTOL = 1e-6
# plain vs JAX on the same folded weights: f32 matmuls, summation order only
PLAIN_REL_TOL = 1e-5
# encoder vs JAX's unfolded eval forward: (x W + b - mean) * rsqrt(var + eps)
# * scale + shift rounds differently from x (W g) + (b g + c)
ENCODER_REL_TOL = 1e-4


def _variables(kind):
    """ShapeEncoderPC {"params", "batch_stats"} as numpy: JAX's init, or
    He-scaled weights with random BN statistics (chip_smoke's teacher)."""
    if kind == "jax_init":
        v = JaxShapeEncoderPC(FEATURE_DIM).init(jax.random.key(0), jnp.zeros((1, 8, 3)),
                                                train=False)
        return jax.tree_util.tree_map(np.asarray, dict(v))
    v = chip_smoke.teacher_variables(np.random.default_rng(5), 64, FEATURE_DIM)
    return {"params": v["params"]["ShapeEncoderPC_0"],
            "batch_stats": v["batch_stats"]["ShapeEncoderPC_0"]}


def _port_state(variables):
    sd = {}
    export_pointnet(variables["params"], variables["batch_stats"], (), sd, "")
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _points(n, p, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, p, 3)).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind", ["jax_init", "seeded"])
def test_fold_matches_jax(kind):
    v = _variables(kind)
    want = jax_fold(v["params"], v["batch_stats"])
    got = pointnet.fold_pointnet_params(_port_state(v))
    for (w, b), (jw, jb) in zip(got, want):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=FOLD_RTOL, atol=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=FOLD_RTOL,
                                   atol=FOLD_RTOL * np.abs(np.asarray(jb)).max())


@pytest.mark.parametrize("p", [100, 513])
def test_plain_matches_xla_and_pallas_interpret(p):
    """N = 5 is no multiple of Pallas's 8 rows, P no multiple of its 512
    points: the interpret run pads both."""
    v = _variables("seeded")
    folded = pointnet.fold_pointnet_params(_port_state(v))
    jfolded = [(jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in folded]
    pts = _points(5, p)
    got = pointnet.pointnet_eval_plain(torch.from_numpy(pts), folded).numpy()
    xla = _xla_pointnet_eval(jnp.asarray(pts), *[t for pair in jfolded for t in pair])
    interp = pallas_pointnet_interpret(jnp.asarray(pts), jfolded)
    assert got.shape == (5, FEATURE_DIM)
    assert _rel(got, xla) <= PLAIN_REL_TOL
    assert _rel(got, interp) <= PLAIN_REL_TOL


@pytest.mark.parametrize("kind", ["jax_init", "seeded"])
@pytest.mark.parametrize("p", [100, 513])
def test_shape_encoder_matches_jax(kind, p):
    v = _variables(kind)
    pts = _points(7, p, seed=p)
    want = JaxShapeEncoderPC(FEATURE_DIM).apply(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(pts), train=False)
    enc = ShapeEncoderPC(FEATURE_DIM)
    enc.load_state_dict(_port_state(v), strict=True)
    enc.eval()
    got = enc(torch.from_numpy(pts))
    assert not got.requires_grad  # the frozen teacher's forward
    assert _rel(got.numpy(), want) <= ENCODER_REL_TOL


def test_all_negative_outputs_keep_their_max():
    """The last layer has no ReLU: a max that started at 0 would read 0."""
    v = _variables("seeded")
    folded = pointnet.fold_pointnet_params(_port_state(v))
    (w1, b1), (w2, b2), (w3, b3) = folded
    folded = [(w1, b1), (w2, b2), (w3, torch.full_like(b3, -100.0))]
    pts = _points(3, 100)
    got = pointnet.pointnet_eval(torch.from_numpy(pts), folded).numpy()
    want = _xla_pointnet_eval(jnp.asarray(pts), *[jnp.asarray(t.numpy())
                                                  for pair in folded for t in pair])
    assert got.max() < 0
    assert _rel(got, want) <= PLAIN_REL_TOL


def test_shape_encoder_train_mode_is_refused():
    enc = ShapeEncoderPC(FEATURE_DIM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc(torch.zeros((2, 10, 3)))


def test_cpu_tensors_take_the_plain_version():
    folded = pointnet.fold_pointnet_params(_port_state(_variables("seeded")))
    pts = torch.from_numpy(_points(4, 70))
    before = pointnet.pointnet_eval.launches
    out = pointnet.pointnet_eval(pts, folded)
    assert pointnet.pointnet_eval.launches == before
    assert torch.equal(out, pointnet.pointnet_eval_plain(pts, folded))
    empty = pointnet.pointnet_eval(pts[:0], folded)
    assert empty.shape == (0, FEATURE_DIM)


@pytest.mark.parametrize("n,p,d,want", [
    (64, 2500, 1024, 1),   # 256 blocks: two full waves on 132 SMs
    (46, 2500, 1024, 5),   # 184 blocks would leave 80 SMs idle in wave 2
    (1, 2500, 1024, 20),   # serving at batch 1: 80 blocks of two tiles
    (2, 1, 256, 1),        # a single tile cannot be split
])
def test_segments_fill_the_card(n, p, d, want):
    assert pointnet.segments_for(n, p, d, 132) == want


@pytest.mark.parametrize("n,p,d", [(1, 511, 256), (46, 2501, 1024), (300, 2500, 1024)])
def test_segments_stay_within_the_tiles(n, p, d):
    s = pointnet.segments_for(n, p, d, 132)
    assert 1 <= s <= -(-p // pointnet.TILE_P)
