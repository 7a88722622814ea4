"""The port's PointNet encoder (`ops.pointnet`, `models.pointnet`) against the
JAX package, on the CPU.

The same seeded weights go through JAX's fold, its plain XLA version and its
Pallas kernel in interpret mode, and through the port's fold and plain
version; the port's ShapeEncoderPC is held against JAX's eval forward.

The CUDA kernel's arithmetic, which no CPU run reaches, is emulated in numpy
(`split_tf32_pointnet`: layers 1-2 as the kernel's f32 FMA chains, layer 3
in split TF32 with cvt.rna as rounding the f32 bits to 10 mantissa bits,
half away from zero, over the kernel's 16 k-steps of mma.m16n8k8, each
k-step's three products an exact 8-term sum rounded to f32 into a fresh
accumulator, then added to the running f32 sum) and held against JAX's
plain version in f64; one TF32 product instead of three misses the
tolerance, which is why the kernel splits.
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
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

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


def _rna(a):
    """cvt.rna.tf32.f32: the f32 bit pattern rounded to 10 mantissa bits,
    half away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """a = big + small, both TF32: small is the remainder (exact in f32), rounded."""
    big = _rna(a)
    return big, _rna(np.asarray(a, np.float32) - big)


def split_tf32_pointnet(pts, folded, products=3):
    """csrc/pointnet_eval.cu's arithmetic in numpy (f32), (N, P, 3) -> (N, D):
    layer 1 as fma(x2, w_c, fma(x1, w_b, x0 w_a)) + b1, layer 2 as one FMA
    chain over k = 0..63, both ReLU'd; layer 3 over 16 k-steps of 8, each
    k-step's small.big, big.small, big.big (products=3; big.big alone with
    1) into a fresh f32 accumulator (each mma an exact 8-term sum rounded to
    f32), then added to the running f32 sum; the max over the points, then
    b3. (An FMA is its f64 product and sum rounded once to f32.)"""
    (w1, b1), (w2, b2), (w3, b3) = folded
    n, p, _ = pts.shape
    x = pts.reshape(-1, 3).astype(np.float64)
    h = (x[:, :1] * w1[0]).astype(np.float32)
    h = (x[:, 1:2] * w1[1] + h).astype(np.float32)
    h = (x[:, 2:3] * w1[2] + h).astype(np.float32)
    h1 = np.maximum(h + b1, 0).astype(np.float32)
    acc = np.zeros((h1.shape[0], w2.shape[1]), np.float32)
    for k in range(w2.shape[0]):
        acc = (h1[:, k:k + 1].astype(np.float64) * w2[k] + acc).astype(np.float32)
    h2 = np.maximum(acc + b2, 0).astype(np.float32)
    (a_big, a_small), (b_big, b_small) = _split(h2), _split(w3)
    terms = [(a_small, b_big), (a_big, b_small), (a_big, b_big)][3 - products:]
    acc = np.zeros((h2.shape[0], w3.shape[1]), np.float32)
    for j in range(0, w3.shape[0], 8):
        ks = slice(j, j + 8)
        part = np.zeros_like(acc)
        for ta, tb in terms:
            part = (part + ta[:, ks].astype(np.float64) @ tb[ks].astype(np.float64)
                    ).astype(np.float32)
        acc = acc + part
    return (acc.reshape(n, p, -1).max(axis=1) + b3).astype(np.float32)


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


@pytest.mark.parametrize("p", [100, 513])
def test_shape_encoder_bf16_matches_jax(p):
    """bf16 (--bf16): the port's ShapeEncoderPC(compute_dtype=bfloat16) in
    eval mode (on the CPU pointnet_eval_bf16_plain on the unfolded layers,
    no launch) against JAX's ShapeEncoderPC(dtype=bfloat16) eval forward
    (flax: JAX's model never calls its Pallas kernel there) on the same
    points: each element within one bf16 ulp (2^-7 of max|ref|), under 1 %
    unequal."""
    v = _variables("seeded")
    pts = _points(5, p, seed=p + 1)
    want = JaxShapeEncoderPC(FEATURE_DIM, dtype=jnp.bfloat16).apply(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(pts), train=False)
    enc = ShapeEncoderPC(FEATURE_DIM, compute_dtype=torch.bfloat16)
    enc.load_state_dict(_port_state(v), strict=True)
    before = pointnet.pointnet_eval_bf16.launches, pointnet.pointnet_eval.launches
    got = enc.eval()(torch.from_numpy(pts))
    assert (pointnet.pointnet_eval_bf16.launches, pointnet.pointnet_eval.launches) == before
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    err, unequal = _rel(got, want), float(np.mean(got != want))
    print(f"ShapeEncoderPC bf16 P {p}: max|d|/max|ref| {err:.3g} (one ulp 2^-7), "
          f"unequal {unequal:.3g}")
    assert err <= 2.0**-7 and unequal < 0.01
    layers = pointnet.eval_layers_bf16(_port_state(v))
    assert [(w.dtype, b.dtype, bn.dtype) for w, b, bn in layers] == \
        [(torch.bfloat16, torch.bfloat16, torch.float32)] * 3


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
    """Train mode was refused until its forward was ported; it now runs in
    plain PyTorch, away from the eval kernel: batch statistics (the output
    differs from eval mode's), gradients, the running statistics updated."""
    enc = ShapeEncoderPC(FEATURE_DIM, generator=torch.Generator().manual_seed(0))
    pts = torch.from_numpy(_points(2, 10))
    before = pointnet.pointnet_eval.launches
    out = enc.train()(pts)
    out.sum().backward()
    assert pointnet.pointnet_eval.launches == before
    assert enc.conv3.weight.grad is not None and int(enc.bn1.num_batches_tracked) == 1
    assert not torch.allclose(out.detach(), enc.eval()(pts))


def test_cpu_tensors_take_the_plain_version():
    folded = pointnet.fold_pointnet_params(_port_state(_variables("seeded")))
    pts = torch.from_numpy(_points(4, 70))
    before = pointnet.pointnet_eval.launches
    out = pointnet.pointnet_eval(pts, folded)
    assert pointnet.pointnet_eval.launches == before
    assert torch.equal(out, pointnet.pointnet_eval_plain(pts, folded))
    empty = pointnet.pointnet_eval(pts[:0], folded)
    assert empty.shape == (0, FEATURE_DIM)


@pytest.mark.parametrize("d", [256, 1024])
def test_split_tf32_kernel_arithmetic_matches_jax_f64(d):
    """The kernel's arithmetic (three TF32 products per f32 product, K 128 in
    16 k-steps) within ENCODER_REL_TOL of JAX's plain version in f64 at P 513
    (no multiple of the 128-point tile); one TF32 product is not."""
    folded = [(w.numpy(), b.numpy())
              for w, b in chip_smoke.pointnet_params(np.random.default_rng(d), d, "cpu")]
    pts = _points(5, 513, seed=d)
    with jax.enable_x64(True):
        want = np.asarray(_xla_pointnet_eval(
            jnp.asarray(pts, jnp.float64), *[jnp.asarray(t, jnp.float64)
                                             for pair in folded for t in pair]))
    got = split_tf32_pointnet(pts, folded)
    assert got.shape == want.shape == (5, d)
    assert _rel(got, want) <= ENCODER_REL_TOL
    assert _rel(split_tf32_pointnet(pts, folded, products=1), want) > ENCODER_REL_TOL


@pytest.mark.parametrize("n,p,d,want", [
    # serving and evaluation at batch 64: 64 x 20 tiles of 128 points; 2
    # segments of 10 tiles make 128 blocks, one wave on 132 SMs
    (64, 2500, 1024, (2, 1)),
    # the KD step's frozen teacher: 920 one-tile blocks, 7 waves 99.6 % full;
    # 2 segments (92 blocks) would leave 40 SMs idle for the whole call
    (46, 2500, 1024, (20, 1)),
    # serving at batch 1: 20 tiles x 4 column groups of one 256-column pass
    # = 80 blocks, layers 1-2 computed once a group
    (1, 2500, 1024, (20, 4)),
    # the teacher step's and stage 1's evaluations at D 256: as at D 1024
    (64, 2500, 256, (2, 1)),
    (46, 2500, 256, (20, 1)),
    # a single tile and a single pass cannot be split
    (2, 1, 256, (1, 1)),
])
def test_segments_fill_the_card(n, p, d, want):
    assert pointnet.segments_for(n, p, d, 132) == want


@pytest.mark.parametrize("n,p,d", [(1, 511, 256), (46, 2501, 1024), (300, 2500, 1024),
                                   (1, 1, 1000)])
def test_segments_stay_within_the_tiles(n, p, d):
    s, g = pointnet.segments_for(n, p, d, 132)
    assert 1 <= s <= -(-p // pointnet.TILE_P)
    assert 1 <= g <= -(-d // pointnet.CHUNK_D)


def bf16_accumulator_max(pts, layers, tile=256):
    """The bf16 kernel's order of work, on the CPU: layers 1-2 at the plain
    version's rounding points, layer 3's f32 sums, the rows of a cloud's
    last tile past its end repeating that tile's first point, the columns
    whose BN multiplier is negative negated, the max over the points of
    those sums, then layer 3's epilogue once a column on the max negated
    back (flax's rounding points: bf16(acc), + b in bf16, the BN in f32)."""
    x = pts
    for w, b, bn in layers[:2]:
        h = (x.float() @ w.float()).to(torch.bfloat16)
        h = (h.float() + b.float()).to(torch.bfloat16)
        x = torch.relu(((h.float() - bn[0]) * bn[1] + bn[2]).to(torch.bfloat16))
    w3, b3, bn3 = layers[2]
    acc = x.float() @ w3.float()  # (n, p, d)
    p = pts.shape[1]
    rows = torch.arange(-(-p // tile) * tile)
    acc = acc[:, torch.where(rows < p, rows, rows // tile * tile)]
    sign = torch.where(bn3[1] < 0, -1.0, 1.0)
    m = (acc * sign).amax(dim=1) * sign
    h = (m.to(torch.bfloat16).float() + b3.float()).to(torch.bfloat16)
    return ((h.float() - bn3[0]) * bn3[1] + bn3[2]).to(torch.bfloat16)


@pytest.mark.parametrize("n,p,d,b3", [(2, 1, 256, None), (3, 257, 1001, None),
                                      (2, 700, 1024, None), (3, 300, 256, -100.0)])
def test_bf16_max_on_accumulators_is_the_plain_max(n, p, d, b3):
    """Why the bf16 kernel may take the max before the epilogue: each step
    of layer 3's epilogue rounds monotonically, rising with the accumulator
    where the BN multiplier is positive and falling where it is negative, so
    the max over the points of the epilogue is the epilogue at the
    accumulators' max (min where negative), and repeated rows change no
    max: bit-equal to pointnet_eval_bf16_plain, multipliers of both signs
    (every output negative at b3 -100)."""
    layers = chip_smoke.pointnet_bf16_params(np.random.default_rng(d + p), d, "cpu", b3)
    assert bool((layers[2][2][1] < 0).any()) == (b3 is None)
    pts = torch.from_numpy(np.random.default_rng(p).uniform(-1, 1, (n, p, 3)).astype(
        np.float32)).to(torch.bfloat16)
    got = bf16_accumulator_max(pts, layers)
    assert torch.equal(got, pointnet.pointnet_eval_bf16_plain(pts, layers))
    if b3 is not None:
        assert float(got.float().max()) < 0


@pytest.mark.parametrize("p", [100, 513])
def test_bf16_accumulator_max_matches_jax(p):
    """The bf16 kernel's order of work (bf16_accumulator_max) against JAX's
    ShapeEncoderPC(dtype=bfloat16) eval forward on the same points: within
    one bf16 ulp (2^-7 of max|ref|), under 1 % unequal."""
    v = _variables("seeded")
    pts = _points(5, p, seed=p + 3)
    want = JaxShapeEncoderPC(FEATURE_DIM, dtype=jnp.bfloat16).apply(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(pts), train=False)
    layers = pointnet.eval_layers_bf16(_port_state(v))
    got = bf16_accumulator_max(torch.from_numpy(pts).to(torch.bfloat16), layers)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert _rel(got, want) <= 2.0**-7 and float(np.mean(got != want)) < 0.01


@pytest.mark.parametrize("n,p,d,want", [
    # serving and evaluation at batch 64: 64 clouds x 10 tiles of 256 points
    # in one column group (D 1024 is 8 chunks: layers 1-2 once a tile); 640
    # units over 132 blocks, at most 5 a block. Two groups would be 10
    # units of 4 chunks a block, layers 1-2 twice a tile
    (64, 2500, 1024, (132, 1)),
    # the KD step's frozen teacher: 460 units over 132 blocks, at most 4 a
    # block (2 groups: at most 7 units of 4 chunks, more work a block)
    (46, 2500, 1024, (132, 1)),
    # serving at batch 1: 10 tiles would leave 122 SMs idle; 8 groups of
    # one chunk make 80 units, one a block
    (1, 2500, 1024, (80, 8)),
    # stage 2 and the D-256 teachers: one group of 2 chunks, which stays
    # in the ring for a block's run; 460 units, at most 4 a block
    (46, 2500, 256, (132, 1)),
    # a single tile: 2 groups of one chunk, 4 units on 4 blocks
    (2, 1, 256, (4, 2)),
    # 132 clouds of 2 tiles: 264 units, 2 a block, each block one cloud
    (132, 300, 256, (132, 1)),
])
def test_bf16_split_fills_the_card(n, p, d, want):
    assert pointnet.bf16_split(n, p, d, 132) == want


@pytest.mark.parametrize("n,p,d", [(1, 511, 256), (46, 2501, 1024), (300, 2500, 1024),
                                   (1, 1, 1000)])
def test_bf16_split_stays_within_the_tiles_and_columns(n, p, d):
    """Every group holds columns and at most BF16_GROUP_CHUNKS chunks (the
    running max's room), and no block is left without a unit."""
    blocks, groups = pointnet.bf16_split(n, p, d, 132)
    tiles, chunks = -(-p // pointnet.BF16_TILE_P), -(-d // pointnet.BF16_CHUNK_D)
    per_group = -(-chunks // groups)
    assert 1 <= per_group <= pointnet.BF16_GROUP_CHUNKS
    assert -(-chunks // per_group) == groups
    assert 1 <= blocks <= min(132, groups * n * tiles)


@pytest.mark.parametrize("n,p,d,want", [
    # the shared clouds' merge: a block's run starts inside a cloud
    (64, 2500, 1024, 2), (46, 2500, 1024, 2), (1, 2500, 1024, 2), (46, 2500, 256, 2),
    # one cloud a block (a tile's 4 units on 4 blocks; 2 tiles a block)
    (2, 1, 256, 1), (132, 300, 256, 1),
    # and W3's copy into rows of a multiple of 8 columns
    (2, 300, 1001, 3),
])
def test_bf16_launches_per_call(n, p, d, want):
    assert pointnet.bf16_launches_per_call(n, p, d, 132) == want
