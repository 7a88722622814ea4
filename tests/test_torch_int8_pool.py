"""The int8 convolution with VGG's 2x2 max-pool taken on its s32 sums
(`ops.int8_conv.int8_conv(..., pool=True)`, the op
`pose3d_torch::int8_conv_pool`) and the K-major storage of the quantized
trees' int8 weights, on the CPU, where the product is the plain version.

What is held, and why:
  * `int8_conv_pool_plain` is JAX's order bit for bit (`_quantize_act`, the
    int32 convolution, `_max_pool` on the sums, then the dequantization and
    the ReLU; pose3d_tpu/serving/quant_student.py), and equals the
    dequantized convolution pooled afterwards, as the student forward ran
    it before the pool moved into the kernel (every step of the
    dequantization is non-decreasing where a * ws > 0), in f32 and bf16, at
    even and odd sizes (VALID: the last row and column dropped), 3x3 with
    padding, 1x1, strided;
  * the quantized trees hold each int8 weight with JAX's shape and values,
    stored K-major (the kernel's layout), made when the tree is built or
    loaded; `save_quantized` still writes JAX's keys and HWIO values, and
    the .npz loads in JAX;
  * `pose3d_torch::int8_conv` keeps the schema that artifacts exported
    before name (they still load), and the pooled op's fake matches its
    CPU kernel;
  * the student's int8 forward pools its four pre-pool convs in the op and
    gives the heads of the earlier order (the pool after the
    dequantization).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from pose3d_tpu.serving import quant_student as jqs
from pose3d_tpu.serving import quant_teacher as jqt
from pose3d_tpu_torch.models.estimators import BaselineEstimator
from pose3d_tpu_torch.ops import int8_conv as i8
from pose3d_tpu_torch.serving import quant_student as pqs
from pose3d_tpu_torch.serving import quant_teacher as pqt
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
POOLED = [  # (n, h, w, c, k, co, stride, padding)
    (2, 8, 8, 16, 3, 32, 1, 1),    # even sizes, 3x3 with padding 1
    (2, 9, 11, 16, 3, 24, 1, 1),   # odd: the last row and column are dropped
    (1, 6, 7, 32, 1, 16, 1, 0),    # 1x1
    (3, 13, 13, 20, 3, 8, 2, 1),   # strided, C not a multiple of 16
]
EXPORTED_SCHEMA = ("pose3d_torch::int8_conv(Tensor x, Tensor a, Tensor w, Tensor ws, "
                   "Tensor shift, SymInt stride, SymInt padding, bool relu) -> Tensor")


def _case(n, h, w, c, k, co, dtype, seed=0):
    """numpy x (float32 values of `dtype`), int8 HWIO w, a, ws, shift."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(dtype)
    x = x.float().numpy()
    wq = rng.integers(-127, 128, (k, k, c, co), dtype=np.int8)
    a = np.float32(np.abs(x).max() / 127.0)
    ws = rng.uniform(1e-4, 1e-2, co).astype(np.float32)
    shift = rng.standard_normal(co).astype(np.float32)
    return x, wq, a, ws, shift


def _torch_args(x, wq, a, ws, shift, dtype):
    return (torch.from_numpy(x).to(dtype), torch.tensor(a), i8.k_major(wq),
            torch.from_numpy(ws), torch.from_numpy(shift))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n,h,w,c,k,co,stride,padding", POOLED)
def test_pool_plain_is_jax_order(n, h, w, c, k, co, stride, padding, dt):
    tdt, jdt = DTYPES[dt]
    x, wq, a, ws, shift = _case(n, h, w, c, k, co, tdt, seed=n * 100 + h)
    xq = jqs._quantize_act(jnp.asarray(x).astype(jdt), a)
    z = jqs._conv(xq, jnp.asarray(wq), (stride, stride), ((padding, padding),) * 2,
                  acc=jnp.int32)
    want = jax.nn.relu((jqs._max_pool(z).astype(jnp.float32) * (a * ws) + shift).astype(jdt))
    args = _torch_args(x, wq, a, ws, shift, tdt)
    got = i8.int8_conv_pool_plain(*args, stride, padding, relu=True)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the op (its CPU kernel) and the wrapper give the same bits
    assert torch.equal(i8.int8_conv(*args, stride, padding, relu=True, pool=True), got)
    assert torch.equal(i8.int8_conv_plain(*args, stride, padding, True, pool=True), got)
    # the earlier order: the dequantized convolution, then the pool
    after = i8.int8_conv_plain(*args, stride, padding, relu=True)
    assert torch.equal(F.max_pool2d(after.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1), got)


def test_max_pool_s32_drops_odd_edges():
    z = torch.arange(2 * 5 * 7 * 3, dtype=torch.int32).reshape(2, 5, 7, 3)
    want = np.asarray(jqs._max_pool(jnp.asarray(z.numpy())))
    np.testing.assert_array_equal(i8.max_pool_s32(z).numpy(), want)
    assert i8.max_pool_s32(z).shape == (2, 2, 3, 3)


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 48, 5), (40, 24)])
def test_k_major_keeps_values_and_stores_k_major(shape):
    w = np.random.default_rng(1).integers(-127, 128, shape, dtype=np.int8)
    wk = i8.k_major(w)
    assert wk.shape == w.shape and wk.dtype == torch.int8
    np.testing.assert_array_equal(wk.numpy(), w)
    storage = wk.movedim(-1, 0)  # (CO, KH, KW, C) or (CO, K)
    assert storage.is_contiguous()
    np.testing.assert_array_equal(storage.numpy(), np.moveaxis(w, -1, 0))


def test_kernel_reads_the_k_major_storage_without_a_copy():
    w = np.random.default_rng(2).integers(-127, 128, (3, 3, 16, 8), dtype=np.int8)
    wk = i8.k_major(w)
    before = i8.int8_conv.weight_copies
    assert i8._k_major_storage(wk).data_ptr() == wk.data_ptr()
    assert i8.int8_conv.weight_copies == before
    copied = i8._k_major_storage(torch.from_numpy(w))  # HWIO storage: copied, counted
    assert copied.is_contiguous() and i8.int8_conv.weight_copies == before + 1
    np.testing.assert_array_equal(copied.numpy(), np.moveaxis(w, -1, 0))


def test_routes_by_channels():
    assert [i8.route(c) for c in (3, 20, 48, 64, 512, 25088, 1000)] == \
        ["mma.sync", "mma.sync", "wgmma", "wgmma", "wgmma", "wgmma", "mma.sync"]


def _student_tree(rng):
    """A quantized student tree in JAX's schema, numpy leaves (no model)."""
    def entry(shape):
        co = shape[-1]
        return {"w": rng.integers(-127, 128, shape, dtype=np.int8),
                "ws": rng.uniform(1e-4, 1e-2, co).astype(np.float32),
                "b": rng.standard_normal(co).astype(np.float32), "a": np.float32(0.02)}

    return {"stem": {"kernel": rng.standard_normal((3, 3, 3, 8)).astype(np.float32),
                     "bias": rng.standard_normal(8).astype(np.float32)},
            "convs": [entry((3, 3, 8, 16)), entry((3, 3, 16, 16))],
            "fcs": [entry((64, 32)), entry((32, 16))],
            "compress": [(rng.standard_normal((16, 8)).astype(np.float32),
                          rng.standard_normal(8).astype(np.float32),
                          rng.standard_normal(8).astype(np.float32))],
            "heads": [(rng.standard_normal((8, 4)).astype(np.float32),
                       rng.standard_normal(4).astype(np.float32))]}


def _teacher_tree(rng):
    def entry(shape):
        co = shape[-1]
        return {"w": rng.integers(-127, 128, shape, dtype=np.int8),
                "s": rng.uniform(1e-4, 1e-2, co).astype(np.float32),
                "h": rng.standard_normal(co).astype(np.float32), "a": np.float32(0.03)}

    return {"stem": {"kernel": rng.standard_normal((7, 7, 3, 8)).astype(np.float32),
                     "g": np.ones(8, np.float32), "h": np.zeros(8, np.float32)},
            "blocks": [[entry((3, 3, 8, 8)), entry((3, 3, 8, 8))],
                       [entry((3, 3, 8, 16)), entry((3, 3, 16, 16)), entry((1, 1, 8, 16))]],
            "fc": {"kernel": rng.standard_normal((16, 10)).astype(np.float32),
                   "bias": np.zeros(10, np.float32)}}


def _int8_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _int8_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _int8_leaves(v, f"{path}/{i}")
    elif np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree).dtype == np.int8:
        yield path, tree


@pytest.mark.parametrize("kind", ["student", "teacher", "MultiView"])
def test_loaded_trees_store_int8_weights_k_major(kind, tmp_path):
    """JAX's .npz read by the port: each int8 weight keeps JAX's shape and
    values and is stored K-major; the port's save_quantized writes JAX's
    keys and values back, which JAX loads."""
    rng = np.random.default_rng(3)
    tree = (_student_tree(rng) if kind == "student" else _teacher_tree(rng) if kind == "teacher"
            else {"img": _teacher_tree(rng), "shape": _teacher_tree(rng)})
    jqs.save_quantized(tree, str(tmp_path / "jax.npz"))
    load = pqs.load_quantized if kind == "student" else pqt.load_quantized_teacher
    q = load(str(tmp_path / "jax.npz"))
    want = dict(_int8_leaves(tree))
    got = dict(_int8_leaves(q))
    assert set(got) == set(want) and got
    for path, w in got.items():
        assert w.shape == want[path].shape, path
        assert w.movedim(-1, 0).is_contiguous(), path
        np.testing.assert_array_equal(w.numpy(), want[path], err_msg=path)
    pqs.save_quantized(q, str(tmp_path / "port.npz"))
    theirs, ours = np.load(str(tmp_path / "jax.npz")), np.load(str(tmp_path / "port.npz"))
    assert sorted(ours.keys()) == sorted(theirs.keys())
    for key in theirs.keys():
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    back = (jqs.load_quantized if kind == "student" else jqt.load_quantized_teacher)(
        str(tmp_path / "port.npz"))
    for path, w in dict(_int8_leaves(back)).items():
        np.testing.assert_array_equal(np.asarray(w), want[path], err_msg=path)


def _small_student():
    torch.manual_seed(0)
    model = BaselineEstimator(img_feature_dim=32, width_mult=0.125, input_dim=64).eval()
    calib = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return model, calib


def test_quantize_student_stores_k_major_and_saves_jax_keys(tmp_path):
    model, calib = _small_student()
    q = pqs.quantize_student(model, [calib])
    leaves = dict(_int8_leaves(q))
    assert len(leaves) == 7 + 3  # convs 1-7 and the three dense layers
    assert all(w.movedim(-1, 0).is_contiguous() for w in leaves.values())
    pqs.save_quantized(q, str(tmp_path / "q.npz"))
    keys = set(np.load(str(tmp_path / "q.npz")).keys())
    assert keys == set(pqs.flatten_tree(q)) and all(k.split("/")[-1] != "wk" for k in keys)
    loaded = jqs.load_quantized(str(tmp_path / "q.npz"))
    np.testing.assert_array_equal(np.asarray(loaded["convs"][0]["w"]),
                                  q["convs"][0]["w"].numpy())


def test_student_forward_pools_in_the_op(monkeypatch):
    """Four of the seven convs go through the pooled op, and the heads are
    the earlier order's (the pool after the dequantization) bit for bit,
    in bf16."""
    model, calib = _small_student()
    q = pqs.quantize_student(model, [calib])
    im = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 64, 64, 3)).astype(np.float32))
    calls, conv = [], i8.int8_conv

    def record(x, a, w, ws, shift, stride=1, padding=0, relu=False, pool=False):
        calls.append(pool)
        return conv(x, a, w, ws, shift, stride, padding, relu, pool)

    monkeypatch.setattr(i8, "int8_conv", record)
    got = pqs.student_int8_infer(q, im)
    assert calls == [True, False, True, False, True, False, True, False, False, False]

    def pool_after(x, a, w, ws, shift, stride=1, padding=0, relu=False, pool=False):
        y = i8.int8_conv_plain(x, a, w, ws, shift, stride, padding, relu)
        return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1) if pool else y

    monkeypatch.setattr(i8, "int8_conv", pool_after)
    want = pqs.student_int8_infer(q, im)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_int8_conv_keeps_its_exported_schema():
    assert str(torch.ops.pose3d_torch.int8_conv.default._schema) == EXPORTED_SCHEMA
    assert str(torch.ops.pose3d_torch.int8_conv_pool.default._schema) == \
        EXPORTED_SCHEMA.replace("::int8_conv(", "::int8_conv_pool(")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_pool_op_fake_matches_its_cpu_kernel(dt):
    tdt = DTYPES[dt][0]
    x, wq, a, ws, shift = _case(2, 9, 11, 16, 3, 8, tdt, seed=6)
    args = (*_torch_args(x, wq, a, ws, shift, tdt), 1, 1, True)
    real = i8.int8_conv_pool_op(*args)
    with FakeTensorMode() as mode:
        fake = i8.int8_conv_pool_op(*(mode.from_tensor(t) if isinstance(t, torch.Tensor) else t
                                      for t in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    assert real.shape == (2, 4, 5, 8)


def test_pool_counts_no_launch_on_the_cpu():
    x, wq, a, ws, shift = _case(1, 6, 6, 16, 3, 8, torch.float32)
    before = (i8.int8_conv.launches, dict(i8.int8_conv.route_launches))
    i8.int8_conv(*_torch_args(x, wq, a, ws, shift, torch.float32), 1, 1, pool=True)
    assert (i8.int8_conv.launches, i8.int8_conv.route_launches) == before
