"""The port's on-device data path against the JAX package, on the CPU: the
shape banks (`ops/shape_bank.py`), the device augmentation and view
synthesis (`ops/augment.py`), the datasets' raw, one-view and
bank-reference emissions, and the steps that take them.

Tolerances. `gather_renders` within 2^-24 of JAX's (JAX's dewire is one
ulp off true division). `sample_from_bank` given JAX's indices within 1e-6
abs (both rotate and normalise in f32). `device_augment` given JAX's draws
within 1e-5 of max|ref|. `rotate_views` and `synthesize_views` bit-equal.
The datasets' samples equal JAX's seed for seed, every array. The steps:
a bank at the full subset (the cloud's 64 vertices, 64 points) against
the host clouds, the same loss within 2e-5 relative (the subset comes in
another order, and the eval PointNet's max does not see the order; the
host normalises in f64, the bank in f32), and the train-mode steps in f64
likewise; a RenderBank's renders are the host path's bit for bit, so the
MultiView teacher's step and evaluation equal the host path's exactly.
One KD --crd step with --device_views and JAX's augmentation draws against
JAX's step at `tests/test_torch_kd.py`'s tolerances (the student in f64 on
both sides, the teacher and the losses in f32).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pose3d_tpu.data import datasets as jdatasets
from pose3d_tpu.data import synthetic
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.ops import augment as jaugment
from pose3d_tpu.ops import shape_bank as jsb
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu_torch.data import datasets
from pose3d_tpu_torch.data.annotations import OBJECTNET3D_TEST_CATS
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                PoseEstimatorVanilla)
from pose3d_tpu_torch.ops import augment, shape_bank
from pose3d_tpu_torch.train import convert, steps
from pose3d_tpu_torch.train.evaluate import evaluate_categories, host_array
from pose3d_tpu_torch.train.state import create_train_state
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401
from test_torch_kd import (BATCH, INPUT_DIM, STUDENT_DIM, TEACHER_DIM, WIDTH_MULT, _port_student,
                           _student_variables, chip_smoke)

N_VERTICES, VIEW_NUM, RENDER = 64, 4, 24
LR = 1e-4


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_device_data")
    synthetic.make_objectnet3d_fixture(str(root / "ObjectNet3D"), categories=("bed", "bookshelf"),
                                       n_train_per_cat=4, n_val_per_cat=2, image_size=72,
                                       n_vertices=N_VERTICES, with_renders=True,
                                       render_size=RENDER)
    return root / "ObjectNet3D"


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# --- the banks ----------------------------------------------------------------

def _bank_arrays(rng, counts=(50, 30, 10, 64), v=64):
    verts = np.zeros((len(counts), v, 3), np.float32)
    for s, c in enumerate(counts):
        verts[s, :c] = rng.normal(size=(c, 3))
    return verts, np.asarray(counts, np.int32)


def _jax_indices(count, seed, v, point_num):
    """JAX's `_sample_one` index selection, step by step."""
    k_wor, k_wr = jax.random.split(jax.random.key(seed))
    keys = jnp.where(jnp.arange(v) < count, jax.random.uniform(k_wor, (v,)), -1.0)
    idx_wor = jax.lax.top_k(keys, point_num)[1]
    idx_wr = jax.random.randint(k_wr, (point_num,), 0, jnp.maximum(count, 1))
    return np.asarray(jnp.where(count >= point_num, idx_wor, idx_wr))


@pytest.mark.parametrize("point_num", [20, 40])
def test_sample_from_bank_given_jax_indices_matches_jax(rng, point_num):
    """Counts above and below point_num (both branches), rotations 0, +-15
    and 37 degrees."""
    verts, counts = _bank_arrays(rng)
    ids = np.array([0, 1, 2, 3, 1, 2, 0, 3], np.int32)
    rot = np.array([0.0, 15.0, -15.0, 37.0, 0.0, 15.0, -15.0, 0.0], np.float32)
    seeds = rng.integers(0, 2**32, len(ids), dtype=np.uint32)
    want = np.asarray(jsb.sample_from_bank(jsb.ShapeBank.from_arrays(verts, counts, point_num),
                                           jnp.asarray(ids), jnp.asarray(rot),
                                           jnp.asarray(seeds)))
    idx = np.stack([_jax_indices(counts[i], int(s), verts.shape[1], point_num)
                    for i, s in zip(ids, seeds)])
    bank = shape_bank.ShapeBank.from_arrays(verts, counts, point_num, "cpu")
    got = shape_bank.sample_with_indices(bank, torch.from_numpy(ids).long(),
                                         torch.from_numpy(idx).long(), torch.from_numpy(rot))
    assert got.dtype == torch.float32 and got.shape == (len(ids), point_num, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_rotation_zero_is_the_identity(rng):
    """rot 0: the subset, min-max normalised, nothing else."""
    verts, counts = _bank_arrays(rng)
    bank = shape_bank.ShapeBank.from_arrays(verts, counts, 20, "cpu")
    idx = torch.arange(20)[None, :]
    got = shape_bank.sample_with_indices(bank, torch.tensor([0]), idx, torch.zeros(1))[0]
    pts = torch.from_numpy(verts[0, :20])
    pts = pts - pts.min()
    assert torch.equal(got, pts / pts.max())


def test_port_draws_are_distinct_in_range_and_a_function_of_the_seed(rng):
    """Without replacement: point_num distinct indices inside the valid
    prefix; with replacement: indices in [0, count); the same seed gives
    the same subset in a batch of 1 and of 8, and other seeds others."""
    verts, counts = _bank_arrays(rng)
    point_num = 20
    bank = shape_bank.ShapeBank.from_arrays(verts, counts, point_num, "cpu")
    ids = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3])
    seeds = torch.from_numpy(rng.integers(0, 2**32, 8, dtype=np.uint32))
    idx = shape_bank.sample_indices(bank.counts[ids], seeds, verts.shape[1], point_num)
    for row, sid in zip(idx, ids.tolist()):
        if counts[sid] >= point_num:
            assert len(set(row.tolist())) == point_num and int(row.max()) < counts[sid]
        else:
            assert 0 <= int(row.min()) and int(row.max()) < counts[sid]
    for k in range(8):
        one = shape_bank.sample_indices(bank.counts[ids[k:k + 1]], seeds[k:k + 1],
                                        verts.shape[1], point_num)
        assert torch.equal(one[0], idx[k])
    clouds = shape_bank.sample_from_bank(bank, ids, torch.zeros(8), seeds)
    again = shape_bank.sample_from_bank(bank, ids[3:4], torch.zeros(1), seeds[3:4])
    assert torch.equal(clouds[3], again[0])
    other = shape_bank.sample_indices(bank.counts[ids], seeds.long() + 1, verts.shape[1],
                                      point_num)
    assert not torch.equal(other, idx)
    # the uniform keys cover [0, 2^32): a draw of 2,000 is spread over it
    keys = shape_bank.uniform_keys(seeds[:1], 2000, 0)
    assert 0.45 < float(keys.double().mean()) / 2**32 < 0.55


def test_gather_renders_matches_jax(rng):
    renders = rng.integers(0, 256, (3, 10, 8, 8, 3), dtype=np.uint8)
    table = rng.integers(0, 10, (72, 4)).astype(np.int32)
    ids, mut = np.array([2, 0, 1, 2], np.int32), np.array([0, 71, 5, 36], np.int32)
    want = np.asarray(jsb.gather_renders(jsb.RenderBank.from_arrays(renders, table),
                                         jnp.asarray(ids), jnp.asarray(mut)))
    bank = shape_bank.RenderBank.from_arrays(renders, table, "cpu")
    got = shape_bank.gather_renders(bank, torch.from_numpy(ids), torch.from_numpy(mut))
    assert got.dtype == torch.float32 and got.shape == (4, 4, 8, 8, 3)
    assert np.abs(got.numpy() - want).max() <= 2.0**-24
    np.testing.assert_array_equal(got.numpy(), renders[ids[:, None], table[mut]] / np.float32(255))


# --- the device augmentation and the views ------------------------------------

def _jax_draws(key, n):
    """JAX's `device_augment` draws, taken with its own splits and shapes."""
    k_apply, k_b, k_c, k_s, k_gray, k_pca = jax.random.split(key, 6)

    def factor(k):
        return jax.random.uniform(k, (n, 1, 1, 1), minval=0.5, maxval=1.5)

    return {"apply": jax.random.uniform(k_apply, (n, 1, 1, 1)) < 0.8,
            "fb": factor(k_b), "fc": factor(k_c), "fs": factor(k_s),
            "gray": jax.random.uniform(k_gray, (n, 1, 1, 1)) < 0.2,
            "alpha": 0.1 * jax.random.normal(k_pca, (n, 3))}


def _port_draws(draws):
    return {k: torch.from_numpy(np.array(v)).reshape(v.shape[0], -1).squeeze(1)
            for k, v in draws.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_device_augment_given_jax_draws_matches_jax(rng, seed):
    n = 12
    raw = rng.random((n, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jaugment.device_augment(jnp.asarray(raw), key))
    draws = _jax_draws(key, n)
    # both branches of each choice in the batch
    assert 0 < int(np.asarray(draws["apply"]).sum()) < n
    got = augment.device_augment(torch.from_numpy(raw), draws=_port_draws(draws))
    assert got.dtype == torch.float32
    assert _max_rel(got.numpy(), want) <= 1e-5
    # the port's own draws: one generator seed, one result
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (augment.device_augment(torch.from_numpy(raw), gen) for gen in g)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert augment.augment_draws(n, torch.Generator().manual_seed(0), "cpu").keys() == \
        set(augment.AUG_DRAW_KEYS)


def test_device_normalize_matches_jax(rng):
    raw = rng.random((3, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jaugment.device_normalize(jnp.asarray(raw)))
    assert _max_rel(augment.device_normalize(torch.from_numpy(raw)).numpy(), want) <= 1e-6


@pytest.mark.parametrize("size", [17, 32, 64])
def test_rotate_and_synthesize_views_equal_jax(rng, size):
    imgs = rng.random((4, size, size, 3)).astype(np.float32)
    signs = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
    want_rot = np.asarray(jaugment.rotate_views(jnp.asarray(imgs), jnp.asarray(signs)))
    want = np.asarray(jaugment.synthesize_views(jnp.asarray(imgs), jnp.asarray(signs)))
    got_rot = augment.rotate_views(torch.from_numpy(imgs), torch.from_numpy(signs))
    got = augment.synthesize_views(torch.from_numpy(imgs), torch.from_numpy(signs))
    np.testing.assert_array_equal(got_rot.numpy(), want_rot)
    np.testing.assert_array_equal(got.numpy(), want)
    # the index grids are JAX's
    for angle in (15.0, -15.0):
        for a, b in zip(augment._rotation_index_grid(size, size, angle),
                        jaugment._rotation_index_grid(size, size, angle)):
            np.testing.assert_array_equal(a, b)


def test_rotate_views_matches_pil_at_64(rng):
    """JAX's rule: PIL's Image.rotate (nearest, black fill) bit for bit at
    64x64."""
    from PIL import Image

    imgs = (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    signs = np.array([1.0, -1.0], np.float32)
    out = augment.rotate_views(torch.from_numpy(imgs), torch.from_numpy(signs)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(out[i], np.asarray(Image.fromarray(imgs[i]).rotate(
            15.0 * signs[i])))


# --- the datasets -------------------------------------------------------------

DATASET_KINDS = {
    "contrast_raw": ("Pascal3DContrast", dict(train=True, shape="PointCloud",
                                              host_augment=False)),
    "contrast_views": ("Pascal3DContrast", dict(train=True, shape="PointCloud",
                                                device_views=True)),
    "contrast_views_bank": ("Pascal3DContrast", dict(train=True, shape="PointCloud",
                                                     device_views=True, device_shapes=True)),
    "contrast_raw_render_bank": ("Pascal3DContrast", dict(train=True, shape="MultiView",
                                                          host_augment=False,
                                                          device_shapes=True)),
    "contrast_val_bank": ("Pascal3DContrast", dict(train=False, shape="PointCloud",
                                                   device_shapes=True)),
    "pascal_bank": ("Pascal3D", dict(train=True, shape="PointCloud", random=True,
                                     random_range=2, novel=False, device_shapes=True)),
    "pascal_render_bank": ("Pascal3D", dict(train=True, shape="MultiView", random=True,
                                            random_range=1, novel=False, device_shapes=True)),
}


def _dataset_pair(fixture_dir, kind, **extra):
    cls, kw = DATASET_KINDS[kind]
    shape_dir = "pointcloud" if kw["shape"] == "PointCloud" else "Renders_semi_sphere"
    kw = dict(kw, shape_dir=shape_dir, input_dim=INPUT_DIM, point_num=N_VERTICES,
              view_num=VIEW_NUM, tour=2, cat_choice=OBJECTNET3D_TEST_CATS, **extra)
    args = (str(fixture_dir), "ObjectNet3D.txt")
    return getattr(datasets, cls)(*args, **kw), getattr(jdatasets, cls)(*args, **kw)


@pytest.mark.parametrize("kind", list(DATASET_KINDS))
def test_dataset_emissions_equal_jax(fixture_dir, kind):
    """The u8 views, the one-view emission with rot_sign and the bank
    references equal JAX's samples seed for seed, every array."""
    ds, jds = _dataset_pair(fixture_dir, kind)
    for i in range(len(ds)):
        want = jds.get(i, np.random.default_rng((46, 1, i)))
        got = ds.get(i, np.random.default_rng((46, 1, i)))
        assert set(got) == set(want), (i, set(got) ^ set(want))
        for key in want:
            assert got[key].dtype == want[key].dtype, f"{i} {key}"
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")
    sample = ds.get(0, np.random.default_rng(0))
    if DATASET_KINDS[kind][1].get("device_shapes"):
        assert "shape" not in sample and "shape_id" in sample
    if kind.startswith("contrast_raw") or kind.startswith("contrast_views"):
        assert sample["im"].dtype == np.uint8


@pytest.mark.parametrize("shape", ["PointCloud", "MultiView"])
def test_built_banks_equal_jax(fixture_dir, shape):
    ds, jds = _dataset_pair(fixture_dir, "pascal_bank" if shape == "PointCloud"
                            else "pascal_render_bank")
    build = "build_shape_bank" if shape == "PointCloud" else "build_render_bank"
    for got, want in zip(getattr(ds, build)(), getattr(jds, build)()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if shape == "MultiView":
        renders, _ = ds.build_render_bank()
        assert renders.shape[1:] == (216, INPUT_DIM, INPUT_DIM, 3)


def test_render_bank_refuses_more_than_8_gib(fixture_dir, monkeypatch):
    """JAX's refusal, with its message: each model's renders read as 216 x
    4096 x 2048 x 3 (a broadcast view, nothing allocated), 5.1 GiB a model
    over the fixture's models."""
    ds, _ = _dataset_pair(fixture_dir, "pascal_render_bank")
    assert len(ds._shape_index()) >= 2
    big = np.broadcast_to(np.zeros((), np.uint8), (216, 4096, 2048, 3))
    monkeypatch.setattr(ds.renders, "load_all", lambda *a: big)
    with pytest.raises(SystemExit, match="too large for --device_shapes"):
        ds.build_render_bank()


# --- the steps ------------------------------------------------------------------

def _batches(fixture_dir, kind, keys, n=4, **extra):
    """Batches of the host path's dataset and of the bank path's, samples
    from the same seeds: (host batch, bank batch, bank)."""
    ds_host, ds_bank = (_dataset_pair(fixture_dir, kind, **extra)[0] for _ in range(2))
    ds_host.device_shapes, ds_bank.device_shapes = False, True
    multiview = DATASET_KINDS[kind][1]["shape"] == "MultiView"
    bank_keys = shape_bank.RENDER_ID_KEYS if multiview else shape_bank.SHAPE_ID_KEYS
    out = []
    for ds, shape_keys in ((ds_host, ("shape",)), (ds_bank, bank_keys)):
        samples = [ds.get(i, np.random.default_rng((46, 0, i))) for i in range(n)]
        out.append({k: torch.as_tensor(host_array(np.stack([s[k] for s in samples])))
                    for k in (*keys, *shape_keys)})
    np.testing.assert_array_equal(out[0]["im"].numpy(), out[1]["im"].numpy())
    if multiview:
        bank = shape_bank.RenderBank.from_arrays(*ds_bank.build_render_bank(), "cpu")
    else:
        bank = shape_bank.ShapeBank.from_arrays(*ds_bank.build_shape_bank(), N_VERTICES, "cpu")
    return out[0], out[1], bank


def _small_teacher(shape="PointCloud"):
    kw = dict(view_num=VIEW_NUM) if shape == "MultiView" else {}
    return PoseEstimator(shape=shape, img_feature_dim=16, shape_feature_dim=8,
                         generator=torch.Generator().manual_seed(3), **kw)


def test_kd_crd_step_with_a_bank_at_the_full_subset_equals_host_clouds(fixture_dir):
    """JAX's tests/test_shape_bank.py:120 for the port: 64 of 64 vertices,
    --device_views, the frozen teacher's eval PointNet sees the same point
    set in another order."""
    keys = ("im", "label", "label_flip", "label_rot", "rot_sign")
    host, dev, bank = _batches(fixture_dir, "contrast_views", keys)
    teacher = _small_teacher().eval().requires_grad_(False)
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM, generator=torch.Generator().manual_seed(4))
    metrics = []
    for batch, b in ((host, None), (dev, bank)):
        state = create_train_state(copy.deepcopy(student), LR, [100], seed=0)
        step = steps.make_kd_crd_step(device_views=True, shape_bank=b)
        metrics.append(step(state, teacher, batch))
    for key in ("loss", "gt_loss"):
        assert float(metrics[1][key]) == pytest.approx(float(metrics[0][key]), rel=2e-5)
    assert np.isfinite(float(metrics[1]["loss"]))


def test_stage1_step_with_a_bank_at_the_full_subset_equals_host_clouds(fixture_dir):
    """The vanilla teacher's train-mode PointNet over the same point set in
    another order, both models in f64."""
    host, dev, bank = _batches(fixture_dir, "pascal_bank", ("im", "label"))
    teacher = PoseEstimatorVanilla(img_feature_dim=16, shape_feature_dim=8,
                                   generator=torch.Generator().manual_seed(5)).double()
    student = BaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                input_dim=INPUT_DIM,
                                generator=torch.Generator().manual_seed(6)).double()
    metrics = []
    for batch, b in ((host, None), (dev, bank)):
        t_state = create_train_state(copy.deepcopy(teacher), LR, [100], seed=1)
        s_state = create_train_state(copy.deepcopy(student), LR, [100], seed=2)
        batch = dict(batch, im=batch["im"].double())
        if b is None:
            batch["shape"] = batch["shape"].double()
        metrics.append(steps.make_stage1_step(shape_bank=b)(t_state, s_state, batch))
    for key in ("loss", "teacher_loss"):
        assert float(metrics[1][key]) == pytest.approx(float(metrics[0][key]), rel=2e-5)


def test_multiview_teacher_step_and_evaluation_with_a_render_bank_equal_host(fixture_dir):
    """The RenderBank's renders are the host path's bit for bit: the
    teacher's step (with --device_augment's draws from one generator seed
    on both) and its evaluation give the same numbers."""
    host, dev, bank = _batches(fixture_dir, "contrast_raw_render_bank", ("im", "label"))
    assert host["im"].dtype == torch.uint8
    np.testing.assert_array_equal(host["shape"].numpy(), shape_bank.gather_renders(
        bank, dev["shape_id"], dev["shape_mut"]).numpy())
    model = _small_teacher("MultiView")
    results = []
    for batch, b in ((host, None), (dev, bank)):
        state = create_train_state(copy.deepcopy(model), LR, [100], seed=0)
        m = steps.make_teacher_train_step(device_augment=True, shape_bank=b)(state, batch)
        results.append((m, {k: p.grad for k, p in state.model.named_parameters()}))
    for key in ("loss", "pose_loss", "nce_loss"):
        assert float(results[1][0][key]) == float(results[0][0][key]), key
    for k, g in results[0][1].items():
        assert torch.equal(results[1][1][k], g), k

    evals = []
    for device_shapes in (False, True):  # the bank of the evaluation set's models
        ds = datasets.Pascal3DContrast(str(fixture_dir), "ObjectNet3D.txt", train=False,
                                       shape="MultiView", shape_dir="Renders_semi_sphere",
                                       input_dim=INPUT_DIM, view_num=VIEW_NUM,
                                       cat_choice=OBJECTNET3D_TEST_CATS,
                                       device_shapes=device_shapes)
        bank = shape_bank.RenderBank.from_arrays(*ds.build_render_bank(), "cpu")
        step = steps.make_eval_step(model.eval(), "teacher",
                                    shape_bank=bank if device_shapes else None)
        evals.append(evaluate_categories(step, DataLoader(ds, 3, shuffle=False, num_workers=0),
                                         ds.category_names, "cpu"))
    np.testing.assert_array_equal(evals[1].predictions, evals[0].predictions)
    assert evals[1].val_loss == evals[0].val_loss
    assert evals[1].val_nce_loss == evals[0].val_nce_loss


def _device_views_batch():
    """One raw u8 view a sample, rot_sign, the three labels, clouds and a
    padded last row."""
    rng = np.random.default_rng(32)
    batch = {"im": rng.integers(0, 256, (BATCH, INPUT_DIM, INPUT_DIM, 3), dtype=np.uint8),
             "rot_sign": np.array([1.0, -1.0, -1.0, 1.0], np.float32)[:BATCH]}
    for view in ("", "_flip", "_rot"):
        batch["label" + view] = chip_smoke.random_labels(rng, BATCH)
    extent = rng.uniform(0.2, 1.0, (BATCH, 1, 3))
    batch["shape"] = (rng.uniform(0, 1, (BATCH, 100, 3)) * extent).astype(np.float32)
    batch["valid"] = np.arange(BATCH) < BATCH - 1
    return batch


@functools.cache
def _jax_device_views_step():
    """JAX's make_kd_crd_step(device_views=True) on the student in f64, the
    teacher in f32, plain SGD at lr 1 (the parameters' change is the
    gradient); and the augmentation's draws as its step takes them: the
    state's key split for the step, that split again for the
    augmentation, then `device_augment`'s six."""
    svars = _student_variables(13)
    tvars = chip_smoke.teacher_variables(np.random.default_rng(14), TEACHER_DIM, TEACHER_DIM)
    batch = _device_views_batch()
    with jax.enable_x64(True):
        student = JaxBaselineEstimator(img_feature_dim=STUDENT_DIM, width_mult=WIDTH_MULT,
                                       dropout_rate=0.0, dtype=jnp.float64)
        teacher = JaxPoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), svars["params"])
        stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       svars["batch_stats"])
        tx = optax.sgd(1.0)
        key = jax.random.key(0)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params), rng=key, tx=tx)
        step = jax.jit(jsteps.make_kd_crd_step(student, teacher, 15, 1.0, device_views=True))
        new_state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, tvars),
                                  {k: jnp.asarray(v) for k, v in batch.items()})
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params, new_state.params)
        step_key = jax.random.split(key)[0]
        draws = jax.device_get(_jax_draws(jax.random.split(step_key)[1], 3 * BATCH))
        metrics = {k: float(v) for k, v in metrics.items()}
    return svars, tvars, metrics, grads, draws


def test_kd_crd_step_with_device_views_and_jax_draws_matches_jax():
    svars, tvars, want_metrics, want_grads, draws = _jax_device_views_step()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _device_views_batch().items()}
    student = _port_student(svars).double()
    state = create_train_state(student, LR, [100], seed=0)
    teacher = PoseEstimator(img_feature_dim=TEACHER_DIM, shape_feature_dim=TEACHER_DIM)
    teacher.load_state_dict(convert.pose_state_dict(tvars), strict=True)
    teacher.requires_grad_(False)
    metrics = steps.make_kd_crd_step(device_views=True)(state, teacher, batch,
                                                        aug=_port_draws(draws))
    for key in ("loss", "gt_loss"):
        assert float(metrics[key]) == pytest.approx(want_metrics[key], rel=1e-5), key
    assert float(metrics["acc_rot"]) == pytest.approx(want_metrics["acc_rot"], abs=1e-4)
    want_grads = convert.baseline_state_dict({"params": want_grads,
                                              "batch_stats": svars["batch_stats"]})
    grads = {name: p.grad for name, p in student.named_parameters()}
    largest = max(float(want_grads[k].abs().max()) for k in grads)
    for name, got in grads.items():
        want = want_grads[name].double()
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN
            assert float(got.abs().max()) < 1e-6 * largest, name
        else:
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
    # without the draws given, they come from the state's generator
    state2 = create_train_state(_port_student(svars).double(), LR, [100], seed=0)
    assert np.isfinite(float(steps.make_kd_crd_step(device_views=True)(state2, teacher,
                                                                       batch)["loss"]))
