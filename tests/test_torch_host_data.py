"""The port's host data options against the JAX package, on the CPU:
the decoded-image cache (`data/decode_cache.py`, `decode_cache_mb` on the
datasets), the shared-memory process loader (`data/shm_loader.py`), the
native PLY reader (`csrc/ply_reader.cpp` through `data/ply.py`), the
trainers' `Prefetcher` over recycled buffers and `--profile_dir`
(`train/trainer.py StepProfiler`), and the CLIs with `--loader shm`,
`--cache_decoded_mb` and `--profile_dir`.

Samples: every dataset class with the cache gives the samples of the same
class without it and of JAX's with it, seed for seed, over two epochs, on
JAX's generated fixtures (`pose3d_tpu/data/synthetic.py`); a planted
in-place paste into a cached image fails that test. Batches:
`ShmDataLoader` with two workers equals the port's thread `DataLoader` and
JAX's loader bit for bit.
"""

import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from pose3d_tpu.data import datasets as jdatasets
from pose3d_tpu.data import loader as jloader
from pose3d_tpu.data import ply as jply
from pose3d_tpu.data import synthetic
from pose3d_tpu.data.annotations import (LINEMOD_TEST_CATS, OBJECTNET3D_TEST_CATS,
                                         PIX3D_TEST_CATS)
from pose3d_tpu_torch.cli import testing, training, trainingKD
from pose3d_tpu_torch.data import datasets, decode_cache, ply, shm_loader
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.train import trainer as trainer_lib
import torch_host_data_cases as cases
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

TESTS = pathlib.Path(__file__).resolve().parent
CATS = ("bed", "bookshelf", "calculator")
VIEW_NUM, RENDER, INPUT_DIM, POINT_NUM = 4, 24, 32, 50
CACHE_MB = 64.0


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_host_data")
    data = root / "data"
    synthetic.make_objectnet3d_fixture(str(data / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=6, n_val_per_cat=2, image_size=48,
                                       with_renders=True, render_size=RENDER)
    synthetic.make_objectnet3d_fixture(str(data / "Pascal3D"), categories=("bus", "car"),
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48,
                                       with_renders=True, render_size=RENDER,
                                       dataset_name="Pascal3D")
    synthetic.make_linemod_fixture(str(data / "LineMod"))
    synthetic.make_shapenet_fixture(str(data / "ShapeNetCore"), str(data / "SUN"),
                                    image_size=240, with_shape_renders=True,
                                    shape_render_size=RENDER)
    synthetic.make_pix3d_eval_fixture(str(data / "Pix3D"))
    synthetic.make_pix3d_fixture(str(root / "test_data" / "Pix3D"), n_per_cat=6)
    return root


def _kwargs(fixture_dir, kind):
    """(port class, JAX class, constructor kwargs) of each dataset kind."""
    data = fixture_dir / "data"
    mv = dict(shape="MultiView", shape_dir="Renders_semi_sphere", view_num=VIEW_NUM, tour=2,
              input_dim=INPUT_DIM)
    on3d = dict(root_dir=str(data / "ObjectNet3D"), annotation_file="ObjectNet3D.txt")
    if kind == "pascal3d_train":
        return datasets.Pascal3D, jdatasets.Pascal3D, dict(
            root_dir=str(data / "Pascal3D"), annotation_file="Pascal3D.txt", train=True,
            random=True, random_range=1, **mv)
    if kind == "pascal3d_val_cloud":
        return datasets.Pascal3D, jdatasets.Pascal3D, dict(
            train=False, shape="PointCloud", shape_dir="pointcloud", point_num=POINT_NUM,
            input_dim=INPUT_DIM, cat_choice=OBJECTNET3D_TEST_CATS, **on3d)
    if kind == "contrast_train":
        return datasets.Pascal3DContrast, jdatasets.Pascal3DContrast, dict(
            train=True, cat_choice=OBJECTNET3D_TEST_CATS, keypoint=False, seed=46, **mv,
            **on3d)
    if kind == "contrast_train_cloud":
        return datasets.Pascal3DContrast, jdatasets.Pascal3DContrast, dict(
            train=True, cat_choice=OBJECTNET3D_TEST_CATS, seed=46, shape="PointCloud",
            shape_dir="pointcloud", point_num=POINT_NUM, input_dim=INPUT_DIM, **on3d)
    if kind == "shapenet_train":
        return datasets.ShapeNet, jdatasets.ShapeNet, dict(
            root_dir=str(data / "ShapeNetCore"), annotation_file="ShapeNetCore.txt",
            bg_dir=str(data / "SUN"), train=True, random=True, random_range=2,
            shape="MultiView", view_num=VIEW_NUM, tour=2)
    if kind == "pix3d":
        return datasets.Pix3D, jdatasets.Pix3D, dict(
            root_dir=str(data / "Pix3D"), annotation_file="Pix3D.txt", input_dim=INPUT_DIM,
            cat_choice=PIX3D_TEST_CATS)
    if kind == "linemod":
        return datasets.Linemod, jdatasets.Linemod, dict(
            root_dir=str(data / "LineMod"), annotation_file="LineMod.txt",
            input_dim=INPUT_DIM, cat_choice=LINEMOD_TEST_CATS)
    assert kind == "pix3d_contrast_train"
    return datasets.Pix3DContrast, jdatasets.Pix3DContrast, dict(
        root_dir=str(fixture_dir / "test_data" / "Pix3D"), annotation_file="Pix3D.txt",
        train=True, input_dim=INPUT_DIM, offset=10, rot=10, pose_batch=True, bs=4, seed=3)


KINDS = ["pascal3d_train", "pascal3d_val_cloud", "contrast_train", "contrast_train_cloud",
         "shapenet_train", "pix3d", "linemod", "pix3d_contrast_train"]


def _assert_same(got, want, where):
    assert set(got) == set(want), where
    for key in want:
        assert got[key].dtype == want[key].dtype, f"{where} {key}"
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where} {key}")


def _epochs_equal(cached, plain, jcached, epochs=2):
    """Every sample of `cached` equals `plain`'s and `jcached`'s from the
    same (46, epoch, index) seed; the cache's stats after each epoch."""
    stats = []
    for epoch in range(epochs):
        for i in range(len(plain)):
            seed = (46, epoch, i)
            want = plain.get(i, np.random.default_rng(seed))
            _assert_same(cached.get(i, np.random.default_rng(seed)), want, (epoch, i))
            _assert_same(jcached.get(i, np.random.default_rng(seed)), want, (epoch, i))
        stats.append(cached.cache.stats())
    return stats


@pytest.mark.parametrize("kind", KINDS)
def test_cached_samples_equal_uncached_and_jax(fixture_dir, kind):
    """Each dataset class with decode_cache_mb gives the samples of the
    same class without it and of JAX's with it, over two epochs; the
    second epoch hits the cache."""
    cls, jcls, kw = _kwargs(fixture_dir, kind)
    cached, plain = cls(**kw, decode_cache_mb=CACHE_MB), cls(**kw)
    jcached = jcls(**kw, decode_cache_mb=CACHE_MB)
    assert isinstance(plain.cache, decode_cache._NoCache)
    stats = _epochs_equal(cached, plain, jcached)
    assert stats[1]["hits"] > stats[0]["hits"]
    assert stats[1] == jcached.cache.stats()


def test_in_place_paste_into_a_cached_image_fails(fixture_dir, monkeypatch):
    """The planted fault: ShapeNet pastes its render into the background
    without copying it first (a cached image changed in place): the samples
    with the cache then differ from those without it."""
    cls, jcls, kw = _kwargs(fixture_dir, "shapenet_train")
    cached, plain = cls(**kw, decode_cache_mb=CACHE_MB), cls(**kw)
    jcached = jcls(**kw, decode_cache_mb=CACHE_MB)
    monkeypatch.setattr(Image.Image, "copy", lambda self: self)
    with pytest.raises(AssertionError):
        _epochs_equal(cached, plain, jcached)


def test_cache_evicts_to_its_budget_and_serves_large_images_uncached(fixture_dir):
    cls, _, kw = _kwargs(fixture_dir, "linemod")
    one = 96 * 96 * 3 / (1 << 20)  # LineMod's fixture images: 96 x 96 RGB
    small = cls(**kw, decode_cache_mb=2.5 * one)
    plain = cls(**kw)
    for epoch in range(2):
        for i in range(len(plain)):
            seed = (46, epoch, i)
            _assert_same(small.get(i, np.random.default_rng(seed)),
                         plain.get(i, np.random.default_rng(seed)), (epoch, i))
            stats = small.cache.stats()
            assert stats["items"] <= 2 and stats["mb"] <= 2.5 * one + 1e-9
    assert small.cache.stats()["hits"] == 0  # a ring of 8 through 2 slots: all evicted
    tiny = cls(**kw, decode_cache_mb=0.5 * one)
    tiny.get(0, np.random.default_rng(0))
    assert tiny.cache.stats() == {"items": 0, "mb": 0.0, "hits": 0, "misses": 1}


def test_cache_pickles_empty_and_is_thread_safe(fixture_dir):
    """The cache pickles empty (its budget kept, shared by the renders);
    16 threads (more than the cores) reading through one cache, with the
    interpreter switching threads every microsecond, get the uncached
    samples, and the cache's counts and bytes stay exact."""
    cls, _, kw = _kwargs(fixture_dir, "pascal3d_train")
    ds = cls(**kw, decode_cache_mb=CACHE_MB)
    ds.get(0, np.random.default_rng(0))
    assert ds.cache.stats()["items"] > 0
    copy = pickle.loads(pickle.dumps(ds))
    assert copy.cache.stats() == {"items": 0, "mb": 0.0, "hits": 0, "misses": 0}
    assert copy.cache.capacity_mb == CACHE_MB and copy.renders.cache is copy.cache
    n = 64
    want = [cls(**kw).get(i % len(ds), np.random.default_rng(i)) for i in range(n)]
    got = [None] * n

    def run(k):
        for i in range(k, n, 16):
            got[i] = copy.get(i % len(ds), np.random.default_rng(i))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i in range(n):
        _assert_same(got[i], want[i], i)
    stats = copy.cache.stats()
    assert stats["hits"] + stats["misses"] == n * (1 + VIEW_NUM)  # the image and its renders
    assert copy.cache._bytes == sum(decode_cache._nbytes(im)
                                    for im in copy.cache._items.values())


# --- the shared-memory loader --------------------------------------------------------

def _contrast_cloud(fixture_dir, **extra):
    _, _, kw = _kwargs(fixture_dir, "contrast_train_cloud")
    return datasets.Pascal3DContrast(**kw, **extra)


def _segments(loader) -> list[str]:
    return [n for n in loader.names if os.path.exists(os.path.join(shm_loader.SHM_DIR, n))]


def _batches_equal(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, j)


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_shm_loader_equals_thread_and_jax_loaders(fixture_dir, shuffle, drop_last):
    """Two epochs of batches of 5 (a ragged tail padded, or dropped) from
    two workers with the cache on: the port's thread loader's and JAX's
    loader's, bit for bit; after close() no segment is left."""
    _, jcls, kw = _kwargs(fixture_dir, "contrast_train_cloud")
    ds = datasets.Pascal3DContrast(**kw, decode_cache_mb=CACHE_MB)
    jds = jcls(**kw)
    loader_kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7)
    want_loader = DataLoader(_contrast_cloud(fixture_dir), 5, num_workers=2, **loader_kw)
    jax_loader = jloader.DataLoader(jds, 5, num_workers=0, process_index=0,
                                    process_count=1, **loader_kw)
    with shm_loader.ShmDataLoader(ds, 5, num_workers=2, **loader_kw) as dl:
        for epoch in range(2):
            for ld in (dl, want_loader, jax_loader):
                ld.set_epoch(epoch)
            got = list(dl)
            _batches_equal(got, list(want_loader))
            _batches_equal(got, list(jax_loader))
            assert len(got) == len(dl) == len(want_loader)
            assert all(b["valid"].all() for b in got) == (drop_last or len(ds) % 5 == 0)
        names = list(dl.names)
        assert len(names) == dl.slots == 4 and _segments(dl) == names
        stats = dl.cache_stats()  # each worker's cache, hit from the second epoch on
        assert stats["hits"] > 0 and stats["items"] > 0
    assert _segments(dl) == []
    assert not any(p.is_alive() for p in dl._procs)


def test_shm_loader_zero_copy_abandoned_iteration_and_restart(fixture_dir):
    """Zero-copy batches consumed at once equal the thread loader's; an
    iteration abandoned after one batch leaves tasks in flight (the other
    batches' samples are slowed down), and the next iteration (the same
    epoch, then the next) still equals it."""
    ds = _contrast_cloud(fixture_dir)
    kw = dict(shuffle=True, seed=3)
    want = DataLoader(ds, 4, num_workers=0, **kw)
    slow = cases.SlowExcept(ds, want._indices()[:4].tolist(), 0.08)
    with shm_loader.ShmDataLoader(slow, 4, num_workers=2, copy=False, **kw) as dl:
        ref = list(want)
        for got, w in zip(dl, ref):  # consumed at once, as the contract says
            _assert_same({k: np.array(v) for k, v in got.items()}, w, "zero-copy")
        for _ in dl:
            break
        assert dl._outstanding > 0
        _batches_equal(_copies(dl), ref)
        dl.set_epoch(1)
        want.set_epoch(1)
        _batches_equal(_copies(dl), list(want))


def _copies(loader):
    return [{k: np.array(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("dataset,match", [(cases.BrokenDataset, "boom at sample 4"),
                                           (cases.DyingDataset, "exited with code 3")])
def test_shm_worker_error_propagates(dataset, match):
    """A worker's exception, or its death without a word, fails the
    iteration with its reason; the loader closes and leaves no segment."""
    dl = shm_loader.ShmDataLoader(dataset(), 4, shuffle=False, num_workers=2)
    with pytest.raises(RuntimeError, match=match):
        list(dl)
    assert dl._closed and _segments(dl) == []
    assert not any(p.is_alive() for p in dl._procs)


_MAIN_IMPORTS_TORCH = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch  # a main module that imports torch, as the CLIs' do
from pose3d_tpu_torch.data import datasets, shm_loader
import torch_host_data_cases as cases

if __name__ == "__main__":
    ds = cases.ModulesProbe(datasets.Pascal3DContrast(**{kw!r}))
    with shm_loader.ShmDataLoader(ds, 4, num_workers=2) as dl:
        print(sum(bool(b["torch"].any()) for b in dl), len(dl))
"""


def test_shm_worker_imports_no_torch(fixture_dir, tmp_path):
    """The workers unpickle a port dataset importing numpy, PIL and pandas
    only: neither torch nor JAX, which this process has imported; nor does
    spawn run a main module that imports torch again in them."""
    probe = cases.ModulesProbe(_contrast_cloud(fixture_dir, decode_cache_mb=CACHE_MB))
    with shm_loader.ShmDataLoader(probe, 4, num_workers=2) as dl:
        batches = list(dl)
    assert len(batches) == len(dl) > 1
    assert not any(b["torch"].any() or b["jax"].any() for b in batches)
    assert probe.get(0, np.random.default_rng(0))["torch"]
    script = tmp_path / "main_imports_torch.py"
    kw = _kwargs(fixture_dir, "contrast_train_cloud")[2]
    script.write_text(_MAIN_IMPORTS_TORCH.format(repo=str(TESTS.parent), tests=str(TESTS), kw=kw))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", str(len(dl))]


def test_shm_refuses_slots_that_do_not_fit(fixture_dir, monkeypatch):
    """The slots' bytes against the free space of /dev/shm: a set that does
    not fit is refused, naming both numbers, before any segment or worker
    exists."""
    ds = _contrast_cloud(fixture_dir)
    monkeypatch.setattr(shm_loader, "shm_free_bytes", lambda: (1 << 20, 64 << 20))
    dl = shm_loader.ShmDataLoader(ds, 8, num_workers=2)
    with pytest.raises(RuntimeError, match=r"4 slots of \d+ bytes .* need \d+ bytes of "
                                           r"/dev/shm, which has 1048576 bytes free"):
        iter(dl).__next__()
    assert not dl._started and dl.names == [] and not hasattr(dl, "_procs")


def test_shm_workers_start_on_entering_and_main_hidden_by_the_class():
    """Entering the loader starts its workers on the entering thread, before
    any iteration (a trainer's Prefetcher iterates it on a thread of its
    own). `__main__` is hidden while they start only on the main thread and
    only where the dataset's class is not defined in it: the string
    '__main__' in the dataset's data does not matter."""
    holder = cases.Holds("__main__")
    with shm_loader.ShmDataLoader(holder, 4, shuffle=False, num_workers=2) as dl:
        assert dl._started and [p.is_alive() for p in dl._procs] == [True, True]
        assert _segments(dl) == dl.names and len(dl.names) == 4
    assert _segments(dl) == [] and not any(p.is_alive() for p in dl._procs)
    assert b"__main__" in pickle.dumps(holder) and shm_loader._hides_main(holder)
    assert not shm_loader._hides_main(type("FromMain", (), {"__module__": "__main__"})())
    off_main = []
    thread = threading.Thread(target=lambda: off_main.append(shm_loader._hides_main(holder)))
    thread.start()
    thread.join()
    assert off_main == [False]


# --- the trainers' Prefetcher over recycled buffers -----------------------------------

class _RecyclingLoader:
    """Batches i = 0..n-1 with 'x' filled with i, all in one buffer that is
    overwritten when the next batch is asked for (the zero-copy slot's
    contract, at its tightest)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        buf = {"x": np.zeros((2, 3), np.float32), "valid": np.ones(2, bool)}
        for i in range(self.n):
            buf["x"][:] = i
            buf["valid"][:] = [True, i != self.n - 1]
            yield buf


def test_prefetcher_copies_each_batch_before_the_next(fixture_dir):
    """On the CPU the Prefetcher copies each batch (and its valid mask) out
    of the loader's arrays before it asks for the next: a recycled buffer
    and the zero-copy shm loader give the batches a copying loader gives,
    though every batch is held at once."""
    got = list(trainer_lib.Prefetcher(_RecyclingLoader(5), ("x",), torch.device("cpu")))
    for i, (db, valid) in enumerate(got):
        assert torch.equal(db["x"], torch.full((2, 3), float(i)))
        assert valid.tolist() == [True, i != 4]
        assert ("valid" in db) == (i == 4)
    ds = _contrast_cloud(fixture_dir)
    keys = ("im", "shape", "label", "im_flip", "label_flip", "im_rot", "label_rot")
    want = list(trainer_lib.Prefetcher(DataLoader(ds, 4, seed=5), keys, torch.device("cpu")))
    with shm_loader.ShmDataLoader(ds, 4, num_workers=2, seed=5, copy=False, slots=2) as dl:
        held = list(trainer_lib.Prefetcher(dl, keys, torch.device("cpu")))
    assert len(held) == len(want)
    for (g, gv), (w, wv) in zip(held, want):
        assert set(g) == set(w) and np.array_equal(gv, wv)
        for k in w:
            assert torch.equal(g[k], w[k]), k


# --- the native PLY reader ------------------------------------------------------------

def _ply(path, fmt, props, rows, n):
    header = (b"ply\nformat %s 1.0\nelement vertex %d\n" % (fmt.encode(), n)
              + b"".join(b"property %s %s\n" % (t.encode(), k.encode()) for k, t in props)
              + b"element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    path.write_bytes(header + rows)
    return str(path)


PLY_CASES = ["ascii", "binary_little_endian", "binary_big_endian", "doubles_xyz_not_first",
             "ascii_xyz_not_first", "signed_integers"]


@pytest.mark.parametrize("case", PLY_CASES)
def test_native_ply_reader_equals_numpy_and_jax(tmp_path, case):
    """The native reader's vertices equal the port's numpy reader's and
    JAX's `load_vertices`; it declines big-endian, which load_vertices then
    reads with numpy. Integer coordinates (ROADMAP Queue 3): the port reads
    them with their sign and type, where JAX's numpy reader takes a 4-byte
    int for float32 bits."""
    n = 101
    verts = np.random.default_rng(11).standard_normal((n, 3))
    if case == "signed_integers":
        verts = np.round(verts * 1000)
    if case == "ascii":
        path = str(tmp_path / "a.ply")
        jply.write_ply(path, verts.astype(np.float32), binary=False)
    elif case.startswith("binary"):
        end = "<" if case.endswith("little_endian") else ">"
        rows = verts.astype(end + "f4").tobytes()
        path = _ply(tmp_path / "b.ply", case, [(k, "float") for k in "xyz"], rows, n)
    elif case == "doubles_xyz_not_first":
        dt = np.dtype([("red", "u1"), ("nx", "<f4"), ("z", "<f8"), ("x", "<f8"),
                       ("y", "<f8"), ("s", "<i2")])
        rows = np.zeros(n, dt)
        rows["x"], rows["y"], rows["z"] = verts.T
        rows["red"], rows["s"] = 7, -3
        path = _ply(tmp_path / "d.ply", "binary_little_endian",
                    [("red", "uchar"), ("nx", "float"), ("z", "double"), ("x", "double"),
                     ("y", "double"), ("s", "short")], rows.tobytes(), n)
    elif case == "signed_integers":
        dt = np.dtype([("x", "<i4"), ("y", "<i2"), ("z", "<i4")])
        rows = np.zeros(n, dt)
        rows["x"], rows["y"], rows["z"] = verts.T
        path = _ply(tmp_path / "i.ply", "binary_little_endian",
                    [("x", "int"), ("y", "short"), ("z", "int")], rows.tobytes(), n)
    else:
        lines = "".join("%d %.17g %.17g %.17g\n" % (i, z, y, x)
                        for i, (x, y, z) in enumerate(verts))
        path = _ply(tmp_path / "c.ply", "ascii", [("i", "int"), ("z", "double"),
                                                   ("y", "double"), ("x", "double")],
                    lines.encode(), n)
    native = ply.read_native(path)
    got = ply.load_vertices(path, cache=False)
    np.testing.assert_array_equal(got, ply.read_numpy(path))
    if case == "signed_integers":
        assert not np.array_equal(got, jply._load_numpy(path))
    else:
        np.testing.assert_array_equal(got, jply.load_vertices(path, cache=False))
    assert got.dtype == np.float32 and got.shape == (n, 3)
    if case == "binary_big_endian":
        assert native is None
    else:
        np.testing.assert_array_equal(native, got)
        np.testing.assert_array_equal(got, verts.astype(np.float32))


def test_ply_readers_refuse_a_vertex_element_not_first(tmp_path):
    path = tmp_path / "f.ply"
    path.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement face 1\n"
                     b"property uchar c\nelement vertex 2\nproperty float x\n"
                     b"property float y\nproperty float z\nend_header\n"
                     + np.zeros(1, np.uint8).tobytes() + np.ones(6, "<f4").tobytes())
    assert ply.read_native(str(path)) is None
    with pytest.raises(ValueError, match="vertex element must come first"):
        ply.load_vertices(str(path), cache=False)


def test_native_ply_reader_without_a_compiler_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "a.ply")
    jply.write_ply(path, np.zeros((3, 3), np.float32))
    monkeypatch.setattr(ply, "_native", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        ply.load_vertices(path, cache=False)


def test_host_library_name_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    src = tmp_path / "r.cpp"
    src.write_text("// one\n")
    first = _build.host_library_path("r")
    assert first == _build.host_library_path("r") and first.endswith(".so")
    src.write_text("// two\n")
    assert _build.host_library_path("r") != first


# --- the CLIs -------------------------------------------------------------------------

BASELINE = ["--dataset", "ObjectNet3D", "--shape", "None", "--batch_size", "1",
            "--workers", "2", "--input_dim", "32", "--img_feature_dim", "16",
            "--student_width_mult", "0.25", "--decrease", "1", "--device", "cpu"]


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _trace_names(path: str) -> set[str]:
    """The names of a chrome trace's events (ops, annotations, kernels)."""
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f).get("traceEvents", [])}


def test_training_cli_profile_dir_writes_one_trace_of_steps_5_to_14(fixture_dir, tmp_path,
                                                                    monkeypatch):
    """--profile_dir (the baseline's epoch of 18 steps of batch 1): one
    trace, of steps 5-14, each in its "step i" annotation; the same run
    without it writes none. --loader shm with --cache_decoded_mb gives the
    thread loader's losses exactly, and leaves no segment."""
    monkeypatch.chdir(tmp_path)
    flags = BASELINE + ["--data_root", str(fixture_dir / "data"), "--n_epoch", "1"]
    training.main(flags + ["--profile_dir", str(tmp_path / "trace"), "--loader", "shm",
                           "--cache_decoded_mb", "64", "--result_dir", "shm"])
    traces = os.listdir(tmp_path / "trace")
    assert traces == ["student_steps5-14.pt.trace.json"]
    names = _trace_names(str(tmp_path / "trace" / traces[0]))
    assert {f"step {i}" for i in range(5, 15)} <= names
    assert not names & {"step 4", "step 15"}
    training.main(flags + ["--result_dir", "thread"])
    assert not os.path.exists(tmp_path / "thread" / "trace")
    shm = _records(tmp_path / "shm" / "baseline_ObjectNet3D")
    thread = _records(tmp_path / "thread" / "baseline_ObjectNet3D")
    assert [r["train_samples"] for r in shm] == [18]
    for key in ("train_loss", "train_acc", "val_loss", "val_acc", "val_med"):
        assert [r[key] for r in shm] == [r[key] for r in thread], key
    assert not [n for n in os.listdir(shm_loader.SHM_DIR)
                if n.startswith(f"{shm_loader.SHM_PREFIX}_{os.getpid()}_")]
    for run in ("shm", "thread"):  # 0.2 GB of checkpoints each, off the disk
        shutil.rmtree(tmp_path / run)


def test_step_profiler_stops_when_a_step_raises(tmp_path):
    """The trainers' loop shape: a step that raises inside the window ends
    the trace (steps 5-7 written) and leaves no profiler running."""
    prof = trainer_lib.StepProfiler(str(tmp_path / "trace"), "x", torch.device("cpu"))
    with pytest.raises(ValueError, match="step 7"):
        try:
            for i in range(12):
                with prof.step(i):
                    if i == 7:
                        raise ValueError("step 7")
        finally:
            prof.stop()
    assert not torch.autograd._profiler_enabled()
    assert os.listdir(tmp_path / "trace") == ["x_steps5-7.pt.trace.json"]


def test_kd_and_testing_clis_take_the_host_options(fixture_dir, tmp_path, monkeypatch):
    """KD --stage 1 (the vanilla teacher's PointNet over clouds from the
    native reader) with --loader shm, --cache_decoded_mb and --profile_dir:
    its epoch of 9 steps ends before step 15, so its trace holds steps
    5-8. Testing with --cache_decoded_mb and --loader shm equals testing
    without."""
    monkeypatch.chdir(tmp_path)
    flags = ["--stage", "1", "--dataset", "ObjectNet3D", "--shape", "PointCloud",
             "--shape_dir", "pointcloud", "--data_root", str(fixture_dir / "data"),
             "--batch_size", "2", "--workers", "2", "--input_dim", "32", "--point_num",
             str(POINT_NUM), "--img_feature_dim", "16", "--shape_feature_dim", "16",
             "--student_feature_dim", "16", "--student_width_mult", "0.25", "--n_epoch", "1",
             "--decrease", "1", "--device", "cpu"]
    trainingKD.main(flags + ["--loader", "shm", "--cache_decoded_mb", "64", "--profile_dir",
                             str(tmp_path / "trace"), "--result_dir", "shm"])
    assert os.listdir(tmp_path / "trace") == ["stage1_steps5-8.pt.trace.json"]
    names = _trace_names(str(tmp_path / "trace" / "stage1_steps5-8.pt.trace.json"))
    assert {f"step {i}" for i in range(5, 9)} <= names and "step 4" not in names
    (record,) = _records(tmp_path / "shm" / "KD_ObjectNet3D")
    assert record["train_samples"] == 18 and np.isfinite(record["train_loss"])
    shutil.rmtree(tmp_path / "shm")  # 0.36 GB of checkpoints, off the disk
    test_flags = ["--dataset", "ObjectNet3D", "--shape", "None", "--data_root",
                  str(fixture_dir / "data"), "--input_dim", "32", "--img_feature_dim", "16",
                  "--student_width_mult", "0.25", "--batch_size", "4", "--device", "cpu"]
    plain = testing.main(test_flags + ["--output_dir", str(tmp_path / "p")])
    cached = testing.main(test_flags + ["--output_dir", str(tmp_path / "c"), "--loader", "shm",
                                        "--cache_decoded_mb", "64"])
    np.testing.assert_array_equal(cached.predictions, plain.predictions)
    np.testing.assert_array_equal(cached.errors, plain.errors)
