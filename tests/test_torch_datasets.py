"""The port's render data path and its remaining datasets against the JAX
package, on the CPU, and the MultiView, LineMod, Pix3D and ShapeNetCore
paths of the CLIs on generated fixtures.

Samples: the same seed gives the same samples, every array equal, on JAX's
generated fixtures (`pose3d_tpu/data/synthetic.py`; JAX's decode cache
off): Pascal3D and Pascal3DContrast with their renders (train with
`random` at each `random_range`, validation; renders resized to
`input_dim`, or at 224 kept at the files' own size), ShapeNet without and
with its renders (train with `random`, validation; backgrounds the size of
the render and not, so that the white fallback and the zero-padded crop
are taken), Pix3D, Linemod and Pix3DContrast (train with `pose_batch`,
validation). `test_normalised_renders_fail` plants the likeliest fault
(renders ImageNet-normalised as images are) and shows that the sample test
fails on it.

The CLIs run on the fixtures at small width (ResNet-18 over 4 views of
24x24 renders resized to 32, feature 16; ResNet-50 at 32x32, feature 32;
the student at width 0.25): the MultiView teacher's training one epoch and
--resume, its testing (also under --bf16) and single-image inference; KD --crd from it; KD
--stage 1 with the MultiView vanilla teacher, then --stage 2 from its
checkpoint; the testing CLI on LineMod and Pix3D; the RGB-only baseline on
ShapeNetCore, validated on Pix3D. Their numbers are held by the module and
step tests (tests/test_torch_multiview.py); here: the runs end, their
files, epochs, steps and finite metrics.
"""

import json
import os

import numpy as np
import pytest
import torch

from pose3d_tpu.data import datasets as jdatasets
from pose3d_tpu.data import synthetic
from pose3d_tpu.data.annotations import (LINEMOD_TEST_CATS, OBJECTNET3D_TEST_CATS,
                                         PIX3D_TEST_CATS)
from pose3d_tpu_torch.cli import inference, testing, training, trainingKD
from pose3d_tpu_torch.data import datasets
from pose3d_tpu_torch.data import transforms as T
from pose3d_tpu_torch.models.estimators import PoseEstimator, PoseEstimatorVanilla
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

CATS = ("bed", "bookshelf", "calculator")
VIEW_NUM, RENDER, INPUT_DIM = 4, 24, 32
SHAPE_DIM, IMG_DIM, STUDENT_DIM, WIDTH_MULT = 16, 32, 32, 0.25


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_datasets")
    data = root / "data"
    synthetic.make_objectnet3d_fixture(str(data / "ObjectNet3D"), categories=CATS,
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48,
                                       with_renders=True, render_size=RENDER)
    synthetic.make_objectnet3d_fixture(str(data / "Pascal3D"), categories=("bus", "car"),
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48,
                                       with_renders=True, render_size=RENDER,
                                       dataset_name="Pascal3D")
    synthetic.make_linemod_fixture(str(data / "LineMod"))
    # ShapeNetCore trains on renders at 240 (cropped to 224) over SUN
    # backgrounds of their size, and validates on plain Pix3D
    synthetic.make_shapenet_fixture(str(data / "ShapeNetCore"), str(data / "SUN"),
                                    image_size=240, with_shape_renders=True,
                                    shape_render_size=RENDER)
    synthetic.make_pix3d_eval_fixture(str(data / "Pix3D"))
    # renders smaller than the crop, over backgrounds of another size
    synthetic.make_shapenet_fixture(str(root / "small" / "ShapeNetCore"),
                                    str(root / "small" / "SUN"), image_size=96,
                                    with_shape_renders=True, shape_render_size=RENDER)
    (root / "small" / "SUN" / "bg" / "bg_1.jpg").unlink()  # a missing background
    # the Pix3DContrast layout, which the testing CLI reads
    synthetic.make_pix3d_fixture(str(root / "test_data" / "Pix3D"), n_per_cat=6)
    return root


def _same_samples(ds, jds, seeds=(46, 1)):
    """Every sample of `ds` equals `jds`'s from the same seed."""
    assert len(ds) == len(jds) > 0 and list(ds.category_names) == list(jds.category_names)
    for i in range(len(ds)):
        want = jds.get(i, np.random.default_rng((*seeds, i)))
        got = ds.get(i, np.random.default_rng((*seeds, i)))
        assert set(got) == set(want), i
        for key in want:
            assert got[key].dtype == want[key].dtype, f"{i} {key}"
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")


PASCAL_KINDS = ["train_random0", "train_random1", "train_random2", "val", "contrast_train",
                "contrast_val", "contrast_val_224"]


def _pascal_pair(fixture_dir, kind):
    common = dict(shape="MultiView", shape_dir="Renders_semi_sphere", view_num=VIEW_NUM,
                  tour=2, input_dim=224 if kind.endswith("224") else INPUT_DIM)
    if kind.startswith("contrast"):
        root, name = str(fixture_dir / "data" / "ObjectNet3D"), "ObjectNet3D.txt"
        kw = dict(train=kind == "contrast_train", cat_choice=OBJECTNET3D_TEST_CATS,
                  keypoint=False, seed=46, **common)
        return datasets.Pascal3DContrast(root, name, **kw), jdatasets.Pascal3DContrast(
            root, name, **kw)
    root, name = str(fixture_dir / "data" / "Pascal3D"), "Pascal3D.txt"
    train = kind.startswith("train")
    kw = dict(train=train, random=train, random_range=int(kind[-1]) if train else 0, **common)
    return datasets.Pascal3D(root, name, **kw), jdatasets.Pascal3D(root, name, **kw)


@pytest.mark.parametrize("kind", PASCAL_KINDS)
def test_pascal_render_samples_match_jax(fixture_dir, kind):
    """Pascal3D (train with random at random_range 0 / 1 / 2: the ring
    rolled and the azimuth label turned with it; validation) and
    Pascal3DContrast (train; validation, at 32 with the renders resized and
    at 224 with the files' own 24x24 kept) with their renders."""
    ds, jds = _pascal_pair(fixture_dir, kind)
    _same_samples(ds, jds)
    sample = ds.get(0, np.random.default_rng(0))
    size = RENDER if kind.endswith("224") else INPUT_DIM
    assert sample["shape"].shape == (VIEW_NUM, size, size, 3)
    assert 0.0 <= sample["shape"].min() and sample["shape"].max() <= 1.0


def test_normalised_renders_fail(fixture_dir, monkeypatch):
    """The planted fault: renders ImageNet-normalised as the images are
    fail the sample test."""
    load = datasets._Renders.load
    monkeypatch.setattr(datasets._Renders, "load",
                        lambda self, *a: T.normalize_image(load(self, *a)))
    with pytest.raises(AssertionError):
        _same_samples(*_pascal_pair(fixture_dir, "val"))


@pytest.mark.parametrize("shape", [None, "MultiView"])
@pytest.mark.parametrize("split", ["train", "val", "train_small"])
def test_shapenet_samples_match_jax(fixture_dir, shape, split):
    """ShapeNet: the turned render pasted over a SUN background (white where
    the drawn one is missing or another size), blurred, flipped, jittered
    and cropped to 224 (centred, zero-padded where smaller, at validation);
    with renders, the ring rolled by `random` in training."""
    base = fixture_dir / ("small" if split == "train_small" else "data")
    kw = dict(root_dir=str(base / "ShapeNetCore"), annotation_file="ShapeNetCore.txt",
              bg_dir=str(base / "SUN"), train=split != "val", random=split != "val",
              random_range=2, shape=shape, view_num=VIEW_NUM, tour=2)
    ds, jds = datasets.ShapeNet(**kw), jdatasets.ShapeNet(**kw)
    _same_samples(ds, jds)
    assert ds.get(0, np.random.default_rng(0))["im"].shape == (224, 224, 3)


def test_pix3d_and_linemod_samples_match_jax(fixture_dir):
    """The evaluation-only sets: Pix3D (resized, its label units) and
    Linemod (the box resize-padded, its label units), each at 32 and 224."""
    data = fixture_dir / "data"
    for input_dim in (INPUT_DIM, 224):
        _same_samples(datasets.Pix3D(str(data / "Pix3D"), "Pix3D.txt", input_dim=input_dim,
                                     cat_choice=PIX3D_TEST_CATS),
                      jdatasets.Pix3D(str(data / "Pix3D"), "Pix3D.txt", input_dim=input_dim,
                                      cat_choice=PIX3D_TEST_CATS))
        _same_samples(datasets.Linemod(str(data / "LineMod"), "LineMod.txt",
                                       input_dim=input_dim, cat_choice=LINEMOD_TEST_CATS),
                      jdatasets.Linemod(str(data / "LineMod"), "LineMod.txt",
                                        input_dim=input_dim, cat_choice=LINEMOD_TEST_CATS))


@pytest.mark.parametrize("train", [True, False])
def test_pix3d_contrast_samples_match_jax(fixture_dir, train):
    """Pix3DContrast: train with the pose-balanced remap (batches of 4 from
    one 30-degree azimuth bucket each), the rotation at +-10 degrees and an
    offset; validation."""
    kw = dict(root_dir=str(fixture_dir / "test_data" / "Pix3D"), annotation_file="Pix3D.txt",
              train=train, input_dim=INPUT_DIM, offset=10 if train else 0, rot=10,
              pose_batch=train, bs=4, seed=3)
    ds, jds = datasets.Pix3DContrast(**kw), jdatasets.Pix3DContrast(**kw)
    _same_samples(ds, jds)
    if train:
        assert [ds._remap(i) for i in range(len(ds))] == [jds._remap(i) for i in range(len(ds))]


# --- the CLIs on the fixtures -------------------------------------------------------

MV_FLAGS = ["--dataset", "ObjectNet3D", "--shape", "MultiView",
            "--shape_dir", "Renders_semi_sphere", "--view_num", str(VIEW_NUM), "--tour", "2",
            "--batch_size", "4", "--workers", "2", "--input_dim", str(INPUT_DIM),
            "--img_feature_dim", str(IMG_DIM), "--shape_feature_dim", str(SHAPE_DIM),
            "--decrease", "1", "--device", "cpu"]
STUDENT_FLAGS = ["--student_feature_dim", str(STUDENT_DIM),
                 "--student_width_mult", str(WIDTH_MULT)]


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def mv_teacher(fixture_dir):
    """The MultiView teacher's training CLI, one epoch (--fused_nce), then
    --resume into a second: its checkpoint.pth."""
    cwd = os.getcwd()
    os.chdir(fixture_dir)
    try:
        flags = MV_FLAGS + ["--data_root", str(fixture_dir / "data"), "--fused_nce"]
        training.main(flags + ["--n_epoch", "1"])
        training.main(flags + ["--n_epoch", "2", "--resume"])
    finally:
        os.chdir(cwd)
    return fixture_dir / "result" / "MultiView_ObjectNet3D"


def test_multiview_teacher_training_resume_testing_and_inference(fixture_dir, mv_teacher,
                                                                 tmp_path):
    run = mv_teacher
    assert [r["epoch"] for r in _records(run)] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_nce"])
               for r in _records(run))
    assert (run / "ckpt" / "EPOCH").read_text() == "1"
    saved = torch.load(run / "ckpt" / "checkpoint.pth", weights_only=True)
    assert saved["step"] == 4  # two epochs of two steps (9 train samples, batch 4)
    model = PoseEstimator(shape="MultiView", view_num=VIEW_NUM, img_feature_dim=IMG_DIM,
                          shape_feature_dim=SHAPE_DIM)
    model.load_state_dict(saved["model"], strict=True)

    result = testing.main(MV_FLAGS[:-6] + ["--img_feature_dim", str(IMG_DIM),
                                           "--shape_feature_dim", str(SHAPE_DIM),
                                           "--data_root", str(fixture_dir / "data"),
                                           "--model", str(run / "ckpt" / "checkpoint.pth"),
                                           "--device", "cpu",
                                           "--output_dir", str(fixture_dir / "mv_preds")])
    assert len(result.cat_ids) == 6 and np.isfinite(result.sample_med)
    assert np.isfinite(result.val_nce_loss)
    result16 = testing.main(MV_FLAGS[:-6] + ["--img_feature_dim", str(IMG_DIM),
                                             "--shape_feature_dim", str(SHAPE_DIM),
                                             "--data_root", str(fixture_dir / "data"),
                                             "--model", str(run / "ckpt" / "checkpoint.pth"),
                                             "--device", "cpu", "--bf16",
                                             "--output_dir", str(fixture_dir / "mv_preds16")])
    assert len(result16.cat_ids) == 6 and np.isfinite(result16.sample_med)

    crop = fixture_dir / "data" / "ObjectNet3D" / "Renders_semi_sphere" / "bed" / "01" / "crop"
    vp = inference.main(["--ckpt", str(run / "ckpt" / "checkpoint.pth"),
                         "--img_path", str(fixture_dir / "data" / "ObjectNet3D" / "Images" /
                                           "bed_val_0.jpg"),
                         "--render_dir", str(crop), "--view_num", str(VIEW_NUM),
                         "--mutation", "5", "--input_dim", str(INPUT_DIM),
                         "--img_feature_dim", str(IMG_DIM),
                         "--shape_feature_dim", str(SHAPE_DIM), "--device", "cpu"])
    assert vp.shape == (3,) and np.all(np.isfinite(vp))
    renders = inference.load_renders(str(crop), VIEW_NUM, 2, 5, INPUT_DIM)
    assert renders.shape == (1, VIEW_NUM, INPUT_DIM, INPUT_DIM, 3)
    for name in sorted(os.listdir(crop))[:100]:  # a ring cut short: refused, as in JAX
        (tmp_path / name).write_bytes((crop / name).read_bytes())
    with pytest.raises(SystemExit, match="ring needs 109"):
        inference.load_renders(str(tmp_path), VIEW_NUM, 2, 0, INPUT_DIM)


def test_kd_crd_cli_from_the_multiview_teacher(fixture_dir, mv_teacher, monkeypatch):
    """KD --crd one epoch from the MultiView teacher's checkpoint.pth."""
    monkeypatch.chdir(fixture_dir)
    trainingKD.main(MV_FLAGS + STUDENT_FLAGS + [
        "--data_root", str(fixture_dir / "data"), "--crd", "--n_epoch", "1",
        "--result_dir", "result_crd",
        "--teacher_model", str(mv_teacher / "ckpt" / "checkpoint.pth")])
    run = fixture_dir / "result_crd" / "KD_ObjectNet3D"
    records = _records(run)
    assert [r["epoch"] for r in records] == [0] and records[0]["train_samples"] == 8
    assert np.isfinite(records[0]["train_loss"])


def test_stage1_then_stage2_cli_with_the_multiview_vanilla_teacher(fixture_dir, monkeypatch):
    """KD --stage 1 (--fused_nce) one epoch, the MultiView vanilla teacher
    trained with the student; then --stage 2 one epoch from its
    checkpoint.pth."""
    monkeypatch.chdir(fixture_dir)
    flags = MV_FLAGS + STUDENT_FLAGS + ["--data_root", str(fixture_dir / "data"),
                                        "--n_epoch", "1"]
    trainingKD.main(flags + ["--stage", "1", "--fused_nce", "--result_dir", "result_s1"])
    ckpt = fixture_dir / "result_s1" / "KD_ObjectNet3D" / "ckpt" / "checkpoint.pth"
    saved = torch.load(ckpt, weights_only=True)
    assert saved["teacher"]["step"] == saved["student"]["step"] == 2
    teacher = PoseEstimatorVanilla(shape="MultiView", view_num=VIEW_NUM,
                                   img_feature_dim=IMG_DIM, shape_feature_dim=SHAPE_DIM)
    teacher.load_state_dict(saved["teacher"]["model"], strict=True)
    trainingKD.main(flags + ["--stage", "2", "--result_dir", "result_s2",
                             "--teacher_model", str(ckpt)])
    records = _records(fixture_dir / "result_s2" / "KD_ObjectNet3D")
    assert [r["kind"] for r in records] == ["stage2_epoch"]
    assert np.isfinite(records[0]["train_loss"]) and np.isfinite(records[0]["val_med"])


@pytest.mark.parametrize("dataset", ["LineMod", "Pix3D"])
def test_testing_cli_on_linemod_and_pix3d(fixture_dir, dataset):
    """The student's evaluation on LineMod (its objects 1 and 2) and on
    Pix3D (Pix3DContrast's validation rows of bed and chair)."""
    root = fixture_dir / ("data" if dataset == "LineMod" else "test_data")
    out = fixture_dir / f"preds_{dataset}"
    result = testing.main(["--dataset", dataset, "--shape", "None", "--data_root", str(root),
                           "--batch_size", "4", "--workers", "0", "--input_dim",
                           str(INPUT_DIM), "--img_feature_dim", str(STUDENT_DIM),
                           "--student_width_mult", str(WIDTH_MULT), "--device", "cpu",
                           "--output_dir", str(out)])
    want = {"LineMod": {1, 2}, "Pix3D": {"bed", "chair"}}[dataset]
    assert set(result.per_category_acc) == want and np.isfinite(result.sample_med)
    log = (out / "testing_log.txt").read_text()
    assert "Average for all categories" in log
    assert len(list(out.glob("predictions_*.npy"))) == 2


def test_training_cli_shapenetcore_baseline(fixture_dir, monkeypatch):
    """The RGB-only baseline on ShapeNetCore (6 renders at 224, 3 steps of
    2), validated on Pix3D (6 rows)."""
    monkeypatch.chdir(fixture_dir)
    training.main(["--dataset", "ShapeNetCore", "--shape", "None", "--data_root",
                   str(fixture_dir / "data"), "--batch_size", "2", "--workers", "2",
                   "--img_feature_dim", str(STUDENT_DIM), "--student_width_mult",
                   str(WIDTH_MULT), "--n_epoch", "1", "--decrease", "1", "--device", "cpu"])
    run = fixture_dir / "result" / "baseline_ShapeNetCore"
    records = _records(run)
    assert [r["epoch"] for r in records] == [0] and records[0]["train_samples"] == 6
    assert np.isfinite(records[0]["train_loss"]) and np.isfinite(records[0]["val_med"])
    assert "evaluation set: 6" in (run / "training_log.txt").read_text()


@pytest.mark.parametrize("cli,argv,message", [
    ("training", ["--dataset", "ShapeNetCore", "--shape", "MultiView"], "Pix3D"),
    ("training", ["--dataset", "ShapeNetCore", "--shape", "None", "--input_dim", "64"], "224"),
    ("training", ["--dataset", "LineMod", "--shape", "None"], "unsupported training"),
    ("trainingKD", ["--dataset", "ShapeNetCore", "--shape", "MultiView", "--crd"], "Pix3D"),
    ("trainingKD", ["--dataset", "ShapeNetCore", "--shape", "PointCloud", "--stage", "1"],
     "first evaluation"),
    ("trainingKD", ["--dataset", "ObjectNet3D", "--shape", "None", "--crd"], "teacher"),
    ("testing", ["--dataset", "LineMod", "--shape", "MultiView"], "carry no shape"),
    ("testing", ["--dataset", "Pix3D", "--shape", "PointCloud"], "carry no shape"),
    ("testing", ["--dataset", "ShapeNetCore", "--shape", "None"], "unsupported dataset")])
def test_clis_refuse_what_jax_cannot_run(cli, argv, message):
    """Where JAX's run fails on these datasets (a teacher validated on
    Pix3D's shapeless samples, KD's three views missing from ShapeNet's
    samples, a teacher tested on LineMod or Pix3D) the port refuses the
    combination at parse time and says why; where JAX refuses, with its
    message."""
    module = {"training": training, "trainingKD": trainingKD, "testing": testing}[cli]
    with pytest.raises(SystemExit, match=message):
        module.main(argv + ["--device", "cpu"])
