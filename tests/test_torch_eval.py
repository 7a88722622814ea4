"""The port's evaluation slices against the JAX package, on the CPU.

One synthetic ObjectNet3D fixture (three test categories, a ragged last
batch, a point cloud per CAD model) and seeded student and teacher weights
go through the JAX path (`make_eval_step(..., "student" / "teacher")` +
`evaluate_categories`, JAX loader) and through the port's (its own loader,
`--device cpu` semantics), then through the port's two CLIs; the teacher's
CLI modes against the JAX CLIs.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pose3d_tpu import geometry as jgeometry
from pose3d_tpu.cli import inference as jax_inference
from pose3d_tpu.cli import testing as jax_testing
from pose3d_tpu.data import datasets as jdatasets
from pose3d_tpu.data import ply as jply
from pose3d_tpu.data import synthetic
from pose3d_tpu.data import transforms as jtransforms
from pose3d_tpu.data.annotations import OBJECTNET3D_TEST_CATS
from pose3d_tpu.data.loader import DataLoader as JaxDataLoader
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu.train.evaluate import evaluate_categories as jevaluate_categories
from pose3d_tpu_torch.cli import inference, testing
from pose3d_tpu_torch.data import ply, transforms
from pose3d_tpu_torch.data.datasets import Pascal3DContrast
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
from pose3d_tpu_torch.train import steps
from pose3d_tpu_torch.train.convert import baseline_state_dict, pose_state_dict
from pose3d_tpu_torch.train.evaluate import evaluate_categories
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CATS = ("bed", "bookshelf", "calculator")  # ObjectNet3D test categories
IMG_FEATURE_DIM, WIDTH_MULT, INPUT_DIM, BATCH = 64, 0.25, 32, 4
MODEL_FLAGS = ["--img_feature_dim", str(IMG_FEATURE_DIM), "--student_width_mult",
               str(WIDTH_MULT), "--input_dim", str(INPUT_DIM), "--device", "cpu"]
TOL = 1e-3  # MedErr (degrees) and validation loss


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Fixture tree, weights (.pth), and both evaluation paths' results."""
    root = tmp_path_factory.mktemp("torch_eval")
    data_dir = root / "ObjectNet3D"
    annotation = synthetic.make_objectnet3d_fixture(
        str(data_dir), categories=CATS, n_train_per_cat=1, n_val_per_cat=3,
        image_size=48)  # 9 val samples: batches of 4, 4 and a ragged 1
    variables = chip_smoke.student_variables(np.random.default_rng(11), IMG_FEATURE_DIM,
                                             WIDTH_MULT, INPUT_DIM)
    state = baseline_state_dict(variables)
    pth = root / "student.pth"
    torch.save({"state_dict": state}, pth)

    jmodel = JaxBaselineEstimator(img_feature_dim=IMG_FEATURE_DIM, width_mult=WIDTH_MULT)
    jvariables = jax.tree_util.tree_map(jnp.asarray, variables)
    jdataset = jdatasets.Pascal3DContrast(
        str(data_dir), annotation, train=False, cat_choice=OBJECTNET3D_TEST_CATS,
        keypoint=False, shape=None, input_dim=INPUT_DIM)
    jbatches = list(JaxDataLoader(jdataset, BATCH, shuffle=False, num_workers=0,
                                  process_index=0, process_count=1))
    jresult = jevaluate_categories(jax.jit(jsteps.make_eval_step(jmodel, "student")),
                                   jvariables, jbatches, jdataset.category_names)

    model = BaselineEstimator(img_feature_dim=IMG_FEATURE_DIM, width_mult=WIDTH_MULT,
                              input_dim=INPUT_DIM)
    model.load_state_dict(state, strict=True)
    dataset = Pascal3DContrast(str(data_dir), annotation, input_dim=INPUT_DIM,
                               keypoint=False, cat_choice=OBJECTNET3D_TEST_CATS)
    batches = list(DataLoader(dataset, BATCH, shuffle=False, num_workers=0))
    result = evaluate_categories(steps.make_eval_step(model, "student"), batches,
                                 dataset.category_names, "cpu")
    return dict(root=root, data_dir=data_dir, pth=pth, jmodel=jmodel,
                jvariables=jvariables, jbatches=jbatches, jresult=jresult,
                jnames=jdataset.category_names, batches=batches, result=result,
                names=dataset.category_names)


def test_eval_batches_match_jax(slice_run):
    jbatches, batches = slice_run["jbatches"], slice_run["batches"]
    assert len(batches) == len(jbatches) == 3
    assert slice_run["names"] == slice_run["jnames"] == list(CATS)
    for b, jb in zip(batches, jbatches):
        assert set(b) == set(jb)
        np.testing.assert_allclose(b["im"], jb["im"], atol=1e-6)
        for key in ("label", "cat_id", "valid"):
            np.testing.assert_array_equal(b[key], jb[key])
    assert batches[-1]["valid"].sum() == 1


def test_eval_metrics_match_jax(slice_run):
    result, jresult = slice_run["result"], slice_run["jresult"]
    assert result.per_category_acc == jresult.per_category_acc
    assert result.sample_acc == jresult.sample_acc
    assert result.mean_acc == pytest.approx(jresult.mean_acc, abs=1e-9)
    for cat, med in jresult.per_category_med.items():
        assert result.per_category_med[cat] == pytest.approx(med, abs=TOL)
    assert result.mean_med == pytest.approx(jresult.mean_med, abs=TOL)
    assert result.sample_med == pytest.approx(jresult.sample_med, abs=TOL)
    assert result.val_loss == pytest.approx(jresult.val_loss, abs=TOL)
    np.testing.assert_array_equal(result.cat_ids, jresult.cat_ids)
    np.testing.assert_array_equal(result.labels, jresult.labels)
    assert len(result.cat_ids) == 9


def test_testing_cli_matches_function(slice_run, tmp_path):
    out = tmp_path / "preds"
    testing.main(["--dataset", "ObjectNet3D", "--shape", "None", "--data_root",
                  str(slice_run["root"]), "--batch_size", str(BATCH), "--workers", "2",
                  "--model", str(slice_run["pth"]), "--output_dir", str(out)]
                 + MODEL_FLAGS)
    r = slice_run["result"]
    want = ["", *[line for ci, cat in enumerate(CATS) for line in (
        "test accuracy for %d images of catgory %s in datatset ObjectNet3D "
        % (int(np.sum(r.cat_ids == ci)), cat),
        "Med_Err is %.2f, and Acc_pi/6 is %.2f " % (r.per_category_med[cat],
                                                   r.per_category_acc[cat]),
        " ")],
        "Average for all categories  >>>>  Med_Err is %.2f, and Acc_pi/6 is %.2f "
        % (r.mean_med, r.mean_acc),
        "Average for all Samples  >>>>  Med_Err is %.2f, and Acc_pi/6 is %.2f "
        % (r.sample_med, r.sample_acc)]
    assert (out / "testing_log.txt").read_text().split("\n")[:-1] == want
    for ci, cat in enumerate(CATS):
        np.testing.assert_array_equal(np.load(out / f"predictions_{cat}.npy"),
                                      r.predictions[r.cat_ids == ci])


def test_inference_cli_matches_jax(slice_run, capsys):
    img = slice_run["data_dir"] / "Images" / "bookshelf_val_1.jpg"
    vp = inference.main(["--ckpt", str(slice_run["pth"]), "--img_path", str(img)]
                        + MODEL_FLAGS)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    angles = [float(kv.split("=")[1]) for kv in printed.split()]
    assert len(angles) == 3 and np.all(np.isfinite(angles))

    arr = jtransforms.normalize_image(jtransforms.to_float_array(
        jtransforms.resize_pad(Image.open(img).convert("RGB"), INPUT_DIM)))[None]
    heads, _ = slice_run["jmodel"].apply(slice_run["jvariables"], jnp.asarray(arr),
                                         train=False)
    want = np.array(jgeometry.decode_predictions_inference(
        tuple(heads[:3]), tuple(heads[3:]), 15))[0]
    want[1] -= 90.0  # the annotation-convention shift of cli/inference.py
    want[2] -= 180.0
    np.testing.assert_allclose(vp, want, atol=1e-3)
    np.testing.assert_allclose(angles, want, atol=5e-3)  # printed with %.2f


# ---------------------------------------------------------------------------
# The PointCloud teacher: clouds from the fixture's PLY files, the teacher's
# evaluation (with its validation NCE) and its two CLI modes
# ---------------------------------------------------------------------------

POINT_NUM = 100  # the fixture's clouds have 300 vertices
TEACHER_FLAGS = ["--img_feature_dim", str(IMG_FEATURE_DIM), "--shape_feature_dim",
                 str(IMG_FEATURE_DIM), "--input_dim", str(INPUT_DIM), "--point_num",
                 str(POINT_NUM)]


def _jax_keep_mask(n, width, device):
    """JAX's validation-NCE dropout mask, handed to the port."""
    keep = jax.random.bernoulli(jax.random.key(0), 1.0 - steps.NCE_DROPOUT, (n, width))
    return torch.from_numpy(np.array(keep)).to(device)


@pytest.fixture(scope="module")
def teacher_run(slice_run):
    """Teacher weights (.pth) and both evaluation paths' results on the
    fixture of `slice_run`, whose tree holds pointcloud/<cat>/<XX>/."""
    root, data_dir = slice_run["root"], slice_run["data_dir"]
    variables = chip_smoke.teacher_variables(np.random.default_rng(12), IMG_FEATURE_DIM,
                                             IMG_FEATURE_DIM)
    state = pose_state_dict(variables)
    pth = root / "teacher.pth"
    torch.save({"state_dict": state}, pth)

    jmodel = JaxPoseEstimator(img_feature_dim=IMG_FEATURE_DIM,
                              shape_feature_dim=IMG_FEATURE_DIM)
    jvariables = jax.tree_util.tree_map(jnp.asarray, variables)
    jdataset = jdatasets.Pascal3DContrast(
        str(data_dir), "ObjectNet3D.txt", train=False, cat_choice=OBJECTNET3D_TEST_CATS,
        keypoint=False, shape="PointCloud", shape_dir="pointcloud", input_dim=INPUT_DIM,
        point_num=POINT_NUM)
    jbatches = list(JaxDataLoader(jdataset, BATCH, shuffle=False, num_workers=0,
                                  process_index=0, process_count=1))
    jresult = jevaluate_categories(jax.jit(jsteps.make_eval_step(jmodel, "teacher")),
                                   jvariables, jbatches, jdataset.category_names)

    model = PoseEstimator(img_feature_dim=IMG_FEATURE_DIM, shape_feature_dim=IMG_FEATURE_DIM)
    model.load_state_dict(state, strict=True)
    dataset = Pascal3DContrast(str(data_dir), "ObjectNet3D.txt", input_dim=INPUT_DIM,
                               keypoint=False, cat_choice=OBJECTNET3D_TEST_CATS,
                               shape="PointCloud", shape_dir="pointcloud",
                               point_num=POINT_NUM)
    batches = list(DataLoader(dataset, BATCH, shuffle=False, num_workers=0))
    with pytest.MonkeyPatch.context() as mp:  # JAX's NCE dropout mask
        mp.setattr(steps, "fixed_keep_mask", _jax_keep_mask)
        result = evaluate_categories(steps.make_eval_step(model, "teacher"), batches,
                                     dataset.category_names, "cpu")
    return dict(pth=pth, jbatches=jbatches, jresult=jresult, batches=batches,
                result=result)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_reader_matches_jax(tmp_path, binary):
    verts = np.random.default_rng(1).standard_normal((37, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    jply.write_ply(path, verts, binary=binary)
    got = ply.load_vertices(path, cache=False)
    np.testing.assert_array_equal(got, jply.load_vertices(path, cache=False))
    np.testing.assert_array_equal(got, jply._load_numpy(path))
    np.testing.assert_allclose(got, verts, rtol=1e-6 if not binary else 0)


def test_ply_reader_reads_doubles_and_extra_properties(tmp_path):
    verts = np.random.default_rng(2).standard_normal((9, 3))
    rows = np.zeros(9, [("x", "<f8"), ("nx", "<f4"), ("y", "<f8"), ("z", "<f8"),
                        ("red", "u1")])
    rows["x"], rows["y"], rows["z"] = verts.T
    path = tmp_path / "d.ply"
    path.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 9\n"
                     b"property double x\nproperty float nx\nproperty double y\n"
                     b"property double z\nproperty uchar red\nend_header\n" + rows.tobytes())
    got = ply.load_vertices(str(path), cache=False)
    np.testing.assert_array_equal(got, verts.astype(np.float32))
    np.testing.assert_array_equal(got, jply._load_numpy(str(path)))


@pytest.mark.parametrize("point_num,rotation", [(100, 0.0), (513, 30.0)])
def test_sample_pointcloud_matches_jax(point_num, rotation):
    """The same subset draw, rotation, float64 min-max and float32 cast; 513
    points from 300 vertices draws with replacement."""
    verts = np.random.default_rng(3).standard_normal((300, 3)).astype(np.float32)
    got = transforms.sample_pointcloud(verts, point_num, rotation, np.random.default_rng(4))
    want = jtransforms.sample_pointcloud(verts, point_num, rotation,
                                         np.random.default_rng(4))
    assert got.dtype == np.float32 and got.shape == (point_num, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("random_model", [False, True])
def test_pointcloud_samples_match_jax(slice_run, random_model):
    """Sample for sample, with the loader's per-(seed, epoch, index) rng: the
    random_model draw first, then the cloud's subset."""
    kw = dict(keypoint=False, cat_choice=OBJECTNET3D_TEST_CATS, shape="PointCloud",
              shape_dir="pointcloud", input_dim=INPUT_DIM, point_num=POINT_NUM,
              random_model=random_model)
    data_dir = str(slice_run["data_dir"])
    jdataset = jdatasets.Pascal3DContrast(data_dir, "ObjectNet3D.txt", train=False, **kw)
    dataset = Pascal3DContrast(data_dir, "ObjectNet3D.txt", **kw)
    assert len(dataset) == len(jdataset) == 9
    for i in range(len(dataset)):
        got = dataset.get(i, np.random.default_rng((46, 0, i)))
        want = jdataset.get(i, np.random.default_rng((46, 0, i)))
        assert set(got) == set(want) == {"im", "label", "cat_id", "shape"}
        np.testing.assert_array_equal(got["shape"], want["shape"])
        np.testing.assert_allclose(got["im"], want["im"], atol=1e-6)
        np.testing.assert_array_equal(got["label"], want["label"])


def test_teacher_eval_batches_match_jax(teacher_run):
    jbatches, batches = teacher_run["jbatches"], teacher_run["batches"]
    assert len(batches) == len(jbatches) == 3
    for b, jb in zip(batches, jbatches):
        assert set(b) == set(jb)
        assert b["shape"].shape == (BATCH, POINT_NUM, 3)
        np.testing.assert_array_equal(b["shape"], jb["shape"])
        for key in ("label", "cat_id", "valid"):
            np.testing.assert_array_equal(b[key], jb[key])


def test_teacher_eval_metrics_match_jax(teacher_run):
    """Acc exact; MedErr, the pose loss and the NCE loss (with JAX's dropout
    mask) within TOL."""
    result, jresult = teacher_run["result"], teacher_run["jresult"]
    assert result.per_category_acc == jresult.per_category_acc
    assert result.sample_acc == jresult.sample_acc
    for cat, med in jresult.per_category_med.items():
        assert result.per_category_med[cat] == pytest.approx(med, abs=TOL)
    assert result.sample_med == pytest.approx(jresult.sample_med, abs=TOL)
    assert result.val_loss == pytest.approx(jresult.val_loss, abs=TOL)
    assert jresult.val_nce_loss > 0
    assert result.val_nce_loss == pytest.approx(jresult.val_nce_loss, abs=TOL)
    np.testing.assert_array_equal(result.labels, jresult.labels)
    np.testing.assert_allclose(result.predictions, jresult.predictions, atol=TOL)


def test_teacher_eval_default_mask_is_fixed():
    """The port draws its own mask: one per batch shape, the same on every
    call, keeping about 70 %."""
    a = steps.fixed_keep_mask(BATCH, 200, "cpu")
    assert torch.equal(a, steps.fixed_keep_mask(BATCH, 200, torch.device("cpu")))
    assert a.shape == (BATCH, 200)
    assert 0.6 < float(a.float().mean()) < 0.8


def _log_numbers(path):
    lines = path.read_text().split("\n")
    words = [line.split() for line in lines]
    return lines, [[float(w) for w in ws if w.replace(".", "", 1).isdigit()] for ws in words]


def test_teacher_testing_cli_matches_jax(slice_run, teacher_run, tmp_path):
    """The port's `--shape PointCloud` log against the JAX CLI's, on the
    same .pth: the same lines, numbers within the log's 0.01 resolution."""
    common = ["--dataset", "ObjectNet3D", "--shape", "PointCloud", "--shape_dir",
              "pointcloud", "--data_root", str(slice_run["root"]), "--batch_size",
              str(BATCH), "--workers", "0", "--model", str(teacher_run["pth"])]
    jax_testing.main(common + TEACHER_FLAGS + ["--output_dir", str(tmp_path / "jax"),
                                              "--n_devices", "1"])
    result = testing.main(common + TEACHER_FLAGS + ["--output_dir", str(tmp_path / "port"),
                                                    "--device", "cpu"])
    jlines, jnums = _log_numbers(tmp_path / "jax" / "testing_log.txt")
    lines, nums = _log_numbers(tmp_path / "port" / "testing_log.txt")
    assert [line.split()[:4] for line in lines] == [line.split()[:4] for line in jlines]
    assert len(lines) == 3 * 3 + 4
    for got, want in zip(nums, jnums):
        np.testing.assert_allclose(got, want, atol=0.0100001)
    for ci, cat in enumerate(CATS):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"predictions_{cat}.npy"),
                                   np.load(tmp_path / "jax" / f"predictions_{cat}.npy"),
                                   atol=TOL)
    assert result.per_category_acc == teacher_run["jresult"].per_category_acc


def test_teacher_inference_cli_matches_jax(slice_run, teacher_run, capsys):
    img = slice_run["data_dir"] / "Images" / "calculator_val_2.jpg"
    cloud = slice_run["data_dir"] / "pointcloud" / "calculator" / "01" / "compressed.ply"
    argv = ["--ckpt", str(teacher_run["pth"]), "--img_path", str(img), "--ply_path",
            str(cloud)] + TEACHER_FLAGS
    want = jax_inference.main(argv)
    capsys.readouterr()
    vp = inference.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    angles = [float(kv.split("=")[1]) for kv in printed.split()]
    np.testing.assert_allclose(vp, want, atol=1e-3)
    np.testing.assert_allclose(angles, want, atol=5e-3)  # printed with %.2f
