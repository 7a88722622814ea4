"""The on-device data options through the port's CLIs on JAX's synthetic
fixture, on the CPU: each flag one epoch, then --resume into a second.

  * training --shape PointCloud --device_shapes --device_augment (the
    teacher's clouds in a ShapeBank, its views' raw pixels augmented in
    the step), then testing --device_shapes on its checkpoint against
    testing on host clouds: at the full subset (the clouds' 64 vertices,
    --point_num 64) the two evaluations agree, the PointNet's max not
    seeing the order of the points;
  * training --shape MultiView --device_shapes --device_augment --bf16 (a
    RenderBank), then testing --device_shapes, equal to testing on host
    renders (the bank's renders are the files' bit for bit);
  * trainingKD --crd --device_views --device_shapes --device_augment from
    the PointCloud teacher, and --vid with --device_views;
  * trainingKD --stage 1 --device_shapes, then --stage 2 --device_views
    --device_shapes --bf16 from its checkpoint.
Their numbers are held by tests/test_torch_device_data.py; here: the runs
end, their epochs and steps, finite metrics, and the evaluations agree.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from pose3d_tpu.data import synthetic
from pose3d_tpu_torch.cli import testing, training, trainingKD
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

INPUT_DIM, N_VERTICES, VIEW_NUM, FEATURE_DIM = 32, 64, 4, 16
COMMON = ["--dataset", "ObjectNet3D", "--batch_size", "4", "--workers", "2",
          "--input_dim", str(INPUT_DIM), "--decrease", "1", "--device", "cpu"]
PC = ["--shape", "PointCloud", "--shape_dir", "pointcloud", "--point_num", str(N_VERTICES)]
MV = ["--shape", "MultiView", "--shape_dir", "Renders_semi_sphere", "--view_num",
      str(VIEW_NUM), "--tour", "2"]
TEACHER = ["--img_feature_dim", str(FEATURE_DIM), "--shape_feature_dim", str(FEATURE_DIM)]
STUDENT = ["--student_feature_dim", "32", "--student_width_mult", "0.25"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The fixture, and the runs' checkpoints under it (the ResNets' full
    depth: about 2 GB), removed when the module is done, so that a whole
    run's temporary files stay within the disk's room."""
    root = tmp_path_factory.mktemp("torch_device_cli")
    synthetic.make_objectnet3d_fixture(str(root / "data" / "ObjectNet3D"),
                                       categories=("bed", "bookshelf", "calculator"),
                                       n_train_per_cat=3, n_val_per_cat=2, image_size=48,
                                       n_vertices=N_VERTICES, with_renders=True, render_size=24)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _two_epochs(main, flags):
    main(flags + ["--n_epoch", "1"])
    main(flags + ["--n_epoch", "2", "--resume"])


def _test(data_root, shape_flags, model, device_shapes, extra=()):
    return testing.main(["--dataset", "ObjectNet3D", "--data_root", str(data_root / "data"),
                         "--input_dim", str(INPUT_DIM), "--batch_size", "4", "--workers", "0",
                         *shape_flags, *TEACHER, "--model", str(model), "--device", "cpu",
                         "--output_dir", str(data_root / "preds"), *extra]
                        + (["--device_shapes"] if device_shapes else []))


@pytest.fixture(scope="module")
def pc_teacher(data_root):
    """training --shape PointCloud --device_shapes --device_augment, one
    epoch, then --resume into a second: its run directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(data_root)
        _two_epochs(training.main, COMMON + PC + TEACHER + [
            "--data_root", str(data_root / "data"), "--device_shapes", "--device_augment"])
    return data_root / "result" / "PointCloud_ObjectNet3D"


def test_training_cli_pointcloud_device_shapes_and_augment(data_root, pc_teacher):
    records = _records(pc_teacher)
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_nce"]) and
               r["train_samples"] == 8 for r in records)
    assert torch.load(pc_teacher / "ckpt" / "checkpoint.pth", weights_only=True)["step"] == 4
    ckpt = pc_teacher / "ckpt" / "checkpoint.pth"
    banked, host = (_test(data_root, PC, ckpt, flag) for flag in (True, False))
    assert len(banked.cat_ids) == len(host.cat_ids) == 6
    np.testing.assert_allclose(banked.errors, host.errors, atol=1e-3)
    assert banked.val_loss == pytest.approx(host.val_loss, rel=1e-4)


def test_training_cli_multiview_render_bank_bf16(data_root, monkeypatch):
    monkeypatch.chdir(data_root)
    _two_epochs(training.main, COMMON + MV + TEACHER + [
        "--data_root", str(data_root / "data"), "--device_shapes", "--device_augment",
        "--bf16", "--result_dir", "result_mv"])
    run = data_root / "result_mv" / "MultiView_ObjectNet3D"
    records = _records(run)
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in records)
    ckpt = run / "ckpt" / "checkpoint.pth"
    banked, host = (_test(data_root, MV, ckpt, flag) for flag in (True, False))
    np.testing.assert_array_equal(banked.predictions, host.predictions)
    assert banked.val_nce_loss == host.val_nce_loss


@pytest.mark.parametrize("variant", [["--crd", "--device_augment"], ["--vid"]])
def test_kd_cli_device_views_and_shapes(data_root, pc_teacher, monkeypatch, variant):
    monkeypatch.chdir(data_root)
    result_dir = f"result_kd{variant[0]}"
    _two_epochs(trainingKD.main, COMMON + PC + TEACHER + STUDENT + variant + [
        "--data_root", str(data_root / "data"), "--device_views", "--device_shapes",
        "--result_dir", result_dir,
        "--teacher_model", str(pc_teacher / "ckpt" / "checkpoint.pth")])
    records = _records(data_root / result_dir / "KD_ObjectNet3D")
    assert [r["epoch"] for r in records] == [0, 1]
    assert [r["kind"] for r in records] == [variant[0][2:] + "_epoch"] * 2
    assert all(np.isfinite(r["train_loss"]) and r["train_samples"] == 8 for r in records)


def test_kd_stage1_device_shapes_then_stage2_device_views_bf16(data_root, monkeypatch):
    monkeypatch.chdir(data_root)
    flags = COMMON + PC + TEACHER + STUDENT + ["--data_root", str(data_root / "data"),
                                               "--device_shapes"]
    _two_epochs(trainingKD.main, flags + ["--stage", "1", "--result_dir", "result_s1"])
    ckpt = data_root / "result_s1" / "KD_ObjectNet3D" / "ckpt" / "checkpoint.pth"
    saved = torch.load(ckpt, weights_only=True)
    assert saved["teacher"]["step"] == saved["student"]["step"] == 4
    _two_epochs(trainingKD.main, flags + ["--stage", "2", "--device_views", "--bf16",
                                          "--result_dir", "result_s2", "--teacher_model",
                                          str(ckpt)])
    records = _records(data_root / "result_s2" / "KD_ObjectNet3D")
    assert [r["kind"] for r in records] == ["stage2_epoch"] * 2
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_med"]) for r in records)
