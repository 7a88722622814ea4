"""The port's evaluation slice against the JAX package, on the CPU.

One synthetic ObjectNet3D fixture (three test categories, a ragged last
batch) and one set of seeded student weights go through the JAX path
(`make_eval_step(..., "student")` + `evaluate_categories`, JAX loader) and
through the port's (its own loader, `--device cpu` semantics), then through
the port's two CLIs.
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
from pose3d_tpu.data import datasets as jdatasets
from pose3d_tpu.data import synthetic
from pose3d_tpu.data import transforms as jtransforms
from pose3d_tpu.data.annotations import OBJECTNET3D_TEST_CATS
from pose3d_tpu.data.loader import DataLoader as JaxDataLoader
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.train import steps as jsteps
from pose3d_tpu.train.evaluate import evaluate_categories as jevaluate_categories
from pose3d_tpu_torch.cli import inference, testing
from pose3d_tpu_torch.data.datasets import Pascal3DContrast
from pose3d_tpu_torch.data.loader import DataLoader
from pose3d_tpu_torch.models.estimators import BaselineEstimator
from pose3d_tpu_torch.train import steps
from pose3d_tpu_torch.train.convert import baseline_state_dict
from pose3d_tpu_torch.train.evaluate import evaluate_categories

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
