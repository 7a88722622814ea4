"""The port's student against the JAX `BaselineEstimator`, on the CPU.

The JAX model's variables go through `pose3d_tpu_torch.train.convert` into
the port (strict load); both run the same NHWC batch in eval mode in f32.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu import geometry as jgeometry
from pose3d_tpu.models import BaselineEstimator as JaxBaselineEstimator
from pose3d_tpu.train.torch_export import export_baseline_estimator
from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.models.estimators import BaselineEstimator
from pose3d_tpu_torch.train.convert import baseline_state_dict
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

IMG_FEATURE_DIM, WIDTH_MULT = 64, 0.25
# f32 on both sides: only the convolutions' summation order differs
REL_TOL = 1e-4


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


@pytest.mark.parametrize("img_feature_dim,width_mult,input_dim",
                         [(2048, 1.0, 32), (IMG_FEATURE_DIM, WIDTH_MULT, 64)])
def test_chip_smoke_variables_have_jax_shapes(img_feature_dim, width_mult, input_dim):
    """chip_smoke.py writes the JAX model's shapes out by hand (the card's
    machine has no JAX): hold them against jax.eval_shape."""
    model = JaxBaselineEstimator(img_feature_dim=img_feature_dim, width_mult=width_mult)
    want = jax.eval_shape(functools.partial(model.init, train=False), jax.random.key(0),
                          jnp.zeros((1, input_dim, input_dim, 3)))
    got = chip_smoke.student_variables(np.random.default_rng(0), img_feature_dim,
                                       width_mult, input_dim)
    assert _shapes(got) == _shapes(dict(want))


def test_state_dict_keys_match_torch_export():
    """The port's keys are the reference layout that torch_export writes."""
    shapes = jax.eval_shape(functools.partial(JaxBaselineEstimator().init, train=False),
                            jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    # keys depend only on the tree: every leaf's last axis is cut to 1 so no
    # full-width array is made (classifier.0's input axis keeps 25088, which
    # export checks)
    tiny = jax.tree_util.tree_map(lambda s: np.zeros(s.shape[:-1] + (1,), np.float32),
                                  dict(shapes))
    with torch.device("meta"):
        port_keys = set(BaselineEstimator().state_dict())
    assert port_keys == set(export_baseline_estimator(tiny))


def _variables(kind, input_dim):
    model = JaxBaselineEstimator(img_feature_dim=IMG_FEATURE_DIM, width_mult=WIDTH_MULT)
    if kind == "jax_init":
        variables = model.init(jax.random.key(0), jnp.zeros((1, input_dim, input_dim, 3)),
                               train=False)
        variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    else:  # He-scaled weights: outputs of order one, so the decoders see real spread
        variables = chip_smoke.student_variables(np.random.default_rng(7), IMG_FEATURE_DIM,
                                                 WIDTH_MULT, input_dim)
    return model, variables


@pytest.mark.parametrize("kind", ["jax_init", "seeded"])
@pytest.mark.parametrize("input_dim", [32, 64])
def test_student_forward_matches_jax(rng, kind, input_dim):
    jmodel, variables = _variables(kind, input_dim)
    port = BaselineEstimator(img_feature_dim=IMG_FEATURE_DIM, width_mult=WIDTH_MULT,
                             input_dim=input_dim)
    port.load_state_dict(baseline_state_dict(variables), strict=True)
    port.eval()

    im = rng.standard_normal((8, input_dim, input_dim, 3)).astype(np.float32)
    ref_heads, ref_proj = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                       jnp.asarray(im), train=False)
    with torch.no_grad():
        heads, proj = port(torch.from_numpy(im))
    for got, want in zip(heads + [proj], list(ref_heads) + [ref_proj]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()

    for decoder in ("decode_predictions", "decode_predictions_inference"):
        want = np.asarray(getattr(jgeometry, decoder)(
            tuple(ref_heads[:3]), tuple(ref_heads[3:]), 15))
        got = getattr(geometry, decoder)(heads[:3], heads[3:], 15).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3)
    for got, want in zip(heads[:3], ref_heads[:3]):  # bins equal
        np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
