"""The port's PointCloud teacher (`PoseEstimator`, ResNet, DeformNet) against
the JAX package, on the CPU.

JAX variables go through `pose3d_tpu_torch.train.convert.pose_state_dict`
(strict load); both frameworks run the same NHWC images and (N, P, 3) clouds
in eval mode in f32.
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
from pose3d_tpu.models import PoseEstimator as JaxPoseEstimator
from pose3d_tpu.models.resnet import resnet18 as jax_resnet18
from pose3d_tpu.models.resnet import resnet50 as jax_resnet50
from pose3d_tpu.train.torch_export import export_pose_estimator, export_resnet
from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.models.estimators import PoseEstimator
from pose3d_tpu_torch.models.resnet import resnet18, resnet50
from pose3d_tpu_torch.ops import pointnet
from pose3d_tpu_torch.train.convert import pose_state_dict
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

IMG_FEATURE_DIM = SHAPE_FEATURE_DIM = 64
# f32 on both sides: the convolutions' summation order, and the PointNet's
# BatchNorm folded in the port and unfolded in JAX
REL_TOL = 1e-4


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _jax_init(model, *inputs):
    v = model.init(jax.random.key(0), *map(jnp.asarray, inputs), train=False)
    return jax.tree_util.tree_map(np.asarray, dict(v))


@pytest.mark.parametrize("img_feature_dim,shape_feature_dim,input_dim",
                         [(1024, 1024, 224), (IMG_FEATURE_DIM, SHAPE_FEATURE_DIM, 32)])
def test_chip_smoke_teacher_variables_have_jax_shapes(img_feature_dim, shape_feature_dim,
                                                      input_dim):
    """chip_smoke.py writes the JAX teacher's shapes out by hand (the card's
    machine has no JAX): hold them against jax.eval_shape."""
    model = JaxPoseEstimator(img_feature_dim=img_feature_dim,
                             shape_feature_dim=shape_feature_dim)
    want = jax.eval_shape(functools.partial(model.init, train=False), jax.random.key(0),
                          jnp.zeros((1, input_dim, input_dim, 3)), jnp.zeros((1, 2500, 3)))
    got = chip_smoke.teacher_variables(np.random.default_rng(0), img_feature_dim,
                                       shape_feature_dim)
    assert _shapes(got) == _shapes(dict(want))


def test_state_dict_keys_match_torch_export():
    """The port's keys and shapes are the reference layout that torch_export
    writes, at full width (built on the meta device: no memory)."""
    shapes = jax.eval_shape(functools.partial(JaxPoseEstimator().init, train=False),
                            jax.random.key(0), jnp.zeros((1, 224, 224, 3)),
                            jnp.zeros((1, 2500, 3)))
    exported = export_pose_estimator(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), dict(shapes)))
    with torch.device("meta"):
        port = PoseEstimator().state_dict()
    assert set(port) == set(exported)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(np.shape(v)) for k, v in exported.items()}


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_two_outputs_match_jax(rng, name):
    """Both outputs, the pooled feature and the head's, from JAX's init
    loaded through the reference exporter."""
    jmodel = {"resnet18": jax_resnet18, "resnet50": jax_resnet50}[name](num_classes=32)
    port = {"resnet18": resnet18, "resnet50": resnet50}[name](num_classes=32)
    im = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    v = _jax_init(jmodel, im)
    sd = {}
    export_resnet(v["params"], v["batch_stats"], (), sd, "",
                  [2, 2, 2, 2] if name == "resnet18" else [3, 4, 6, 3], name == "resnet50")
    port.load_state_dict({k: torch.from_numpy(np.asarray(x)) for k, x in sd.items()},
                         strict=True)
    port.eval()
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(im), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(im))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= REL_TOL


def _teacher(kind, input_dim, p):
    jmodel = JaxPoseEstimator(img_feature_dim=IMG_FEATURE_DIM,
                              shape_feature_dim=SHAPE_FEATURE_DIM)
    if kind == "jax_init":
        variables = _jax_init(jmodel, np.zeros((1, input_dim, input_dim, 3), np.float32),
                              np.zeros((1, p, 3), np.float32))
    else:  # He-scaled weights: outputs of order one
        variables = chip_smoke.teacher_variables(np.random.default_rng(3), IMG_FEATURE_DIM,
                                                 SHAPE_FEATURE_DIM)
    port = PoseEstimator(img_feature_dim=IMG_FEATURE_DIM, shape_feature_dim=SHAPE_FEATURE_DIM)
    port.load_state_dict(pose_state_dict(variables), strict=True)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, variables), port.eval()


def _inputs(rng, n, input_dim, p):
    im = rng.standard_normal((n, input_dim, input_dim, 3)).astype(np.float32)
    return im, rng.uniform(0, 1, (n, p, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,input_dim,p,view_tile", [
    ("jax_init", 32, 100, 1), ("seeded", 32, 513, 1),
    ("seeded", 64, 100, 3), ("jax_init", 64, 513, 3)])
def test_teacher_forward_matches_jax(rng, kind, input_dim, p, view_tile):
    """Heads, the fused feature and the projector; with view_tile 3 the
    images are three stacked views of 2 samples and the clouds only 2."""
    jmodel, jvars, port = _teacher(kind, input_dim, p)
    im, pc = _inputs(rng, 6, input_dim, p)
    pc = pc[:6 // view_tile]
    jheads, jfused, jproj = jmodel.apply(jvars, jnp.asarray(im), jnp.asarray(pc),
                                         train=False, view_tile=view_tile)
    heads, fused, proj = port(torch.from_numpy(im), torch.from_numpy(pc),
                              view_tile=view_tile)
    for got, want in zip(heads + [fused, proj], list(jheads) + [jfused, jproj]):
        assert got.shape == want.shape
        assert _rel(got.detach().numpy(), want) <= REL_TOL


def test_view_tile_tiles_rows_as_jnp_tile(rng):
    """view_tile repeats the whole block of clouds (rows 0, 1, 0, 1, 0, 1),
    as jnp.tile does, not each cloud in place (0, 0, 0, 1, 1, 1)."""
    _, _, port = _teacher("seeded", 32, 100)
    im, pc = _inputs(rng, 6, 32, 100)
    im_t, pc_t = torch.from_numpy(im), torch.from_numpy(pc[:2])
    with torch.no_grad():
        tiled = port(im_t, pc_t, view_tile=3)
        repeated = port(im_t, pc_t.repeat(3, 1, 1))
        interleaved = port(im_t, pc_t.repeat_interleave(3, dim=0))
    for a, b in zip(tiled[0] + list(tiled[1:]), repeated[0] + list(repeated[1:])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert not torch.allclose(tiled[1], interleaved[1], atol=1e-3)


def test_predict_viewpoint_matches_jax_decoder(rng):
    jmodel, jvars, port = _teacher("seeded", 32, 100)
    im, pc = _inputs(rng, 4, 32, 100)
    jheads, _, _ = jmodel.apply(jvars, jnp.asarray(im), jnp.asarray(pc), train=False)
    want = np.asarray(jgeometry.decode_predictions_inference(
        tuple(jheads[:3]), tuple(jheads[3:]), 15))
    got = port.predict_viewpoint(torch.from_numpy(im), torch.from_numpy(pc))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    for decoder in ("decode_predictions", "decode_predictions_inference"):
        heads, _, _ = port(torch.from_numpy(im), torch.from_numpy(pc))
        np.testing.assert_allclose(
            getattr(geometry, decoder)(heads[:3], heads[3:], 15).detach().numpy(),
            np.asarray(getattr(jgeometry, decoder)(tuple(jheads[:3]), tuple(jheads[3:]),
                                                   15)), atol=1e-3)


def test_cpu_teacher_forward_takes_the_plain_pointnet(rng):
    _, _, port = _teacher("seeded", 32, 100)
    im, pc = _inputs(rng, 2, 32, 100)
    before = pointnet.pointnet_eval.launches
    port(torch.from_numpy(im), torch.from_numpy(pc))
    assert pointnet.pointnet_eval.launches == before


def test_multiview_teacher_runs_on_the_cpu(rng):
    """The MultiView teacher (tests/test_torch_multiview.py holds it against
    JAX): its bottleneck takes shape_feature_dim x view_num, and on the CPU
    it launches no kernel."""
    model = PoseEstimator(shape="MultiView", view_num=4, img_feature_dim=32,
                          shape_feature_dim=16).eval()
    assert model.deformNet.conv1.weight.shape[1] == 16 * 4 + 32
    im = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    renders = torch.from_numpy(rng.uniform(0, 1, (2, 4, 24, 24, 3)).astype(np.float32))
    before = pointnet.pointnet_eval.launches
    with torch.no_grad():
        heads, fused, proj = model(im, renders)
    assert pointnet.pointnet_eval.launches == before
    assert fused.shape == (2, 200) and proj.shape == (2, 200)
    assert all(bool(torch.isfinite(h).all()) for h in heads)
    with pytest.raises(ValueError, match="PointCloud"):
        PoseEstimator(shape="Voxel")
