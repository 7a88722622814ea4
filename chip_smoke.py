"""Smoke run of the PyTorch port (pose3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, and drives the port's paths once at full
width with random weights from a seed:
  * the student (VGG-11, img_feature_dim 2048, 224x224): serving a batch of
    requests, then a per-category evaluation whose geodesic errors go
    through the geodesic kernel;
  * the PointCloud teacher (ResNet-50 and PointNet, img/shape_feature_dim
    1024, DeformNet bottleneck 2048, 224x224 images, 2,500-point clouds):
    serving, then evaluation, with the shape encoder in the PointNet kernel;
  * the contrastive teacher's training with --fused_nce at the recipe's
    width (ResNet-50, img_feature_dim 1024, shape_feature_dim 256,
    DeformNet bottleneck 1280, batch 160, 224x224, 2,500 points, Adam lr
    1e-4, weight decay 5e-4): train steps whose infoNCE runs forward and
    backward in the NCE kernels, then the trainer's epoch loop (train, both
    evaluations, checkpoints, resume).
Phases:

  1 device    2 build    3 geodesic kernel vs plain
  4 pointnet kernel vs plain    5 student at full width
  6 student serving    7 student evaluation
  8 teacher at full width    9 teacher serving    10 teacher evaluation
  11 view_tile    12 serving times
  13 NCE kernel vs plain    14 train step, card vs CPU
  15 teacher training at full width    16 trainer epoch and resume
  17 training times and profile
Each path (6-7, 9-10, 15 and 16) is driven with the kernels' launch counts
set to 0 just before it and read just after it; 15 is the training path's
main path.

Each phase prints a line; any failure raises and exits non-zero. Before the
last line come the card's name and power limit (nvidia-smi) and one JSON
line {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, the script fails
before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

VGG11_CONV_WIDTHS = (64, 128, 256, 256, 512, 512, 512, 512)
RESNET50_STAGES = (3, 4, 6, 3)
HEAD_BINS = (24, 12, 24)
GEODESIC_RTOL, GEODESIC_ATOL = 1e-4, 0.05  # degrees; arccos is ill-conditioned near 0
HEADS_REL_TOL = 1e-3  # card vs CPU, f32 with TF32 off: summation order only
# pointnet kernel vs plain: f32 sums of 128 products in another order
POINTNET_REL_TOL = 1e-4
POINT_NUM, TEACHER_BATCH = 2500, 64
# NCE kernel vs plain: loss relative; each gradient against its max|ref|
NCE_LOSS_RTOL, NCE_GRAD_TOL = 1e-5, 1e-4
# train step, card vs CPU, model in f64 and losses in f32 on both (as the
# CPU test against JAX): losses relative; gradients against their max|ref|
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-5, 1e-3
TRAIN_BATCH, TRAIN_SHAPE_DIM, TRAIN_STEPS, LR = 160, 256, 6, 1e-4
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12
EVAL_CATEGORIES = ["bed", "bookshelf", "calculator"]
EVAL_COUNTS = [64] * 8 + [37]  # 8 full batches of 64 + a ragged 37 padded to 64
EDGE_ROWS = (  # (pred, label): identical triples (0 deg) and 180 deg apart,
    # where rounding pushes the trace past the clamp at 3 or at -1
    ((0.0, 0.0, 0.0), (0, 0, 0)),
    ((37.0, 91.0, 250.0), (37, 91, 250)),
    ((359.0, 179.0, 359.0), (359, 179, 359)),
    ((0.0, 180.0, 180.0), (180, 180, 180)),
    ((10.0, 45.0, 300.0), (190, 45, 300)),
)


def student_variables(rng: np.random.Generator, img_feature_dim: int = 2048,
                      width_mult: float = 1.0, input_dim: int = 224) -> dict:
    """Seeded numpy {"params", "batch_stats"} with the shapes of the JAX
    `pose3d_tpu.models.estimators.BaselineEstimator`, written out here
    because the card's machine has no JAX (tests/test_torch_student.py holds
    them against jax.eval_shape). Weights are He-scaled so activations stay
    of order one; BN statistics are random."""

    def normal(shape, std):
        return std * rng.standard_normal(shape, dtype=np.float32)

    def dense(fan_in, out, gain=2.0):
        return {"kernel": normal((fan_in, out), math.sqrt(gain / fan_in)),
                "bias": normal((out,), 0.01)}

    vgg, channels = {}, 3
    for i, width in enumerate(VGG11_CONV_WIDTHS):
        if width_mult != 1.0:
            width = max(16, int(round(width * width_mult / 16)) * 16)
        vgg[f"Conv_{i}"] = {"kernel": normal((3, 3, channels, width),
                                             math.sqrt(2.0 / (9 * channels))),
                            "bias": normal((width,), 0.01)}
        channels = width
    side = input_dim // 32  # five 2x2 pools
    vgg["Dense_0"] = dense(side * side * channels, 4096)
    vgg["Dense_1"] = dense(4096, 4096)
    vgg["Dense_2"] = dense(4096, img_feature_dim)
    params, stats = {"VGG_0": vgg}, {}
    # compress (DenseBNRelu_0..2), then the projector's DenseBNRelu_3
    widths = (img_feature_dim, 800, 400, 200, 200)
    for k in range(4):
        out = widths[k + 1]
        params[f"DenseBNRelu_{k}"] = {
            "Dense_0": dense(widths[k], out),
            "BatchNorm_0": {"scale": 1.0 + normal((out,), 0.1),
                            "bias": normal((out,), 0.1)}}
        stats[f"DenseBNRelu_{k}"] = {"BatchNorm_0": {
            "mean": normal((out,), 0.1),
            "var": rng.uniform(0.5, 1.5, out).astype(np.float32)}}
    params["_SixHeads_0"] = {f"Dense_{i}": dense(200, HEAD_BINS[i % 3], gain=1.0)
                             for i in range(6)}
    params["Dense_0"] = dense(200, 200, gain=1.0)
    return {"params": params, "batch_stats": stats}


def teacher_variables(rng: np.random.Generator, img_feature_dim: int = 1024,
                      shape_feature_dim: int = 1024) -> dict:
    """Seeded numpy {"params", "batch_stats"} with the shapes of the JAX
    `pose3d_tpu.models.estimators.PoseEstimator(shape="PointCloud")`, written
    out by hand like `student_variables` (tests/test_torch_teacher.py holds
    them against jax.eval_shape). Convs followed by a ReLU are He-scaled
    (gain 2); the last conv of each residual branch and the projection have
    gain 0.25, so the residual stream keeps its scale through the 16 blocks
    (with gain 1 the image feature grows to about 70), and the DeformNet's
    last layer too, so that most of the fused feature stays off tanh's
    flat ends."""

    def normal(shape, std):
        return std * rng.standard_normal(shape, dtype=np.float32)

    def dense(fan_in, out, gain=2.0):
        return {"kernel": normal((fan_in, out), math.sqrt(gain / fan_in)),
                "bias": normal((out,), 0.01)}

    def bn(width):
        return ({"scale": 1.0 + normal((width,), 0.1), "bias": normal((width,), 0.1)},
                {"mean": normal((width,), 0.1),
                 "var": rng.uniform(0.5, 1.5, width).astype(np.float32)})

    def convbn(k, cin, cout, gain):
        p, s = bn(cout)
        return ({"Conv_0": {"kernel": normal((k, k, cin, cout),
                                             math.sqrt(gain / (k * k * cin)))},
                 "BatchNorm_0": p}, {"BatchNorm_0": s})

    def put(params, stats, name, pair):
        params[name], stats[name] = pair

    resnet, resnet_stats = {}, {}
    put(resnet, resnet_stats, "ConvBN_0", convbn(7, 3, 64, 2.0))
    channels, k = 64, 0
    for i, n_blocks in enumerate(RESNET50_STAGES):
        width = 64 * 2**i
        for j in range(n_blocks):
            block, block_stats = {}, {}
            put(block, block_stats, "ConvBN_0", convbn(1, channels, width, 2.0))
            put(block, block_stats, "ConvBN_1", convbn(3, width, width, 2.0))
            put(block, block_stats, "ConvBN_2", convbn(1, width, 4 * width, 0.25))
            if j == 0:  # stride 2, or 64 -> 256 channels: a projection
                put(block, block_stats, "ConvBN_3", convbn(1, channels, 4 * width, 0.25))
            resnet[f"Bottleneck_{k}"], resnet_stats[f"Bottleneck_{k}"] = block, block_stats
            channels, k = 4 * width, k + 1
    resnet["Dense_0"] = dense(channels, img_feature_dim, gain=1.0)

    pointnet, pointnet_stats = {}, {}
    widths = (3, 64, 128, shape_feature_dim)
    for i in range(3):
        pointnet[f"Dense_{i}"] = dense(widths[i], widths[i + 1])
        put(pointnet, pointnet_stats, f"BatchNorm_{i}", bn(widths[i + 1]))

    b = shape_feature_dim + img_feature_dim
    deform, deform_stats = {}, {}
    for i, (fan_in, out) in enumerate(((b, b), (b, b // 2), (b // 2, b // 4))):
        p, s = bn(out)
        deform[f"DenseBNRelu_{i}"] = {"Dense_0": dense(fan_in, out), "BatchNorm_0": p}
        deform_stats[f"DenseBNRelu_{i}"] = {"BatchNorm_0": s}
    deform["Dense_0"] = dense(b // 4, 200, gain=0.25)

    params = {"ResNet_0": resnet, "ShapeEncoderPC_0": pointnet, "DeformNet_0": deform,
              "_SixHeads_0": {f"Dense_{i}": dense(200, HEAD_BINS[i % 3], gain=1.0)
                              for i in range(6)}}
    stats = {"ResNet_0": resnet_stats, "ShapeEncoderPC_0": pointnet_stats,
             "DeformNet_0": deform_stats}
    for i, (fan_in, out) in enumerate(((img_feature_dim, 800), (800, 400))):
        p, s = bn(out)
        params[f"DenseBNRelu_{i}"] = {"Dense_0": dense(fan_in, out), "BatchNorm_0": p}
        stats[f"DenseBNRelu_{i}"] = {"BatchNorm_0": s}
    params["Dense_0"] = dense(400, 200, gain=1.0)
    return {"params": params, "batch_stats": stats}


def random_labels(rng: np.random.Generator, n: int) -> np.ndarray:
    """Canonical integer label triples: azi [0,360), ele+90 [0,180), inp+180 [0,360)."""
    return np.stack([rng.integers(0, 360, n), rng.integers(0, 180, n),
                     rng.integers(0, 360, n)], axis=1).astype(np.int32)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.1f} s)", flush=True)


def pointnet_params(rng: np.random.Generator, d: int, dev, b3: float | None = None):
    """Folded PointNet parameters (W (in, out), b), He-scaled, on `dev`."""
    folded = []
    for fan_in, out in ((3, 64), (64, 128), (128, d)):
        w = rng.standard_normal((fan_in, out), dtype=np.float32) * math.sqrt(2.0 / fan_in)
        b = rng.standard_normal(out, dtype=np.float32) * 0.1
        folded.append((torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)))
    if b3 is not None:  # every output negative: a max that started at 0 would read 0
        folded[2] = (folded[2][0], torch.full((d,), b3, device=dev))
    return folded


def eval_batches(seed: int, with_clouds: bool):
    """The evaluation input: 8 x 64 + 37 rows over 3 categories, as the loader
    emits them (padded tail, 'valid' mask), with clouds for the teacher."""
    rng = np.random.default_rng(seed)
    for count in EVAL_COUNTS:
        batch = {"im": rng.standard_normal((64, 224, 224, 3), dtype=np.float32),
                 "label": random_labels(rng, 64),
                 "cat_id": rng.integers(0, 3, 64).astype(np.int32),
                 "valid": np.arange(64) < count}
        if with_clouds:
            batch["shape"] = rng.uniform(0, 1, (64, POINT_NUM, 3)).astype(np.float32)
        yield batch


def check_eval(result, geometry, name: str) -> None:
    """Rows kept, finite errors, and per-category Acc / Med equal to the
    plain CPU recomputation from the same predictions."""
    n_eval = len(result.cat_ids)
    if n_eval != sum(EVAL_COUNTS) or not np.all(np.isfinite(result.errors)):
        raise RuntimeError(f"{name} evaluation kept {n_eval} rows, or errors not finite")
    errs_cpu = geometry.rotation_err(torch.from_numpy(result.predictions),
                                     torch.from_numpy(result.labels).float()).numpy()
    for ci, cat in enumerate(EVAL_CATEGORIES):
        e = errs_cpu[result.cat_ids == ci]
        acc, med = 100.0 * float(np.mean(e <= 30.0)), float(np.median(e))
        if acc != result.per_category_acc[cat] or \
                abs(med - result.per_category_med[cat]) > 1e-3:
            raise RuntimeError(f"{name} {cat}: card Acc/Med {result.per_category_acc[cat]}/"
                               f"{result.per_category_med[cat]} vs CPU {acc}/{med}")


def rel_err(got, want) -> float:
    return float((got.cpu() - want.cpu()).abs().max() / want.abs().max())


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    over the HBM rate and the f32 operations over the f32 CUDA-core rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nce_inputs(rng: np.random.Generator, n: int, d: int, dev, masked=False,
               offset=0, identical=False):
    """s (n, d), keys t (n + offset, d) and the masks of one NCE case: with
    `masked`, the last quarter of the rows (and their key columns) invalid;
    with an offset, the rows are a shard whose positives start there."""
    nc = n + offset
    s = rng.standard_normal((n, d), dtype=np.float32)
    t = rng.standard_normal((nc, d), dtype=np.float32)
    if identical:
        s[:], t[:] = s[0], t[0]
    vrow = vcol = None
    if masked:
        vrow = np.arange(n) < max(1, n - n // 4)
        vcol = np.concatenate([np.ones(offset, bool), vrow])
    as_dev = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return as_dev(s), as_dev(t), as_dev(vrow), as_dev(vcol)


def nce_kernel_vs_plain(nce, s, t, vrow, vcol, offset):
    """Loss and both gradients through the kernels and through the plain
    version (autograd) on the same inputs: (max relative loss error,
    max gradient error over its max|ref|, max|d|)."""
    s, t = s.clone().requires_grad_(), t.clone().requires_grad_()
    if offset:
        loss = nce.blocked_info_nce_partial(s, t, vrow, vcol, offset, 0.1)
    elif vrow is not None:
        loss = nce.blocked_info_nce(s, t, 0.1, valid=vrow)
    else:
        loss = nce.fused_info_nce(s, t, 0.1)
    grads = torch.autograd.grad(loss, (s, t))
    ref = nce.info_nce_plain(s, t, 0.1, vrow, vcol, offset)
    if not offset:
        ref = ref / (s.shape[0] if vrow is None else vrow.sum())
    ref_grads = torch.autograd.grad(ref, (s, t))
    loss, ref = float(loss.detach()), float(ref.detach())
    loss_err = abs(loss - ref) / abs(ref)
    max_d = max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads))
    # one row alone has a zero gradient: a floor for its rounding
    grad_err = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-4)
                   for g, r in zip(grads, ref_grads))
    return loss_err, grad_err, max(max_d, abs(loss - ref))


def train_batch(rng: np.random.Generator, n: int, dim: int, points: int) -> dict:
    """A teacher train batch as the loader emits it (numpy): normalised
    images, clouds of varied extents, label triples."""
    extent = rng.uniform(0.2, 1.0, (n, 1, 3))
    return {"im": rng.standard_normal((n, dim, dim, 3), dtype=np.float32),
            "shape": (rng.uniform(0, 1, (n, points, 3)) * extent).astype(np.float32),
            "label": random_labels(rng, n)}


class MemorySet:
    """Teacher samples made from a seed and held in memory, with the
    dataset interface the port's DataLoader takes (get(idx, rng) -> dict,
    category_names): the trainer runs without files."""

    def __init__(self, n: int, seed: int, dim: int):
        rng = np.random.default_rng(seed)
        self.batch = train_batch(rng, n, dim, POINT_NUM)
        self.batch["cat_id"] = rng.integers(0, len(EVAL_CATEGORIES), n).astype(np.int32)
        self.category_names = list(EVAL_CATEGORIES)

    def __len__(self):
        return len(self.batch["label"])

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        return {k: v[idx] for k, v in self.batch.items()}


def main() -> int:
    t0 = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from pose3d_tpu_torch import geometry
    from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
    from pose3d_tpu_torch.data.loader import DataLoader
    from pose3d_tpu_torch.ops import _build, geodesic, nce, pointnet
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.train.evaluate import evaluate_categories
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.trainer import TeacherTrainer

    def reset_counts():
        geodesic.rotation_err.launches = pointnet.pointnet_eval.launches = 0
        nce.nce_forward.launches = nce.nce_backward.launches = 0

    def counts():
        return (geodesic.rotation_err.launches, pointnet.pointnet_eval.launches,
                nce.nce_forward.launches, nce.nce_backward.launches)

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", t0, f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for cuDNN and matmul")

    # 2. build: one nvcc per source, all started together
    tb = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(_build.build, ("geodesic", "pointnet_eval", "info_nce")))
    build_s = time.perf_counter() - tb
    for lib in libs:
        with open(lib[:-3] + ".log") as f:
            ptxas = " | ".join(line.strip() for line in f
                               if "ptxas info" in line or "spill" in line)
        phase("build", t0, f"nvcc {lib}; {ptxas}")
    phase("build", t0, f"three libraries in {build_s:.2f} s; pointnet_eval_kernel: "
          f"{pointnet.shared_memory_bytes()} bytes of dynamic shared memory a block; "
          f"info_nce at D 200 (forward, backward): {nce.shared_memory_bytes(200)} bytes")

    # 3. geodesic kernel vs plain version on the card, 1,000,003 rows + edge rows
    rng = np.random.default_rng(0)
    n = 1_000_003
    preds = np.concatenate([
        np.stack([rng.uniform(0, 360, n), rng.uniform(0, 180, n),
                  rng.uniform(0, 360, n)], 1),
        np.array([p for p, _ in EDGE_ROWS])]).astype(np.float32)
    labels = np.concatenate([random_labels(rng, n),
                             np.array([g for _, g in EDGE_ROWS])]).astype(np.float32)
    p_dev, l_dev = torch.from_numpy(preds).to(dev), torch.from_numpy(labels).to(dev)
    before = geodesic.rotation_err.launches
    out = geodesic.rotation_err(p_dev, l_dev)
    ref = geometry.rotation_err(p_dev, l_dev)
    torch.cuda.synchronize()
    if geodesic.rotation_err.launches != before + 1:
        raise RuntimeError("the geodesic wrapper did not count its launch")
    torch.testing.assert_close(out, ref, rtol=GEODESIC_RTOL, atol=GEODESIC_ATOL)
    geo_err = float((out - ref).abs().max())
    edge = out[n:].cpu().numpy()
    phase("geodesic", t0, f"kernel vs plain on {n + len(EDGE_ROWS)} rows: "
          f"max|d| {geo_err:.3g} deg (rtol {GEODESIC_RTOL}, atol {GEODESIC_ATOL}); "
          f"edge rows {np.round(edge, 4).tolist()}")

    # 4. pointnet kernel vs plain version on the card
    pn_err, pn_rel, cases = 0.0, 0.0, []
    prng = np.random.default_rng(1)
    for n_c in (1, 46, 64):
        for p_c in (1, 511, 2500, 2501):
            for d_c in (256, 1024):
                cases.append((n_c, p_c, d_c, None, False))
    cases += [(3, 2500, 256, -100.0, False), (2, 700, 1024, None, True)]
    for n_c, p_c, d_c, b3, identical in cases:
        folded = pointnet_params(prng, d_c, dev, b3)
        pts = prng.uniform(0, 1, (n_c, 1 if identical else p_c, 3)).astype(np.float32)
        pts = torch.from_numpy(np.broadcast_to(pts, (n_c, p_c, 3)).copy()).to(dev)
        before = pointnet.pointnet_eval.launches
        out = pointnet.pointnet_eval(pts, folded)
        ref = pointnet.pointnet_eval_plain(pts, folded)
        torch.cuda.synchronize()
        if pointnet.pointnet_eval.launches != before + 1:
            raise RuntimeError("the pointnet wrapper did not count its launch")
        if out.shape != (n_c, d_c) or (b3 is not None and float(out.max()) >= 0):
            raise RuntimeError(f"pointnet {(n_c, p_c, d_c)}: shape {tuple(out.shape)}, "
                               f"max {float(out.max())}")
        err = float((out - ref).abs().max())
        if err > POINTNET_REL_TOL * float(ref.abs().max()):
            raise RuntimeError(f"pointnet kernel vs plain at {(n_c, p_c, d_c, b3)}: "
                               f"max|d| {err:.3g}, max|ref| {float(ref.abs().max()):.3g}")
        pn_err, pn_rel = max(pn_err, err), max(pn_rel, err / float(ref.abs().max()))
    phase("pointnet", t0, f"kernel vs plain in {len(cases)} cases (N 1/46/64 x P 1/511/"
          f"2500/2501 x D 256/1024, all outputs negative, identical points): max|d| "
          f"{pn_err:.3g}, max|d|/max|ref| {pn_rel:.3g} (tol {POINTNET_REL_TOL})")

    # 5. student at full width, random weights from a seed, loaded strictly
    state = convert.baseline_state_dict(student_variables(np.random.default_rng(1)))
    with torch.device("meta"):
        model_cpu, model = BaselineEstimator(), BaselineEstimator()
    model_cpu.load_state_dict(state, strict=True, assign=True)
    model.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True,
                          assign=True)
    model_cpu.eval()
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 224, 224, 3), dtype=np.float32))
    with torch.no_grad():
        for b in (64, 1):
            heads, proj = model(x[:b].to(dev))
            for t in heads + [proj]:
                if not bool(torch.isfinite(t).all()):
                    raise RuntimeError(f"non-finite output at batch {b}")
        heads, proj = model(x[:2].to(dev))
        heads_ref, proj_ref = model_cpu(x[:2])
    worst = max(rel_err(g, w) for g, w in zip(heads + [proj], heads_ref + [proj_ref]))
    if worst > HEADS_REL_TOL:
        raise RuntimeError(f"student card vs CPU: max|d|/max|ref| {worst:.3g}")
    phase("student", t0, f"{n_params} params loaded strict; batch 64 and 1 finite; "
          f"batch 2 card vs CPU max|d|/max|ref| {worst:.3g} (tol {HEADS_REL_TOL})")
    del model_cpu

    # the student's main path: serving, then evaluation
    reset_counts()
    # 6. serving: NHWC batch -> forward -> inference decoder
    vp = model.predict_viewpoint(x.to(dev))
    if vp.shape != (64, 3) or not bool(((vp >= 0) & (vp <= 360)).all()):
        raise RuntimeError(f"serving output {tuple(vp.shape)} outside [0, 360]")
    phase("student serving", t0, f"64 requests -> {tuple(vp.shape)} degrees in [0, 360]; "
          f"first {np.round(vp[0].cpu().numpy(), 2).tolist()}")
    # 7. evaluation
    result = evaluate_categories(steps.make_eval_step(model, "student"),
                                 eval_batches(3, False), EVAL_CATEGORIES, dev)
    torch.cuda.synchronize()
    student_geo = geodesic.rotation_err.launches
    if student_geo < 1:
        raise RuntimeError("the student's evaluation did not launch the geodesic kernel")
    check_eval(result, geometry, "student")
    p_eval = torch.from_numpy(result.predictions).to(dev)
    l_eval = torch.from_numpy(result.labels).float().to(dev)
    d_eval = geodesic.rotation_err(p_eval, l_eval) - geometry.rotation_err(p_eval, l_eval)
    geo_err = max(geo_err, float(d_eval.abs().max()))
    phase("student evaluation", t0, f"{len(result.cat_ids)} rows, {student_geo} geodesic "
          f"launch(es); Acc {result.per_category_acc} Med "
          f"{ {k: round(v, 3) for k, v in result.per_category_med.items()} } "
          f"val_loss {result.val_loss:.4f}; equal to the plain CPU recomputation")

    # 8. teacher at full width, random weights from a seed, loaded strictly
    state = convert.pose_state_dict(teacher_variables(np.random.default_rng(5)))
    with torch.device("meta"):
        teacher_cpu, teacher = PoseEstimator(), PoseEstimator()
    teacher_cpu.load_state_dict(state, strict=True, assign=True)
    teacher.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True,
                            assign=True)
    teacher_cpu.eval()
    teacher.eval()
    del state
    n_params = sum(p.numel() for p in teacher.parameters())
    trng = np.random.default_rng(6)
    xt = torch.from_numpy(trng.standard_normal((TEACHER_BATCH, 224, 224, 3),
                                               dtype=np.float32))
    pc = torch.from_numpy(trng.uniform(0, 1, (TEACHER_BATCH, POINT_NUM, 3))
                          .astype(np.float32))
    with torch.no_grad():
        got = teacher(xt[:2].to(dev), pc[:2].to(dev))
        want = teacher_cpu(xt[:2], pc[:2])
    got, want = got[0] + list(got[1:]), want[0] + list(want[1:])
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise RuntimeError("teacher: non-finite output on the card")
    worst = max(rel_err(g, w) for g, w in zip(got, want))
    if worst > HEADS_REL_TOL:
        raise RuntimeError(f"teacher card vs CPU: max|d|/max|ref| {worst:.3g}")
    phase("teacher", t0, f"{n_params} params loaded strict; batch 2 card vs CPU "
          f"(heads, fused, projector) max|d|/max|ref| {worst:.3g} (tol {HEADS_REL_TOL})")
    del teacher_cpu

    # the teacher's main path: serving, then evaluation
    reset_counts()
    # 9. serving: (image, cloud) requests -> forward -> inference decoder
    vp = teacher.predict_viewpoint(xt.to(dev), pc.to(dev))
    torch.cuda.synchronize()
    if vp.shape != (TEACHER_BATCH, 3) or not bool(((vp >= 0) & (vp <= 360)).all()):
        raise RuntimeError(f"teacher serving output {tuple(vp.shape)} outside [0, 360]")
    serving_pn = pointnet.pointnet_eval.launches
    if serving_pn < 1:
        raise RuntimeError("teacher serving did not launch the pointnet kernel")
    phase("teacher serving", t0, f"{TEACHER_BATCH} requests -> {tuple(vp.shape)} degrees "
          f"in [0, 360], {serving_pn} pointnet launch(es); first "
          f"{np.round(vp[0].cpu().numpy(), 2).tolist()}")
    # 10. evaluation through the teacher's eval step (validation NCE included)
    result = evaluate_categories(steps.make_eval_step(teacher, "teacher"),
                                 eval_batches(7, True), EVAL_CATEGORIES, dev)
    torch.cuda.synchronize()
    teacher_geo, teacher_pn = geodesic.rotation_err.launches, pointnet.pointnet_eval.launches
    if teacher_geo != 1 or teacher_pn - serving_pn < 1:
        raise RuntimeError(f"teacher evaluation made {teacher_geo} geodesic and "
                           f"{teacher_pn - serving_pn} pointnet launches")
    check_eval(result, geometry, "teacher")
    if not math.isfinite(result.val_nce_loss) or not math.isfinite(result.val_loss):
        raise RuntimeError(f"teacher val losses {result.val_loss}, {result.val_nce_loss}")
    # both kernels against their plain versions at the path's shapes
    p_eval = torch.from_numpy(result.predictions).to(dev)
    l_eval = torch.from_numpy(result.labels).float().to(dev)
    d_eval = geodesic.rotation_err(p_eval, l_eval) - geometry.rotation_err(p_eval, l_eval)
    geo_err = max(geo_err, float(d_eval.abs().max()))
    folded = pointnet.fold_pointnet_params(teacher.shape_encoder.state_dict())
    pc_dev = pc.to(dev)
    out = pointnet.pointnet_eval(pc_dev, folded)
    ref = pointnet.pointnet_eval_plain(pc_dev, folded)
    err = float((out - ref).abs().max())
    if err > POINTNET_REL_TOL * float(ref.abs().max()):
        raise RuntimeError(f"pointnet kernel vs plain on the teacher's weights: {err:.3g}")
    pn_err = max(pn_err, err)
    phase("teacher evaluation", t0, f"{len(result.cat_ids)} rows with clouds, "
          f"{teacher_geo} geodesic and {teacher_pn - serving_pn} pointnet launch(es); "
          f"Acc {result.per_category_acc} Med "
          f"{ {k: round(v, 3) for k, v in result.per_category_med.items()} } "
          f"val_loss {result.val_loss:.4f} val_nce_loss {result.val_nce_loss:.4f}; "
          f"equal to the plain CPU recomputation; kernel vs plain on the teacher's "
          f"PointNet max|d| {err:.3g}")

    # 11. view_tile: 3 stacked views of 16 samples, the 16 clouds encoded once
    with torch.no_grad():
        im3 = xt[:48].to(dev)
        tiled = teacher(im3, pc_dev[:16], view_tile=3)
        repeated = teacher(im3, pc_dev[:16].repeat(3, 1, 1))
    tiled, repeated = tiled[0] + list(tiled[1:]), repeated[0] + list(repeated[1:])
    worst = max(rel_err(a, b) for a, b in zip(tiled, repeated))
    if worst > 1e-6:
        raise RuntimeError(f"view_tile=3 vs tiled clouds: max|d|/max|ref| {worst:.3g}")
    phase("view_tile", t0, f"teacher(im x3, 16 clouds, view_tile=3) vs the clouds tiled "
          f"x3: max|d|/max|ref| {worst:.3g}")

    # 12. times (CUDA events, after warm-up), with the card beside each
    with torch.no_grad():
        for b in (1, 64, 256):
            xb = torch.from_numpy(np.random.default_rng(4).standard_normal(
                (b, 224, 224, 3), dtype=np.float32)).to(dev)
            ms = cuda_ms(lambda: model(xb), iters=20 if b < 256 else 10)
            phase("time", t0, f"student serving f32 batch {b}: {ms:.3f} ms/batch = "
                  f"{b * 1000.0 / ms:.1f} img/s [{card}]")
        del model
        for b in (1, TEACHER_BATCH):
            xb, pb = xt[:b].to(dev), pc_dev[:b]
            ms = cuda_ms(lambda: teacher(xb, pb), iters=20)
            phase("time", t0, f"teacher serving f32 batch {b}: {ms:.3f} ms/batch = "
                  f"{b * 1000.0 / ms:.1f} img/s [{card}]")
    geo_times = {}
    for rows in (10_000, 1_000_000):
        p, l_ = p_dev[:rows].contiguous(), l_dev[:rows].contiguous()
        k_ms = cuda_ms(lambda: geodesic.rotation_err(p, l_), iters=200)
        plain_ms = cuda_ms(lambda: geometry.rotation_err(p, l_), iters=200)
        geo_times[rows] = (k_ms, plain_ms)
        phase("time", t0, f"geodesic {rows} rows: kernel {k_ms * 1000:.2f} us, plain "
              f"{plain_ms * 1000:.2f} us ({plain_ms / k_ms:.2f}x) [{card}]")
    pn_times = {}
    for n_c in (64, 46):
        pts = pc_dev[:n_c].contiguous()
        # in turns: plain, kernel, kernel, plain
        runs = [cuda_ms(fn, iters=20) for fn in (
            lambda: pointnet.pointnet_eval_plain(pts, folded),
            lambda: pointnet.pointnet_eval(pts, folded),
            lambda: pointnet.pointnet_eval(pts, folded),
            lambda: pointnet.pointnet_eval_plain(pts, folded))]
        k_ms, plain_ms = (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2
        pn_times[n_c] = (k_ms, plain_ms)
        phase("time", t0, f"pointnet ({n_c}, {POINT_NUM}, 1024): kernel {runs[1]:.4f} / "
              f"{runs[2]:.4f} ms, plain {runs[0]:.4f} / {runs[3]:.4f} ms "
              f"({plain_ms / k_ms:.2f}x) [{card}]")

    del teacher
    pn_bytes = 4.0 * (64 * POINT_NUM * 3 + sum(w.numel() + b.numel() for w, b in folded)
                      + 64 * 1024)
    pn_flops = 2.0 * 64 * POINT_NUM * (3 * 64 + 64 * 128 + 128 * 1024)
    # per row: 24 bytes read, 4 written; about 100 operations (six sincos,
    # two 3x3 builds, the trace, acos)
    geo_bound = bound(28.0 * 1_000_000, 100.0 * 1_000_000)
    pn_bound = bound(pn_bytes, pn_flops)

    # 13. NCE kernels vs the plain version on the card: loss and both
    # gradients; N 1 to 2500 (one tile to 79), D 64 / 200, with and without
    # masked rows and columns, a shard with its row offset, identical rows
    nrng = np.random.default_rng(13)
    cases = [(n, d, masked, 0, False) for n in (1, 7, 160, 1025, 2500) for d in (64, 200)
             for masked in (False, True)]
    cases += [(160, 200, True, 97, False), (100, 200, False, 37, False),
              (160, 200, False, 0, True)]
    nce_loss_err = nce_grad_err = nce_err = 0.0
    for n, d, masked, offset, identical in cases:
        s_c, t_c, vrow, vcol = nce_inputs(nrng, n, d, dev, masked, offset, identical)
        before = counts()
        loss_err, grad_err, max_d = nce_kernel_vs_plain(nce, s_c, t_c, vrow, vcol, offset)
        torch.cuda.synchronize()
        after = counts()
        if (after[2] - before[2], after[3] - before[3]) != (1, 1):
            raise RuntimeError(f"NCE case {(n, d, masked, offset)}: launches "
                               f"{after[2] - before[2]} forward, {after[3] - before[3]} backward")
        if loss_err > NCE_LOSS_RTOL or grad_err > NCE_GRAD_TOL:
            raise RuntimeError(f"NCE kernel vs plain at {(n, d, masked, offset, identical)}: "
                               f"loss {loss_err:.3g}, gradients {grad_err:.3g}")
        nce_loss_err, nce_grad_err = max(nce_loss_err, loss_err), max(nce_grad_err, grad_err)
        nce_err = max(nce_err, max_d)
    phase("nce", t0, f"kernel vs plain in {len(cases)} cases (N 1/7/160/1025/2500 x D 64/200 "
          f"x masked or not, shards at offsets 97 and 37, identical rows): loss rel "
          f"{nce_loss_err:.3g} (tol {NCE_LOSS_RTOL}), gradients max|d|/max|ref| "
          f"{nce_grad_err:.3g} (tol {NCE_GRAD_TOL}); one forward and one backward launch "
          f"a case")

    # 14. one train step, card vs CPU: small width, the same seeded weights,
    # model in f64 and losses in f32 (the NCE in its kernel on the card), no
    # dropout; in f32 the batch-statistics BatchNorm of ResNet-50 at batch 8
    # magnifies rounding far past these tolerances (tests/test_torch_train.py)
    small = convert.pose_state_dict(teacher_variables(np.random.default_rng(14), 64, 64))
    small_batch = train_batch(np.random.default_rng(14), 8, 64, 100)
    got = {}
    for where in ("cpu", "cuda"):
        model_s = PoseEstimator(img_feature_dim=64, shape_feature_dim=64)
        model_s.load_state_dict(small, strict=True)
        state_s = create_train_state(model_s.double().to(where), LR, [100], seed=0)
        batch = {k: torch.from_numpy(v).to(where) for k, v in small_batch.items()}
        batch["im"], batch["shape"] = batch["im"].double(), batch["shape"].double()
        before = counts()
        metrics = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)(
            state_s, batch)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(counts()[2:], before[2:]))
        got[where] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.grad.cpu() for k, p in model_s.named_parameters()},
                      {k: v.cpu() for k, v in model_s.state_dict().items() if "running" in k},
                      launched)
    (m_cpu, g_cpu, r_cpu, l_cpu), (m_gpu, g_gpu, r_gpu, l_gpu) = got["cpu"], got["cuda"]
    if l_gpu != (1, 1) or l_cpu != (0, 0):
        raise RuntimeError(f"train step NCE launches: card {l_gpu}, CPU {l_cpu}")
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
                   for k in ("loss", "pose_loss", "nce_loss"))
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    grad_err = 0.0
    for k, want in g_cpu.items():
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN
            if float(g_gpu[k].abs().max()) >= 1e-6 * largest:
                raise RuntimeError(f"train step: {k} has a gradient on the card only")
            continue
        grad_err = max(grad_err, rel_err(g_gpu[k], want))
    stat_err = max(float((r_gpu[k] - v).abs().max()) for k, v in r_cpu.items())
    if loss_err > STEP_LOSS_RTOL or grad_err > STEP_GRAD_TOL or stat_err > 1e-5:
        raise RuntimeError(f"train step card vs CPU: losses {loss_err:.3g}, gradients "
                           f"{grad_err:.3g}, running statistics {stat_err:.3g}")
    phase("train step", t0, f"card vs CPU at width 64, 64x64, batch 8 (f64 model, f32 "
          f"losses): losses rel {loss_err:.3g} (tol {STEP_LOSS_RTOL}), gradients max|d|/"
          f"max|ref| {grad_err:.3g} (tol {STEP_GRAD_TOL}), running statistics max|d| "
          f"{stat_err:.3g}; the card's step launched the NCE kernels {l_gpu}")

    # 15. the teacher's training at the recipe's width with --fused_nce,
    # through make_teacher_train_step: the training path's main path
    def recipe_teacher(seed):
        return PoseEstimator(img_feature_dim=1024, shape_feature_dim=TRAIN_SHAPE_DIM,
                             generator=torch.Generator().manual_seed(seed)).to(dev)

    state = create_train_state(recipe_teacher(46), LR, [10**9], seed=46)
    n_params = sum(p.numel() for p in state.model.parameters())
    step = steps.make_teacher_train_step(use_fused_nce=True)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in
          train_batch(np.random.default_rng(15), TRAIN_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [step(state, tb) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_counts = counts()
    losses = [float(m["loss"]) for m in history]
    pose_losses = [float(m["pose_loss"]) for m in history]
    if train_counts != (0, 0, TRAIN_STEPS, TRAIN_STEPS):
        raise RuntimeError(f"teacher training: launches (geodesic, pointnet, NCE forward, "
                           f"NCE backward) {train_counts}, expected one NCE forward and "
                           f"backward a step")
    if not all(math.isfinite(v) for v in losses + pose_losses) or \
            not (losses[-1] < losses[0] and pose_losses[-1] < pose_losses[0]):
        raise RuntimeError(f"teacher training on one repeated batch: losses {losses}, "
                           f"pose losses {pose_losses}")
    phase("teacher training", t0, f"{n_params} params, batch {TRAIN_BATCH}, 224x224, "
          f"{POINT_NUM} points, {TRAIN_STEPS} steps on one batch: loss "
          f"{[round(v, 4) for v in losses]} (pose {[round(v, 4) for v in pose_losses]}); "
          f"NCE launches {train_counts[2]} forward, {train_counts[3]} backward")

    # 16. the trainer: one epoch on in-memory samples (train, both
    # evaluations, checkpoints), then a resume into a second
    with tempfile.TemporaryDirectory() as tmp:
        def loaders():
            sets = (MemorySet(64, 16, 224), MemorySet(40, 17, 224), MemorySet(40, 18, 224))
            return (DataLoader(sets[0], 32, shuffle=True, drop_last=True, num_workers=2),
                    DataLoader(sets[1], 32, shuffle=False, num_workers=2),
                    DataLoader(sets[2], 32, shuffle=False, num_workers=2))

        fit_state = create_train_state(recipe_teacher(16), LR, [10**9], seed=46)
        train_l, val_l, cat_l = loaders()
        trainer = TeacherTrainer(fit_state, train_l, val_l, EVAL_CATEGORIES, tmp,
                                 print_freq=100, cat_eval_loader=cat_l, use_fused_nce=True)
        reset_counts()
        trainer.fit(1)
        torch.cuda.synchronize()
        fit_counts = counts()
        saved = set(os.listdir(os.path.join(tmp, "ckpt")))
        if fit_counts[0] != 2 or fit_counts[1] < 2 or fit_counts[2:] != (2, 2) or \
                not {"checkpoint.pth", "checkpoint_img_encoder.pth", "EPOCH"} <= saved:
            raise RuntimeError(f"trainer epoch: launches {fit_counts}, checkpoint files "
                               f"{sorted(saved)}")
        resumed = create_train_state(recipe_teacher(99), LR, [10**9], seed=0)
        resumed.load_state_dict(trainer.ckpt.restore("checkpoint"))
        same = all(torch.equal(a, b) for a, b in zip(
            fit_state.model.state_dict().values(), resumed.model.state_dict().values()))
        train_l, val_l, cat_l = loaders()
        TeacherTrainer(resumed, train_l, val_l, EVAL_CATEGORIES, tmp, print_freq=100,
                       cat_eval_loader=cat_l, use_fused_nce=True).fit(2, start_epoch=1)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(tmp, "ckpt", "EPOCH")) as f:
            last_epoch = f.read()
        if not same or resumed.step != 4 or last_epoch != "1" or \
                [r["epoch"] for r in records] != [0, 1] or \
                not all(math.isfinite(r["train_loss"]) and math.isfinite(r["val_nce"])
                        for r in records):
            raise RuntimeError(f"trainer resume: state restored {same}, step "
                               f"{resumed.step}, EPOCH {last_epoch}, records {records}")
    phase("trainer", t0, f"epoch 0 at batch 32 (2 steps, 40 + 40 evaluation rows): "
          f"launches (geodesic, pointnet, NCE forward, NCE backward) {fit_counts}; "
          f"checkpoints {sorted(saved)}; resumed from them (state equal) into epoch 1; "
          f"train_loss {[round(r['train_loss'], 4) for r in records]} val_nce "
          f"{[round(r['val_nce'], 4) for r in records]}")
    del fit_state, resumed, trainer

    # 17. training times at batch 160 (host clock around synced steps), a
    # profile of two steps, and the NCE kernels vs their plain versions
    torch.cuda.synchronize()
    tt = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step(state, tb)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - tt) * 1e3 / TRAIN_STEPS
    phase("time", t0, f"teacher train step f32 batch {TRAIN_BATCH}, --fused_nce: "
          f"{step_ms:.3f} ms/step = {TRAIN_BATCH * 1000.0 / step_ms:.1f} samples/s [{card}]")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tt = time.perf_counter()
        for _ in range(2):
            step(state, tb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tt) * 1e3
    # the device's own rows (kernels, copies), as the profiler's "Self CUDA
    # time total" counts them: an aten op's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    nce_ms = sum(e.self_device_time_total for e in rows if "nce_" in e.key) / 1e3
    phase("profile", t0, f"2 train steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms "
          f"wall (busy {device_ms / wall_ms:.3f}); the NCE kernels {nce_ms:.4f} ms "
          f"[{card}]; by self device time:")
    for e in rows[:16] if device_ms > 0 else []:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / 1e3 / device_ms:5.1f} %  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)

    nce_times = {}
    for n in (TRAIN_BATCH, 4096):
        s_c, t_c, _, _ = nce_inputs(np.random.default_rng(17), n, 200, dev)
        loss, count, saved_res = nce.nce_forward(s_c, t_c, None, None, 0, 0.1, True)
        g = torch.ones((), device=dev)
        s_g, t_g = s_c.clone().requires_grad_(), t_c.clone().requires_grad_()
        plain_loss = nce.info_nce_plain(s_g, t_g) / n

        def plain_fwd():
            with torch.no_grad():
                nce.info_nce_plain(s_c, t_c)

        iters = 200 if n == TRAIN_BATCH else 20
        fns = {"kernel forward": lambda: nce.nce_forward(s_c, t_c, None, None, 0, 0.1, True),
               "kernel backward": lambda: nce.nce_backward(saved_res, None, None, count, g, 0,
                                                           0.1, True),
               "plain forward": plain_fwd,
               "plain backward": lambda: torch.autograd.grad(plain_loss, (s_g, t_g),
                                                             retain_graph=True)}
        # in turns: plain, kernel, kernel, plain
        runs = {k: [] for k in fns}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for who in order:
                for part in ("forward", "backward"):
                    runs[f"{who} {part}"].append(cuda_ms(fns[f"{who} {part}"], iters))
        nce_times[n] = {k: sum(v) / len(v) for k, v in runs.items()}
        phase("time", t0, f"NCE ({n}, 200): kernel forward {runs['kernel forward']} + "
              f"backward {runs['kernel backward']} ms; plain forward "
              f"{runs['plain forward']} + backward {runs['plain backward']} ms; "
              f"forward+backward {nce_times[n]['kernel forward'] + nce_times[n]['kernel backward']:.4f}"
              f" vs {nce_times[n]['plain forward'] + nce_times[n]['plain backward']:.4f} ms "
              f"[{card}]")
    n, d = TRAIN_BATCH, 200
    fwd_bound = bound(4.0 * 2 * n * d, 2.0 * n * n * d)
    bwd_bound = bound(4.0 * 4 * n * d, 4.0 * n * n * d)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(card)
    print(json.dumps({"kernels": [
        entry("geodesic_rotation_err", "pose3d_tpu_torch/csrc/geodesic.cu",
              "pose3d_tpu/ops/geodesic.py:65", student_geo + teacher_geo, geo_err,
              geo_times[1_000_000][0], geo_times[1_000_000][1], geo_bound),
        entry("pointnet_eval", "pose3d_tpu_torch/csrc/pointnet_eval.cu",
              "pose3d_tpu/ops/pointnet_fused.py:78", teacher_pn, pn_err, pn_times[64][0],
              pn_times[64][1], pn_bound),
        entry("info_nce_forward", "pose3d_tpu_torch/csrc/info_nce.cu",
              "pose3d_tpu/ops/nce_fused.py:109", train_counts[2], nce_err,
              nce_times[n]["kernel forward"], nce_times[n]["plain forward"], fwd_bound),
        entry("info_nce_backward", "pose3d_tpu_torch/csrc/info_nce.cu",
              "pose3d_tpu/ops/nce_fused.py:134", train_counts[3], nce_err,
              nce_times[n]["kernel backward"], nce_times[n]["plain backward"], bwd_bound)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
