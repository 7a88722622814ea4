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
    backward in the NCE kernels and whose train-mode PointNet runs in its
    kernels, then the trainer's epoch loop (train, both evaluations,
    checkpoints, resume);
  * the KD --crd student's training at the KD CLI's width (the student
    above, the frozen teacher above, batch 46 samples x 3 views, 224x224,
    2,500 points, Adam lr 1e-4): train steps whose student stem runs
    forward and backward in the VGG stem kernels and whose teacher encodes
    the clouds in the PointNet kernel, then the KD trainer's epoch loop;
  * KD --stage 1 (the student above and the vanilla teacher: ResNet-18,
    img_feature_dim 1024, shape_feature_dim 256, 2,500 points; batch 46,
    Adam lr 1e-4, tau 0.5, --fused_nce): train steps through the stem, NCE
    and train-mode PointNet kernels, then the stage-1 trainer's epoch loop.
The student's stem (conv3x3 + ReLU + 2x2 pool) runs in the VGG stem
kernel in every student forward. Phases:

  1 device    2 build    3 geodesic kernel vs plain
  4 pointnet kernel vs plain    5 VGG stem kernel vs plain
  6 student at full width    7 student serving    8 student evaluation
  9 teacher at full width    10 teacher serving    11 teacher evaluation
  12 view_tile    13 serving times
  14 NCE kernel vs plain    15 train step, card vs CPU
  16 teacher training at full width    17 trainer epoch and resume
  18 training times (with and without the train-mode PointNet kernels)
     and profile
  19 KD step, card vs CPU    20 KD training at full width
  21 KD trainer epoch and resume    22 KD times and profile
  23 train-mode PointNet kernels vs plain    24 stage-1 training at full
  width    25 stage-1 trainer epoch and resume    26 stage-1 times and
  profile    27 train-mode PointNet times
Each path (7-8, 10-11, 16-17, 20-21 and 24-25) is driven with the
kernels' launch counts set to 0 just before it and read just after it;
16, 20 and 24 are the three training paths' main paths.

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
# VGG stem kernel vs plain: f32 sums of 27 products (forward), of the
# gradient over the image (weight and bias) in another order; each against
# its max|ref|
STEM_Y_TOL, STEM_GRAD_TOL = 1e-5, 1e-4
KD_BATCH = 46  # samples a KD step (x 3 views: 138 student rows), bench.py's
# the train-mode PointNet kernel vs the plain version in float64 on the
# kernel's inputs: outputs and statistics over their max|ref| (f32 sums of
# up to 400,000 points in another order); gradients over their max|ref|;
# the dense biases' gradients (zero in exact arithmetic) over the largest
# weight gradient; how far below the f64 maximum an argmax point may lie (a
# near tie that f32 rounding decides otherwise), over max|out|; how far
# from 0 a ReLU input may lie where the kernels decide it otherwise than
# f64, over its channel's max|input| (4 f32 ulps); and how many such
# decisions they may make: twice the f32 plain version's, plus 2
PT_OUT_TOL, PT_GRAD_TOL, PT_BIAS_TOL, PT_TIE_TOL = 1e-5, 1e-3, 1e-2, 1e-5
PT_RELU_TOL = 2.0**-21
STAGE1_SHAPE_DIM = 256  # PoseEstimatorVanilla's shape_feature_dim
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


class _Init:
    """Seeded numpy initialisers for the hand-written variable trees below:
    kernels He-scaled by `gain`, biases small, BatchNorm statistics random."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def normal(self, shape, std):
        return std * self.rng.standard_normal(shape, dtype=np.float32)

    def dense(self, fan_in, out, gain=2.0):
        return {"kernel": self.normal((fan_in, out), math.sqrt(gain / fan_in)),
                "bias": self.normal((out,), 0.01)}

    def bn(self, width):
        return ({"scale": 1.0 + self.normal((width,), 0.1), "bias": self.normal((width,), 0.1)},
                {"mean": self.normal((width,), 0.1),
                 "var": self.rng.uniform(0.5, 1.5, width).astype(np.float32)})

    def convbn(self, k, cin, cout, gain):
        p, s = self.bn(cout)
        return ({"Conv_0": {"kernel": self.normal((k, k, cin, cout),
                                                  math.sqrt(gain / (k * k * cin)))},
                 "BatchNorm_0": p}, {"BatchNorm_0": s})

    def resnet(self, stages, bottleneck: bool, out_dim: int):
        """ResNet_0's (params, batch_stats): the last conv of each residual
        branch and the projection have gain 0.25, so that the residual
        stream keeps its scale through the blocks (with gain 1 the image
        feature grows to about 70)."""
        params, stats = {}, {}
        params["ConvBN_0"], stats["ConvBN_0"] = self.convbn(7, 3, 64, 2.0)
        channels, k = 64, 0
        expansion = 4 if bottleneck else 1
        for i, n_blocks in enumerate(stages):
            width = 64 * 2**i
            for j in range(n_blocks):
                if bottleneck:
                    convs = [(1, channels, width, 2.0), (3, width, width, 2.0),
                             (1, width, 4 * width, 0.25)]
                else:
                    convs = [(3, channels, width, 2.0), (3, width, width, 0.25)]
                if channels != expansion * width or (j == 0 and i > 0):  # a projection
                    convs.append((1, channels, expansion * width, 0.25))
                block, block_stats = {}, {}
                for c, args in enumerate(convs):
                    block[f"ConvBN_{c}"], block_stats[f"ConvBN_{c}"] = self.convbn(*args)
                name = f"{'Bottleneck' if bottleneck else 'BasicBlock'}_{k}"
                params[name], stats[name] = block, block_stats
                channels, k = expansion * width, k + 1
        params["Dense_0"] = self.dense(channels, out_dim, gain=1.0)
        return params, stats

    def pointnet(self, d):
        params, stats = {}, {}
        widths = (3, 64, 128, d)
        for i in range(3):
            params[f"Dense_{i}"] = self.dense(widths[i], widths[i + 1])
            params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = self.bn(widths[i + 1])
        return params, stats

    def heads(self, width):
        return {f"Dense_{i}": self.dense(width, HEAD_BINS[i % 3], gain=1.0) for i in range(6)}

    def dense_bn_relu(self, params, stats, start, widths):
        for i, (fan_in, out) in enumerate(zip(widths[:-1], widths[1:])):
            p, s = self.bn(out)
            params[f"DenseBNRelu_{start + i}"] = {"Dense_0": self.dense(fan_in, out),
                                                  "BatchNorm_0": p}
            stats[f"DenseBNRelu_{start + i}"] = {"BatchNorm_0": s}


def teacher_variables(rng: np.random.Generator, img_feature_dim: int = 1024,
                      shape_feature_dim: int = 1024) -> dict:
    """Seeded numpy {"params", "batch_stats"} with the shapes of the JAX
    `pose3d_tpu.models.estimators.PoseEstimator(shape="PointCloud")`, written
    out by hand like `student_variables` (tests/test_torch_teacher.py holds
    them against jax.eval_shape). The DeformNet's last layer has gain 0.25,
    so that most of the fused feature stays off tanh's flat ends."""
    init = _Init(rng)
    resnet, resnet_stats = init.resnet(RESNET50_STAGES, True, img_feature_dim)
    pointnet, pointnet_stats = init.pointnet(shape_feature_dim)
    b = shape_feature_dim + img_feature_dim
    deform, deform_stats = {}, {}
    init.dense_bn_relu(deform, deform_stats, 0, (b, b, b // 2, b // 4))
    deform["Dense_0"] = init.dense(b // 4, 200, gain=0.25)
    params = {"ResNet_0": resnet, "ShapeEncoderPC_0": pointnet, "DeformNet_0": deform,
              "_SixHeads_0": init.heads(200)}
    stats = {"ResNet_0": resnet_stats, "ShapeEncoderPC_0": pointnet_stats,
             "DeformNet_0": deform_stats}
    init.dense_bn_relu(params, stats, 0, (img_feature_dim, 800, 400))
    params["Dense_0"] = init.dense(400, 200, gain=1.0)
    return {"params": params, "batch_stats": stats}


def vanilla_variables(rng: np.random.Generator, img_feature_dim: int = 1024,
                      shape_feature_dim: int = 256) -> dict:
    """Seeded numpy {"params", "batch_stats"} with the shapes of the JAX
    `PoseEstimatorVanilla(shape="PointCloud")`: ResNet-18, the PointNet, the
    compress MLP and the six heads (tests/test_torch_stage1.py holds them
    against jax.eval_shape)."""
    init = _Init(rng)
    resnet, resnet_stats = init.resnet((2, 2, 2, 2), False, img_feature_dim)
    pointnet, pointnet_stats = init.pointnet(shape_feature_dim)
    params = {"ResNet_0": resnet, "ShapeEncoderPC_0": pointnet}
    stats = {"ResNet_0": resnet_stats, "ShapeEncoderPC_0": pointnet_stats}
    init.dense_bn_relu(params, stats, 0,
                       (shape_feature_dim + img_feature_dim, 800, 400, 200))
    params["_SixHeads_0"] = init.heads(200)
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


def steps_ms(run_step, steps: int = TRAIN_STEPS) -> float:
    """Host-clock ms a step of `steps` synced calls of run_step()."""
    torch.cuda.synchronize()
    tt = time.perf_counter()
    for _ in range(steps):
        run_step()
    torch.cuda.synchronize()
    return (time.perf_counter() - tt) * 1e3 / steps


def ab_times(module, name: str, plain, run) -> dict:
    """run() with `module.<name>` as it is ("kernel") and swapped for
    `plain` ("plain"), in turns kernel, plain, plain, kernel: the swap is a
    measurement only and is undone at once."""
    kernel = getattr(module, name)
    ab = {"kernel": [], "plain": []}
    for who in ("kernel", "plain", "plain", "kernel"):
        setattr(module, name, plain if who == "plain" else kernel)
        try:
            ab[who].append(run())
        finally:
            setattr(module, name, kernel)
    return ab


def profile_steps(run_step, steps: int = 2):
    """Profile `steps` calls of run_step(): the device's own rows (kernels,
    copies), as the profiler's "Self CUDA time total" counts them (an aten
    op's row repeats its kernels' time), sorted by self device time; their
    sum in ms; and the wall time in ms of the synced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tt = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tt) * 1e3
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), key=lambda e: -e.self_device_time_total)
    return rows, sum(e.self_device_time_total for e in rows) / 1e3, wall_ms


def print_rows(rows, device_ms: float, top: int = 16) -> None:
    for e in rows[:top] if device_ms > 0 else []:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / 1e3 / device_ms:5.1f} %  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


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


def stem_inputs(rng: np.random.Generator, n: int, hw: int, f: int, kind: str, dev,
                dtype=torch.float32):
    """The stem's inputs, as the student hands them over: an NCHW view of
    NHWC memory, the (F, 3, 3, 3) weight and bias (both needing a
    gradient), and an upstream gradient. `kind`: random, "ties" (an image
    constant on each 2x2 cell and the kernel's centre tap only: every
    pooling window ties, and the off-centre taps' gradient shows which
    position took it) or "negative" (every output masked by the ReLU)."""
    if kind == "ties":
        cells = rng.standard_normal((n, hw // 2, hw // 2, 3))
        x = np.repeat(np.repeat(cells, 2, axis=1), 2, axis=2)
        w = np.zeros((f, 3, 3, 3))
        w[:, :, 1, 1] = rng.standard_normal((f, 3))
    else:
        x = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
        w = rng.standard_normal((f, 3, 3, 3)) * math.sqrt(2.0 / 27)
        if kind == "negative":  # positive weights on a negative image
            x, w = -100.0 - np.abs(x), np.abs(w)
    b = rng.standard_normal(f) * 0.1
    as_dev = lambda a: torch.from_numpy(a).to(dev, dtype)
    # the upstream gradient drawn on the device: 111 M values at the KD shape
    g = torch.randn((n, hw // 2, hw // 2, f), device=dev, dtype=dtype,
                    generator=torch.Generator(dev).manual_seed(int(rng.integers(2**31))))
    return (as_dev(x).permute(0, 3, 1, 2), as_dev(w).requires_grad_(),
            as_dev(b).requires_grad_(), g.permute(0, 3, 1, 2))


def stem_kernel_vs_plain(vgg_stem, x, w, b, g):
    """The stem's output and weight/bias gradients through the kernels and
    through the plain version (autograd) on the same inputs: (output error
    over max|ref|, gradient error over max|ref|, max|d|, the kernels' bits
    equal on a second run, the kernel's largest output)."""
    runs = []
    for _ in range(2):
        y = vgg_stem.vgg_stem(x, w, b)
        runs.append((y.detach(), *torch.autograd.grad(y, (w, b), g)))
    y_ref = vgg_stem.vgg_stem_plain(x, w, b)
    refs = (y_ref.detach(), *torch.autograd.grad(y_ref, (w, b), g))
    errs = [float((got - want).abs().max()) for got, want in zip(runs[0], refs)]
    scaled = [e / max(float(want.abs().max()), 1e-6) for e, want in zip(errs, refs)]
    same = all(torch.equal(a, c) for a, c in zip(*runs))
    return scaled[0], max(scaled[1:]), max(errs), same, float(runs[0][0].max())


def student_heads_plain_stem(model, x):
    """The student's eval forward with its first block run layer by layer
    (cuDNN conv, ReLU, MaxPool2d): the plain stem, on the card too."""
    from pose3d_tpu_torch.models.estimators import HEADS

    vgg = model.img_encoder
    feat = vgg.classifier(torch.flatten(vgg.features(x.permute(0, 3, 1, 2)), 1))
    h = model.compress(feat)
    return [getattr(model, name)(h) for name in HEADS]


def kd_batch(rng: np.random.Generator, n: int, dim: int, points: int) -> dict:
    """A KD train batch as the loader emits it (numpy): three views of each
    sample with their labels, and the sample's cloud."""
    batch = {}
    for view in ("", "_flip", "_rot"):
        batch["im" + view] = rng.standard_normal((n, dim, dim, 3), dtype=np.float32)
        batch["label" + view] = random_labels(rng, n)
    extent = rng.uniform(0.2, 1.0, (n, 1, 3))
    batch["shape"] = (rng.uniform(0, 1, (n, points, 3)) * extent).astype(np.float32)
    return batch


def pt_inputs(rng: np.random.Generator, n: int, p: int, d: int, dev,
              dtype=torch.float32, masked=False, ties=False, gamma0=False):
    """One case of the train-mode PointNet: clouds of varied extents (with
    `ties`, every point of cloud 0 the same, so that each of its outputs
    ties over all its points), He-scaled (weight (out, in), bias, gamma,
    beta) layers (with `gamma0`, gamma3 = 0 in channel 0: every point ties
    there), the (N,) validity (with `masked`, the last quarter of the
    clouds padded) and an upstream gradient."""
    pts = rng.uniform(0, 1, (n, p, 3)) * rng.uniform(0.2, 1.0, (n, 1, 3))
    if ties:
        pts[0] = pts[0, :1]
    layers = []
    for fan_in, out in ((3, 64), (64, 128), (128, d)):
        layers.append([rng.standard_normal((out, fan_in)) * math.sqrt(2.0 / fan_in),
                       0.1 * rng.standard_normal(out), 1.0 + 0.1 * rng.standard_normal(out),
                       0.1 * rng.standard_normal(out)])
    if gamma0:
        layers[2][2][0] = 0.0
    as_dev = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    valid = torch.from_numpy(np.arange(n) < n - max(1, n // 4)).to(dev) if masked else None
    return (as_dev(pts), [[as_dev(a) for a in layer] for layer in layers], valid,
            as_dev(rng.standard_normal((n, d))))


def pt_reference(pts, layers, valid, index, masks=None):
    """The plain version's function in the inputs' dtype, with its max taken
    at the points `index` (N, D) and, with `masks`, its ReLUs opened there
    (`forward_parts`). Returns (out (N, D), (y1, y2) the ReLUs' inputs)."""
    from pose3d_tpu_torch.tools.pointnet_train_precision import forward_parts

    y3, pre, _ = forward_parts(pts, layers, valid, masks)
    return y3.gather(1, index.to(torch.int64)[:, None, :])[:, 0], pre


def relu_flips(h_pairs, pre_ref) -> tuple[int, float]:
    """ReLU decisions ((h > 0) of each layer) that differ from float64's,
    and the largest |float64 ReLU input| among them over its channel's
    max|input|: how close to 0 the inputs lie where the two part ways."""
    flips, gap = 0, 0.0
    for open_, y in zip(h_pairs, pre_ref):
        differ = open_ != (y > 0)
        flips += int(differ.sum())
        if bool(differ.any()):
            rel = y.abs() / y.abs().amax((0, 1)).clamp_min(1e-30)
            gap = max(gap, float(rel[differ].max()))
    return flips, gap


def pt_kernel_vs_plain(pt, pts, layers, valid, g) -> dict:
    """The train-mode PointNet's kernels (forward and backward, twice, and
    one use under autograd) against the plain version in float64 on the
    same inputs, at its own max and ReLU decisions. Returns
    out / stats: errors over max|ref|; own_grads: the 12 gradients'
    errors against the plain version's own (the weights', gammas' and
    betas', over max|ref|); grads: the same against float64 at the
    kernels' argmax points and ReLU decisions, which part from float64's
    only where tie_gap and relu_gap bound them: a ReLU input within f32
    rounding of 0, or a near tie, may go either way, and where it routes a
    maximum's gradient that moves a gradient by about 1e-3 of its largest
    entry; bias: the dense biases' gradients over the largest weight
    gradient; tie_gap: how far below the f64 maximum the kernels' argmax
    points lie, over max|out|; moved: argmax entries other than f64's;
    relu_gap, flips: `relu_flips` of the kernels' decisions; plain_flips
    and plain_own_grads: the f32 plain version's ReLU decisions that differ
    from f64's and its gradients' errors against f64's own, on the card;
    max_d: the largest |difference|; same: the same bits on a second run
    and under autograd; launches: (forward, backward) calls of the autograd
    use."""
    d = layers[2][0].shape[0]
    prm = pt.pack_params(layers)
    runs = []
    for _ in range(2):
        out, stats, idx, h1, h2, gram = pt.train_forward(pts, prm, d, valid)
        runs.append((out, stats, idx, pt.train_backward(pts, prm, d, valid, stats, idx, h1,
                                                        h2, gram, g)))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    out, stats, idx, grads = runs[0]
    opened = (h1 > 0, h2 > 0)
    del h1, h2
    grads = pt.unpack_grads(grads, d)
    tracked = [[t.clone().requires_grad_() for t in layer] for layer in layers]
    before = (pt.train_forward.launches, pt.train_backward.launches)
    out_a, _ = pt.pointnet_train(pts, tracked, valid)
    grads_a = torch.autograd.grad(out_a, [t for layer in tracked for t in layer], g)
    launches = (pt.train_forward.launches - before[0], pt.train_backward.launches - before[1])
    same = same and torch.equal(out_a, out) and all(torch.equal(a, b)
                                                    for a, b in zip(grads_a, grads))
    del out_a, grads_a

    flat = lambda ls: [t for layer in ls for t in layer]
    pts64 = pts.double()
    own = [[t.double().requires_grad_() for t in layer] for layer in layers]
    best, stats_r, idx_r = pt.pointnet_train_plain(pts64, own, valid)
    grads_o = torch.autograd.grad(best, flat(own), g.double())
    best = best.detach()
    own32 = [[t.clone().requires_grad_() for t in layer] for layer in layers]
    grads_32 = torch.autograd.grad(pt.pointnet_train_plain(pts, own32, valid)[0], flat(own32), g)
    with torch.no_grad():
        at_idx, pre64 = pt_reference(pts64, own, valid, idx)
        _, pre32 = pt_reference(pts, layers, valid, idx)
        flips, relu_gap = relu_flips(opened, pre64)
        plain_flips, _ = relu_flips([y > 0 for y in pre32], pre64)
    del pre64, pre32
    pinned = [[t.double().requires_grad_() for t in layer] for layer in layers]
    out_r, _ = pt_reference(pts64, pinned, valid, idx, masks=opened)
    grads_r = torch.autograd.grad(out_r, flat(pinned), g.double())
    scale = lambda r: max(float(r.detach().abs().max()), 1e-30)
    diff = lambda a, r: float((a.double() - r.detach()).abs().max())
    grad_err = lambda got, ref: max(diff(a, r) / scale(r) for i, (a, r) in
                                    enumerate(zip(got, ref)) if i % 4 != 1)
    largest = max(scale(grads_r[4 * i]) for i in range(3))
    return {
        "out": diff(out, best) / scale(best),
        "stats": max(diff(a, r) / scale(r) for pair, pair_r in
                     zip(pt.split_stats(stats, d), stats_r) for a, r in zip(pair, pair_r)),
        "grads": grad_err(grads, grads_r), "own_grads": grad_err(grads, grads_o),
        "plain_own_grads": grad_err(grads_32, grads_o),
        "bias": max(float(a.abs().max()) for a in grads[1::4]) / largest,
        "tie_gap": float((best - at_idx).max()) / scale(best),
        "moved": int((idx.long() != idx_r).sum()),
        "relu_gap": relu_gap, "flips": flips, "plain_flips": plain_flips,
        "max_d": max([diff(out, best)] + [diff(a, r) for a, r in zip(grads, grads_r)]),
        "same": same, "launches": launches}


class KDMemorySet(MemorySet):
    """KD samples (three views, labels, a cloud) held in memory, or, with
    `train` False, evaluation samples (one view, no cloud)."""

    def __init__(self, n: int, seed: int, dim: int, train: bool = True):
        rng = np.random.default_rng(seed)
        self.batch = kd_batch(rng, n, dim, POINT_NUM)
        if not train:
            self.batch = {"im": self.batch["im"], "label": self.batch["label"]}
        self.batch["cat_id"] = rng.integers(0, len(EVAL_CATEGORIES), n).astype(np.int32)
        self.category_names = list(EVAL_CATEGORIES)


def main() -> int:
    t0 = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from pose3d_tpu_torch import geometry
    from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                    PoseEstimatorVanilla)
    from pose3d_tpu_torch.data.loader import DataLoader
    from pose3d_tpu_torch.ops import _build, geodesic, nce, pointnet, pointnet_train, vgg_stem
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.train.evaluate import evaluate_categories
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.trainer import KDTrainer, TeacherTrainer

    def reset_counts():
        geodesic.rotation_err.launches = pointnet.pointnet_eval.launches = 0
        nce.nce_forward.launches = nce.nce_backward.launches = 0
        vgg_stem.stem_forward.launches = vgg_stem.stem_backward.launches = 0
        pointnet_train.train_forward.launches = pointnet_train.train_backward.launches = 0

    def counts():
        """(geodesic, pointnet, NCE forward, NCE backward, stem forward,
        stem backward, train-mode pointnet forward, its backward) launches."""
        return (geodesic.rotation_err.launches, pointnet.pointnet_eval.launches,
                nce.nce_forward.launches, nce.nce_backward.launches,
                vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                pointnet_train.train_forward.launches, pointnet_train.train_backward.launches)

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", t0, f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for cuDNN and matmul")

    # 2. build: one nvcc per source, all started together
    tb = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        libs = list(pool.map(_build.build, ("geodesic", "pointnet_eval", "info_nce",
                                            "vgg_stem", "pointnet_train")))
    build_s = time.perf_counter() - tb
    for lib in libs:
        with open(lib[:-3] + ".log") as f:
            ptxas = " | ".join(line.strip() for line in f
                               if "ptxas info" in line or "spill" in line)
        phase("build", t0, f"nvcc {lib}; {ptxas}")
    phase("build", t0, f"five libraries in {build_s:.2f} s; pointnet_eval_kernel: "
          f"{pointnet.shared_memory_bytes()} bytes of dynamic shared memory a block; "
          f"info_nce at D 200 (forward, backward): {nce.shared_memory_bytes(200)} bytes; "
          f"vgg_stem at F 64 (forward, weight gradient): "
          f"{vgg_stem.shared_memory_bytes(64)} bytes; pointnet_train's largest block "
          f"(f32, f64): {pointnet_train.shared_memory_bytes()}, "
          f"{pointnet_train.shared_memory_bytes(torch.float64)} bytes; its CUDA launches a "
          f"forward and a backward call: {pointnet_train.kernel_launches_per_call()}")

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

    # 5. VGG stem kernel vs plain version on the card: forward and the
    # weight/bias gradient, at the main path's shapes and around them
    srng = np.random.default_rng(2)
    cases = [(n_c, hw, f_c, "rand") for n_c in (1, 7, 138) for hw in (224, 64, 30)
             for f_c in (16, 64)]
    cases += [(7, 224, 64, "ties"), (7, 224, 64, "negative")]
    stem_y_err = stem_grad_err = stem_err = 0.0
    for n_c, hw, f_c, kind in cases:
        x_s, w_s, b_s, g_s = stem_inputs(srng, n_c, hw, f_c, kind, dev)
        before = counts()
        y_err, grad_err, max_d, same, y_max = stem_kernel_vs_plain(vgg_stem, x_s, w_s, b_s,
                                                                   g_s)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(counts()[4:6], before[4:6]))
        if launched != (2, 2) or not same or (kind == "negative") != (y_max == 0.0):
            raise RuntimeError(f"stem case {(n_c, hw, f_c, kind)}: launches (forward, "
                               f"backward) {launched} for two runs, bits equal {same}, "
                               f"largest output {y_max}")
        if y_err > STEM_Y_TOL or grad_err > STEM_GRAD_TOL:
            raise RuntimeError(f"stem kernel vs plain at {(n_c, hw, f_c, kind)}: output "
                               f"{y_err:.3g}, gradients {grad_err:.3g}")
        stem_y_err, stem_grad_err = max(stem_y_err, y_err), max(stem_grad_err, grad_err)
        stem_err = max(stem_err, max_d)
    del x_s, w_s, b_s, g_s
    phase("vgg_stem", t0, f"kernel vs plain in {len(cases)} cases (N 1/7/138 x H=W 224/64/30 "
          f"x F 16/64, every window tied, every output masked): output max|d|/max|ref| "
          f"{stem_y_err:.3g} (tol {STEM_Y_TOL}), weight and bias gradients {stem_grad_err:.3g} "
          f"(tol {STEM_GRAD_TOL}); one forward and one backward launch a run, the same bits "
          f"on a second run")

    # 6. student at full width, random weights from a seed, loaded strictly
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
        # the same student with its first block layer by layer on the card
        heads_plain = student_heads_plain_stem(model, x.to(dev))
        vp_plain = geometry.decode_predictions_inference(heads_plain[:3], heads_plain[3:], 15)
    worst = max(rel_err(g, w) for g, w in zip(heads + [proj], heads_ref + [proj_ref]))
    if worst > HEADS_REL_TOL:
        raise RuntimeError(f"student card vs CPU: max|d|/max|ref| {worst:.3g}")
    phase("student", t0, f"{n_params} params loaded strict; batch 64 and 1 finite; "
          f"batch 2 card vs CPU max|d|/max|ref| {worst:.3g} (tol {HEADS_REL_TOL})")
    del model_cpu

    # the student's main path: serving, then evaluation
    reset_counts()
    # 7. serving: NHWC batch -> forward -> inference decoder
    vp = model.predict_viewpoint(x.to(dev))
    torch.cuda.synchronize()
    serving_stem = counts()[4:6]
    if vp.shape != (64, 3) or not bool(((vp >= 0) & (vp <= 360)).all()):
        raise RuntimeError(f"serving output {tuple(vp.shape)} outside [0, 360]")
    vp_d = float((vp - vp_plain).abs().max())
    if serving_stem != (1, 0) or vp_d >= 5e-3:  # the printed digits agree
        raise RuntimeError(f"student serving: stem launches {serving_stem}, predictions vs "
                           f"the plain stem's max|d| {vp_d:.3g} deg")
    phase("student serving", t0, f"64 requests -> {tuple(vp.shape)} degrees in [0, 360], "
          f"{serving_stem[0]} stem launch; first {np.round(vp[0].cpu().numpy(), 2).tolist()}, "
          f"plain stem {np.round(vp_plain[0].cpu().numpy(), 2).tolist()} (max|d| over the "
          f"batch {vp_d:.3g} deg)")
    # 8. evaluation, and again with the plain stem
    result = evaluate_categories(steps.make_eval_step(model, "student"),
                                 eval_batches(3, False), EVAL_CATEGORIES, dev)
    torch.cuda.synchronize()
    student_geo, eval_stem = geodesic.rotation_err.launches, counts()[4] - serving_stem[0]
    if student_geo < 1 or eval_stem != len(EVAL_COUNTS):
        raise RuntimeError(f"the student's evaluation made {student_geo} geodesic and "
                           f"{eval_stem} stem launches")
    check_eval(result, geometry, "student")
    plain_step = steps.make_eval_step(model, "student")

    def plain_stem_step(batch):
        with torch.no_grad():
            heads_p = student_heads_plain_stem(model, batch["im"])
        return {"pred": geometry.decode_predictions(heads_p[:3], heads_p[3:], 15),
                "per_sample_loss": plain_step(batch)["per_sample_loss"]}

    result_plain = evaluate_categories(plain_stem_step, eval_batches(3, False),
                                       EVAL_CATEGORIES, dev)
    pred_d = float(np.abs(result.predictions - result_plain.predictions).max())
    if result.per_category_acc != result_plain.per_category_acc or pred_d >= 5e-3:
        raise RuntimeError(f"student evaluation vs the plain stem's: Acc "
                           f"{result.per_category_acc} vs {result_plain.per_category_acc}, "
                           f"predictions max|d| {pred_d:.3g}")
    p_eval = torch.from_numpy(result.predictions).to(dev)
    l_eval = torch.from_numpy(result.labels).float().to(dev)
    d_eval = geodesic.rotation_err(p_eval, l_eval) - geometry.rotation_err(p_eval, l_eval)
    geo_err = max(geo_err, float(d_eval.abs().max()))
    phase("student evaluation", t0, f"{len(result.cat_ids)} rows, {student_geo} geodesic "
          f"and {eval_stem} stem launch(es); Acc {result.per_category_acc} Med "
          f"{ {k: round(v, 3) for k, v in result.per_category_med.items()} } "
          f"val_loss {result.val_loss:.4f}; equal to the plain CPU recomputation; with the "
          f"plain stem the same Acc and predictions within {pred_d:.3g} deg")

    # 9. teacher at full width, random weights from a seed, loaded strictly
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
    # 10. serving: (image, cloud) requests -> forward -> inference decoder
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
    # 11. evaluation through the teacher's eval step (validation NCE included)
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

    # 12. view_tile: 3 stacked views of 16 samples, the 16 clouds encoded once
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

    # 13. times (CUDA events, after warm-up), with the card beside each
    with torch.no_grad():
        for b in (1, 64, 256):
            xb = torch.from_numpy(np.random.default_rng(4).standard_normal(
                (b, 224, 224, 3), dtype=np.float32)).to(dev)
            ms = cuda_ms(lambda: model(xb), iters=20 if b < 256 else 10)
            phase("time", t0, f"student serving f32 batch {b} (stem kernel): {ms:.3f} "
                  f"ms/batch = {b * 1000.0 / ms:.1f} img/s [{card}]")
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

    # 14. NCE kernels vs the plain version on the card: loss and both
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

    # 15. one train step, card vs CPU: small width, the same seeded weights,
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
        launched = launched[:2] + launched[4:]  # NCE and train-mode pointnet
        got[where] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.grad.cpu() for k, p in model_s.named_parameters()},
                      {k: v.cpu() for k, v in model_s.state_dict().items() if "running" in k},
                      launched)
    (m_cpu, g_cpu, r_cpu, l_cpu), (m_gpu, g_gpu, r_gpu, l_gpu) = got["cpu"], got["cuda"]
    if l_gpu != (1, 1, 1, 1) or any(l_cpu):
        raise RuntimeError(f"train step (NCE, train-mode pointnet) forward and backward "
                           f"launches: card {l_gpu}, CPU {l_cpu}")
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
          f"{stat_err:.3g}; the card's step launched (NCE forward, backward, train-mode "
          f"pointnet forward, backward, the last in f64) {l_gpu}")

    # 16. the teacher's training at the recipe's width with --fused_nce,
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
    if train_counts != (0, 0) + (TRAIN_STEPS,) * 2 + (0, 0) + (TRAIN_STEPS,) * 2:
        raise RuntimeError(f"teacher training: launches (geodesic, pointnet, NCE forward, "
                           f"NCE backward, stem forward, stem backward, train-mode pointnet "
                           f"forward, backward) {train_counts}, expected one NCE and one "
                           f"train-mode pointnet forward and backward a step")
    if not all(math.isfinite(v) for v in losses + pose_losses) or \
            not (losses[-1] < losses[0] and pose_losses[-1] < pose_losses[0]):
        raise RuntimeError(f"teacher training on one repeated batch: losses {losses}, "
                           f"pose losses {pose_losses}")
    phase("teacher training", t0, f"{n_params} params, batch {TRAIN_BATCH}, 224x224, "
          f"{POINT_NUM} points, {TRAIN_STEPS} steps on one batch: loss "
          f"{[round(v, 4) for v in losses]} (pose {[round(v, 4) for v in pose_losses]}); "
          f"NCE launches {train_counts[2]} forward, {train_counts[3]} backward; train-mode "
          f"pointnet launches {train_counts[6]} forward, {train_counts[7]} backward")

    # 17. the trainer: one epoch on in-memory samples (train, both
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
        if fit_counts[0] != 2 or fit_counts[1] < 2 or fit_counts[2:] != (2, 2, 0, 0, 2, 2) or \
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
          f"launches (geodesic, pointnet, NCE forward, NCE backward, train-mode pointnet "
          f"forward, backward) {fit_counts[:4] + fit_counts[6:]}; "
          f"checkpoints {sorted(saved)}; resumed from them (state equal) into epoch 1; "
          f"train_loss {[round(r['train_loss'], 4) for r in records]} val_nce "
          f"{[round(r['val_nce'], 4) for r in records]}")
    del fit_state, resumed, trainer

    # 18. training times at batch 160 (host clock around synced steps), the
    # step with the plain train-mode PointNet beside it, a profile of two
    # steps, and the NCE kernels vs their plain versions
    from pose3d_tpu_torch.models import pointnet as pointnet_model

    def plain_pointnet_train(points, layers, valid=None):
        return pointnet_train.pointnet_train_plain(points, layers, valid)[:2]

    ab = ab_times(pointnet_model, "pointnet_train", plain_pointnet_train,
                  lambda: steps_ms(lambda: step(state, tb)))
    step_ms = sum(ab["kernel"]) / 2
    phase("time", t0, f"teacher train step f32 batch {TRAIN_BATCH}, --fused_nce: "
          f"{step_ms:.3f} ms/step = {TRAIN_BATCH * 1000.0 / step_ms:.1f} samples/s (runs "
          f"{ab['kernel']}); with the plain train-mode PointNet {ab['plain']} ms/step = "
          f"{TRAIN_BATCH * 2000.0 / sum(ab['plain']):.1f} samples/s [{card}]")
    rows, device_ms, wall_ms = profile_steps(lambda: step(state, tb))
    nce_ms = sum(e.self_device_time_total for e in rows if "nce_" in e.key) / 1e3
    pt_ms = sum(e.self_device_time_total for e in rows if "pnt_" in e.key) / 1e3
    phase("profile", t0, f"2 train steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms "
          f"wall (busy {device_ms / wall_ms:.3f}); the NCE kernels {nce_ms:.4f} ms, the "
          f"train-mode pointnet kernels {pt_ms:.4f} ms [{card}]; by self device time:")
    print_rows(rows, device_ms)
    del state, tb, step

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

    # 19. one KD step, card vs CPU, at the CPU test's small width: the
    # student in f64 (the stem's f64 kernel on the card), the frozen
    # teacher in f32 (the PointNet kernel is f32 only), the losses in f32,
    # no dropout; 4 samples, the last padded
    s_small = convert.baseline_state_dict(student_variables(np.random.default_rng(19), 64,
                                                            0.25, 32))
    t_small = convert.pose_state_dict(teacher_variables(np.random.default_rng(20), 64, 64))
    kd_small = kd_batch(np.random.default_rng(21), 4, 32, 100)
    kd_small["valid"] = np.arange(4) < 3
    got = {}
    for where in ("cpu", "cuda"):
        student_s = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                      dropout_rate=0.0)
        student_s.load_state_dict(s_small, strict=True)
        teacher_s = PoseEstimator(img_feature_dim=64, shape_feature_dim=64)
        teacher_s.load_state_dict(t_small, strict=True)
        teacher_s = teacher_s.to(where).eval().requires_grad_(False)
        state_s = create_train_state(student_s.double().to(where), LR, [100], seed=0)
        batch = {k: torch.from_numpy(v).to(where) for k, v in kd_small.items()}
        for k in ("im", "im_flip", "im_rot"):
            batch[k] = batch[k].double()
        before = counts()
        metrics = steps.make_kd_crd_step()(state_s, teacher_s, batch)
        torch.cuda.synchronize()
        got[where] = ({k: float(v) for k, v in metrics.items()},
                      {k: p.grad.cpu() for k, p in student_s.named_parameters()},
                      {k: v.cpu() for k, v in student_s.state_dict().items() if "running" in k},
                      tuple(a - b for a, b in zip(counts(), before)))
    (m_cpu, g_cpu, r_cpu, l_cpu), (m_gpu, g_gpu, r_gpu, l_gpu) = got["cpu"], got["cuda"]
    if l_gpu != (0, 1, 0, 0, 1, 1, 0, 0) or any(l_cpu):
        raise RuntimeError(f"KD step launches: card {l_gpu}, CPU {l_cpu}")
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss", "gt_loss"))
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    grad_err = 0.0
    for k, want in g_cpu.items():
        if float(want.abs().max()) < 1e-6 * largest:  # a bias before a train-mode BN
            if float(g_gpu[k].abs().max()) >= 1e-6 * largest:
                raise RuntimeError(f"KD step: {k} has a gradient on the card only")
            continue
        grad_err = max(grad_err, rel_err(g_gpu[k], want))
    stat_err = max(float((r_gpu[k] - v).abs().max()) for k, v in r_cpu.items())
    if loss_err > STEP_LOSS_RTOL or grad_err > STEP_GRAD_TOL or stat_err > 1e-5:
        raise RuntimeError(f"KD step card vs CPU: losses {loss_err:.3g}, gradients "
                           f"{grad_err:.3g}, running statistics {stat_err:.3g}")
    phase("KD step", t0, f"card vs CPU at student width 0.25 / feature 64, 32x32, teacher "
          f"64/64, 4 samples x 3 views, one padded (f64 student, f32 teacher and losses): "
          f"losses rel {loss_err:.3g} (tol {STEP_LOSS_RTOL}), gradients max|d|/max|ref| "
          f"{grad_err:.3g} (tol {STEP_GRAD_TOL}), running statistics max|d| {stat_err:.3g}; "
          f"the card's step launched (pointnet, stem forward, stem backward) "
          f"{(l_gpu[1], l_gpu[4], l_gpu[5])}; loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}")

    # 20. the KD --crd student's training at the KD CLI's width, through
    # make_kd_crd_step: the student path's main path
    state = convert.pose_state_dict(teacher_variables(np.random.default_rng(5)))
    with torch.device("meta"):
        kd_teacher = PoseEstimator()
    kd_teacher.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True,
                               assign=True)
    kd_teacher.eval().requires_grad_(False)
    del state

    def kd_student(seed):
        return BaselineEstimator(generator=torch.Generator().manual_seed(seed)).to(dev)

    kd_state = create_train_state(kd_student(46), LR, [10**9], seed=46)
    n_params = sum(p.numel() for p in kd_state.model.parameters())
    kd_step = steps.make_kd_crd_step()
    kb = {k: torch.from_numpy(v).to(dev) for k, v in
          kd_batch(np.random.default_rng(22), KD_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [kd_step(kd_state, kd_teacher, kb) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    kd_counts = counts()
    kd_losses = [float(m["loss"]) for m in history]
    gt_losses = [float(m["gt_loss"]) for m in history]
    if kd_counts != (0, TRAIN_STEPS, 0, 0, TRAIN_STEPS, TRAIN_STEPS, 0, 0):
        raise RuntimeError(f"KD training: launches (geodesic, pointnet, NCE forward, NCE "
                           f"backward, stem forward, stem backward) {kd_counts}, expected one "
                           f"pointnet, one stem forward and one stem backward a step")
    if not all(math.isfinite(v) for v in kd_losses + gt_losses):
        raise RuntimeError(f"KD training: losses {kd_losses}, gt losses {gt_losses}")
    phase("KD training", t0, f"student {n_params} params, batch {KD_BATCH} x 3 views, "
          f"224x224, teacher 1024/1024 with {POINT_NUM} points, {TRAIN_STEPS} steps on one "
          f"batch: loss {[round(v, 4) for v in kd_losses]} (gt "
          f"{[round(v, 4) for v in gt_losses]}); launches a step: pointnet "
          f"{kd_counts[1] // TRAIN_STEPS}, stem forward {kd_counts[4] // TRAIN_STEPS}, stem "
          f"backward {kd_counts[5] // TRAIN_STEPS}, NCE 0")

    # 21. the KD trainer: one epoch on in-memory samples (train, the
    # student's evaluation, checkpoints), then a resume into a second
    with tempfile.TemporaryDirectory() as tmp:
        def kd_loaders():
            return (DataLoader(KDMemorySet(2 * KD_BATCH, 23, 224), KD_BATCH, shuffle=True,
                               drop_last=True, num_workers=2),
                    DataLoader(KDMemorySet(40, 24, 224, train=False), KD_BATCH,
                               shuffle=False, num_workers=2))

        fit_state = create_train_state(kd_student(23), LR, [10**9], seed=46)
        train_l, val_l = kd_loaders()
        trainer = KDTrainer(fit_state, kd_teacher, train_l, val_l, EVAL_CATEGORIES, tmp)
        reset_counts()
        trainer.fit_crd(1)
        torch.cuda.synchronize()
        kd_fit_counts = counts()
        saved = set(os.listdir(os.path.join(tmp, "ckpt")))
        ckpt_mb = os.path.getsize(trainer.ckpt.path("checkpoint")) / 2**20
        if kd_fit_counts != (1, 2, 0, 0, 3, 2, 0, 0) or not {"checkpoint.pth", "EPOCH"} <= saved:
            raise RuntimeError(f"KD trainer epoch: launches {kd_fit_counts}, checkpoint files "
                               f"{sorted(saved)}")
        resumed = create_train_state(kd_student(99), LR, [10**9], seed=0)
        tr = time.perf_counter()
        resumed.load_state_dict(trainer.ckpt.restore("checkpoint"))
        restore_s = time.perf_counter() - tr
        same = all(torch.equal(a, b) for a, b in zip(
            fit_state.model.state_dict().values(), resumed.model.state_dict().values()))
        del fit_state, trainer
        train_l, val_l = kd_loaders()
        KDTrainer(resumed, kd_teacher, train_l, val_l, EVAL_CATEGORIES, tmp).fit_crd(
            2, start_epoch=1)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(tmp, "ckpt", "EPOCH")) as f:
            last_epoch = f.read()
        if not same or resumed.step != 4 or last_epoch != "1" or \
                [r["epoch"] for r in records] != [0, 1] or \
                not all(math.isfinite(r["train_loss"]) and math.isfinite(r["val_med"])
                        for r in records):
            raise RuntimeError(f"KD trainer resume: state restored {same}, step "
                               f"{resumed.step}, EPOCH {last_epoch}, records {records}")
    phase("KD trainer", t0, f"epoch 0 at batch {KD_BATCH} (2 steps, 40 evaluation rows): "
          f"launches (geodesic, pointnet, NCE forward, NCE backward, stem forward, stem "
          f"backward) {kd_fit_counts}; checkpoints {sorted(saved)} ({ckpt_mb:.1f} MiB a "
          f"checkpoint.pth, restored in {restore_s:.2f} s); resumed from them (state equal) "
          f"into epoch 1; train_loss {[round(r['train_loss'], 4) for r in records]} val_med "
          f"{[round(r['val_med'], 3) for r in records]} train_samples_per_s "
          f"{[round(r['train_samples_per_s'], 1) for r in records]}")
    del resumed

    # 22. KD times at batch 46 x 3 (host clock around synced steps), the
    # step with the plain stem beside it, a profile of two steps, and the
    # stem kernels vs their plain version
    from pose3d_tpu_torch.models import vgg as vgg_model
    ab = ab_times(vgg_model, "vgg_stem", vgg_stem.vgg_stem_plain,
                  lambda: steps_ms(lambda: kd_step(kd_state, kd_teacher, kb)))
    kd_ms = sum(ab["kernel"]) / 2
    phase("time", t0, f"KD --crd step f32 batch {KD_BATCH} x 3 views: {kd_ms:.3f} ms/step = "
          f"{KD_BATCH * 1000.0 / kd_ms:.1f} samples/s (runs {ab['kernel']}); with the plain "
          f"stem {ab['plain']} ms/step = {KD_BATCH * 2000.0 / sum(ab['plain']):.1f} "
          f"samples/s [{card}]")
    rows, device_ms, wall_ms = profile_steps(lambda: kd_step(kd_state, kd_teacher, kb))
    stem_dev_ms = sum(e.self_device_time_total for e in rows if "stem_" in e.key) / 1e3
    phase("profile", t0, f"2 KD steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms wall "
          f"(busy {device_ms / wall_ms:.3f}); the stem kernels {stem_dev_ms:.4f} ms [{card}]; "
          f"by self device time:")
    print_rows(rows, device_ms)
    # the step's parts by CUDA events: the frozen teacher's forward on the
    # 138 views, and Adam (the last step's gradients, applied again)
    im3 = torch.cat([kb["im"], kb["im_flip"], kb["im_rot"]])
    with torch.no_grad():
        teacher_ms = cuda_ms(lambda: kd_teacher(im3, kb["shape"], view_tile=3), iters=5)
    adam_ms = cuda_ms(kd_state.optimizer.step, iters=5)
    phase("time", t0, f"KD step parts: frozen teacher forward {teacher_ms:.3f} ms, Adam over "
          f"{n_params} parameters {adam_ms:.3f} ms, the rest (student forward and backward, "
          f"losses) {kd_ms - teacher_ms - adam_ms:.3f} ms of {kd_ms:.3f} [{card}]")
    del kd_state, kd_teacher, kb, history, im3

    stem_times, stem_bounds = {}, {}
    for n_s in (3 * KD_BATCH, 256):
        x_s, w_s, b_s, g_s = stem_inputs(np.random.default_rng(25), n_s, 224, 64, "rand", dev)
        x_nhwc, w_d, b_d = x_s.permute(0, 2, 3, 1), w_s.detach(), b_s.detach()
        _, index = vgg_stem.stem_forward(x_nhwc, w_d, b_d, with_index=True)
        y_plain = vgg_stem.vgg_stem_plain(x_s, w_s, b_s)

        def plain_fwd():
            with torch.no_grad():
                vgg_stem.vgg_stem_plain(x_s, w_d, b_d)

        fns = {"kernel forward": lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, True),
               "kernel backward": lambda: vgg_stem.stem_backward(x_nhwc, index, g_s),
               "plain forward": plain_fwd,
               "plain backward": lambda: torch.autograd.grad(y_plain, (w_s, b_s), g_s,
                                                             retain_graph=True)}
        runs = {k: [] for k in fns}
        runs["kernel forward, serving"] = []
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for who in order:
                for part in ("forward", "backward"):
                    runs[f"{who} {part}"].append(cuda_ms(fns[f"{who} {part}"], 10))
                if who == "kernel":
                    runs["kernel forward, serving"].append(cuda_ms(
                        lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, False), 10))
        stem_times[n_s] = {k: sum(v) / len(v) for k, v in runs.items()}
        t = stem_times[n_s]
        # the bound: each input read once, each output written once; the
        # weight gradient's products only where this run's outputs pass
        # the ReLU (the routed position of each)
        pooled = n_s * 112 * 112 * 64
        unmasked = int((index < 4).sum())
        stem_bounds[n_s] = (
            bound(4.0 * (n_s * 224 * 224 * 3 + 64 * 28 + pooled) + pooled,
                  2.0 * 27 * 4 * pooled),
            bound(4.0 * (n_s * 224 * 224 * 3 + pooled + 64 * 28) + pooled,
                  2.0 * 28 * unmasked))
        phase("time", t0, f"stem ({n_s}, 224, 224) F 64: kernel forward "
              f"{runs['kernel forward']} ms (serving, no indices, "
              f"{runs['kernel forward, serving']}) + backward {runs['kernel backward']} ms; "
              f"plain forward {runs['plain forward']} + backward {runs['plain backward']} ms; "
              f"forward+backward {t['kernel forward'] + t['kernel backward']:.4f} vs "
              f"{t['plain forward'] + t['plain backward']:.4f} ms "
              f"({(t['plain forward'] + t['plain backward']) / (t['kernel forward'] + t['kernel backward']):.2f}x); "
              f"bound forward {stem_bounds[n_s][0][0]:.4f} ms ({stem_bounds[n_s][0][1]}), "
              f"backward {stem_bounds[n_s][1][0]:.4f} ms ({stem_bounds[n_s][1][1]}; "
              f"{unmasked / pooled:.3f} of the outputs pass the ReLU) [{card}]")
        del x_s, x_nhwc, index, y_plain, g_s

    # 23. the train-mode PointNet kernels vs the plain version in float64
    # on the card: the output, the three statistics and the 12 parameter
    # gradients; N 1 / 7 / 160 x P 100 / 2500 x D 64 / 256 / 1024, a masked
    # batch, a cloud of one repeated point (exact ties), gamma3 = 0 in a
    # channel, and the f64 instantiation
    prng = np.random.default_rng(23)
    cases = [(n_c, p_c, d_c, {}) for n_c in (1, 7, TRAIN_BATCH) for p_c in (100, POINT_NUM)
             for d_c in (64, 256, 1024)]
    cases += [(KD_BATCH, POINT_NUM, 256, {"masked": True}), (7, POINT_NUM, 256, {"ties": True}),
              (7, POINT_NUM, 256, {"gamma0": True}),
              (8, 500, 256, {"masked": True, "dtype": torch.float64})]
    worst = {k: 0.0 for k in ("out", "stats", "grads", "own_grads", "plain_own_grads", "bias",
                              "tie_gap", "relu_gap", "max_d")}
    total = {k: 0 for k in ("moved", "flips", "plain_flips")}
    for n_c, p_c, d_c, kw in cases:
        res = pt_kernel_vs_plain(pointnet_train, *pt_inputs(prng, n_c, p_c, d_c, dev, **kw))
        torch.cuda.synchronize()
        if not res["same"] or res["launches"] != (1, 1) or res["out"] > PT_OUT_TOL or \
                res["stats"] > PT_OUT_TOL or res["grads"] > PT_GRAD_TOL or \
                res["bias"] > PT_BIAS_TOL or res["tie_gap"] > PT_TIE_TOL or \
                res["relu_gap"] > PT_RELU_TOL or res["flips"] > 2 * res["plain_flips"] + 2:
            raise RuntimeError(f"train-mode pointnet kernels vs plain at {(n_c, p_c, d_c, kw)}: "
                               f"{res}")
        worst = {k: max(v, res[k]) for k, v in worst.items()}
        total = {k: v + res[k] for k, v in total.items()}
    pt_err = worst["max_d"]
    phase("pointnet_train", t0, f"kernels vs the plain version in f64 in {len(cases)} cases "
          f"(N 1/7/160 x P 100/2500 x D 64/256/1024, masked, tied points, gamma3 = 0, f64): "
          f"output {worst['out']:.3g} and statistics {worst['stats']:.3g} of max|ref| (tol "
          f"{PT_OUT_TOL}); {total['flips']} ReLU decisions other than f64's (the f32 plain "
          f"version: {total['plain_flips']}), their inputs at most {worst['relu_gap']:.3g} of "
          f"the channel's scale from 0 (tol {PT_RELU_TOL:.3g}), and {total['moved']} argmax "
          f"entries, at most {worst['tie_gap']:.3g} below the maximum (tol {PT_TIE_TOL}); at "
          f"those decisions the gradients {worst['grads']:.3g} of max|ref| (tol {PT_GRAD_TOL}), "
          f"at f64's own {worst['own_grads']:.3g} (the f32 plain version at its own: "
          f"{worst['plain_own_grads']:.3g}); dense biases' gradients {worst['bias']:.3g} of the "
          f"largest weight gradient (tol {PT_BIAS_TOL}); one forward and one backward call a "
          f"use, the same bits on a second run")

    # 24. KD --stage 1 at full width through make_stage1_step: the student
    # above (feature 2048, 224x224, its stem in its kernel) and the vanilla
    # teacher (ResNet-18, img feature 1024, shape feature 256, 2,500 points,
    # the PointNet in its train-mode kernel), batch 46, Adam lr 1e-4, tau
    # 0.5, both NCE directions in the NCE kernels: the stage-1 path's main path
    def stage1_states(seed):
        teacher = PoseEstimatorVanilla(img_feature_dim=1024, shape_feature_dim=STAGE1_SHAPE_DIM,
                                       generator=torch.Generator().manual_seed(seed)).to(dev)
        student = BaselineEstimator(generator=torch.Generator().manual_seed(seed + 1)).to(dev)
        return (create_train_state(teacher, LR, [10**9], seed=seed),
                create_train_state(student, LR, [10**9], seed=seed + 1))

    t1, s1 = stage1_states(46)
    n_teacher = sum(p.numel() for p in t1.model.parameters())
    n_params = sum(p.numel() for p in s1.model.parameters())
    s1_step = steps.make_stage1_step(tau=0.5, use_fused_nce=True)
    sb = {k: torch.from_numpy(v).to(dev) for k, v in
          train_batch(np.random.default_rng(26), KD_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [s1_step(t1, s1, sb) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    s1_counts = counts()
    s1_losses = [float(m["loss"]) for m in history]
    t_losses = [float(m["teacher_loss"]) for m in history]
    if s1_counts != (0, 0) + (2 * TRAIN_STEPS,) * 2 + (TRAIN_STEPS,) * 4:
        raise RuntimeError(f"stage 1: launches (geodesic, pointnet, NCE forward, NCE backward, "
                           f"stem forward, stem backward, train-mode pointnet forward, "
                           f"backward) {s1_counts}, expected two NCE and one of each other "
                           f"kernel forward and backward a step")
    if not all(math.isfinite(v) for v in s1_losses + t_losses) or \
            not t_losses[-1] < t_losses[0]:
        raise RuntimeError(f"stage 1 on one repeated batch: losses {s1_losses}, teacher "
                           f"losses {t_losses}")
    phase("stage 1 training", t0, f"vanilla teacher {n_teacher} params (1024/"
          f"{STAGE1_SHAPE_DIM}), student {n_params} params, batch {KD_BATCH}, 224x224, "
          f"{POINT_NUM} points, {TRAIN_STEPS} steps on one batch: loss "
          f"{[round(v, 4) for v in s1_losses]} (teacher {[round(v, 4) for v in t_losses]}); "
          f"launches a step: NCE {s1_counts[2] // TRAIN_STEPS} forward, "
          f"{s1_counts[3] // TRAIN_STEPS} backward; stem {s1_counts[4] // TRAIN_STEPS} and "
          f"{s1_counts[5] // TRAIN_STEPS}; train-mode pointnet {s1_counts[6] // TRAIN_STEPS} "
          f"and {s1_counts[7] // TRAIN_STEPS}")

    # 25. the stage-1 trainer: one epoch on in-memory samples (train, the
    # vanilla teacher's evaluation, a checkpoint of both train states),
    # then a resume of both into a second
    with tempfile.TemporaryDirectory() as tmp:
        def s1_trainer(teacher_state, student_state):
            return KDTrainer(student_state, None,
                             DataLoader(MemorySet(2 * KD_BATCH, 27, 224), KD_BATCH, shuffle=True,
                                        drop_last=True, num_workers=2),
                             DataLoader(MemorySet(40, 28, 224), KD_BATCH, shuffle=False,
                                        num_workers=2),
                             EVAL_CATEGORIES, tmp, teacher_state=teacher_state, tau=0.5,
                             use_fused_nce=True)

        ft, fs = stage1_states(27)
        trainer = s1_trainer(ft, fs)
        reset_counts()
        trainer.fit_stage1(1)
        torch.cuda.synchronize()
        s1_fit_counts = counts()
        saved = set(os.listdir(os.path.join(tmp, "ckpt")))
        ckpt_mb = os.path.getsize(trainer.ckpt.path("checkpoint")) / 2**20
        if s1_fit_counts != (1, 1, 4, 4, 2, 2, 2, 2) or not {"checkpoint.pth", "EPOCH"} <= saved:
            raise RuntimeError(f"stage-1 trainer epoch: launches {s1_fit_counts}, checkpoint "
                               f"files {sorted(saved)}")
        tr = time.perf_counter()
        restored = trainer.ckpt.restore("checkpoint")
        restore_s = time.perf_counter() - tr
        same = all(torch.equal(v.cpu(), restored[role]["model"][k])
                   for role, st in (("teacher", ft), ("student", fs))
                   for k, v in st.model.state_dict().items())
        del ft, fs, trainer, restored
        rt, rs = stage1_states(99)
        s1_trainer(rt, rs).fit_stage1(2, start_epoch=1)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(tmp, "ckpt", "EPOCH")) as f:
            last_epoch = f.read()
        if not same or (rt.step, rs.step) != (4, 4) or last_epoch != "1" or \
                [r["epoch"] for r in records] != [0, 1] or \
                not all(math.isfinite(r["train_loss"]) and math.isfinite(r["val_med"])
                        for r in records):
            raise RuntimeError(f"stage-1 trainer resume: checkpoint equal {same}, steps "
                               f"{(rt.step, rs.step)}, EPOCH {last_epoch}, records {records}")
    phase("stage-1 trainer", t0, f"epoch 0 at batch {KD_BATCH} (2 steps, 40 evaluation rows of "
          f"the vanilla teacher): launches {s1_fit_counts}; checkpoints {sorted(saved)} "
          f"({ckpt_mb:.1f} MiB a checkpoint.pth of both train states, read in {restore_s:.2f} "
          f"s, equal to the states); both resumed into epoch 1; train_loss "
          f"{[round(r['train_loss'], 4) for r in records]} val_med "
          f"{[round(r['val_med'], 3) for r in records]} train_samples_per_s "
          f"{[round(r['train_samples_per_s'], 1) for r in records]}")
    del rt, rs

    # 26. stage-1 times at batch 46 (host clock around synced steps) and a
    # profile of two steps
    s1_ms = steps_ms(lambda: s1_step(t1, s1, sb))
    phase("time", t0, f"KD --stage 1 step f32 batch {KD_BATCH}, --fused_nce: {s1_ms:.3f} "
          f"ms/step = {KD_BATCH * 1000.0 / s1_ms:.1f} samples/s [{card}]")
    rows, device_ms, wall_ms = profile_steps(lambda: s1_step(t1, s1, sb))
    pt_dev_ms = sum(e.self_device_time_total for e in rows if "pnt_" in e.key) / 1e3
    phase("profile", t0, f"2 stage-1 steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms wall "
          f"(busy {device_ms / wall_ms:.3f}); the train-mode pointnet kernels {pt_dev_ms:.4f} "
          f"ms [{card}]; by self device time:")
    print_rows(rows, device_ms)
    del t1, s1, sb, history

    # 27. the train-mode PointNet kernels vs the plain version at the two
    # paths' shapes: the teacher step's (160, 2500, 256) and stage 1's
    # (46, 2500, 256), in turns plain, kernel, kernel, plain
    pt_times, pt_bounds = {}, {}
    for n_c in (TRAIN_BATCH, KD_BATCH):
        d_c = TRAIN_SHAPE_DIM
        pts_c, layers_c, _, g_c = pt_inputs(np.random.default_rng(29), n_c, POINT_NUM, d_c, dev)
        prm = pointnet_train.pack_params(layers_c)
        _, stats_c, idx_c, h1_c, h2_c, gram_c = pointnet_train.train_forward(pts_c, prm, d_c,
                                                                            None)
        tracked = [[t.clone().requires_grad_() for t in layer] for layer in layers_c]
        flat = [t for layer in tracked for t in layer]
        out_p = pointnet_train.pointnet_train_plain(pts_c, tracked)[0]

        def plain_fwd():
            with torch.no_grad():
                pointnet_train.pointnet_train_plain(pts_c, tracked)

        fns = {"kernel forward": lambda: pointnet_train.train_forward(pts_c, prm, d_c, None),
               "kernel backward": lambda: pointnet_train.train_backward(
                   pts_c, prm, d_c, None, stats_c, idx_c, h1_c, h2_c, gram_c, g_c),
               "plain forward": plain_fwd,
               "plain backward": lambda: torch.autograd.grad(out_p, flat, g_c,
                                                             retain_graph=True)}
        runs = {k: [] for k in fns}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for who in order:
                for part in ("forward", "backward"):
                    runs[f"{who} {part}"].append(cuda_ms(fns[f"{who} {part}"], 10))
        pt_times[n_c] = t = {k: sum(v) / len(v) for k, v in runs.items()}
        # the bound: the points, parameters and outputs (features, argmax
        # indices, statistics) and, backward, the upstream gradient and the
        # parameters' gradients, each moved once; the layers' useful FLOPs:
        # forward the three layers, backward layers 1-2 and, for layer 3,
        # M h2 (128 x 128) a point, its Gram form (csrc/pointnet_train.cu)
        rows_c, n_stats = n_c * POINT_NUM, 2 * (64 + 128 + d_c)
        flops_f = 2.0 * rows_c * (3 * 64 + 64 * 128 + 128 * d_c)
        flops_b = 2.0 * rows_c * (3 * 64 + 2 * 64 * 128 + 128 * 128)
        pt_bounds[n_c] = (
            bound(4.0 * (3 * rows_c + prm.numel() + 2 * n_c * d_c + n_stats), flops_f),
            bound(4.0 * (3 * rows_c + 2 * prm.numel() + 2 * n_c * d_c + n_stats), flops_b))
        phase("time", t0, f"train-mode pointnet ({n_c}, {POINT_NUM}, {d_c}): kernel forward "
              f"{runs['kernel forward']} + backward {runs['kernel backward']} ms; plain forward "
              f"{runs['plain forward']} + backward {runs['plain backward']} ms; forward+backward "
              f"{t['kernel forward'] + t['kernel backward']:.4f} vs "
              f"{t['plain forward'] + t['plain backward']:.4f} ms; bound forward "
              f"{pt_bounds[n_c][0][0]:.4f} ms ({pt_bounds[n_c][0][1]}), backward "
              f"{pt_bounds[n_c][1][0]:.4f} ms ({pt_bounds[n_c][1][1]}); CUDA launches a forward "
              f"and a backward call: {pointnet_train.kernel_launches_per_call()} [{card}]")
        del pts_c, layers_c, g_c, h1_c, h2_c, gram_c, tracked, flat, out_p

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
              nce_times[n]["kernel backward"], nce_times[n]["plain backward"], bwd_bound),
        entry("vgg_stem_forward", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", kd_counts[4], stem_err,
              stem_times[3 * KD_BATCH]["kernel forward"],
              stem_times[3 * KD_BATCH]["plain forward"], stem_bounds[3 * KD_BATCH][0]),
        entry("vgg_stem_backward", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", kd_counts[5], stem_err,
              stem_times[3 * KD_BATCH]["kernel backward"],
              stem_times[3 * KD_BATCH]["plain backward"], stem_bounds[3 * KD_BATCH][1]),
        entry("pointnet_train_forward", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:372", train_counts[6], pt_err,
              pt_times[TRAIN_BATCH]["kernel forward"], pt_times[TRAIN_BATCH]["plain forward"],
              pt_bounds[TRAIN_BATCH][0]),
        entry("pointnet_train_backward", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:372", train_counts[7], pt_err,
              pt_times[TRAIN_BATCH]["kernel backward"], pt_times[TRAIN_BATCH]["plain backward"],
              pt_bounds[TRAIN_BATCH][1])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
