"""Smoke run of the PyTorch port (pose3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--source info_nce=OTHER.cu] [--source vgg_stem=OTHER.cu]
                          [--source pointnet_eval=OTHER.cu ...]

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
    and train-mode PointNet kernels, then the stage-1 trainer's epoch loop;
  * KD --stage 2 (the student above distilled from the vanilla teacher
    that stage 1 trained, read from a stage-1 checkpoint.pth by the CLI's
    loader; batch 46 x 3 views): train steps through the stem kernels and
    the teacher's eval PointNet kernel, then the trainer's epoch loop;
  * the other regimes, 2 steps each at the same widths: KD --contrast and
    --vid, stage 1 with the memory bank and with --nce pose / multipose,
    the teacher step with --nce pose / multipose (batch 160), and the
    RGB-only baseline (training --shape None, batch 64).
The student's stem (conv3x3 + ReLU + 2x2 pool) runs in the VGG stem
kernel in every student forward. Phases:

  1 device    2 build    3 geodesic kernel vs plain
  4 pointnet kernel vs plain (in f32 and f64; HMMA in the encoder's SASS
     only)    5 VGG stem kernel vs plain (and HMMA in the f32 forward's
     SASS only)
  6 student at full width    7 student serving    8 student evaluation
  9 teacher at full width    10 teacher serving    11 teacher evaluation
  12 view_tile    13 serving times, and the pointnet kernel's at (64 / 46
     / 1, 2500, 1024) and (64, 2500, 256)
  14 NCE kernels vs plain (and HMMA in their SASS)    15 train step, card
     vs CPU    16 teacher training at full width    17 trainer epoch and
     resume    18 training times (with and without the train-mode PointNet
     kernels), profile, and the NCE kernels' times at (46 / 160 / 4096, 200)
  19 KD step, card vs CPU    20 KD training at full width
  21 KD trainer epoch and resume    22 KD times and profile
  23 train-mode PointNet kernels vs plain    24 stage-1 training at full
  width    25 stage-1 trainer epoch and resume    26 stage-1 times and
  profile (and stage 1's checkpoint.pth for phase 28)    27 train-mode
  PointNet times    28 stage-2 training at full width, its teacher from
  that checkpoint    29 stage-2 trainer epoch and resume    30 stage-2
  step card vs CPU, times and profile    31 the variants (--contrast,
  --vid, the memory bank, --nce pose / multipose in stage 1 and the
  teacher step, the baseline), each card vs CPU    32 the NCE forward on
  two streams at once
Each path (7-8, 10-11, 16-17, 20-21, 24-25, 28-29 and each variant of 31)
is driven with the kernels' launch counts set to 0 just before it and
read just after it; 16, 20, 24, 28 and 31's are the training paths' main
paths. The total seconds are printed before the card's line.

With --source NAME=FILE (repeatable), another version of csrc/NAME.cu
(info_nce, vgg_stem or pointnet_eval) with the same C interface (an
earlier commit's, from `git show`) is built beside this one, and its
kernels are timed in turns with this source's: info_nce's and the teacher
step through them in phase 18, the stage-1 step in phase 26; vgg_stem's
and the KD step through them in phase 22; pointnet_eval's and teacher
serving through them in phase 13 (also the CUDA-core version of commit
d190092 and before, with its own C interface and segment rule:
`legacy_pointnet_eval`).

Each phase prints a line; any failure raises and exits non-zero. Before the
last line come the card's name and power limit (nvidia-smi) and one JSON
line {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, the script fails
before printing any result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
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
# outside the tensor cores, dense TF32 FLOP/s on the tensor cores
HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
# split TF32: three TF32 products per f32 one. Every kernel whose work is
# f32-accurate products takes its bound at this rate (495 / 3 TFLOP/s),
# whichever unit it uses today: the stem's f32 forward, the NCE's products,
# both PointNet kernels; the f32 CUDA-core figure is printed beside it
SPLIT_TF32_PRODUCTS = 3
# the split-TF32 window sums' error over max|x| sum|w| that the kernel's
# margin for making a routing decision again (kNear, twice this) assumes
STEM_SPLIT_ERR = 2.0**-15
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
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


def graph_ms(fn, stream, calls: int = 10, replays: int = 5) -> float:
    """Device time a call of fn() in ms: `calls` calls captured into one CUDA
    graph on `stream` (a side stream; fn() is run there once first), whose
    replays CUDA events time, so that neither the host nor the profiler's
    records come between the calls. fn() must not synchronise."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (replays * calls)


def graph_kernel_launches(fn) -> int:
    """CUDA kernels one call of fn() launches: fn() is run once (so that its
    libraries set their attributes outside a capture), then captured into a
    CUDA graph, whose kernel nodes are counted through the driver API. The
    count does not depend on the profiler's activity buffers. fn() must not
    synchronise."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    driver = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and driver.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kernels, kind = 0, ctypes.c_int(-1)
    for node in nodes:
        if driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


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


def steps_through(module, others: dict, run_step) -> dict:
    """Host-clock ms a step of run_step() with `module`'s kernels from this
    source and from each library in `others` ({label: path}), in turns
    (this, others, others reversed, this) after one step through each."""
    libs = {"this source": None, **others}
    for lib in others.values():  # their first launches
        using(module, lib, run_step)
    times = {who: [] for who in libs}
    for order in (list(libs), list(libs)[::-1]):
        for who in order:
            times[who].append(using(module, libs[who], lambda: steps_ms(run_step)))
    return times


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


def card_vs_cpu(small_step, loss_keys) -> tuple[float, float, float]:
    """One small train step on the CPU and on the card from the same weights
    and inputs (small_step(where) -> (metrics, [the trained models])): the
    losses' relative error, the gradients' max|d|/max|ref| and the running
    statistics' max|d|; a gradient that is zero in exact arithmetic (a bias
    before a train-mode BatchNorm) must stay under 1e-6 of the largest on
    the card too. Raises past STEP_LOSS_RTOL, STEP_GRAD_TOL and 1e-5."""
    (m_cpu, cpu_models), (m_gpu, gpu_models) = small_step("cpu"), small_step("cuda")
    torch.cuda.synchronize()
    loss_err = max(abs(float(m_gpu[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
                   for k in loss_keys)
    grad_err = stat_err = 0.0
    for m_c, m_g in zip(cpu_models, gpu_models):
        g_cpu = {k: p.grad for k, p in m_c.named_parameters()}
        g_gpu = {k: p.grad.cpu() for k, p in m_g.named_parameters()}
        largest = max(float(g.abs().max()) for g in g_cpu.values())
        for k, want in g_cpu.items():
            if float(want.abs().max()) < 1e-6 * largest:
                if float(g_gpu[k].abs().max()) >= 1e-6 * largest:
                    raise RuntimeError(f"card vs CPU: {k} has a gradient on the card only")
                continue
            grad_err = max(grad_err, rel_err(g_gpu[k], want))
        on_card = dict(m_g.named_buffers())
        stat_err = max([stat_err] + [float((on_card[k].cpu() - v).abs().max())
                                     for k, v in m_c.named_buffers() if "running" in k])
    if loss_err > STEP_LOSS_RTOL or grad_err > STEP_GRAD_TOL or stat_err > 1e-5:
        raise RuntimeError(f"card vs CPU: losses {loss_err:.3g}, gradients {grad_err:.3g}, "
                           f"running statistics {stat_err:.3g}")
    return loss_err, grad_err, stat_err


def bound(n_bytes: float, flops: float, flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    over the HBM rate and the operations over their rate (by default f32
    on the CUDA cores)."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nce_inputs(rng: np.random.Generator, n: int, d: int, dev, masked=False,
               offset=0, identical=False, keys="rand"):
    """s (n, d), keys t (n + offset, d) and the masks of one NCE case: with
    `masked`, the last quarter of the rows (and their key columns) invalid;
    with an offset, the rows are a shard whose positives start there. Keys
    "trained": each row's positive is the row plus 10 % noise, as after
    training; "dropout": 30 % of the entries zeroed and the rest scaled by
    1 / 0.7, as route_info_nce feeds the kernel under dropout."""
    nc = n + offset
    s = rng.standard_normal((n, d), dtype=np.float32)
    t = rng.standard_normal((nc, d), dtype=np.float32)
    if identical:
        s[:], t[:] = s[0], t[0]
    if keys == "trained":
        t[offset:] = s + np.float32(0.1) * rng.standard_normal((n, d), dtype=np.float32)
    elif keys == "dropout":
        t = np.where(rng.random(t.shape) < 0.7, t / np.float32(0.7), 0).astype(np.float32)
    vrow = vcol = None
    if masked:
        vrow = np.arange(n) < max(1, n - n // 4)
        vcol = np.concatenate([np.ones(offset, bool), vrow])
    as_dev = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return as_dev(s), as_dev(t), as_dev(vrow), as_dev(vcol)


def nce_kernel_vs_plain(nce, s, t, vrow, vcol, offset, tau=0.1) -> dict:
    """Loss and both gradients through the kernels (twice) and through the
    plain version (autograd) in f32 and in f64 on the same inputs: the
    relative loss error and the gradients' max|d|/max|ref| against each
    (gradients with a floor of 1e-4 on max|ref|: one row alone has a zero
    gradient), the largest |d| against f32, and whether the two kernel runs
    gave the same bits."""
    def run(x, y, kernel):
        x, y = x.clone().requires_grad_(), y.clone().requires_grad_()
        if kernel and offset:
            loss = nce.blocked_info_nce_partial(x, y, vrow, vcol, offset, tau)
        elif kernel and vrow is not None:
            loss = nce.blocked_info_nce(x, y, tau, valid=vrow)
        elif kernel:
            loss = nce.fused_info_nce(x, y, tau)
        else:
            loss = nce.info_nce_plain(x, y, tau, vrow, vcol, offset)
            if not offset:
                loss = loss / (s.shape[0] if vrow is None else vrow.sum())
        return (loss.detach(), *torch.autograd.grad(loss, (x, y)))

    got, again = run(s, t, True), run(s, t, True)
    res = {"same": all(torch.equal(a, b) for a, b in zip(got, again))}
    for name, ref in (("", run(s, t, False)), ("64", run(s.double(), t.double(), False))):
        res["loss" + name] = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
        res["grads" + name] = max(float((g.double() - r.double()).abs().max()) /
                                  max(float(r.abs().max()), 1e-4)
                                  for g, r in zip(got[1:], ref[1:]))
        if not name:
            res["max_d"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    return res


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
                dtype=torch.float32, bars: float = 0.5):
    """The stem's inputs, as the student hands them over: an NCHW view of
    NHWC memory, the (F, 3, 3, 3) weight and bias (both needing a
    gradient), and an upstream gradient. `kind`: random, "ties" (an image
    constant on each 2x2 cell and the kernel's centre tap only: every
    pooling window ties, and the off-centre taps' gradient shows which
    position took it), "negative" (every output masked by the ReLU) or
    "bars" (random, with `bars` of the rows, or in odd images of the
    columns, a constant colour split between the two edges: resize_pad's
    black padding of a crop that is not square, normalised and lit as the
    training data is; the windows inside a bar are equal)."""
    if kind == "bars":
        x = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
        cut = int(hw * bars / 2)
        for i in range(n):
            colour = (-np.asarray(IMAGENET_MEAN) / np.asarray(IMAGENET_STD)
                      + rng.normal(0.0, 0.05, 3)).astype(np.float32)
            view = x[i] if i % 2 == 0 else x[i].transpose(1, 0, 2)
            view[:cut] = colour
            view[hw - cut:] = colour
        w = rng.standard_normal((f, 3, 3, 3)) * math.sqrt(2.0 / 27)
    elif kind == "ties":
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


def stem_split_error(vgg_stem, x, w, b) -> tuple[float, bool]:
    """The f32 serving forward on the card (its window sums as split TF32;
    no decision is made again without the index) against the f64 kernel on
    the same inputs: per output, |y32 - y64| less one f32 rounding of y32
    (the bias added), over max|x| sum|w| of its window and channel. Returns
    the largest and whether every output is within STEM_SPLIT_ERR."""
    x_nhwc, w, b = x.permute(0, 2, 3, 1), w.detach(), b.detach()
    y32 = vgg_stem.stem_forward(x_nhwc, w, b, False)[0].double()
    y64 = vgg_stem.stem_forward(x_nhwc.double(), w.double(), b.double(), False)[0]
    x_max = torch.nn.functional.max_pool2d(x.abs().amax(1, keepdim=True).double(), 4, 2, 1)
    scale = x_max * w.abs().double().sum((1, 2, 3)).view(1, -1, 1, 1)
    excess = (y32 - y64).abs() - 2.0**-24 * y32.abs()
    ok = bool((excess <= STEM_SPLIT_ERR * scale).all())
    worst = float((excess.clamp_min(0) / scale.clamp_min(1e-30)).max())
    return worst, ok


def stem_near_shares(x_nhwc, w, b, chunk: int = 23) -> tuple[float, float]:
    """Shares of the f32 forward's routing decisions (pooled output x
    channel) that lie within the kernel's margin, 2 STEM_SPLIT_ERR max|x|
    sum|w|, of their threshold (0 for the ReLU, where the output passes it
    the other positions' sums), and of those left once positions that tie
    exactly are one (the kernel's rule: neighbouring positions, 0 and 1, 2
    and 3, 0 and 2, 1 and 3, whose windows are equal on every tap that some
    channel weighs, and what follows from them): these the kernel makes
    again in f32 FMA. Estimated from f64 sums, which lie within
    STEM_SPLIT_ERR of that scale of the kernel's split sums."""
    fn = torch.nn.functional
    n, h, wd, _ = x_nhwc.shape
    ho, wo, f = h // 2, wd // 2, w.shape[0]
    w64, b64 = w.detach().double(), b.detach().double()
    w1 = w64.abs().sum((1, 2, 3)).view(1, -1, 1, 1)
    weighed = (w.detach().permute(0, 2, 3, 1).reshape(f, 27) != 0).any(0)  # (ky, kx, c)
    counts = [0, 0]
    for i in range(0, n, chunk):
        x = x_nhwc[i:i + chunk].permute(0, 3, 1, 2)
        c = x.shape[0]
        pre = fn.conv2d(x.double(), w64, b64, padding=1)
        v = torch.stack([pre[:, :, dy:2 * ho:2, dx:2 * wo:2] for dy in (0, 1) for dx in (0, 1)],
                        -1)
        best, first = v.max(-1)
        margin = 2 * STEM_SPLIT_ERR * w1 * fn.max_pool2d(x.abs().amax(1, keepdim=True).double(),
                                                        4, 2, 1)
        taps = fn.unfold(x, 3, padding=1).view(c, 3, 3, 3, h, wd).permute(0, 2, 3, 1, 4, 5)
        taps = taps.reshape(c, 27, h, wd).contiguous().view(torch.int32)
        pos = [taps[:, :, dy:2 * ho:2, dx:2 * wo:2] for dy in (0, 1) for dx in (0, 1)]
        ties = torch.stack([~((pos[a] != pos[b]) & weighed.view(1, 27, 1, 1)).any(1)
                            for a, b in ((0, 1), (2, 3), (0, 2), (1, 3))], -1)
        ties = ties[:, None].expand(c, f, ho, wo, 4)
        tie = lambda i: ties.gather(-1, i[..., None])[..., 0]  # noqa: E731
        row, col = tie(first >> 1), tie(2 + (first & 1))
        diag = (row & tie(2 + ((first & 1) ^ 1))) | (col & tie((first >> 1) ^ 1))
        at = lambda i: torch.arange(4, device=x.device) == i[..., None]  # noqa: E731
        in_class = (at(first) | (row[..., None] & at(first ^ 1)) | (col[..., None] & at(first ^ 2))
                    | (diag[..., None] & at(first ^ 3)))
        gaps = (best[..., None] - v).masked_fill(
            torch.arange(4, device=x.device) == first[..., None], math.inf)
        gap = torch.minimum(best.abs(), torch.where(best > 0, gaps.min(-1).values, math.inf))
        gap_class = torch.minimum(best.abs(), torch.where(
            best > 0, gaps.masked_fill(in_class, math.inf).min(-1).values, math.inf))
        counts[0] += int((gap < margin).sum())
        counts[1] += int(((gap < margin) & (gap_class < margin)).sum())
        del pre, v, taps, pos, ties, gaps
    total = n * f * ho * wo
    return counts[0] / total, counts[1] / total


LIBRARIES = ("geodesic", "pointnet_eval", "info_nce", "vgg_stem", "pointnet_train")
OTHER_SOURCES = ("info_nce", "vgg_stem", "pointnet_eval")


def parse_source(arg: str) -> tuple[str, str]:
    """--source NAME=PATH: another version of csrc/NAME.cu."""
    name, sep, path = arg.partition("=")
    if not sep or name not in OTHER_SOURCES or not os.path.isfile(path):
        raise argparse.ArgumentTypeError(
            f"--source takes info_nce=FILE, vgg_stem=FILE or pointnet_eval=FILE; got {arg}")
    return name, path


def build_other(name: str, source: str, tag: int) -> str:
    """Build another version of csrc/<name>.cu with the same C interface (an
    earlier commit's) beside this one, its nvcc report kept as a .log; return
    the library's path."""
    from pose3d_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"lib{name}_other{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, source],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    return out


def using(module, path: str | None, run):
    """run() with `module`'s wrappers launching the kernels of the library at
    `path` (None: this source's); the swap is undone at once."""
    own = module._lib
    if path is not None:
        module._lib = functools.partial(own, path)
    try:
        return run()
    finally:
        module._lib = own


def legacy_pointnet_eval(path: str):
    """pointnet_eval(points, folded) through the library at `path`, built
    from csrc/pointnet_eval.cu as of commit d190092 (f32 FMA on the CUDA
    cores): that version's C interface (no
    column groups; the scratch is the partial maxima) and its wrapper's split
    over point segments (64-point tiles, one block a 256-column chunk, one
    block an SM), so that it runs as it did then. Counts no launches."""
    import ctypes

    fn = ctypes.CDLL(path).pointnet_eval
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def segments(n, p, d):
        tiles, blocks = -(-p // 64), n * -(-d // 256)
        best, best_cost = 1, None
        for per in range(tiles, max(1, -(-tiles // 65535)) - 1, -1):
            cost = -(-blocks * -(-tiles // per) // sms) * (per + 0.25)
            if best_cost is None or cost < best_cost:
                best, best_cost = -(-tiles // per), cost
        return best

    def run(points, folded):
        n, p, d = points.shape[0], points.shape[1], folded[2][0].shape[1]
        out = torch.empty((n, d), dtype=torch.float32, device=points.device)
        s = segments(n, p, d)
        partial = torch.empty((n, s, d), dtype=torch.float32, device=points.device) \
            if s > 1 else out
        tensors = [points] + [t for pair in folded for t in pair]
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), partial.data_ptr(), n, p,
                 d, s, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{path}: pointnet_eval launch failed: cudaError_t {err}")
        return out

    return run


def with_pointnet_source(path: str | None, run):
    """run(encoder) with the eval PointNet built from another version of
    csrc/pointnet_eval.cu at `path` (None: this source's): a library with
    this version's C interface through this wrapper (`using`), one with
    commit d190092's through `legacy_pointnet_eval`, which is then also the
    encoder of the models (models.pointnet's pointnet_eval); `encoder` is
    the function that runs it. The swap is undone at once."""
    import ctypes

    from pose3d_tpu_torch.models import pointnet as model
    from pose3d_tpu_torch.ops import pointnet

    if path is None or hasattr(ctypes.CDLL(path), "pointnet_eval_scratch_floats"):
        return using(pointnet, path, lambda: run(pointnet.pointnet_eval))
    legacy = legacy_pointnet_eval(path)
    model.pointnet_eval = legacy
    try:
        return run(legacy)
    finally:
        model.pointnet_eval = pointnet.pointnet_eval


def sass_hmma(lib: str, prefix: str) -> dict:
    """{kernel: whether its SASS holds an HMMA (tensor-core) instruction} for
    the kernels of a built library whose names start with `prefix`, by
    cuobjdump beside nvcc; a template's instantiations apart (<4>, <double>;
    the float one bare)."""
    from pose3d_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        mangled = part.split(None, 1)[0]
        m = re.search(r"\d+(%s\w*?_kernel)(I(?:Li(\d+)E|d|f))?" % prefix, mangled)
        if m is None:
            continue
        key = m.group(1) + ("" if m.group(2) in (None, "If") else
                            "<double>" if m.group(2) == "Id" else f"<{m.group(3)}>")
        found[key] = found.get(key, False) or "HMMA" in part
    return found


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
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--source", action="append", default=[], type=parse_source,
                    metavar="NAME=FILE",
                    help="another version of csrc/NAME.cu (info_nce, vgg_stem or pointnet_eval; "
                    "an earlier commit's, with the same C interface, or pointnet_eval as of d190092) "
                    "to time beside this one: info_nce in phases 18 and 26, vgg_stem in phase "
                    "22, pointnet_eval in phase 13; repeatable")
    args = ap.parse_args()
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
        nce.nce_forward.blocked_launches = nce.nce_backward.blocked_launches = 0
        vgg_stem.stem_forward.launches = vgg_stem.stem_backward.launches = 0
        pointnet_train.train_forward.launches = pointnet_train.train_backward.launches = 0

    def counts():
        """(geodesic, pointnet, NCE forward, NCE backward, stem forward,
        stem backward, train-mode pointnet forward, its backward) launches."""
        return (geodesic.rotation_err.launches, pointnet.pointnet_eval.launches,
                nce.nce_forward.launches, nce.nce_backward.launches,
                vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                pointnet_train.train_forward.launches, pointnet_train.train_backward.launches)

    def blocked_counts():
        """NCE forward and backward launches for the blocked entries (JAX's
        kernel 5, nce_blocked.py)."""
        return nce.nce_forward.blocked_launches, nce.nce_backward.blocked_launches

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", t0, f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for cuDNN and matmul")

    # 2. build: one nvcc per source (and per --source), all started together
    tb = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(LIBRARIES) + len(args.source)) as pool:
        own = [pool.submit(_build.build, name) for name in LIBRARIES]
        other = [pool.submit(build_other, name, path, i)
                 for i, (name, path) in enumerate(args.source)]
        libs = [f.result() for f in own]
        other_libs = {name: {} for name in OTHER_SOURCES}
        for (name, path), f in zip(args.source, other):
            other_libs[name][path] = f.result()
    build_s = time.perf_counter() - tb
    for lib in libs + [p for o in other_libs.values() for p in o.values()]:
        with open(lib[:-3] + ".log") as f:
            ptxas = " | ".join(line.strip() for line in f
                               if "ptxas info" in line or "spill" in line)
        phase("build", t0, f"nvcc {lib}; {ptxas}")
    phase("build", t0, f"{len(libs) + len(args.source)} libraries in {build_s:.2f} s; "
          f"pne_encoder_kernel: "
          f"{pointnet.shared_memory_bytes()} bytes of dynamic shared memory a block; "
          f"info_nce at D 200 (forward, backward): {nce.shared_memory_bytes(200)} bytes; "
          f"vgg_stem at F 64 (forward, weight gradient): "
          f"{vgg_stem.shared_memory_bytes(64)} bytes; pointnet_train's largest block "
          f"(f32, f64): {pointnet_train.shared_memory_bytes()}, "
          f"{pointnet_train.shared_memory_bytes(torch.float64)} bytes; CUDA launches a "
          f"forward and a backward call, as the libraries report them: pointnet_train "
          f"{pointnet_train.kernel_launches_per_call()}, info_nce "
          f"{nce.kernel_launches_per_call()}")

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

    # 4. pointnet kernel vs plain version on the card, in f32 and in f64 (the
    # split-TF32 products' own error); D 1000 is no multiple of the 256-column
    # pass. Layer 3 runs on the tensor cores: HMMA in the encoder's SASS only
    hmma = sass_hmma(libs[1], "pne_")
    want = {"pne_split_w3_kernel": False, "pne_encoder_kernel": True,
            "pne_segment_max_kernel": False}
    if hmma != want:
        raise RuntimeError(f"pointnet_eval SASS: HMMA in {hmma}, expected {want}")
    pn_err, pn_rel, pn_rel64, cases = 0.0, 0.0, 0.0, []
    prng = np.random.default_rng(1)
    for n_c in (1, 46, 64):
        for p_c in (1, 511, 2500, 2501):
            for d_c in (256, 1000, 1024):
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
        ref64 = pointnet.pointnet_eval_plain(pts.double(), [(w.double(), b.double())
                                                            for w, b in folded])
        pn_rel64 = max(pn_rel64, rel_err(out.double(), ref64))
        pn_err, pn_rel = max(pn_err, err), max(pn_rel, err / float(ref.abs().max()))
        del ref64
    phase("pointnet", t0, f"kernel vs plain in {len(cases)} cases (N 1/46/64 x P 1/511/"
          f"2500/2501 x D 256/1000/1024, all outputs negative, identical points): max|d| "
          f"{pn_err:.3g}, max|d|/max|ref| {pn_rel:.3g} (tol {POINTNET_REL_TOL}); against the "
          f"f64 plain version {pn_rel64:.3g}; cuobjdump -sass: HMMA in {hmma}")

    # 5. VGG stem kernel vs plain version on the card: forward and the
    # weight/bias gradient, at the main path's shapes and around them
    # the f32 forward runs on the tensor cores (HMMA in its SASS), the f64
    # kernels and the f32 weight gradient on the CUDA cores
    hmma = sass_hmma(libs[3], "stem_")
    want = {"stem_forward_tf32x3_kernel": True, "stem_wgrad_stream_kernel": False,
            "stem_forward_f64_kernel": False, "stem_wgrad_f64_kernel": False}
    if any(hmma.get(k) != v for k, v in want.items()):
        raise RuntimeError(f"vgg_stem SASS: HMMA in {hmma}, want {want}")
    phase("vgg_stem", t0, f"cuobjdump -sass: HMMA in {hmma}")
    srng = np.random.default_rng(2)
    cases = [(n_c, hw, f_c, "rand") for n_c in (1, 7, 138) for hw in (224, 64, 30)
             for f_c in (16, 64)]
    cases += [(7, 224, 64, "ties"), (7, 224, 64, "negative"), (7, 31, 8, "rand"),
              (7, 64, 256, "rand"), (7, 224, 64, "bars")]
    stem_y_err = stem_grad_err = stem_err = split_err = 0.0
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
        case_split, split_ok = stem_split_error(vgg_stem, x_s, w_s, b_s)
        if not split_ok:
            raise RuntimeError(f"stem split-TF32 sums at {(n_c, hw, f_c, kind)}: error "
                               f"{case_split:.3g} of max|x| sum|w| beyond {STEM_SPLIT_ERR:.3g}")
        split_err = max(split_err, case_split)
    del x_s, w_s, b_s, g_s
    phase("vgg_stem", t0, f"kernel vs plain in {len(cases)} cases (N 1/7/138 x H=W 224/64/30 "
          f"x F 16/64, every window tied, every output masked, 31 x 31 at F 8, F 256, "
          f"constant bars over half the image): output max|d|/max|ref| "
          f"{stem_y_err:.3g} (tol {STEM_Y_TOL}), weight and bias gradients {stem_grad_err:.3g} "
          f"(tol {STEM_GRAD_TOL}); one forward and one backward launch a run, the same bits "
          f"on a second run; the f32 serving forward's split sums vs the f64 kernel: at most "
          f"{split_err:.3g} = 2^{math.log2(split_err) if split_err > 0 else -math.inf:.2f} "
          f"of max|x| sum|w| (the recompute margin assumes {STEM_SPLIT_ERR:.3g})")

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
        # the teacher through this pointnet source and any --source
        # pointnet_eval=..., in turns (this, others, others reversed, this)
        pn_others = other_libs["pointnet_eval"]
        for b in (1, TEACHER_BATCH):
            xb, pb = xt[:b].to(dev), pc_dev[:b]
            runs = {who: [] for who in ("this source", *pn_others)}
            for order in (list(runs), list(runs)[::-1]):
                for who in order:
                    runs[who].append(with_pointnet_source(
                        pn_others.get(who), lambda _: cuda_ms(lambda: teacher(xb, pb), iters=20)))
            ms = sum(runs["this source"]) / 2
            phase("time", t0, f"teacher serving f32 batch {b}: {ms:.3f} ms/batch = "
                  f"{b * 1000.0 / ms:.1f} img/s; ms/batch in turns with the pointnet kernel "
                  f"of {json.dumps(runs)} [{card}]")
    geo_times = {}
    for rows in (10_000, 1_000_000):
        p, l_ = p_dev[:rows].contiguous(), l_dev[:rows].contiguous()
        k_ms = cuda_ms(lambda: geodesic.rotation_err(p, l_), iters=200)
        plain_ms = cuda_ms(lambda: geometry.rotation_err(p, l_), iters=200)
        geo_times[rows] = (k_ms, plain_ms)
        phase("time", t0, f"geodesic {rows} rows: kernel {k_ms * 1000:.2f} us, plain "
              f"{plain_ms * 1000:.2f} us ({plain_ms / k_ms:.2f}x) [{card}]")
    # the pointnet kernel at serving's and evaluation's (64, 2500, 1024), the
    # KD step's frozen teacher's (46, ...), serving at batch 1, and the
    # teacher step's and stage 1's evaluations (64, 2500, 256), in turns
    # plain, kernel, any --source pointnet_eval=..., then back: by CUDA
    # events around back-to-back calls and by CUDA graph replays of 10 calls
    # (the host out of the way at batch 1); CUDA launches a call (a CUDA
    # graph's kernel nodes). The bound: the points and parameters read once,
    # the output written once; the three layers' products as split TF32
    # (three TF32 products per f32 one at 495 TFLOP/s) and, beside it, as
    # f32 on the CUDA cores
    pn_times, pn_bounds = {}, {}
    side = torch.cuda.Stream()
    whos = ("plain", "kernel", *pn_others)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n_c, d_c in ((TEACHER_BATCH, 1024), (KD_BATCH, 1024), (1, 1024), (TEACHER_BATCH, 256)):
        pts = pc_dev[:n_c].contiguous()
        f_c = folded if d_c == 1024 else pointnet_params(np.random.default_rng(13), d_c, dev)
        runs = {who: {"ms": [], "graph_ms": []} for who in whos}
        for order in (whos, whos[::-1]):
            for who in order:
                if who == "plain":
                    fn = functools.partial(pointnet.pointnet_eval_plain, pts, f_c)
                    runs[who]["ms"].append(cuda_ms(fn, iters=20))
                    runs[who]["graph_ms"].append(graph_ms(fn, side))
                    continue
                lib = pn_others.get(who)
                runs[who]["ms"].append(with_pointnet_source(
                    lib, lambda enc: cuda_ms(functools.partial(enc, pts, f_c), iters=20)))
                runs[who]["graph_ms"].append(with_pointnet_source(
                    lib, lambda enc: graph_ms(functools.partial(enc, pts, f_c), side)))
        launches = graph_kernel_launches(functools.partial(pointnet.pointnet_eval, pts, f_c))
        pn_times[n_c, d_c] = (sum(runs["kernel"]["ms"]) / 2, sum(runs["plain"]["ms"]) / 2)
        n_bytes = 4.0 * (n_c * POINT_NUM * 3 + sum(w.numel() + b.numel() for w, b in f_c)
                         + n_c * d_c)
        flops = 2.0 * n_c * POINT_NUM * (3 * 64 + 64 * 128 + 128 * d_c)
        pn_bounds[n_c, d_c] = bound(n_bytes, SPLIT_TF32_PRODUCTS * flops, TF32_FLOPS)
        cores = bound(n_bytes, flops)
        share = pn_bounds[n_c, d_c][0] / (sum(runs["kernel"]["graph_ms"]) / 2)
        phase("time", t0, f"pointnet ({n_c}, {POINT_NUM}, {d_c}) in turns, ms: "
              f"{json.dumps(runs)}; segments and groups "
              f"{pointnet.segments_for(n_c, POINT_NUM, d_c, sms)}, {launches} CUDA "
              f"launches a call; bound {pn_bounds[n_c, d_c][0]:.4f} ms "
              f"({pn_bounds[n_c, d_c][1]}, split TF32; f32 CUDA cores {cores[0]:.4f} ms), "
              f"{100 * share:.1f} % of it by graph replay [{card}]")
        del pts

    del teacher
    # per row: 24 bytes read, 4 written; about 100 operations (six sincos,
    # two 3x3 builds, the trace, acos)
    geo_bound = bound(28.0 * 1_000_000, 100.0 * 1_000_000)

    # 14. NCE kernels vs the plain version on the card: loss and both
    # gradients; N 1 to 2500 (one tile to 79), D 64 / 200, with and without
    # masked rows and columns, a shard with its row offset, identical rows;
    # stage 1's (46, 200) at its tau 0.5, keys under dropout and "trained"
    # keys (the positive near its row), at tau 0.1 and 0.5, to N 4096. Each
    # case runs twice (the same bits) and is held against the f32 plain
    # version within the tolerances and against the f64 one, which shows the
    # split-TF32 products' own error. The forward and backward kernels hold
    # HMMA (tensor-core) instructions in their SASS.
    hmma = sass_hmma(libs[2], "nce_")
    if sorted(hmma) != [f"nce_{p}_kernel<{rm}>" for p in ("backward", "forward")
                        for rm in (1, 2)] or not all(hmma.values()):
        raise RuntimeError(f"info_nce SASS: HMMA in {hmma}, want every kernel")
    phase("nce", t0, f"cuobjdump -sass: HMMA in {hmma}")
    nrng = np.random.default_rng(13)
    cases = [(n, d, masked, 0, False, 0.1, "rand") for n in (1, 7, 160, 1025, 2500)
             for d in (64, 200) for masked in (False, True)]
    cases += [(160, 200, True, 97, False, 0.1, "rand"), (100, 200, False, 37, False, 0.1, "rand"),
              (160, 200, False, 0, True, 0.1, "rand")]
    cases += [(n, 200, False, 0, False, tau, keys) for n in (KD_BATCH, TRAIN_BATCH, 4096)
              for tau in (0.1, 0.5) for keys in ("rand", "dropout", "trained")]
    nce_loss_err = nce_grad_err = nce_err = 0.0
    f64_errs = []
    for n, d, masked, offset, identical, tau, keys in cases:
        s_c, t_c, vrow, vcol = nce_inputs(nrng, n, d, dev, masked, offset, identical, keys)
        before = counts()
        res = nce_kernel_vs_plain(nce, s_c, t_c, vrow, vcol, offset, tau)
        torch.cuda.synchronize()
        after = counts()
        case = (n, d, masked, offset, identical, tau, keys)
        if (after[2] - before[2], after[3] - before[3]) != (2, 2) or not res["same"]:
            raise RuntimeError(f"NCE case {case}: launches {after[2] - before[2]} forward, "
                               f"{after[3] - before[3]} backward for two runs, the same bits "
                               f"{res['same']}")
        if res["loss"] > NCE_LOSS_RTOL or res["grads"] > NCE_GRAD_TOL:
            raise RuntimeError(f"NCE kernel vs plain at {case}: loss {res['loss']:.3g}, "
                               f"gradients {res['grads']:.3g}")
        nce_loss_err = max(nce_loss_err, res["loss"])
        nce_grad_err = max(nce_grad_err, res["grads"])
        nce_err = max(nce_err, res["max_d"])
        f64_errs.append((res["loss64"], res["grads64"]))
        if tau != 0.1 or keys != "rand" or n == KD_BATCH:
            phase("nce", t0, f"({n}, {d}) tau {tau} keys {keys}: vs f32 plain loss "
                  f"{res['loss']:.3g}, gradients {res['grads']:.3g}; vs f64 plain loss "
                  f"{res['loss64']:.3g}, gradients {res['grads64']:.3g}")
    phase("nce", t0, f"kernel vs plain in {len(cases)} cases (N 1/7/46/160/1025/2500/4096 x "
          f"D 64/200 x masked or not, shards at offsets 97 and 37, identical rows, tau "
          f"0.1/0.5, keys random, under dropout or trained): loss rel {nce_loss_err:.3g} (tol "
          f"{NCE_LOSS_RTOL}), gradients max|d|/max|ref| {nce_grad_err:.3g} (tol "
          f"{NCE_GRAD_TOL}); against the f64 plain version at most loss "
          f"{max(e[0] for e in f64_errs):.3g}, gradients {max(e[1] for e in f64_errs):.3g}; "
          f"one forward and one backward launch a run, the same bits twice")

    # 15. one train step, card vs CPU: small width, the same seeded weights,
    # model in f64 and losses in f32 (the NCE in its kernel on the card), no
    # dropout; in f32 the batch-statistics BatchNorm of ResNet-50 at batch 8
    # magnifies rounding far past these tolerances (tests/test_torch_train.py)
    small = convert.pose_state_dict(teacher_variables(np.random.default_rng(14), 64, 64))
    small_batch = train_batch(np.random.default_rng(14), 8, 64, 100)

    def small_teacher_step(launched=None, **kw):
        """small_step(where) for `card_vs_cpu`: one teacher step at the small
        width (make_teacher_train_step's options `kw`); `launched[where]`:
        the kernels' launches it made."""
        def run(where):
            model = PoseEstimator(img_feature_dim=64, shape_feature_dim=64)
            model.load_state_dict(small, strict=True)
            state = create_train_state(model.double().to(where), LR, [100], seed=0)
            batch = {k: torch.from_numpy(v).to(where) for k, v in small_batch.items()}
            batch["im"], batch["shape"] = batch["im"].double(), batch["shape"].double()
            before = counts()
            metrics = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True,
                                                    **kw)(state, batch)
            torch.cuda.synchronize()
            if launched is not None:
                launched[where] = tuple(a - b for a, b in zip(counts(), before))
            return metrics, [state.model]
        return run

    launched = {}
    loss_err, grad_err, stat_err = card_vs_cpu(small_teacher_step(launched),
                                               ("loss", "pose_loss", "nce_loss"))
    # NCE and train-mode pointnet, forward and backward
    l_gpu = launched["cuda"][2:4] + launched["cuda"][6:]
    if l_gpu != (1, 1, 1, 1) or any(launched["cpu"]):
        raise RuntimeError(f"train step (NCE, train-mode pointnet) forward and backward "
                           f"launches: card {l_gpu}, CPU {launched['cpu']}")
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
    train_counts, train_blocked = counts(), blocked_counts()
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
          f"NCE launches {train_counts[2]} forward, {train_counts[3]} backward (blocked "
          f"entries {train_blocked}); train-mode "
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
    if other_libs["info_nce"]:
        phase("time", t0, "teacher train step through the NCE kernels of " + ", ".join(
            f"{who}: {v} ms/step" for who, v in steps_through(
                nce, other_libs["info_nce"], lambda: step(state, tb)).items())
            + f" (in turns) [{card}]")
    rows, device_ms, wall_ms = profile_steps(lambda: step(state, tb))
    nce_ms = sum(e.self_device_time_total for e in rows if "nce_" in e.key) / 1e3
    pt_ms = sum(e.self_device_time_total for e in rows if "pnt_" in e.key) / 1e3
    phase("profile", t0, f"2 train steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms "
          f"wall (busy {device_ms / wall_ms:.3f}); the NCE kernels {nce_ms:.4f} ms, the "
          f"train-mode pointnet kernels {pt_ms:.4f} ms [{card}]; by self device time:")
    print_rows(rows, device_ms)
    del state, tb, step

    # the NCE kernels at stage 1's (46, 200), the teacher step's (160, 200)
    # and the blocked regime's (4096, 200), in turns with the plain version
    # and any --source info_nce=...: time a call by CUDA events around
    # back-to-back calls, device time a call by CUDA events around the
    # replays of a CUDA graph of 10 calls (the profiler lost kernel records
    # here once), the host's time to issue a call (no sync), CUDA launches a
    # call (a CUDA graph's kernel nodes)
    nce_others = other_libs["info_nce"]
    nce_times, nce_bounds = {}, {}
    side = torch.cuda.Stream()
    for n in (KD_BATCH, TRAIN_BATCH, 4096):
        d = 200
        s_c, t_c, _, _ = nce_inputs(np.random.default_rng(17), n, d, dev)
        g = torch.ones((), device=dev)
        s_g, t_g = s_c.clone().requires_grad_(), t_c.clone().requires_grad_()
        plain_loss = nce.info_nce_plain(s_g, t_g) / n
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # leaves and forward there: so is their backward
            s_side, t_side = s_c.clone().requires_grad_(), t_c.clone().requires_grad_()
            plain_loss_side = nce.info_nce_plain(s_side, t_side) / n
        torch.cuda.synchronize()

        def plain_fwd():
            with torch.no_grad():
                nce.info_nce_plain(s_c, t_c)

        fns = {"plain forward": plain_fwd,
               "plain backward": lambda: torch.autograd.grad(plain_loss, (s_g, t_g),
                                                             retain_graph=True)}
        for who, lib in (("kernel", None), *nce_others.items()):
            saved_c = using(nce, lib, lambda: nce.nce_forward(s_c, t_c, None, None, 0, 0.1,
                                                              True))[1]
            fns[f"{who} forward"] = functools.partial(
                using, nce, lib, lambda: nce.nce_forward(s_c, t_c, None, None, 0, 0.1, True))
            fns[f"{who} backward"] = functools.partial(
                using, nce, lib, functools.partial(nce.nce_backward, saved_c, None, None, g,
                                                   (n, n, d), 0, 0.1, True))
        iters = 200 if n < 1000 else 20
        in_graph = dict(fns, **{"plain backward": lambda: torch.autograd.grad(
            plain_loss_side, (s_side, t_side), retain_graph=True)})
        runs = {k: {"ms": [], "graph_ms": [], "host_us": []} for k in fns}
        whos = ("plain", "kernel", *nce_others)
        for order in (whos, whos[::-1]):
            for who in order:
                for part in ("forward", "backward"):
                    fn, r = fns[f"{who} {part}"], runs[f"{who} {part}"]
                    r["ms"].append(cuda_ms(fn, iters))
                    r["graph_ms"].append(graph_ms(in_graph[f"{who} {part}"], side))
                    torch.cuda.synchronize()
                    tt = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    r["host_us"].append((time.perf_counter() - tt) * 1e6 / iters)
                    torch.cuda.synchronize()
        for k, r in runs.items():
            if not k.startswith("plain"):
                r["launches"] = graph_kernel_launches(fns[k])
        nce_times[n] = runs
        # the bound: inputs read once, outputs written once (forward: the
        # normalised rows, norms and per-row residuals; backward: those in,
        # ds and dt out); the products as split TF32 on the tensor cores
        # (three TF32 products per f32 product: 3 x 2 n^2 d forward, 3 x 4 n^2
        # d backward) and, beside it, on the f32 CUDA cores
        fwd_bytes, bwd_bytes = 4.0 * (4 * n * d + 8 * n + 2), 4.0 * (4 * n * d + 5 * n + 2)
        nce_bounds[n] = (bound(fwd_bytes, SPLIT_TF32_PRODUCTS * 2.0 * n * n * d, TF32_FLOPS),
                         bound(bwd_bytes, SPLIT_TF32_PRODUCTS * 4.0 * n * n * d, TF32_FLOPS),
                         bound(fwd_bytes, 2.0 * n * n * d), bound(bwd_bytes, 4.0 * n * n * d))
        fwd_b, bwd_b, fwd_cc, bwd_cc = nce_bounds[n]
        phase("time", t0, f"NCE ({n}, {d}), in turns: " + "; ".join(
            f"{k}: {json.dumps({m: v for m, v in r.items()})}" for k, r in runs.items())
            + f"; bound forward {fwd_b[0]:.5f} ms ({fwd_b[1]}, split TF32; f32 CUDA cores "
            f"{fwd_cc[0]:.5f}), backward {bwd_b[0]:.5f} ms ({bwd_b[1]}, split TF32; f32 CUDA "
            f"cores {bwd_cc[0]:.5f}) [{card}]")
        del s_c, t_c, s_g, t_g, s_side, t_side, plain_loss, plain_loss_side, fns, in_graph

    # 19. one KD step, card vs CPU, at the CPU test's small width: the
    # student in f64 (the stem's f64 kernel on the card), the frozen
    # teacher in f32 (the PointNet kernel is f32 only), the losses in f32,
    # no dropout; 4 samples, the last padded
    s_small = convert.baseline_state_dict(student_variables(np.random.default_rng(19), 64,
                                                            0.25, 32))
    t_small = convert.pose_state_dict(teacher_variables(np.random.default_rng(20), 64, 64))
    kd_small = kd_batch(np.random.default_rng(21), 4, 32, 100)
    kd_small["valid"] = np.arange(4) < 3

    def small_student(where):
        model = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                  dropout_rate=0.0)
        model.load_state_dict(s_small, strict=True)
        return create_train_state(model.double().to(where), LR, [100], seed=0)

    def small_kd_step(make_step, teacher_cls, teacher_sd, launched=None):
        """small_step(where) for `card_vs_cpu`: one student step of
        make_step() over the three views against the frozen small teacher
        (teacher_cls 64/64 from teacher_sd, f32); `launched[where]`: the
        kernels' launches it made."""
        def run(where):
            state = small_student(where)
            teacher = teacher_cls(img_feature_dim=64, shape_feature_dim=64)
            teacher.load_state_dict(teacher_sd, strict=True)
            teacher = teacher.to(where).eval().requires_grad_(False)
            batch = {k: torch.from_numpy(v).to(where) for k, v in kd_small.items()}
            for k in ("im", "im_flip", "im_rot"):
                batch[k] = batch[k].double()
            before = counts()
            metrics = make_step()(state, teacher, batch)
            torch.cuda.synchronize()
            if launched is not None:
                launched[where] = tuple(a - b for a, b in zip(counts(), before))
            return metrics, [state.model]
        return run

    launched = {}
    loss_err, grad_err, stat_err = card_vs_cpu(
        small_kd_step(steps.make_kd_crd_step, PoseEstimator, t_small, launched),
        ("loss", "gt_loss"))
    l_gpu = launched["cuda"]
    if l_gpu != (0, 1, 0, 0, 1, 1, 0, 0) or any(launched["cpu"]):
        raise RuntimeError(f"KD step launches: card {l_gpu}, CPU {launched['cpu']}")
    phase("KD step", t0, f"card vs CPU at student width 0.25 / feature 64, 32x32, teacher "
          f"64/64, 4 samples x 3 views, one padded (f64 student, f32 teacher and losses): "
          f"losses rel {loss_err:.3g} (tol {STEP_LOSS_RTOL}), gradients max|d|/max|ref| "
          f"{grad_err:.3g} (tol {STEP_GRAD_TOL}), running statistics max|d| {stat_err:.3g}; "
          f"the card's step launched (pointnet, stem forward, stem backward) "
          f"{(l_gpu[1], l_gpu[4], l_gpu[5])}")

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
    # step with the plain stem beside it (and with --source vgg_stem=..., with those
    # sources' stem kernels), a profile of two steps, and the stem kernels
    # vs their plain version (and those sources')
    from pose3d_tpu_torch.models import vgg as vgg_model
    others = other_libs["vgg_stem"]
    ab = ab_times(vgg_model, "vgg_stem", vgg_stem.vgg_stem_plain,
                  lambda: steps_ms(lambda: kd_step(kd_state, kd_teacher, kb)))
    kd_ms = sum(ab["kernel"]) / 2
    phase("time", t0, f"KD --crd step f32 batch {KD_BATCH} x 3 views: {kd_ms:.3f} ms/step = "
          f"{KD_BATCH * 1000.0 / kd_ms:.1f} samples/s (runs {ab['kernel']}); with the plain "
          f"stem {ab['plain']} ms/step = {KD_BATCH * 2000.0 / sum(ab['plain']):.1f} "
          f"samples/s [{card}]")
    if others:
        phase("time", t0, "KD --crd step through the stem of " + ", ".join(
            f"{who}: {v} ms/step" for who, v in steps_through(
                vgg_stem, others, lambda: kd_step(kd_state, kd_teacher, kb)).items())
            + f" (in turns) [{card}]")
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
    whos = ("plain", "kernel", *others)
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
               "kernel forward, serving": lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, False),
               "plain forward": plain_fwd,
               "plain backward": lambda: torch.autograd.grad(y_plain, (w_s, b_s), g_s,
                                                             retain_graph=True)}
        for who, lib in others.items():  # the same C interface and index format
            for part in ("forward", "backward", "forward, serving"):
                fns[f"{who} {part}"] = functools.partial(using, vgg_stem, lib,
                                                        fns[f"kernel {part}"])
        runs = {f"{who} {part}": [] for who in whos for part in ("forward", "backward")}
        runs.update({f"{who} forward, serving": [] for who in whos if who != "plain"})
        for order in (whos, whos[::-1]):
            for who in order:
                for key in runs:
                    if key.startswith(who + " "):
                        runs[key].append(cuda_ms(fns[key], 10))
        stem_times[n_s] = {k: sum(v) / len(v) for k, v in runs.items()}
        t = stem_times[n_s]
        # the bound: each input read once, each output written once; the
        # forward's products at the TF32 rate, three for each f32 product
        # (beside it the figure for the f32 CUDA cores), the weight
        # gradient's only where this run's outputs pass the ReLU (the
        # routed position of each), on the CUDA cores
        pooled = n_s * 112 * 112 * 64
        unmasked = int((index < 4).sum())
        in_bytes = 4.0 * (n_s * 224 * 224 * 3 + 64 * 28)
        products = 2.0 * 27 * 4 * pooled
        stem_bounds[n_s] = (
            bound(in_bytes + 4.0 * pooled + pooled, SPLIT_TF32_PRODUCTS * products, TF32_FLOPS),
            bound(in_bytes + 4.0 * pooled + pooled, 2.0 * 28 * unmasked),
            bound(in_bytes + 4.0 * pooled, SPLIT_TF32_PRODUCTS * products, TF32_FLOPS),
            bound(in_bytes + 4.0 * pooled + pooled, products))
        fwd_b, bwd_b, serve_b, cc_b = stem_bounds[n_s]
        other_ms = "".join(f"; {who}: forward {runs[who + ' forward']} (serving "
                           f"{runs[who + ' forward, serving']}) + backward "
                           f"{runs[who + ' backward']} ms" for who in others)
        phase("time", t0, f"stem ({n_s}, 224, 224) F 64: kernel forward "
              f"{runs['kernel forward']} ms (serving, no indices, "
              f"{runs['kernel forward, serving']}) + backward {runs['kernel backward']} ms; "
              f"plain forward {runs['plain forward']} + backward {runs['plain backward']} ms"
              f"{other_ms}; forward+backward {t['kernel forward'] + t['kernel backward']:.4f} vs "
              f"{t['plain forward'] + t['plain backward']:.4f} ms "
              f"({(t['plain forward'] + t['plain backward']) / (t['kernel forward'] + t['kernel backward']):.2f}x); "
              f"bound forward {fwd_b[0]:.4f} ms ({fwd_b[1]}; its products as split TF32 on "
              f"the tensor cores; on the f32 CUDA cores {cc_b[0]:.4f} ms, {cc_b[1]}), serving "
              f"{serve_b[0]:.4f} ms ({serve_b[1]}), backward {bwd_b[0]:.4f} ms ({bwd_b[1]}; "
              f"{unmasked / pooled:.3f} of the outputs pass the ReLU) [{card}]")
        del x_s, x_nhwc, index, y_plain, g_s
    # the forward with indices where windows tie exactly, at the KD shape:
    # phase 5's "ties" image (every window tied) and resize_pad's constant
    # bars over a quarter and a half of the image, beside the random image
    # (with --source vgg_stem=..., those sources' in turns); the shares of routing
    # decisions near their threshold and of those the kernel makes again
    for kind, bars in (("rand", 0.0), ("ties", 0.0), ("bars", 0.25), ("bars", 0.5)):
        x_s, w_s, b_s, _ = stem_inputs(np.random.default_rng(25), 3 * KD_BATCH, 224, 64, kind,
                                       dev, bars=bars)
        x_nhwc, w_d, b_d = x_s.permute(0, 2, 3, 1), w_s.detach(), b_s.detach()
        fwd = {"kernel": lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, True)}
        for who, lib in others.items():
            fwd[who] = functools.partial(using, vgg_stem, lib, fwd["kernel"])
        runs = {who: [] for who in fwd}
        for order in (list(fwd), list(fwd)[::-1]):
            for who in order:
                runs[who].append(cuda_ms(fwd[who], 10))
        near, again = stem_near_shares(x_nhwc, w_d, b_d)
        label = f"bars over {bars:.0%} of it" if kind == "bars" else kind
        other_ms = "".join(f", {who}'s {runs[who]} ms" for who in others)
        phase("time", t0, f"stem forward with indices ({3 * KD_BATCH}, 224, 224) F 64, "
              f"{label} image: kernel {runs['kernel']} ms{other_ms} (in turns); routing "
              f"decisions within the margin of their threshold {near:.6f} of all, made again in "
              f"f32 FMA {again:.6f} (estimated from f64 sums) [{card}]")
        del x_s, w_s, b_s, x_nhwc, w_d, b_d

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
    s1_counts, s1_blocked = counts(), blocked_counts()
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
          f"{s1_counts[3] // TRAIN_STEPS} backward (blocked entries in all {s1_blocked}); stem {s1_counts[4] // TRAIN_STEPS} and "
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
    if other_libs["info_nce"]:
        phase("time", t0, "KD --stage 1 step through the NCE kernels of " + ", ".join(
            f"{who}: {v} ms/step" for who, v in steps_through(
                nce, other_libs["info_nce"], lambda: s1_step(t1, s1, sb)).items())
            + f" (in turns) [{card}]")
    rows, device_ms, wall_ms = profile_steps(lambda: s1_step(t1, s1, sb))
    pt_dev_ms = sum(e.self_device_time_total for e in rows if "pnt_" in e.key) / 1e3
    nce_dev_ms = sum(e.self_device_time_total for e in rows if "nce_" in e.key) / 1e3
    phase("profile", t0, f"2 stage-1 steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms wall "
          f"(busy {device_ms / wall_ms:.3f}); the train-mode pointnet kernels {pt_dev_ms:.4f} "
          f"ms, the NCE kernels {nce_dev_ms:.4f} ms [{card}]; by self device time:")
    print_rows(rows, device_ms)
    # stage 1's train states as its trainer's checkpoint.pth holds them, for
    # stage 2's teacher (phase 28)
    s2_dir = tempfile.TemporaryDirectory()
    s1_ckpt = os.path.join(s2_dir.name, "checkpoint.pth")
    torch.save({"teacher": t1.state_dict(), "student": s1.state_dict()}, s1_ckpt)
    s1_teacher_sd = {k: v.cpu() for k, v in t1.model.state_dict().items()}
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
        # M h2 (128 x 128) a point, its Gram form (csrc/pointnet_train.cu);
        # as split TF32 (three TF32 products per f32 one at 495 TFLOP/s) and,
        # beside it, as f32 on the CUDA cores, where the kernels run today
        rows_c, n_stats = n_c * POINT_NUM, 2 * (64 + 128 + d_c)
        flops_f = 2.0 * rows_c * (3 * 64 + 64 * 128 + 128 * d_c)
        flops_b = 2.0 * rows_c * (3 * 64 + 2 * 64 * 128 + 128 * 128)
        bytes_f = 4.0 * (3 * rows_c + prm.numel() + 2 * n_c * d_c + n_stats)
        bytes_b = 4.0 * (3 * rows_c + 2 * prm.numel() + 2 * n_c * d_c + n_stats)
        pt_bounds[n_c] = (bound(bytes_f, SPLIT_TF32_PRODUCTS * flops_f, TF32_FLOPS),
                          bound(bytes_b, SPLIT_TF32_PRODUCTS * flops_b, TF32_FLOPS))
        cores = bound(bytes_f, flops_f)[0], bound(bytes_b, flops_b)[0]
        phase("time", t0, f"train-mode pointnet ({n_c}, {POINT_NUM}, {d_c}): kernel forward "
              f"{runs['kernel forward']} + backward {runs['kernel backward']} ms; plain forward "
              f"{runs['plain forward']} + backward {runs['plain backward']} ms; forward+backward "
              f"{t['kernel forward'] + t['kernel backward']:.4f} vs "
              f"{t['plain forward'] + t['plain backward']:.4f} ms; bound forward "
              f"{pt_bounds[n_c][0][0]:.4f} ms ({pt_bounds[n_c][0][1]}, split TF32; f32 CUDA "
              f"cores {cores[0]:.4f}), backward {pt_bounds[n_c][1][0]:.4f} ms "
              f"({pt_bounds[n_c][1][1]}, split TF32; f32 CUDA cores {cores[1]:.4f}); CUDA "
              f"launches a forward "
              f"and a backward call: {pointnet_train.kernel_launches_per_call()} [{card}]")
        del pts_c, layers_c, g_c, h1_c, h2_c, gram_c, tracked, flat, out_p

    # 28. KD --stage 2 at full width: the frozen vanilla teacher read by
    # the CLI's loader (`cli.common.build_vanilla`) from the stage-1
    # checkpoint.pth written after phase 26 (the two-stage recipe on the
    # card), the student (2048, 224x224) through make_stage2_step at batch
    # 46 x 3 views: the stage-2 path's main path
    from types import SimpleNamespace
    from pose3d_tpu_torch.cli import common as cli_common
    from pose3d_tpu_torch.losses.memory_bank import MemoryBank, enqueue, init_memory_bank
    from pose3d_tpu_torch.train.ckpt import Checkpointer
    tr = time.perf_counter()
    s2_teacher = cli_common.build_vanilla(
        SimpleNamespace(img_feature_dim=1024, shape_feature_dim=STAGE1_SHAPE_DIM, bin_size=15),
        dev, s1_ckpt).requires_grad_(False)
    load_s = time.perf_counter() - tr
    same = all(torch.equal(v.cpu(), s1_teacher_sd[k])
               for k, v in s2_teacher.state_dict().items())
    if not same or s2_teacher.training:
        raise RuntimeError(f"stage 2: the teacher read from stage 1's checkpoint equal {same}, "
                           f"in train mode {s2_teacher.training}")
    del s1_teacher_sd
    s2_dir.cleanup()
    s2_state = create_train_state(kd_student(47), LR, [10**9], seed=47)
    s2_step = steps.make_stage2_step()
    kb2 = {k: torch.from_numpy(v).to(dev) for k, v in
           kd_batch(np.random.default_rng(28), KD_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [s2_step(s2_state, s2_teacher, kb2) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    s2_counts = counts()
    s2_losses = [float(m["loss"]) for m in history]
    s2_gt = [float(m["gt_loss"]) for m in history]
    if s2_counts != (0, TRAIN_STEPS, 0, 0, TRAIN_STEPS, TRAIN_STEPS, 0, 0):
        raise RuntimeError(f"stage 2: launches {s2_counts}, expected one pointnet, one stem "
                           f"forward and one stem backward a step")
    if not all(math.isfinite(v) for v in s2_losses + s2_gt):
        raise RuntimeError(f"stage 2: losses {s2_losses}, gt losses {s2_gt}")
    phase("stage 2 training", t0, f"vanilla teacher (1024/{STAGE1_SHAPE_DIM}, {POINT_NUM} "
          f"points) read from stage 1's checkpoint.pth in {load_s:.2f} s, equal to the trained "
          f"teacher, eval mode; student {sum(p.numel() for p in s2_state.model.parameters())} "
          f"params, batch {KD_BATCH} x 3 views, 224x224, {TRAIN_STEPS} steps on one batch: "
          f"loss {[round(v, 4) for v in s2_losses]} (gt {[round(v, 4) for v in s2_gt]}); "
          f"launches a step: pointnet {s2_counts[1] // TRAIN_STEPS}, stem forward "
          f"{s2_counts[4] // TRAIN_STEPS}, stem backward {s2_counts[5] // TRAIN_STEPS}")

    # 29. the stage-2 trainer: one epoch on in-memory samples, then a
    # resume into a second (as phase 21 for --crd)
    with tempfile.TemporaryDirectory() as tmp:
        def s2_loaders():
            return (DataLoader(KDMemorySet(2 * KD_BATCH, 29, 224), KD_BATCH, shuffle=True,
                               drop_last=True, num_workers=2),
                    DataLoader(KDMemorySet(40, 30, 224, train=False), KD_BATCH,
                               shuffle=False, num_workers=2))

        fit_state = create_train_state(kd_student(29), LR, [10**9], seed=46)
        trainer = KDTrainer(fit_state, s2_teacher, *s2_loaders(), EVAL_CATEGORIES, tmp)
        reset_counts()
        trainer.fit_stage2(1)
        torch.cuda.synchronize()
        s2_fit_counts = counts()
        if s2_fit_counts != (1, 2, 0, 0, 3, 2, 0, 0):
            raise RuntimeError(f"stage-2 trainer epoch: launches {s2_fit_counts}")
        resumed = create_train_state(kd_student(98), LR, [10**9], seed=0)
        resumed.load_state_dict(trainer.ckpt.restore("checkpoint"))
        same = all(torch.equal(a, b) for a, b in zip(
            fit_state.model.state_dict().values(), resumed.model.state_dict().values()))
        del fit_state, trainer
        KDTrainer(resumed, s2_teacher, *s2_loaders(), EVAL_CATEGORIES, tmp).fit_stage2(
            2, start_epoch=1)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if not same or resumed.step != 4 or [r["epoch"] for r in records] != [0, 1] or \
                not all(r["kind"] == "stage2_epoch" and math.isfinite(r["train_loss"])
                        and math.isfinite(r["val_med"]) for r in records):
            raise RuntimeError(f"stage-2 trainer resume: state restored {same}, step "
                               f"{resumed.step}, records {records}")
    phase("stage-2 trainer", t0, f"epoch 0 at batch {KD_BATCH} (2 steps, 40 evaluation rows): "
          f"launches {s2_fit_counts}; resumed from checkpoint.pth (state equal) into epoch 1; "
          f"train_loss {[round(r['train_loss'], 4) for r in records]} val_med "
          f"{[round(r['val_med'], 3) for r in records]} train_samples_per_s "
          f"{[round(r['train_samples_per_s'], 1) for r in records]}")
    del resumed

    # 30. one stage-2 step card vs CPU at the CPU test's small width (the
    # student in f64, the vanilla teacher in f32 and the losses in f32, no
    # dropout, one sample of 4 padded); the stage-2 step's time by CUDA
    # events, a profile of two steps (busy share, CUDA launches by kernel
    # name) and the frozen teacher's forward
    v_small = convert.pose_vanilla_state_dict(vanilla_variables(np.random.default_rng(31),
                                                                64, 64))
    errs = card_vs_cpu(small_kd_step(steps.make_stage2_step, PoseEstimatorVanilla, v_small),
                       ("loss", "gt_loss"))
    s2_ms = cuda_ms(lambda: s2_step(s2_state, s2_teacher, kb2), iters=TRAIN_STEPS, warmup=1)
    im3 = torch.cat([kb2["im"], kb2["im_flip"], kb2["im_rot"]])
    with torch.no_grad():
        s2_teacher_ms = cuda_ms(lambda: s2_teacher(im3, kb2["shape"], view_tile=3), iters=5)
    rows, device_ms, wall_ms = profile_steps(lambda: s2_step(s2_state, s2_teacher, kb2))
    # CUDA launches a call at the step's shapes, counted as a CUDA graph's
    # kernel nodes (the profiler's records miss a kernel now and then):
    # the stem forward and backward at (138, 224, 224, 64), the eval
    # PointNet at (46, 2500, 256)
    x_s, w_s, b_s, g_s = stem_inputs(np.random.default_rng(30), 3 * KD_BATCH, 224, 64,
                                     "random", dev)
    x_s, w_s, b_s = x_s.permute(0, 2, 3, 1), w_s.detach(), b_s.detach()
    _, index_s = vgg_stem.stem_forward(x_s, w_s, b_s, with_index=True)
    s2_stem = (graph_kernel_launches(lambda: vgg_stem.stem_forward(x_s, w_s, b_s,
                                                                   with_index=True)),
               graph_kernel_launches(lambda: vgg_stem.stem_backward(x_s, index_s, g_s)))
    folded_s = pointnet_params(np.random.default_rng(30), STAGE1_SHAPE_DIM, dev)
    s2_pne = graph_kernel_launches(lambda: pointnet.pointnet_eval(kb2["shape"], folded_s))
    del x_s, w_s, b_s, g_s, index_s, folded_s
    phase("stage 2", t0, f"one step card vs CPU at student width 0.25 / feature 64, 32x32, "
          f"vanilla teacher 64/64, 4 samples x 3 views, one padded (f64 student, f32 teacher "
          f"and losses): losses rel {errs[0]:.3g} (tol {STEP_LOSS_RTOL}), gradients "
          f"max|d|/max|ref| {errs[1]:.3g} (tol {STEP_GRAD_TOL}), running statistics max|d| "
          f"{errs[2]:.3g} (tol 1e-5)")
    phase("time", t0, f"KD --stage 2 step f32 batch {KD_BATCH} x 3 views: {s2_ms:.3f} ms/step "
          f"= {KD_BATCH * 1000.0 / s2_ms:.1f} samples/s by CUDA events; the frozen vanilla "
          f"teacher's forward on the 138 views {s2_teacher_ms:.3f} ms [{card}]")
    phase("profile", t0, f"2 stage-2 steps: {device_ms:.2f} ms device of {wall_ms:.2f} ms wall "
          f"(busy {device_ms / wall_ms:.3f}); a step makes 1 stem forward call ({s2_stem[0]} "
          f"CUDA launch), 1 stem backward call ({s2_stem[1]}) and 1 eval pointnet call "
          f"({s2_pne} at (46, 2500, 256)), launches by a CUDA graph's kernel nodes [{card}]; by "
          f"self device time:")
    print_rows(rows, device_ms)
    del s2_state, s2_teacher, kb2, history, im3

    # 31. the variants, 2 steps each at full width (and 3 more timed by CUDA
    # events), each with one step card vs CPU at the small width:
    # --contrast and --vid through make_kd_crd_step (the KD teacher of phase
    # 20 again), stage 1 with the memory bank (its queue saved and restored
    # through a checkpoint), stage 1 and the teacher step with --nce pose
    # (--weighting sqrt) and --nce multipose, and the RGB-only baseline at
    # batch 64. Each variant's launches are counted from 0. The pose
    # variants' small steps take their pose distances from the CPU on both
    # sides (`pose_distances_on_cpu`).
    variant_counts, variant_ms = {}, {}

    def run_variant(name, run_step, loss_key, expect, small=None, loss_keys=()):
        reset_counts()
        history = [run_step() for _ in range(2)]
        torch.cuda.synchronize()
        variant_counts[name] = counts()
        losses = [float(m[loss_key]) for m in history]
        if variant_counts[name] != expect or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"{name}: launches {variant_counts[name]} (expected {expect}), "
                               f"losses {losses}")
        variant_ms[name] = cuda_ms(run_step, iters=3, warmup=0)
        errs = card_vs_cpu(small, loss_keys) if small is not None else None
        phase(name, t0, f"2 steps: {loss_key} {[round(v, 4) for v in losses]}; launches "
              f"(geodesic, pointnet, NCE forward, NCE backward, stem forward, stem backward, "
              f"train-mode pointnet forward, backward) {variant_counts[name]}; "
              f"{variant_ms[name]:.3f} ms/step by CUDA events [{card}]"
              + ("" if errs is None else
                 f"; one small step card vs CPU: losses rel {errs[0]:.3g} (tol "
                 f"{STEP_LOSS_RTOL}), gradients {errs[1]:.3g} (tol {STEP_GRAD_TOL}), running "
                 f"statistics {errs[2]:.3g} (tol 1e-5)"))

    state = convert.pose_state_dict(teacher_variables(np.random.default_rng(5)))
    with torch.device("meta"):
        kd_teacher = PoseEstimator()
    kd_teacher.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True,
                               assign=True)
    kd_teacher.eval().requires_grad_(False)
    del state
    kv_state = create_train_state(kd_student(48), LR, [10**9], seed=48)
    kbv = {k: torch.from_numpy(v).to(dev) for k, v in
           kd_batch(np.random.default_rng(34), KD_BATCH, 224, POINT_NUM).items()}
    per_kd = (0, 2, 0, 0, 2, 2, 0, 0)
    for variant in ("contrast", "vid"):
        kv_step = steps.make_kd_crd_step(loss_variant=variant)
        run_variant(f"KD --{variant}", lambda: kv_step(kv_state, kd_teacher, kbv), "loss",
                    per_kd, small_kd_step(functools.partial(steps.make_kd_crd_step,
                                                            loss_variant=variant),
                                          PoseEstimator, t_small), ("loss", "gt_loss"))
    del kv_state, kd_teacher, kbv

    # stage 1's variants: the student and the vanilla teacher of phase 24
    tv, sv = stage1_states(49)
    sbv = {k: torch.from_numpy(v).to(dev) for k, v in
           train_batch(np.random.default_rng(35), KD_BATCH, 224, POINT_NUM).items()}
    s1_small = train_batch(np.random.default_rng(36), 4, 32, 100)
    s1_small["valid"] = np.arange(4) < 3
    keep_small = [torch.rand((4, 200), generator=torch.Generator().manual_seed(i)) < 0.7
                  for i in (1, 2)]
    bank_small = torch.randn((6, 200), generator=torch.Generator().manual_seed(3))

    from pose3d_tpu_torch.losses import nce as nce_losses

    def pose_distances_on_cpu(run):
        """run(where) with the pose NCE's distances computed on the CPU for
        either device: the f32 geodesic error of a pair of equal labels
        reads 0 or 0.028 degrees by the device's rounding, and the pose NCE
        weights the positive itself among the negatives by it (1e-4 of the
        loss; tests/torch_pose_geodesic.py)."""
        def wrapped(where):
            own = nce_losses._pairwise_pose_distance_raw
            nce_losses._pairwise_pose_distance_raw = \
                lambda labels: own(labels.cpu()).to(labels.device)
            try:
                return run(where)
            finally:
                nce_losses._pairwise_pose_distance_raw = own
        return wrapped

    def small_stage1(**kw):
        def run(where):
            teacher = PoseEstimatorVanilla(img_feature_dim=64, shape_feature_dim=64)
            teacher.load_state_dict(v_small, strict=True)
            t_state = create_train_state(teacher.double().to(where), LR, [100], seed=1)
            s_state = small_student(where)
            batch = {k: torch.from_numpy(v).to(where) for k, v in s1_small.items()}
            step = steps.make_stage1_step(tau=0.5, **kw)
            if kw.get("use_memory_bank"):
                bank = init_memory_bank(16, 200, where)
                bank = enqueue(bank, bank_small.to(where))
                metrics, bank = step(t_state, s_state, batch,
                                     keep=[k.to(where) for k in keep_small], bank=bank)
            else:
                metrics = step(t_state, s_state, batch)
            return metrics, [t_state.model, s_state.model]
        return pose_distances_on_cpu(run)

    bank = init_memory_bank(4096, 200, dev)
    bank_step = steps.make_stage1_step(tau=0.5, use_memory_bank=True)

    def bank_run():
        nonlocal bank
        metrics, bank = bank_step(tv, sv, sbv, bank=bank)
        return metrics

    per_s1 = (0, 0, 0, 0, 2, 2, 2, 2)
    run_variant("stage 1 --use_memory_bank", bank_run, "loss", per_s1,
                small_stage1(use_memory_bank=True), ("loss", "teacher_loss"))
    # 2 counted steps, then cuda_ms's 3: 5 enqueues of 46 rows
    filled, ptr = int(bank.filled), int(bank.ptr)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp)
        ckpt.save("checkpoint", {"bank": bank._asdict()})
        back = MemoryBank(*(ckpt.restore("checkpoint")["bank"][k].to(dev)
                            for k in MemoryBank._fields))
    if (filled, ptr) != (5 * KD_BATCH,) * 2 or not all(
            torch.equal(a, b) for a, b in zip(bank, back)):
        raise RuntimeError(f"memory bank: filled {filled}, ptr {ptr} after 5 steps of "
                           f"{KD_BATCH}; restored equal "
                           f"{[torch.equal(a, b) for a, b in zip(bank, back)]}")
    phase("stage 1 --use_memory_bank", t0, f"the queue (4096, 200) after 5 steps: filled "
          f"{filled}, ptr {ptr}; saved in a checkpoint and restored equal")
    del bank, back
    for variant in ("pose", "multipose"):
        v_step = steps.make_stage1_step(tau=0.5, nce_variant=variant, nce_weighting="sqrt")
        run_variant(f"stage 1 --nce {variant}", lambda: v_step(tv, sv, sbv), "loss", per_s1,
                    small_stage1(nce_variant=variant, nce_weighting="sqrt"),
                    ("loss", "teacher_loss"))
    del tv, sv, sbv

    # the teacher step's pose variants at the recipe's width (phase 16)
    tp_state = create_train_state(
        PoseEstimator(img_feature_dim=1024, shape_feature_dim=TRAIN_SHAPE_DIM,
                      generator=torch.Generator().manual_seed(50)).to(dev),
        LR, [10**9], seed=50)
    tbv = {k: torch.from_numpy(v).to(dev) for k, v in
           train_batch(np.random.default_rng(39), TRAIN_BATCH, 224, POINT_NUM).items()}
    for variant in ("pose", "multipose"):
        tp_step = steps.make_teacher_train_step(nce_variant=variant, nce_weighting="sqrt")
        run_variant(f"teacher --nce {variant}", lambda: tp_step(tp_state, tbv), "loss",
                    (0, 0, 0, 0, 0, 0, 2, 2),
                    pose_distances_on_cpu(small_teacher_step(nce_variant=variant,
                                                             nce_weighting="sqrt")),
                    ("loss", "pose_loss", "nce_loss"))
    del tp_state, tbv

    # the RGB-only baseline (training --shape None) at batch 64
    def small_baseline(where):
        state = small_student(where)
        batch = {k: torch.from_numpy(v).to(where) for k, v in kd_small.items()
                 if k in ("im", "label", "valid")}
        batch["im"] = batch["im"].double()
        return steps.make_vanilla_train_step(False)(state, batch), [state.model]

    bl_state = create_train_state(kd_student(51), LR, [10**9], seed=51)
    blb = {k: torch.from_numpy(v).to(dev) for k, v in
           train_batch(np.random.default_rng(40), 64, 224, POINT_NUM).items() if k != "shape"}
    bl_step = steps.make_vanilla_train_step(False)
    run_variant("baseline", lambda: bl_step(bl_state, blb), "loss", (0, 0, 0, 0, 2, 2, 0, 0),
                small_baseline, ("loss",))
    del bl_state, blb

    # 32. two forward calls of the NCE at once on two streams, each with its
    # own ticket in its workspace (csrc/info_nce.cu), 20 pairs issued back
    # to back, every loss against the plain version
    pairs = [nce_inputs(np.random.default_rng(41), n, 200, dev)[:2] for n in (2500, 4096)]
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in side:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    with torch.no_grad():
        for _ in range(20):
            for st, (s_c, t_c) in zip(side, pairs):
                with torch.cuda.stream(st):
                    got.append(nce.fused_info_nce(s_c, t_c))
        for st in side:
            torch.cuda.current_stream().wait_stream(st)
        torch.cuda.synchronize()
        want = [nce.info_nce_plain(s_c, t_c) / s_c.shape[0] for s_c, t_c in pairs]
    two_stream_err = max(abs(float(g) - float(want[i % 2])) / abs(float(want[i % 2]))
                         for i, g in enumerate(got))
    if two_stream_err > NCE_LOSS_RTOL:
        raise RuntimeError(f"NCE forward on two streams at once: loss rel {two_stream_err:.3g}")
    phase("nce", t0, f"two streams at once, (2500, 200) and (4096, 200), 20 forward calls "
          f"each: every loss within {two_stream_err:.3g} of the plain version (tol "
          f"{NCE_LOSS_RTOL})")
    del pairs, got

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    # kernel 4 at the teacher step's shape, its launches on the teacher's
    # path; kernel 5 (the same core through the blocked entries, which the
    # router takes at N > 1024, on no recipe's path) at N 4096, its launches
    # on the teacher's and stage 1's paths
    nce_entries = []
    for tag, n_c, wheres, launched in (
            ("", TRAIN_BATCH, ("pose3d_tpu/ops/nce_fused.py:109",
                               "pose3d_tpu/ops/nce_fused.py:134"),
             tuple(a - b for a, b in zip(train_counts[2:4], train_blocked))),
            ("_blocked", 4096, ("pose3d_tpu/ops/nce_blocked.py:191",
                                "pose3d_tpu/ops/nce_blocked.py:224"),
             tuple(a + b for a, b in zip(train_blocked, s1_blocked)))):
        t = nce_times[n_c]
        for i, part in enumerate(("forward", "backward")):
            nce_entries.append(entry(
                f"info_nce{tag}_{part}", "pose3d_tpu_torch/csrc/info_nce.cu", wheres[i],
                launched[i], nce_err, sum(t[f"kernel {part}"]["ms"]) / 2,
                sum(t[f"plain {part}"]["ms"]) / 2, nce_bounds[n_c][i]))

    # the launches of this slice's paths (phases 28 and 31), added to each
    # kernel's main-path count
    added = [sum(c[i] for c in (s2_counts, *variant_counts.values())) for i in range(8)]
    print(f"[total] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [
        entry("geodesic_rotation_err", "pose3d_tpu_torch/csrc/geodesic.cu",
              "pose3d_tpu/ops/geodesic.py:65", student_geo + teacher_geo, geo_err,
              geo_times[1_000_000][0], geo_times[1_000_000][1], geo_bound),
        entry("pointnet_eval", "pose3d_tpu_torch/csrc/pointnet_eval.cu",
              "pose3d_tpu/ops/pointnet_fused.py:78", teacher_pn + added[1], pn_err,
              *pn_times[TEACHER_BATCH, 1024], pn_bounds[TEACHER_BATCH, 1024]),
        *nce_entries,
        entry("vgg_stem_forward", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", kd_counts[4] + added[4], stem_err,
              stem_times[3 * KD_BATCH]["kernel forward"],
              stem_times[3 * KD_BATCH]["plain forward"], stem_bounds[3 * KD_BATCH][0]),
        entry("vgg_stem_backward", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", kd_counts[5] + added[5], stem_err,
              stem_times[3 * KD_BATCH]["kernel backward"],
              stem_times[3 * KD_BATCH]["plain backward"], stem_bounds[3 * KD_BATCH][1]),
        entry("pointnet_train_forward", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:372", train_counts[6] + added[6], pt_err,
              pt_times[TRAIN_BATCH]["kernel forward"], pt_times[TRAIN_BATCH]["plain forward"],
              pt_bounds[TRAIN_BATCH][0]),
        entry("pointnet_train_backward", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:372", train_counts[7] + added[7], pt_err,
              pt_times[TRAIN_BATCH]["kernel backward"], pt_times[TRAIN_BATCH]["plain backward"],
              pt_bounds[TRAIN_BATCH][1])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
