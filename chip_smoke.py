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
    RGB-only baseline (training --shape None, batch 64);
  * int8 post-training-quantized serving: the student, the PointCloud and
    the MultiView teachers served with their convolutions in the int8
    kernel, `testing --int8`, `inference --int8` with a saved and a loaded
    quantized tree, and KD --crd / --stage 2 with --int8_teacher;
  * the MultiView teacher as the CLIs build it (ResNet-50, image feature
    1024; ResNet-18, feature 256 over 12 renders of 224x224, tour 2;
    DeformNet bottleneck 4096): serving and an evaluation with renders,
    its training with --fused_nce (batch 64; 160 in bf16), the training,
    testing and inference CLIs on generated files, KD --crd from it,
    --stage 1 with the MultiView vanilla teacher and --stage 2 from that
    stage's checkpoint; the testing CLI on LineMod and Pix3D and one
    ShapeNetCore epoch of the RGB-only baseline;
  * the on-device data path: the cloud and render banks, the device
    augmentation and view synthesis card vs CPU, a 2.17 GB render bank
    gathered on the card, and the CLIs at full width with --device_shapes,
    --device_augment and --device_views on generated files;
  * exported serving: the student and both teachers exported through
    `torch.export` in f32, bf16 and int8, saved, reloaded and served on the
    card (and the f32 student's and PointCloud teacher's files on the
    CPU), and `inference --export_aot` / `--load_aot` on generated files.
The student's stem (conv3x3 + ReLU + 2x2 pool) runs in the VGG stem
kernel in every student forward. Phases:

  1 device    2 build    3 geodesic kernel vs plain
  4 pointnet kernel vs plain (in f32 and f64; HMMA in the f32 encoder's
     SASS only)    5 VGG stem kernel vs plain (and HMMA in the f32 forward's
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
  bf16 (--bf16: bfloat16 compute, f32 parameters): 33 the bf16 stem
  kernels vs their plain bf16 version on phase 5's cases and the TMA
  route's edges (y within one bf16 ulp of max|ref|, the window index where
  the plain decision is clear and where the plain sums tie exactly between
  equal windows, dW and db given the kernel's index; both routes, TMA and
  registers; a tensor-core instruction in every bf16 instantiation's
  SASS), and their times by graph replay (with --source vgg_stem=, that
  source's in turns)    34 the bf16 eval PointNet kernel vs its plain
  version at (64 / 46 / 1, 2500, 1024) and (46, 2500, 256), a D that 8
  does not divide and a cloud one past a tile (and HGMMA, wgmma, in its
  encoder's SASS alone), times by graph replay with the launches a call
  and the share of the bound (with --source pointnet_eval=, each source's
  in turns)    35 the student in bf16: serving, an
  evaluation, card vs CPU at small width by an oracle rule (the card's
  error against f64, the largest and the RMS difference, at most twice
  the CPU's bf16 error plus 2^-10 of max|ref|), serving at batch 256 and 1
  beside f32, a profile    36 the teacher in bf16 likewise (batch 64; its
  serving batch's device time with each pointnet_eval source in turns)
  37 KD --crd in bf16 at batch 46 x 3: four small steps (phase 19's size
  and batch, and three more) card vs CPU by the oracle rule on each
  tensor's errors summed over them, 6 steps, the trainer's epoch and
  resume, the step beside f32, a profile, its device time (with --source
  vgg_stem= or pointnet_eval=, each source's in turns); --contrast and
  --vid 2 steps
  each    38 KD --stage 2 (its
  teacher read from phase 26's checkpoint under --bf16) and the RGB-only
  baseline (batch 64) in bf16, likewise    39 the train-mode PointNet's
  bf16 instance vs its plain bf16 version in 31 cases (N 1/7/160 x P
  100/2500 x D 64/256/1024, masked too, and clouds whose maxima tie):
  each layer against cuBLAS on its own input, the statistics within one
  bf16 ulp, the gradients by the oracle rule at each side's own ReLU and
  tie decisions against f64, the decisions that differ counted and
  bounded; HMMA.16816.F32.BF16 in its passes' SASS, its launches a call
  from a CUDA graph, its device times beside the f32 instance at (160 /
  46, 2500, 256)    40 the teacher's training (batch 160) and KD --stage 1
  (batch 46) in bf16: eight small steps card vs CPU (the ResNets' residual
  branches damped), 6 steps, the trainer's epoch and resume, the step
  beside f32, a profile
  MultiView and the datasets (`multiview_phases`): 41 the MultiView
  teacher from convert.pose_state_dict(..., "MultiView") loaded strictly,
  card vs CPU at batch 2, serving 64 requests and an evaluation of 2 x 64
  + 37 rows with renders (the geodesic kernel), view_tile=3 against the
  renders tiled, serving at batch 1 and 64 in f32 and bf16 in turns with
  peak memory and a profile    42 its step card vs CPU at small width
  (f64 model, f32 losses), 6 steps at batch 64 (--fused_nce), f32 and bf16
  in turns with peak memory, batch 160 in bf16 and in f32 (out of memory
  recorded, not failed), the NCE kernel's launches a call from a CUDA
  graph, a profile; the training CLI on generated files (12 PNG renders a
  sample) one epoch and --resume, its train samples/s, then the testing
  CLI and inference --render_dir on its checkpoint    43 KD --crd at 46 x
  3 views from the MultiView teacher (view_tile 3), 6 steps f32 and 2
  bf16, the step in turns; --stage 1 with the MultiView vanilla teacher 2
  steps, --stage 2 from its checkpoint.pth (the CLI's loader) 2 steps
  44 the testing CLI on generated LineMod and Pix3D files with the
  student, and one ShapeNetCore epoch of the RGB-only baseline validated
  on Pix3D
  int8 serving (`int8_phases`): 45 the int8 convolution kernel against its
  plain version bit for bit, f32 and bf16, on every distinct int8 conv of
  VGG-11 (its four pre-pool convs pooled in the kernel), ResNet-50 and
  ResNet-18 at 224x224 (recorded from the models' int8 forwards), the
  dense layers at batch 1 and 256, a narrower student's widths, channel
  counts no vector load takes and pooled odd sizes, on both routes; IGMMA
  in the wgmma route's SASS, IMMA in the mma.sync route's; its times
  summed over one forward's calls (graph replay), beside the plain
  version's, the bound, im2col + torch._int_mm's and (--source
  int8_conv=FILE) another build's in turns    46 the
  int8 student (2048, 224x224, its tree calibrated on the requests) at
  batch 1, 64 and 256    47 the int8 PointCloud teacher (ResNet-50,
  1024/1024, 2,500 points) at 64    48 the int8 MultiView teacher (768
  renders through the int8 ResNet-18) at 64; each f32 and bf16: the heads
  bit-equal to the same forward through the plain int8 product on the
  card, JAX's drift rule against the float model in the same dtype, the
  time beside the f32 and bf16 forwards in turns, the busy share and the
  peak memory    49 testing --int8 (the student) and inference --int8
  --save_quantized then --load_quantized (the student, and the MultiView
  teacher on a model's renders) on generated files    50 KD --crd from the
  PointCloud and MultiView teachers and --stage 2 from the vanilla teacher
  with --int8_teacher at 46 x 3, 3 steps each: the teacher's outputs on
  the step's views bit-equal to the plain int8 product's and within the
  drift rule of the float teacher's, the step beside the float teacher's
  the on-device data path (`device_data_phases`): 51 sample_from_bank
  card vs CPU (the same indices, clouds within 1e-6; counts above and
  below 2,500, rot 0 and +-15), gather_renders and synthesize_views
  bit-equal, device_augment with given draws within 1e-6 of max|ref|; a
  render bank of 100 x 144 renders of 224x224 u8 (2.17 GB, made on the
  card) gathered at 64 x 12, sample_from_bank at 160 x 2,500 of 10,000
  vertices, device_augment over 138 views, timed    52 the PointCloud
  teacher step with a ShapeBank at the full subset, the MultiView teacher
  step with a RenderBank, KD --crd with --device_views and given draws,
  --stage 1 with a ShapeBank, each card vs CPU (f64 models, f32 losses),
  and the two bank steps against the host-shape steps on the card
  53 on generated files at full width: training --shape MultiView
  --device_shapes --device_augment one epoch, --resume, and --bf16;
  trainingKD --crd --device_views --device_shapes from a PointCloud
  teacher's .pth one epoch, --resume, and --bf16; --stage 1
  --device_shapes; testing --device_shapes and on host shapes with both
  teachers; then the train loaders alone and the steps with their batch's
  copy from pinned memory, host path and options in turns, f32 and bf16,
  with the busy share, the bank's and the batch's bytes and peak memory
exported serving (`aot_phases`): 54 the student (2048, 224), the
  PointCloud teacher (1024/1024, 2,500 points) and the MultiView teacher
  (1024/256, 12 renders of 224) exported on the card (`torch.export`, the
  batch symbolic) in f32, bf16 and int8, saved, reloaded to the card and
  served (the student at 1, 64 and 256, the teachers at 1 and 64, from one
  file each): each artifact's launches exactly its hand kernels' (the
  stem, the eval PointNet and the int8 convolution as custom ops), its
  predictions against the eager model's, its time beside eager's in turns
  by CUDA events, the export seconds and the file's size; the f32
  student's and PointCloud teacher's files loaded to the CPU against the
  CPU eager model (the canary)    55 inference --export_aot then
  --load_aot (no --ckpt) for the three families on generated files: the
  same prediction
Each path (7-8, 10-11, 16-17, 20-21, 24-25, 28-29, each variant of 31,
35-38's, 40's, 41-44's, 46-50's, each CLI run of 53, each artifact of 54
and each family of 55) is driven with the kernels' launch counts set
to 0 just before it and read just after it; 16, 20, 24, 28 and 31's are
the training paths' main paths, 35-38's and 40's the bf16 ones. The total
seconds are printed before the card's line.

With --source NAME=FILE (repeatable), another version of csrc/NAME.cu
(info_nce, vgg_stem or pointnet_eval) with the same C interface (an
earlier commit's, from `git show`) is built beside this one, and its
kernels are timed in turns with this source's: info_nce's and the teacher
step through them in phase 18, the stage-1 step in phase 26; vgg_stem's
and the KD step through them in phase 22 (f32), its bf16 kernels in phase
33 and the bf16 KD step's device time in phase 37; pointnet_eval's and teacher
serving through them in phase 13 (also the CUDA-core version of commit
d190092 and before, with its own C interface and segment rule:
`legacy_pointnet_eval`), its bf16 kernel in phase 34 and bf16 teacher
serving's and the bf16 KD step's device time in phases 36 and 37 (the bf16
kernel of commits up to daad727 with the split it was built for,
`segments_for`'s).

Each phase prints a line; any failure raises and exits non-zero. Before the
last line come the card's name and power limit (nvidia-smi) and one JSON
line {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, the script fails
before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
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
# the MultiView teacher as the CLIs build it by default: 12 renders (tour
# 2) of feature 256 each; its step timed at batch 64 (and 160 where it
# fits), its evaluation over 2 x 64 + 37 rows
MV_VIEWS, MV_SHAPE_DIM, MV_TRAIN_BATCH, MV_EVAL_COUNTS = 12, 256, 64, [64, 64, 37]
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
# the bf16 kernels vs their plain bf16 versions: one bf16 ulp of max|ref|
# (bf16 keeps 8 significant bits); the dense bf16 rate of the tensor cores
# (published H100 SXM peak); card vs CPU in bf16, an oracle rule (as
# tests/test_torch_bf16.py's): the card's error against the f64 result,
# the largest and the RMS difference, at most twice the CPU's bf16 error
# plus this share of max|ref|
BF16_ULP, BF16_FLOPS, BF16_ORACLE_FLOOR = 2.0**-7, 989e12, 2.0**-10
# the bf16 small steps' batches (phase 19's first; the last unpadded),
# over which each tensor's card and CPU errors are summed
BF16_STEP_SEEDS = (21, 22, 23, 24)
# the bf16 teacher's and stage 1's small steps (phase 40): eight batches,
# the last unpadded; the NCE at tau 0.1 and 0.5 makes one step's losses
# noisier than the KD steps' (PERF.md: over the first four alone the
# teacher's nce_loss reads 1.368 of the bound, with the PointNet's kernel
# and with its plain version alike), and the losses each held
BF16_TRAIN_STEP_SEEDS = tuple(range(21, 29))
T16_LOSSES, S1_16_LOSSES = ("loss", "pose_loss", "nce_loss"), ("loss", "teacher_loss")
# the train-mode PointNet's bf16 instance vs its plain bf16 version: the
# share of (cloud, channel) tie sets, and of ReLU inputs, that may be
# decided otherwise than the plain version decides them (an a3 or a ReLU
# input rounded to the next bf16 value from f32 sums in another order),
# plus 2 a case
PT16_MOVED, PT16_FLIPS = 1e-2, 1e-3
# phase 39's cases beyond its grid (N, P, D, masked, tied): a 1-point tail
# tile of the D-wide passes' 128-point tiles; D 1024 through four 256-column
# groups with a 1-point tail; D 320, one full group and one of 64 columns;
# a masked stage-1 batch through the backward's fused dh2, its tail tile
# 104 points
PT16_EDGE_CASES = ((5, 129, 256, False, False), (46, 641, 1024, True, False),
                   (7, 300, 320, True, False), (46, 1000, 256, True, False))
# phase 33's cases beyond phase 5's (N, H = W, F, kind): the TMA route's
# edges, widths 232 and 40 (multiples of 8 whose last tile is partial), one
# 16 x 16 image (smaller than a patch), F 8 and 256 through the weight
# gradient's channel groups
STEM16_EDGE_CASES = [(7, 232, 64, "rand"), (7, 40, 16, "rand"), (1, 16, 64, "rand"),
                     (7, 64, 8, "rand"), (7, 232, 256, "rand")]
PT16_CASES = [(n_c, p_c, d_c, masked, False) for n_c in (1, 7, 160) for p_c in (100, 2500)
              for d_c in (64, 256, 1024) for masked in (False, True)
              if not (masked and n_c == 1)] + [
    (KD_BATCH, POINT_NUM, STAGE1_SHAPE_DIM, masked, False) for masked in (False, True)] + [
    (16, 2500, 256, True, True)] + list(PT16_EDGE_CASES)
# the bf16 instance's passes by their tensor-core route
PT16_WGMMA_PASSES = ("pnb_l3_kernel", "pnb_l3_back_kernel")
PT16_MMA_PASSES = ("pnb_l2_kernel", "pnb_dh2_kernel", "pnb_l2_back_kernel")
# int8 serving (phases 45-50): the student served at these batches, the
# teachers at 64, KD --int8_teacher steps a regime; JAX's drift rule
# (tests/test_quant_student.py:52-54, tests/test_quant_teacher.py:79-82):
# each head's cosine above, its max|d|/max|ref| below, and the argmax
# agreeing on at least 3/4 of the rows in the heads named; the dense int8
# rate of the tensor cores (published H100 SXM peak)
INT8_SERVE_BATCHES, INT8_TEACHER_BATCH, INT8_KD_STEPS, INT8_IMAGE = (1, 64, 256), 64, 3, 224
STUDENT_DRIFT, TEACHER_DRIFT = (0.995, 0.1, range(6)), (0.985, 0.25, range(3))
INT8_OPS = 1979e12
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# exported serving (phases 54-55): the batches one artifact serves; its
# predictions against the eager model's on the card, as a share of the
# largest |eager| (at least 1): expected bit-equal (the same kernels and
# ATen ops); a bin that differs moves a prediction by about 15 degrees,
# beyond each of these
AOT_STUDENT_BATCHES, AOT_TEACHER_BATCHES, AOT_IMAGE = (1, 64, 256), (1, 64), 224
AOT_TOL = {"f32": 1e-4, "bf16": 2.0**-6, "int8": 2.0**-6}
# the on-device data path (phases 51-53): the vertices of each generated
# cloud; the realistic render bank (models, renders, H, W, 3: 2.17 GB u8)
# and its gather (samples, views)
DD_CLOUD_VERTICES, DD_BANK_SHAPE, DD_GATHER = 10_000, (100, 144, 224, 224, 3), (64, 12)
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


def _shape_encoder(init: _Init, shape_feature_dim: int, view_num: int | None):
    """The shape encoder's (name, params, batch_stats, feature width): the
    PointNet (view_num None), or ShapeEncoderMV's ResNet-18 over view_num
    renders."""
    if view_num is None:
        return ("ShapeEncoderPC_0", *init.pointnet(shape_feature_dim), shape_feature_dim)
    params, stats = init.resnet((2, 2, 2, 2), False, shape_feature_dim)
    return ("ShapeEncoderMV_0", {"ResNet_0": params}, {"ResNet_0": stats},
            shape_feature_dim * view_num)


def teacher_variables(rng: np.random.Generator, img_feature_dim: int = 1024,
                      shape_feature_dim: int = 1024, view_num: int | None = None) -> dict:
    """Seeded numpy {"params", "batch_stats"} with the shapes of the JAX
    `pose3d_tpu.models.estimators.PoseEstimator(shape="PointCloud")` (with
    `view_num`, of `PoseEstimator(shape="MultiView", view_num=view_num)`),
    written out by hand like `student_variables` (tests/test_torch_teacher.py
    and tests/test_torch_multiview.py hold them against jax.eval_shape). The
    DeformNet's last layer has gain 0.25, so that most of the fused feature
    stays off tanh's flat ends."""
    init = _Init(rng)
    resnet, resnet_stats = init.resnet(RESNET50_STAGES, True, img_feature_dim)
    name, shape_params, shape_stats, shape_width = _shape_encoder(init, shape_feature_dim,
                                                                  view_num)
    b = shape_width + img_feature_dim
    deform, deform_stats = {}, {}
    init.dense_bn_relu(deform, deform_stats, 0, (b, b, b // 2, b // 4))
    deform["Dense_0"] = init.dense(b // 4, 200, gain=0.25)
    params = {"ResNet_0": resnet, name: shape_params, "DeformNet_0": deform,
              "_SixHeads_0": init.heads(200)}
    stats = {"ResNet_0": resnet_stats, name: shape_stats, "DeformNet_0": deform_stats}
    init.dense_bn_relu(params, stats, 0, (img_feature_dim, 800, 400))
    params["Dense_0"] = init.dense(400, 200, gain=1.0)
    return {"params": params, "batch_stats": stats}


def vanilla_variables(rng: np.random.Generator, img_feature_dim: int = 1024,
                      shape_feature_dim: int = 256, view_num: int | None = None) -> dict:
    """Seeded numpy {"params", "batch_stats"} with the shapes of the JAX
    `PoseEstimatorVanilla(shape="PointCloud")` (with `view_num`, of its
    MultiView instance): ResNet-18, the shape encoder, the compress MLP and
    the six heads (tests/test_torch_stage1.py and
    tests/test_torch_multiview.py hold them against jax.eval_shape)."""
    init = _Init(rng)
    resnet, resnet_stats = init.resnet((2, 2, 2, 2), False, img_feature_dim)
    name, shape_params, shape_stats, shape_width = _shape_encoder(init, shape_feature_dim,
                                                                  view_num)
    params = {"ResNet_0": resnet, name: shape_params}
    stats = {"ResNet_0": resnet_stats, name: shape_stats}
    init.dense_bn_relu(params, stats, 0, (shape_width + img_feature_dim, 800, 400, 200))
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


def eval_batches(seed: int, with_clouds: bool, views: int = 0, counts=EVAL_COUNTS):
    """The evaluation input: 8 x 64 + 37 rows (`counts`) over 3 categories,
    as the loader emits them (padded tail, 'valid' mask), with clouds for the
    PointCloud teacher, or with `views` renders in [0, 1] a row for the
    MultiView teacher."""
    rng = np.random.default_rng(seed)
    for count in counts:
        batch = {"im": rng.standard_normal((64, 224, 224, 3), dtype=np.float32),
                 "label": random_labels(rng, 64),
                 "cat_id": rng.integers(0, 3, 64).astype(np.int32),
                 "valid": np.arange(64) < count}
        if with_clouds:
            batch["shape"] = rng.uniform(0, 1, (64, POINT_NUM, 3)).astype(np.float32)
        if views:
            batch["shape"] = rng.random((64, views, 224, 224, 3), dtype=np.float32)
        yield batch


def check_eval(result, geometry, name: str, counts=EVAL_COUNTS) -> None:
    """Rows kept, finite errors, and per-category Acc / Med equal to the
    plain CPU recomputation from the same predictions."""
    n_eval = len(result.cat_ids)
    if n_eval != sum(counts) or not np.all(np.isfinite(result.errors)):
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


def write_fixtures(root: str, rng: np.random.Generator) -> dict:
    """Small datasets in the layouts the CLIs read, at the recipes' image
    sizes: <root>/train/ObjectNet3D (256x256 JPEGs of 2 test categories, 96
    train and 32 val rows; 12 of each model's 216 224x224 renders distinct),
    ShapeNetCore (48 240x240 RGBA renders, the SUN backgrounds beside it)
    and Pix3D (24 rows of the evaluation layout); <root>/test/LineMod (24
    rows) and Pix3D (the contrastive layout, 24 val rows). Returns the two
    data roots."""
    import csv

    from PIL import Image

    def image(path, size, mode="RGB"):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arr = (rng.random((size, size, len(mode))) * 255).astype(np.uint8)
        Image.fromarray(arr, mode).save(path)

    def table(path, rows):
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)

    def pose():
        return dict(azimuth=float(rng.integers(0, 360)), elevation=float(rng.integers(-80, 80)),
                    inplane_rotation=float(rng.integers(-170, 170)))

    def box(size):
        w, h = int(rng.integers(size // 2, size - 8)), int(rng.integers(size // 2, size - 8))
        left, upper = int(rng.integers(0, size - w)), int(rng.integers(0, size - h))
        return dict(left=left, upper=upper, right=left + w, lower=upper + h)

    train, test = os.path.join(root, "train"), os.path.join(root, "test")
    flags = dict(difficult=0, truncated=0, occluded=0, has_keypoints=1)
    rows = []
    for cat in ("bed", "bookshelf"):
        for split, n in (("train", 48), ("val", 16)):
            for i in range(n):
                name = f"Images/{cat}_{split}_{i}.jpg"
                image(os.path.join(train, "ObjectNet3D", name), 256)
                rows.append(dict(im_path=name, cat=cat, cad_index=1 + i % 2, set=split,
                                 **box(256), **pose(), **flags))
        for cad in (1, 2):
            crop = os.path.join(train, "ObjectNet3D", "Renders_semi_sphere", cat, f"{cad:02d}",
                                "crop")
            for k in range(12):
                image(os.path.join(crop, f"render_{k:03d}.png"), 224)
            for k in range(12, 216):
                with open(os.path.join(crop, f"render_{k % 12:03d}.png"), "rb") as f:
                    data = f.read()
                with open(os.path.join(crop, f"render_{k:03d}.png"), "wb") as f:
                    f.write(data)
    table(os.path.join(train, "ObjectNet3D", "ObjectNet3D.txt"), rows)
    rows = []
    for ex in range(2):
        for v in range(24):
            name = f"renders/{ex}_{v}.png"
            image(os.path.join(train, "ShapeNetCore", name), 240, "RGBA")
            rows.append(dict(cat_id=2818832, example_id=f"ex{ex}", image_path=name,
                             azimuth=float(rng.integers(0, 360)),
                             elevation=float(rng.integers(-80, 80))))
    table(os.path.join(train, "ShapeNetCore", "ShapeNetCore.txt"), rows)
    for i in range(4):
        image(os.path.join(train, "SUN", f"bg/{i}.jpg"), 240)
    table(os.path.join(train, "SUN", "SUN_database.txt"),
          [dict(idx=i, path=f"bg/{i}.jpg") for i in range(4)])
    rows = []
    for i in range(24):
        name = f"img/{i}.jpg"
        image(os.path.join(train, "Pix3D", name), 200)
        rows.append(dict(image_path=name, cat_id=("bed", "chair")[i % 2], example_id=f"e{i}",
                         model_name="model", truncated=False, occluded=False,
                         slightly_occluded=False, azimuth=float(rng.integers(0, 360)),
                         elevation=float(rng.integers(-80, 80)),
                         inplane_rotation=float(rng.uniform(-3, 3))))
    table(os.path.join(train, "Pix3D", "Pix3D.txt"), rows)
    rows = []
    for i in range(24):
        name = f"imgs/{i}.jpg"
        image(os.path.join(test, "LineMod", name), 256)
        b = box(256)
        rows.append(dict(obj_id=1 + i % 2, image_path=name, x=b["left"], y=b["upper"],
                         w=b["right"] - b["left"], h=b["lower"] - b["upper"], **pose()))
    table(os.path.join(test, "LineMod", "LineMod.txt"), rows)
    rows = []
    for i in range(24):
        name = f"imgs/{i}.jpg"
        image(os.path.join(test, "Pix3D", name), 256)
        rows.append(dict(im_path=name, cls_name=("bed", "chair")[i % 2], set="val", **box(256),
                         **pose(), **flags))
    table(os.path.join(test, "Pix3D", "Pix3D.txt"), rows)
    return {"train": train, "test": test}


def quiet(main, argv):
    """A CLI's main(argv), its printing held back (shown if it fails)."""
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            return main(argv)
    except BaseException:
        print(out.getvalue(), flush=True)
        raise


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


LIBRARIES = ("geodesic", "pointnet_eval", "info_nce", "vgg_stem", "pointnet_train", "int8_conv")
OTHER_SOURCES = ("info_nce", "vgg_stem", "pointnet_eval", "int8_conv", "pointnet_train")


def stem_bf16_vs_plain(vgg_stem, x, w, b, g, chunk: int = 23, ties: bool = False) -> dict:
    """The bf16 stem kernels against the plain bf16 version on the same
    inputs (x an NCHW view of NHWC bf16 memory, w and b bf16 needing a
    gradient, g bf16): y through the wrapper (autograd: one forward and one
    backward launch) and the window index through one more forward; y's
    max|d| over max|ref| and its unequal share; the index's unequal share
    and how many index bytes differ from the plain version's where that
    one's top two window sums are more than one bf16 ulp apart and its ReLU
    input more than two from 0; dW's and db's max|d| over max|ref| against
    the f32 sums (exact products, TF32 off) of g routed by the kernel's own
    index, and their largest absolute differences (dw_abs, db_abs). With
    `ties`, also how many index bytes differ from the plain version's first
    maximum (tie_bad) among those (tie_checked) where its rounded window sums
    tie exactly between windows equal on every weighed tap, the other
    positions more than an ulp below and its ReLU input more than two from
    0: such windows have one sum in any order of summation, so the first of
    them wins on both sides. Chunks of `chunk` images keep the
    full-resolution sums small."""
    F = torch.nn.functional
    y = vgg_stem.vgg_stem(x, w, b)
    dw, db = torch.autograd.grad(y, (w, b), g)
    w, b = w.detach(), b.detach()
    index = vgg_stem.stem_forward(x.permute(0, 2, 3, 1), w, b, True)[1]
    y_ref = vgg_stem.vgg_stem_plain(x, w, b)
    d = (y.detach().float() - y_ref.float()).abs()
    y_scale = float(y_ref.float().abs().max())
    out = {"y_err": float(d.max()) / y_scale if y_scale > 0 else float(d.max()),
           "y_unequal": float((y.detach() != y_ref).float().mean()), "index_unequal": 0.0,
           "index_bad": 0, "max_abs_err": float(d.max()), "tie_bad": 0, "tie_checked": 0}
    weighed = (w != 0).permute(0, 2, 3, 1).reshape(w.shape[0], 27).any(0)  # taps (ky, kx, c)
    n, f, hh, ww = x.shape[0], w.shape[0], x.shape[2], x.shape[3]
    ho, wo = hh // 2, ww // 2
    dw_ref = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    db_ref = torch.zeros(f, dtype=torch.float32, device=x.device)
    unequal = 0
    for i in range(0, n, chunk):
        xs = x[i:i + chunk].float()
        conv = F.conv2d(xs, w.float(), padding=1)
        m = conv.shape[0]
        win = (conv.to(torch.bfloat16).float()[:, :, :2 * ho, :2 * wo]
               .reshape(m, f, ho, 2, wo, 2).permute(0, 1, 2, 4, 3, 5).reshape(m, f, ho, wo, 4))
        top2 = win.topk(2, dim=-1).values
        first = win.argmax(-1)  # the first maximum
        pre = top2[..., 0] + b.float()[None, :, None, None]
        plain = torch.where(pre.to(torch.bfloat16).float() > 0, first, torch.full_like(first, 4))
        ulp = torch.exp2(torch.floor(torch.log2(top2[..., 0].abs().clamp_min(1e-30))) - 7)
        clear = (top2[..., 0] - top2[..., 1] > ulp) & (pre.abs() > 2 * ulp)
        k_idx = index[i:i + chunk].permute(0, 3, 1, 2).long()
        differ = k_idx != plain
        unequal += int(differ.sum())
        out["index_bad"] += int((differ & clear).sum())
        if ties:
            taps = F.unfold(xs, 3, padding=1).view(m, 3, 3, 3, hh, ww).permute(0, 2, 3, 1, 4, 5)
            taps = taps.reshape(m, 27, hh, ww)[:, weighed]
            pos = [taps[:, :, dy:2 * ho:2, dx:2 * wo:2] for dy in (0, 1) for dx in (0, 1)]
            # same[:, a, :, :, c]: windows a and c equal on every weighed tap
            same = torch.stack([torch.stack([(pos[a] == pos[c]).all(1) for c in range(4)], -1)
                                for a in range(4)], 1)                     # (m, 4, ho, wo, 4)
            same_first = same.unsqueeze(1).expand(m, f, 4, ho, wo, 4).gather(
                2, first[:, :, None, :, :, None].expand(m, f, 1, ho, wo, 4)).squeeze(2)
            at_max = win == top2[..., :1]
            below = torch.where(at_max, torch.full_like(win, -math.inf), win).amax(-1)
            tied = (at_max.sum(-1) >= 2) & (at_max <= same_first).all(-1) & \
                (top2[..., 0] - below > ulp) & (pre.abs() > 2 * ulp)
            out["tie_checked"] += int(tied.sum())
            out["tie_bad"] += int((differ & tied).sum())
            del taps, pos, same, same_first, at_max, below, tied
        gs = g[i:i + chunk].float() * (k_idx < 4)
        routed = torch.zeros((m, f, ho, wo, 4), device=x.device).scatter_(
            4, k_idx.clamp(max=3).unsqueeze(-1), gs.unsqueeze(-1))
        g_conv = torch.zeros_like(conv)
        g_conv[:, :, :2 * ho, :2 * wo] = (routed.reshape(m, f, ho, wo, 2, 2)
                                           .permute(0, 1, 2, 4, 3, 5).reshape(m, f, 2 * ho, 2 * wo))
        dw_ref += torch.nn.grad.conv2d_weight(xs, tuple(w.shape), g_conv, padding=1)
        db_ref += gs.sum((0, 2, 3))
        del conv, win, top2, first, pre, plain, ulp, clear, routed, g_conv, differ
    out["index_unequal"] = unequal / index.numel()
    for name, got, want in (("dw_err", dw, dw_ref), ("db_err", db, db_ref)):
        scale = float(want.abs().max())
        err = float((got.float() - want).abs().max())
        out[name] = err / scale if scale > 0 else err
        out[name.replace("err", "abs")] = err
    return out


def pointnet_bf16_params(rng: np.random.Generator, d: int, dev, b3: float | None = None):
    """The bf16 eval PointNet's unfolded layers (W (in, out) and b bf16, He-
    scaled; the eval BN (3, out) f32: mean, a multiplier of either sign, a
    shift), on `dev`; with `b3`, layer 3's multipliers positive and its shift
    b3 (every output negative at b3 -100)."""
    layers = []
    for fan_in, out in ((3, 64), (64, 128), (128, d)):
        w = rng.standard_normal((fan_in, out), dtype=np.float32) * math.sqrt(2.0 / fan_in)
        b = rng.standard_normal(out, dtype=np.float32) * 0.1
        bn = np.stack([rng.standard_normal(out) * 0.1, rng.uniform(-1.5, 1.5, out),
                       rng.standard_normal(out) * 0.1]).astype(np.float32)
        if b3 is not None and out == d:
            bn[1], bn[2] = np.abs(bn[1]), b3
        layers.append((torch.from_numpy(w).to(dev, torch.bfloat16),
                       torch.from_numpy(b).to(dev, torch.bfloat16), torch.from_numpy(bn).to(dev)))
    return layers


def set_compute_dtype(model: torch.nn.Module, dtype: torch.dtype | None) -> torch.nn.Module:
    """Switch a built model's compute dtype (None: its parameters'), so that
    one set of weights is timed in f32 and in bf16 in turns; the CLIs fix
    it when they build the model (`compute_dtype=`)."""
    for module in model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = dtype
    return model


def bf16_errors(card, cpu, ref) -> dict:
    """The card's and the CPU's bf16 errors against the f64 `ref`: the
    largest difference ("max") and the root-mean-square difference ("rms")."""
    card, cpu, ref = (t.detach().cpu().double() for t in (card, cpu, ref))
    return {"max": [float((t - ref).abs().max()) for t in (card, cpu)],
            "rms": [float((t - ref).pow(2).mean().sqrt()) for t in (card, cpu)]}


def bound_share(errs: dict, floor: float) -> float:
    """The largest share, over both statistics of `bf16_errors` (or of their
    sums over several steps), that the card's error takes of the oracle's
    bound: twice the CPU's error plus `floor` (BF16_ORACLE_FLOOR of
    max|ref|, or the sum of those)."""
    return max(card / (2 * cpu + floor) for card, cpu in errs.values())


def bf16_oracle(errs: dict, floor: float, what: str) -> float:
    """`bound_share`, raising where the card's error exceeds the bound."""
    share = bound_share(errs, floor)
    if share > 1:
        raise RuntimeError(f"bf16 card vs CPU, {what}: card and CPU errors against f64 "
                           f"{errs}, floor {floor:.3g}")
    return share


def bf16_card_vs_cpu(small_step, loss_keys, batches, hold: bool = True, witness=None,
                     first: int = len(BF16_STEP_SEEDS)) -> dict:
    """Small train steps in bf16 on the card and on the CPU, and in f64 on
    the CPU, one on each of `batches` (small_step(where, bf16, batch) ->
    (metrics, [trained models]), the models in bfloat16 compute, or in
    float64 with bf16 False): each loss of `loss_keys` and every parameter
    gradient held (with `hold`) to `bf16_oracle` with each tensor's errors
    and floors summed over the batches (a gradient zero in exact arithmetic
    takes the step's largest gradient as its scale). With `witness` (a
    context manager under which the card runs the step with a kernel
    replaced by its plain version, on the card) the card's step runs that
    way too, and the card's errors, summed so, are also held to twice the
    witness's plus the floor: what the kernel adds to the step's error.

    Returns {"share": the largest share of the bound over the sums,
    "batches": each batch's largest share alone, "keys": each loss's
    summed share, "first": each loss's share summed over the first `first`
    batches, "key_batches": each loss's share a batch alone} and with `witness` {"witness_first": the witness's shares
    against the CPU there, "vs_witness": the card's largest summed share
    against the witness, "equal": the (batch, tensor) pairs in which the
    card and the witness are bit-equal, and of how many}. Each batch's
    share alone is printed, not held, since one small bf16 step's error
    against f64 is too noisy a yardstick (PERF.md: the rule fails between
    two correct bf16 runs on some batches)."""
    pooled, head, w_head, vs_w, shares, equal = {}, {}, {}, {}, [], [0, 0]
    key_batches = {k: [] for k in loss_keys}

    def add(into, k, errs, floor):
        sums, floors = into.get(k, ({"max": [0.0, 0.0], "rms": [0.0, 0.0]}, 0.0))
        into[k] = ({stat: [a + b for a, b in zip(sums[stat], errs[stat])] for stat in sums},
                   floors + floor)

    for i, batch in enumerate(batches):
        ref, cpu = small_step("cpu", False, batch), small_step("cpu", True, batch)
        runs = [small_step("cuda", True, batch), cpu, ref]
        if witness is not None:
            with witness():
                runs.append(small_step("cuda", True, batch))
        torch.cuda.synchronize()
        tensors = {k: [torch.as_tensor(m[k]).detach().cpu().double().reshape(-1)
                       for m, _ in runs] for k in loss_keys}
        for j, models in enumerate(zip(*(r[1] for r in runs))):
            params = [dict(m.named_parameters()) for m in models]
            for k in params[2]:
                tensors[f"{j}.{k}"] = [p[k].grad.detach().cpu().double() for p in params]
        largest = max(float(ts[2].abs().max()) for k, ts in tensors.items()
                      if k not in loss_keys)
        share = 0.0
        for k, (g, c, r, *w) in tensors.items():
            scale = float(r.abs().max())
            if k not in loss_keys and scale < 1e-6 * largest:
                scale = largest
            errs, floor = bf16_errors(g, c, r), BF16_ORACLE_FLOOR * scale
            share = max(share, bound_share(errs, floor))
            if k in key_batches:
                key_batches[k].append(round(bound_share(errs, floor), 3))
            add(pooled, k, errs, floor)
            if i < first:
                add(head, k, errs, floor)
            if w:
                add(vs_w, k, bf16_errors(g, w[0], r), floor)
                equal = [equal[0] + int(torch.equal(g, w[0])), equal[1] + 1]
                if i < first:
                    add(w_head, k, bf16_errors(w[0], c, r), floor)
        shares.append(round(share, 3))
    if hold:
        for what, sums in (("card and CPU", pooled), ("card and its witness", vs_w)):
            failed = {k: (e, round(f, 6)) for k, (e, f) in sums.items() if bound_share(e, f) > 1}
            if failed:
                raise RuntimeError(f"bf16 card vs CPU: {what} errors against f64 over the "
                                   f"bound (twice the second's plus the floor) in {len(failed)} "
                                   f"of {len(sums)} tensors: {failed}")
    of = lambda sums, keys: {k: round(bound_share(*sums[k]), 3) for k in keys}
    out = {"share": max(bound_share(e, f) for e, f in pooled.values()), "batches": shares,
           "keys": of(pooled, loss_keys), "first": of(head, loss_keys),
           "key_batches": key_batches}
    if witness is not None:
        out |= {"witness_first": of(w_head, loss_keys), "equal": equal,
                "vs_witness": max(bound_share(e, f) for e, f in vs_w.values())}
    return out


@contextlib.contextmanager
def plain_train_pointnet():
    """While it lasts, the models' bf16 train-mode PointNet runs through its
    plain bf16 version (`pointnet_train_plain_bf16`), on the card too: the
    witness beside the kernel in phase 40's small steps."""
    from pose3d_tpu_torch.models import pointnet as model
    from pose3d_tpu_torch.ops import pointnet_train

    own = model.pointnet_train

    def plain(points, layers, mask=None):
        if points.dtype == torch.bfloat16:
            return pointnet_train.pointnet_train_plain_bf16(points, layers, mask)
        return own(points, layers, mask)

    model.pointnet_train = plain
    try:
        yield
    finally:
        model.pointnet_train = own


def parse_source(arg: str) -> tuple[str, str]:
    """--source NAME=PATH: another version of csrc/NAME.cu."""
    name, sep, path = arg.partition("=")
    if not sep or name not in OTHER_SOURCES or not os.path.isfile(path):
        raise argparse.ArgumentTypeError(
            f"--source takes info_nce=FILE, vgg_stem=FILE, pointnet_eval=FILE, "
            f"int8_conv=FILE or pointnet_train=FILE; got {arg}")
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
    this version's C interface through this wrapper (`using`; the bf16
    instance of commits up to daad727, without pointnet_eval_bf16_tile_points,
    with the grid it was built for, `segments_for`'s), one with
    commit d190092's through `legacy_pointnet_eval`, which is then also the
    encoder of the models (models.pointnet's pointnet_eval); `encoder` is
    the function that runs it. The swap is undone at once."""
    import ctypes

    from pose3d_tpu_torch.models import pointnet as model
    from pose3d_tpu_torch.ops import pointnet

    if path is not None and hasattr(ctypes.CDLL(path), "pointnet_eval_scratch_floats") and \
            not hasattr(ctypes.CDLL(path), "pointnet_eval_bf16_tile_points"):
        # a source up to daad727: its bf16 grid is (segments, groups) by the f32 split
        own_split = pointnet.bf16_split
        pointnet.bf16_split = pointnet.segments_for
        try:
            return using(pointnet, path, lambda: run(pointnet.pointnet_eval))
        finally:
            pointnet.bf16_split = own_split
    if path is None or hasattr(ctypes.CDLL(path), "pointnet_eval_scratch_floats"):
        return using(pointnet, path, lambda: run(pointnet.pointnet_eval))
    legacy = legacy_pointnet_eval(path)
    model.pointnet_eval = legacy
    try:
        return run(legacy)
    finally:
        model.pointnet_eval = pointnet.pointnet_eval


def sass_hmma(lib: str, prefix: str, needle: str = "HMMA", bools: bool = False) -> dict:
    """{kernel: whether its SASS holds `needle` (an HMMA, tensor-core,
    instruction; "HMMA.16816.F32.BF16" the bf16 m16n8k16 one)} for the
    kernels of a built library whose names start with `prefix`, by
    cuobjdump beside nvcc; a template's instantiations apart (<4>, <double>,
    <bf16>; the float one bare; with `bools`, <1,0> for bool arguments, else
    those merged, any instantiation holding it)."""
    from pose3d_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        mangled = part.split(None, 1)[0]
        m = re.search(r"\d+(%s\w*?_kernel)(I(?:Li(\d+)E|d|f|13__nv_bfloat16|((?:Lb[01]E)+)))?"
                      % prefix, mangled)
        if m is None:
            continue
        key = m.group(1) + ("" if m.group(2) in (None, "If") else
                            "<double>" if m.group(2) == "Id" else
                            "<bf16>" if m.group(2) == "I13__nv_bfloat16" else
                            ("<%s>" % ",".join(re.findall(r"Lb([01])E", m.group(4)))
                             if bools else "") if m.group(4) else f"<{m.group(3)}>")
        found[key] = found.get(key, False) or needle in part
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


def damp_residuals(variables: dict, factor: float = 0.2) -> dict:
    """`variables` (a teacher's or vanilla teacher's, flax layout) with the
    ResNets' residual branches damped (the image encoder's, and a MultiView
    encoder's): each block's last BatchNorm scale
    times `factor`, in place. At the seeded init (every scale 1) the
    train-mode ResNet in bf16 is chaotic at the small sizes of the card-vs-
    CPU steps: any bf16 implementation's features lie about as far from
    float64's as they are large, so that no two can be held to each other;
    damped residual branches, as in the common zero-gamma init, keep the
    steps' bf16 errors a small share of their values
    (tests/test_torch_bf16_train.py holds JAX's and the port's steps so)."""
    params = variables["params"]
    resnets = [params["ResNet_0"]] + [params[k]["ResNet_0"] for k in ("ShapeEncoderMV_0",)
                                      if k in params]
    for resnet in resnets:
        for name, block in resnet.items():
            last = {"Bottleneck": "ConvBN_2", "BasicBlock": "ConvBN_1"}.get(name.split("_")[0])
            if last is not None:
                bn = block[last]["BatchNorm_0"]
                bn["scale"] = (np.asarray(bn["scale"]) * factor).astype(np.float32)
    return variables


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits): 2^(floor(log2 |x|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp_min(2.0**-126))) - 7)


def dense_share(got: torch.Tensor, ref: torch.Tensor, bias: torch.Tensor) -> float:
    """The largest |got - ref| of a bf16 Dense's output (bf16(bf16(x W) +
    b)) over one bf16 ulp of the larger of |ref| and |ref - b| there: the
    most that f32 sums in another order can move it (x W rounded to the next
    bf16 value, then + b rounded)."""
    ref = ref.float()
    scale = bf16_ulp(torch.maximum(ref.abs(), (ref - bias.float()).abs()))
    return float(((got.float() - ref).abs() / scale).max())


def pt_bf16_forward_from(pt, layers, stats, a1, a2):
    """A bf16 forward's layers recomputed from its own a1, a2 and float32
    statistics by cuBLAS at flax's rounding points: (y1, y2, the ReLUs'
    inputs; a3; y3)."""
    (w1, b1, g1, be1), (w2, b2, g2, be2), (w3, b3, g3, be3) = layers
    (mu1, v1), (mu2, v2), (mu3, v3) = stats
    y1 = pt._bn_relu_bf16(a1, mu1, v1, g1, be1, False)
    y2 = pt._bn_relu_bf16(a2, mu2, v2, g2, be2, False)
    a3 = pt._dense_bf16(torch.relu(y2), w3, b3)
    return y1, y2, a3, pt._bn_relu_bf16(a3, mu3, v3, g3, be3, False)


def pt_bf16_decisions(pt, layers, stats, out, a1, a2):
    """The ReLU decisions (h1 > 0, h2 > 0) and the tie sets ((N, P, D) bool:
    the points whose y3 equals the cloud's maximum) of a bf16 forward, from
    its layer-1 and layer-2 outputs before BatchNorm (a1, a2), its float32
    statistics and its output (`pt_bf16_forward_from`)."""
    y1, y2, _, y3 = pt_bf16_forward_from(pt, layers, stats, a1, a2)
    ties = y3 == out[:, None, :]
    # where no y3 read off cuBLAS's a3 reaches the output (its a3 rounded to
    # the next bf16 value at the maximum: `count_moved`), that y3's own max
    lost = ~ties.any(1, keepdim=True)
    return (y1 > 0, y2 > 0), ties | (lost & (y3 == y3.amax(1, keepdim=True)))


def pt_bf16_layer_shares(pt, pts, layers, stats, out, a1, a2) -> tuple[float, float, float]:
    """A bf16 forward's layers, each against cuBLAS on that forward's own
    input to the layer and its own statistics: a1 and a2 by `dense_share`,
    and out against the max over the points of y3 recomputed from its a2,
    over |mul3| ulp(a3) + ulp(out) a channel (an a3 rounded to the next bf16
    value moves y3 by |mul3| ulp(a3), several ulps of y3 where |a3| is the
    larger; the ulps at the channel's largest |a3| or |a3 - b3|, and |out|)."""
    (w1, b1, g1, be1), (w2, b2, _, _), (_, b3, g3, _) = layers
    share1 = dense_share(a1, pt._dense_bf16(pts, w1, b1), b1)
    share2 = dense_share(a2, pt._dense_bf16(pt._bn_relu_bf16(a1, *stats[0], g1, be1, True),
                                            w2, b2), b2)
    _, _, a3, y3 = pt_bf16_forward_from(pt, layers, stats, a1, a2)
    a3 = a3.float()
    largest = torch.maximum(a3.abs().amax((0, 1)), (a3 - b3.float()).abs().amax((0, 1)))
    ref = y3.amax(1).float()
    bound = ((g3 / torch.sqrt(stats[2][1] + 1e-5)).abs() * bf16_ulp(largest)
             + bf16_ulp(ref.abs().amax(0)))
    return share1, share2, float(((out.float() - ref).abs() / bound[None, :]).max())


def pt_bf16_reference(pts, layers, valid, masks, ties, g):
    """The 12 parameter gradients of sum(out * g) in float64 (no rounding),
    with the ReLUs' decisions `masks` and the max's tie sets `ties`: out =
    the mean of y3 over each cloud's tied points (the even split)."""
    from pose3d_tpu_torch.models.common import BN_EPS, batch_stats

    tracked = [[t.double().requires_grad_() for t in layer] for layer in layers]
    x = pts.double()
    for i, (w, b, gamma, beta) in enumerate(tracked):
        a = x @ w.t() + b
        mean, var = batch_stats(a, (0, 1), valid)
        y = (a - mean) * (torch.rsqrt(var + BN_EPS) * gamma) + beta
        x = y * masks[i] if i < 2 else y
    weights = ties.double() / ties.sum(1, keepdim=True)
    out = (x * weights).sum(1)
    return torch.autograd.grad(out, [t for layer in tracked for t in layer], g.double())


def pt_bf16_vs_plain(pt, pts, layers, valid, g) -> dict:
    """The train-mode PointNet kernel's bf16 instance (forward and backward,
    twice, and once under autograd) against the plain bf16 version on the
    same inputs. out and the six statistics: max|d| over max|ref| (the
    statistics held to one bf16 ulp; out, where an a2 or a3 rounded to the
    next bf16 value moves y3 through the BatchNorms' multipliers, by its
    layers: `pt_bf16_layer_shares`, a1_share, a2_share and out_share, each
    held at 1); out_unequal: the share of outputs that differ. The
    gradients at each side's own decisions: each side's ReLU decisions and
    tie sets (`pt_bf16_decisions`; the kernel's from its own a1, a2 and
    statistics, the plain version's from its forward), a float64
    reference at them (`pt_bf16_reference`), and `grad_share`: the largest,
    over the 12 gradients and both the largest and the RMS difference, of
    the kernel's error against its reference over twice the plain
    version's against its own plus 2^-10 of max|ref| (the dense biases'
    gradients, zero in exact arithmetic, of the largest weight gradient):
    the oracle rule, held at 1. relu_flips: ReLU decisions that differ
    between the two; ties_moved: (cloud, channel) entries whose number of
    tied points differs between them; count_moved: entries where the
    kernel's own tie count differs from the count `pt_bf16_decisions`
    reads off its a2 (cuBLAS's products rounding an a3 otherwise); tie_share:
    the entries whose maximum more than one point reaches, in the kernel's
    forward; bf16_grads: the weights' and biases' gradients bf16 values;
    same: the same bits on a second run and under autograd; launches:
    (forward, backward) calls of the autograd use."""
    d = layers[2][0].shape[0]
    prm = pt.pack_params(layers)
    runs = []
    for _ in range(2):
        fwd = pt.train_forward_bf16(pts, prm, d, valid)
        out, stats, count, tsum, a1, a2 = fwd
        runs.append(fwd[:4] + (pt.train_backward_bf16(pts, prm, d, valid, stats, out, count,
                                                      tsum, a1, a2, g),))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    out, stats, count, _, grads = runs[0]
    del runs
    grads = pt.unpack_grads(grads, d)
    tracked = [[t.clone().requires_grad_() for t in layer] for layer in layers]
    flat = lambda ls: [t for layer in ls for t in layer]
    before = (pt.train_forward_bf16.launches, pt.train_backward_bf16.launches)
    out_a, _ = pt.pointnet_train(pts, tracked, valid)
    grads_a = torch.autograd.grad(out_a, flat(tracked), g)
    launches = (pt.train_forward_bf16.launches - before[0],
                pt.train_backward_bf16.launches - before[1])
    same = same and torch.equal(out_a, out) and all(torch.equal(a, b)
                                                    for a, b in zip(grads_a, grads))
    del out_a, grads_a
    own = [[t.clone().requires_grad_() for t in layer] for layer in layers]
    out_p, stats_p = pt.pointnet_train_plain_bf16(pts, own, valid)
    grads_p = torch.autograd.grad(out_p, flat(own), g)
    out_p = out_p.detach()
    stats_k = pt.split_stats(stats, d)
    with torch.no_grad():
        masks_k, ties_k = pt_bf16_decisions(pt, layers, stats_k, out, a1, a2)
        layer_shares = pt_bf16_layer_shares(pt, pts, layers, stats_k, out, a1, a2)
        _, stats_pp, (a1_p, a2_p, _) = pt.plain_bf16_parts(pts, layers, valid)
        masks_p, ties_p = pt_bf16_decisions(pt, layers, stats_pp, out_p, a1_p, a2_p)
    del a1, a2, a1_p, a2_p
    relu_flips = sum(int((a != b).sum()) for a, b in zip(masks_k, masks_p))
    ties_moved = int((ties_k.sum(1) != ties_p.sum(1)).sum())
    count_moved = int((ties_k.sum(1) != count).sum())
    ref_k = pt_bf16_reference(pts, layers, valid, masks_k, ties_k, g)
    del masks_k, ties_k
    ref_p = pt_bf16_reference(pts, layers, valid, masks_p, ties_p, g)
    del masks_p, ties_p
    scale = lambda r: max(float(r.abs().max()), 1e-30)
    largest = max(scale(ref_p[4 * i]) for i in range(3))
    share = 0.0
    for i, (k, rk, p, rp) in enumerate(zip(grads, ref_k, grads_p, ref_p)):
        floor = BF16_ORACLE_FLOOR * (largest if i % 4 == 1 else scale(rp))
        dk, dp = k.double() - rk, p.double() - rp
        for stat in (lambda t: float(t.abs().max()), lambda t: float(t.pow(2).mean().sqrt())):
            ratio = stat(dk) / (2 * stat(dp) + floor)
            share = max(share, ratio if math.isfinite(ratio) else math.inf)
    diff = lambda a, r: float((a.float() - r.float()).abs().max()) / scale(r.float())
    return {
        "out": diff(out, out_p), "out_unequal": float((out != out_p).float().mean()),
        "a1_share": layer_shares[0], "a2_share": layer_shares[1], "out_share": layer_shares[2],
        "stats": max(diff(a, r.detach()) for pair, pair_r in zip(stats_k, stats_p)
                     for a, r in zip(pair, pair_r)),
        "grad_share": share, "relu_flips": relu_flips, "ties_moved": ties_moved,
        "count_moved": count_moved, "tie_share": float((count > 1).float().mean()),
        "bf16_grads": all(torch.equal(t, t.to(torch.bfloat16).float())
                          for i, t in enumerate(grads) if i % 4 < 2),
        "max_abs_err": float((out.float() - out_p.float()).abs().max()),
        "grad_abs": max(float((k - p).abs().max()) for k, p in zip(grads, grads_p)),
        "same": same, "launches": launches}


def pt16_graph_ms(pt, p16, prm, d, g16, stream) -> tuple[float, float]:
    """The bf16 train-mode PointNet's forward and backward device time a
    call (ms, `graph_ms`) through the wrapper's library."""
    saved = pt.train_forward_bf16(p16, prm, d, None)
    return (graph_ms(lambda: pt.train_forward_bf16(p16, prm, d, None), stream),
            graph_ms(lambda: pt.train_backward_bf16(p16, prm, d, None, saved[1], saved[0],
                                                    *saved[2:], g16), stream))


def pt16_pass_split(pt, p16, prm, d, g16, calls: int = 10) -> dict:
    """Each pass of the bf16 train-mode PointNet's forward and backward:
    {"forward": {kernel: ms a call}, "backward": ...} by the profiler over
    `calls` calls through the wrapper's library, a template's instances
    apart, the largest first."""
    saved = pt.train_forward_bf16(p16, prm, d, None)
    split = {}
    for part, run in (("forward", lambda: pt.train_forward_bf16(p16, prm, d, None)),
                      ("backward", lambda: pt.train_backward_bf16(
                          p16, prm, d, None, saved[1], saved[0], *saved[2:], g16))):
        run()
        rows, _, _ = profile_steps(run, steps=calls)
        ms = {}
        for e in rows:
            m = re.search(r"(pn[bt]_\w+?_kernel(<\w+>)?)", e.key)
            if m:
                ms[m.group(1)] = ms.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / calls
        split[part] = {k: round(v, 4) for k, v in sorted(ms.items(), key=lambda kv: -kv[1])}
    return split


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


def pt16_phase(dev, card: str, t0: float, lib: str, pt_others: dict, side) -> tuple:
    """Phase 39: the train-mode PointNet's bf16 instance (`lib`, this
    source's build) against its plain version, its SASS, launches and times;
    `pt_others` {source: library} other builds timed in turns. Returns
    (the worst errors, the times, the bounds) by batch."""
    from pose3d_tpu_torch.ops import pointnet_train

    bf16 = torch.bfloat16
    # 39. the train-mode PointNet kernel's bf16 instance (kernel 3 in its
    # TPU dtype) vs the plain bf16 version, `pt_bf16_vs_plain`: N 1 / 7 /
    # 160 x P 100 / 2500 x D 64 / 256 / 1024, unmasked and (N 7, 160) with
    # a quarter of the clouds padded, stage 1's (46, 2500, 256) unmasked and
    # padded, clouds on a 2^-8 grid whose maxima tie, and PT16_EDGE_CASES;
    # out and statistics within one bf16 ulp of max|ref|, the gradients by
    # the oracle rule at each side's own decisions, the differing
    # decisions counted and bounded; HGMMA (wgmma) in the D-wide passes'
    # SASS, HMMA.16816.F32.BF16 (mma.sync) in the narrow product passes';
    # launches a call from a CUDA graph's kernel nodes; device times by
    # graph replay at the two paths' shapes beside the f32 instance and
    # beside each --source pointnet_train= build in turns, and each pass's
    # device time by the profiler
    pnb_hgmma = sass_hmma(lib, "pnb_", needle="HGMMA")
    pnb_hmma = sass_hmma(lib, "pnb_", needle="HMMA.16816.F32.BF16")
    if {k for k, v in pnb_hgmma.items() if v} != set(PT16_WGMMA_PASSES) or \
            {k for k, v in pnb_hmma.items() if v} != set(PT16_MMA_PASSES):
        raise RuntimeError(f"pointnet_train bf16 SASS: HGMMA in {pnb_hgmma}, "
                           f"HMMA.16816.F32.BF16 in {pnb_hmma}")
    pt16_launch = pointnet_train.kernel_launches_per_call(bf16)
    trng = np.random.default_rng(39)
    pt16_cases = PT16_CASES
    pt16_worst, pt16_total = {}, {"relu_flips": 0, "ties_moved": 0, "count_moved": 0}
    outputs, grid_ties = 0, None
    for n_c, p_c, d_c, masked, grid in pt16_cases:
        pts_c, layers_c, valid_c, g_c = pt_inputs(trng, n_c, p_c, d_c, dev, masked=masked)
        if grid:  # clouds on a 2^-8 grid, 3 steps each way around one point
            base = torch.from_numpy(trng.uniform(0.5, 1.0, (n_c, 1, 3))).float()
            steps_c = torch.from_numpy(trng.integers(-3, 4, (n_c, p_c, 3))).float()
            pts_c = (base + steps_c * 2.0**-8).to(dev)
        r = pt_bf16_vs_plain(pointnet_train, pts_c.to(bf16), layers_c, valid_c, g_c.to(bf16))
        torch.cuda.synchronize()
        case = (n_c, p_c, d_c, masked, grid)
        if max(r["a1_share"], r["a2_share"], r["out_share"]) > 1 or r["stats"] > BF16_ULP or \
                r["grad_share"] > 1 or \
                not r["bf16_grads"] or not r["same"] or r["launches"] != (1, 1) or \
                r["count_moved"] > PT16_MOVED * n_c * d_c + 2 or \
                r["ties_moved"] > PT16_MOVED * n_c * d_c + 2 or \
                r["relu_flips"] > PT16_FLIPS * n_c * p_c * 192 + 2 or \
                (grid and r["tie_share"] < 0.1):
            raise RuntimeError(f"bf16 train-mode pointnet case {case}: {r}")
        pt16_worst = {k: max(pt16_worst.get(k, 0), v) for k, v in r.items()
                      if isinstance(v, float)}
        pt16_total = {k: pt16_total[k] + r[k] for k in pt16_total}
        grid_ties = r["tie_share"] if grid else grid_ties
        outputs += n_c * d_c
        del pts_c, layers_c, valid_c, g_c
    phase("pointnet_train bf16", t0, f"kernels vs the plain bf16 version in {len(pt16_cases)} "
          f"cases (N 1/7/160 x P 100/2500 x D 64/256/1024, masked too; stage 1's "
          f"({KD_BATCH}, {POINT_NUM}, {STAGE1_SHAPE_DIM}) unmasked and masked; "
          f"{PT16_EDGE_CASES}; tied clouds on a grid, "
          f"tie share {grid_ties:.3f}): out max|d|/max|ref| {pt16_worst['out']:.3g} (one ulp "
          f"{BF16_ULP:.3g}), unequal share at most {pt16_worst['out_unequal']:.3g}; each layer on "
          f"its own input against cuBLAS: a1 and a2 within {pt16_worst['a1_share']:.3g} and "
          f"{pt16_worst['a2_share']:.3g} ulp, out within {pt16_worst['out_share']:.3g} of |mul3| "
          f"ulp(a3) + ulp(out) a channel (held at 1); statistics "
          f"{pt16_worst['stats']:.3g}; gradients at each side's own decisions at most "
          f"{pt16_worst['grad_share']:.3g} of the oracle's bound (twice the plain version's "
          f"error against f64 plus 2^-10 max|ref|); decisions that differ, in all: "
          f"{pt16_total['relu_flips']} ReLU (tol {PT16_FLIPS:.0e} of the ReLU inputs + 2 a "
          f"case), {pt16_total['ties_moved']} of {outputs} tie sets (tol {PT16_MOVED:.0e} of "
          f"the outputs + 2), {pt16_total['count_moved']} tie counts the kernel's a2 reads "
          f"otherwise through cuBLAS; the weights' and biases' gradients bf16 values; one "
          f"forward and one backward call a use, the same bits on a second run; launches a "
          f"call {pt16_launch} at D 256, "
          f"{pointnet_train.kernel_launches_per_call(bf16, 1024)} at D 1024 (library); "
          f"cuobjdump -sass: HGMMA in {pnb_hgmma}, HMMA.16816.F32.BF16 in {pnb_hmma}")
    pt16_times, pt16_bounds, pt16_sources = {}, {}, {}
    for n_c in (TRAIN_BATCH, KD_BATCH):
        d_c = TRAIN_SHAPE_DIM
        pts_c, layers_c, _, g_c = pt_inputs(np.random.default_rng(29), n_c, POINT_NUM, d_c, dev)
        prm = pointnet_train.pack_params(layers_c)
        p16, g16 = pts_c.to(bf16), g_c.to(bf16)
        saved16 = pointnet_train.train_forward_bf16(p16, prm, d_c, None)
        saved32 = pointnet_train.train_forward(pts_c, prm, d_c, None)
        tie_share = float((saved16[2] > 1).float().mean())
        fns = {"bf16 forward": lambda: pointnet_train.train_forward_bf16(p16, prm, d_c, None),
               "bf16 backward": lambda: pointnet_train.train_backward_bf16(
                   p16, prm, d_c, None, saved16[1], saved16[0], *saved16[2:], g16),
               "f32 forward": lambda: pointnet_train.train_forward(pts_c, prm, d_c, None),
               "f32 backward": lambda: pointnet_train.train_backward(
                   pts_c, prm, d_c, None, *saved32[1:], g_c)}
        if n_c == TRAIN_BATCH:
            graphs16 = (graph_kernel_launches(fns["bf16 forward"]),
                        graph_kernel_launches(fns["bf16 backward"]))
            if graphs16 != pt16_launch:
                raise RuntimeError(f"bf16 train-mode pointnet: a CUDA graph of one call holds "
                                   f"{graphs16} kernels, the library says {pt16_launch}")
        runs = {k: [] for k in fns}
        for order in (("f32", "bf16"), ("bf16", "f32")):
            for who in order:
                for part in ("forward", "backward"):
                    runs[f"{who} {part}"].append(round(graph_ms(fns[f"{who} {part}"], side), 4))
        # this source and each --source pointnet_train= build in turns (this,
        # other, other, this), and each one's passes by the profiler
        pt16_sources[n_c] = {}
        for label, path in [("this source", None)] + list(pt_others.items()):
            pt16_sources[n_c][label] = {"forward": [], "backward": [], "passes": using(
                pointnet_train, path, lambda: pt16_pass_split(pointnet_train, p16, prm, d_c, g16))}
        for label, path in [(k, v) for other in pt_others.items()
                            for k, v in (("this source", None), other, other,
                                         ("this source", None))]:
            f_ms, b_ms = using(pointnet_train, path,
                               lambda: pt16_graph_ms(pointnet_train, p16, prm, d_c, g16, side))
            pt16_sources[n_c][label]["forward"].append(round(f_ms, 4))
            pt16_sources[n_c][label]["backward"].append(round(b_ms, 4))
        tracked = [[t.clone().requires_grad_() for t in layer] for layer in layers_c]
        flat = [t for layer in tracked for t in layer]
        out_p = pointnet_train.pointnet_train_plain_bf16(p16, tracked)[0]

        def plain16_fwd():
            with torch.no_grad():
                pointnet_train.pointnet_train_plain_bf16(p16, tracked)

        plain = {"forward": cuda_ms(plain16_fwd, 5),
                 "backward": cuda_ms(lambda: torch.autograd.grad(out_p, flat, g16,
                                                                 retain_graph=True), 5)}
        pt16_times[n_c] = {k: sum(v) / len(v) for k, v in runs.items()} | {
            f"plain {k}": v for k, v in plain.items()}
        # the bound: the points (bf16), the parameters and the outputs
        # (features bf16, statistics) and, backward, the upstream gradient
        # (bf16) and the parameters' gradients, each moved once; the useful
        # products on the bf16 tensor cores: forward the three layers,
        # backward dW and the input's gradient of layers 2 and 3 and dW1
        rows_c, n_stats = n_c * POINT_NUM, 2 * (64 + 128 + d_c)
        flops_f = 2.0 * rows_c * (3 * 64 + 64 * 128 + 128 * d_c)
        flops_b = 2.0 * rows_c * (3 * 64 + 2 * 64 * 128 + 2 * 128 * d_c)
        bytes_f = 2.0 * 3 * rows_c + 4.0 * prm.numel() + 2.0 * n_c * d_c + 4.0 * n_stats
        bytes_b = 2.0 * 3 * rows_c + 8.0 * prm.numel() + 2.0 * n_c * d_c + 4.0 * n_stats
        pt16_bounds[n_c] = (bound(bytes_f, flops_f, BF16_FLOPS),
                            bound(bytes_b, flops_b, BF16_FLOPS))
        t = pt16_times[n_c]
        phase("time", t0, f"train-mode pointnet ({n_c}, {POINT_NUM}, {d_c}), device time a "
              f"call by graph replay in turns (f32, bf16, bf16, f32): bf16 forward "
              f"{runs['bf16 forward']} + backward {runs['bf16 backward']} ms, f32 forward "
              f"{runs['f32 forward']} + backward {runs['f32 backward']} ms; the plain bf16 "
              f"version by CUDA events {plain['forward']:.4f} + {plain['backward']:.4f} ms; "
              f"bound forward {pt16_bounds[n_c][0][0]:.4f} ms ({pt16_bounds[n_c][0][1]}, bf16 "
              f"tensor cores), backward {pt16_bounds[n_c][1][0]:.4f} ms "
              f"({pt16_bounds[n_c][1][1]}); bf16 at {pt16_bounds[n_c][0][0] / t['bf16 forward']:.1%} "
              f"and {pt16_bounds[n_c][1][0] / t['bf16 backward']:.1%} of its bound; tied maxima "
              f"{tie_share:.4f} of the (cloud, channel) entries [{card}]")
        for label, v in pt16_sources[n_c].items():
            turns = (f"forward {v['forward']} + backward {v['backward']} ms by graph replay in "
                     f"turns (this source, other, other, this source); " if v["forward"] else "")
            phase("time", t0, f"train-mode pointnet bf16 ({n_c}, {POINT_NUM}, {d_c}), {label}: "
                  f"{turns}each pass's device time a call by the profiler (ms): "
                  f"forward {v['passes']['forward']}; backward {v['passes']['backward']} "
                  f"[{card}]")
        del pts_c, layers_c, g_c, saved16, saved32, out_p, tracked, flat, p16, g16

    return pt16_worst, pt16_times, pt16_bounds


def multiview_phases(dev, card: str, t0: float, reset_counts, counts, bf16_counts):
    """Phases 41-44: the MultiView teacher's serving, evaluation, training
    (steps, the training CLI on generated files, testing and inference),
    KD --crd, --stage 1 and --stage 2 with it, and the testing and training
    CLIs on LineMod, Pix3D and ShapeNetCore, each path driven with the
    launch counts set to 0 just before it (`reset_counts`) and read just
    after it (`counts`, `bf16_counts`). Returns the paths' launches summed
    (as `counts` orders them, and as `bf16_counts` does) and the geodesic
    kernel's largest difference from its plain version on the evaluation's
    rows."""
    from types import SimpleNamespace

    from pose3d_tpu_torch import geometry
    from pose3d_tpu_torch.cli import common as cli_common
    from pose3d_tpu_torch.cli import inference as inference_cli
    from pose3d_tpu_torch.cli import testing as testing_cli
    from pose3d_tpu_torch.cli import training as training_cli
    from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                    PoseEstimatorVanilla)
    from pose3d_tpu_torch.ops import geodesic, nce
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.train.evaluate import evaluate_categories
    from pose3d_tpu_torch.train.state import create_train_state

    def mean(v):
        return sum(v) / len(v)

    geo_err = 0.0
    # 41. the MultiView teacher at full width (ResNet-50, image feature
    # 1024; ResNet-18, feature 256 over 12 renders of 224x224, tour 2;
    # DeformNet bottleneck 4096), random weights from a seed through
    # convert.py, loaded strictly: card vs CPU at batch 2, then its main
    # path (serving a batch of 64 requests, an evaluation with renders
    # through the geodesic kernel), view_tile=3, and serving times at
    # batch 1 and 64, f32 and bf16 in turns
    torch.cuda.empty_cache()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    mv_counts, mv16_counts = [], []  # the MultiView paths' launches
    mv_sd = convert.pose_state_dict(teacher_variables(
        np.random.default_rng(41), 1024, MV_SHAPE_DIM, view_num=MV_VIEWS), "MultiView")

    def mv_built(where, sd=mv_sd):
        with torch.device("meta"):
            m = PoseEstimator(shape="MultiView", view_num=MV_VIEWS, img_feature_dim=1024,
                              shape_feature_dim=MV_SHAPE_DIM)
        m.load_state_dict({k: v.to(where) for k, v in sd.items()}, strict=True, assign=True)
        return m.eval()

    mv_cpu, mv = mv_built("cpu"), mv_built(dev)
    n_mv = sum(p.numel() for p in mv.parameters())
    xm = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (TEACHER_BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    gm = torch.Generator(device=dev).manual_seed(42)
    rm = torch.rand((TEACHER_BATCH, MV_VIEWS, 224, 224, 3), generator=gm, device=dev)
    with torch.no_grad():
        got = mv(xm[:2], rm[:2])
        want = mv_cpu(xm[:2].cpu(), rm[:2].cpu())
    got, want = got[0] + list(got[1:]), want[0] + list(want[1:])
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise RuntimeError("MultiView teacher: non-finite output on the card")
    worst = max(rel_err(g, w) for g, w in zip(got, want))
    if worst > HEADS_REL_TOL:
        raise RuntimeError(f"MultiView teacher card vs CPU: max|d|/max|ref| {worst:.3g}")
    phase("MultiView teacher", t0, f"{n_mv} params loaded strict from convert.pose_state_dict"
          f"(..., 'MultiView'); batch 2 card vs CPU (heads, fused, projector) max|d|/max|ref| "
          f"{worst:.3g} (tol {HEADS_REL_TOL}); {resident_gib:.2f} GiB resident before it")
    del mv_cpu

    reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vp = mv.predict_viewpoint(xm, rm)
    torch.cuda.synchronize()
    serve_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if vp.shape != (TEACHER_BATCH, 3) or not bool(((vp >= 0) & (vp <= 360)).all()):
        raise RuntimeError(f"MultiView serving output {tuple(vp.shape)} outside [0, 360]")
    result = evaluate_categories(steps.make_eval_step(mv, "teacher"),
                                 eval_batches(43, False, MV_VIEWS, MV_EVAL_COUNTS),
                                 EVAL_CATEGORIES, dev)
    torch.cuda.synchronize()
    mv_eval = counts()
    if mv_eval != (1, 0, 0, 0, 0, 0, 0, 0):
        raise RuntimeError(f"MultiView serving and evaluation: launches {mv_eval}, expected "
                           "one geodesic")
    mv_counts.append(mv_eval)
    check_eval(result, geometry, "MultiView teacher", MV_EVAL_COUNTS)
    if not math.isfinite(result.val_nce_loss) or not math.isfinite(result.val_loss):
        raise RuntimeError(f"MultiView val losses {result.val_loss}, {result.val_nce_loss}")
    p_eval = torch.from_numpy(result.predictions).to(dev)
    l_eval = torch.from_numpy(result.labels).float().to(dev)
    geo_err = max(geo_err, float((geodesic.rotation_err(p_eval, l_eval)
                                  - geometry.rotation_err(p_eval, l_eval)).abs().max()))
    phase("MultiView serving", t0, f"{TEACHER_BATCH} requests (images and 12 renders each) -> "
          f"{tuple(vp.shape)} degrees in [0, 360], peak {serve_peak:.2f} GiB over the resident; "
          f"evaluation of {len(result.cat_ids)} rows with renders: geodesic launches "
          f"{mv_eval[0]}, Acc {result.per_category_acc} val_loss {result.val_loss:.4f} "
          f"val_nce_loss {result.val_nce_loss:.4f}, equal to the plain CPU recomputation")
    with torch.no_grad():
        tiled = mv(xm[:48], rm[:16], view_tile=3)
        by_hand = mv(xm[:48], rm[:16].repeat(3, 1, 1, 1, 1))
    tiled, by_hand = tiled[0] + list(tiled[1:]), by_hand[0] + list(by_hand[1:])
    worst = max(rel_err(a, b) for a, b in zip(tiled, by_hand))
    if worst > 1e-5:
        raise RuntimeError(f"MultiView view_tile=3 vs tiled renders: {worst:.3g}")
    phase("view_tile", t0, f"MultiView teacher(im x3, 16 render stacks, view_tile=3) vs the "
          f"renders tiled x3: max|d|/max|ref| {worst:.3g} (tol 1e-5: cuDNN may take another "
          f"algorithm at another batch)")
    mv_serve, mv_serve_peak, mv_lead = {}, {}, {}
    with torch.no_grad():
        for b in (1, TEACHER_BATCH):
            xb, rb = xm[:b], rm[:b]
            t = {"f32": [], "bf16": []}
            for who in ("f32", "bf16", "bf16", "f32"):
                set_compute_dtype(mv, torch.bfloat16 if who == "bf16" else None)
                torch.cuda.reset_peak_memory_stats()
                t[who].append(cuda_ms(lambda: mv(xb, rb), iters=20 if b == 1 else 8))
                mv_serve_peak[b, who] = (torch.cuda.max_memory_allocated() - base) / 2**30
            mv_serve[b] = t
        for who in ("f32", "bf16"):
            set_compute_dtype(mv, torch.bfloat16 if who == "bf16" else None)
            rows, device_ms, wall_ms = profile_steps(lambda: mv(xm, rm))
            mv_lead[who] = (device_ms / wall_ms, rows[0].key[:60] if rows else "",
                            rows[0].self_device_time_total / 1e3 / device_ms if rows else 0.0)
        vp16 = mv.predict_viewpoint(xm, rm)
        set_compute_dtype(mv, None)
    vp_d = (vp16.float() - vp).abs()
    vp_d = torch.minimum(vp_d, 360 - vp_d)
    for b, t in mv_serve.items():
        phase("time", t0, f"MultiView serving batch {b}: f32 {t['f32']} ms/batch, bf16 "
              f"{t['bf16']} ms/batch = {b * 1000.0 / mean(t['bf16']):.1f} requests/s (f32 "
              f"{b * 1000.0 / mean(t['f32']):.1f}); peak over the resident f32 "
              f"{mv_serve_peak[b, 'f32']:.2f} GiB, bf16 {mv_serve_peak[b, 'bf16']:.2f} GiB "
              f"[{card}]")
    phase("profile", t0, "MultiView serving batch 64: " + "; ".join(
        f"{who} busy {v[0]:.3f}, leading {v[1]} ({v[2]:.3f} of device time)"
        for who, v in mv_lead.items()) + f"; bf16 vs f32 predictions: median "
        f"{float(vp_d.median()):.3g} deg, largest {float(vp_d.max()):.3g} deg (not held) [{card}]")

    # 42. the MultiView teacher's training with --fused_nce: one small step
    # card vs CPU (f64 model, f32 losses), then its main path, 6 steps at
    # the training CLI's width (1024 / 256 x 12) and batch 64, f32; the step
    # in f32 and bf16 in turns with the peak memory of each, batch 160 in
    # bf16 (and f32, where it fits); the NCE kernel's launches a call from a
    # CUDA graph at the step's (64, 200)
    mv_small = convert.pose_state_dict(teacher_variables(np.random.default_rng(44), 64, 16,
                                                         view_num=4), "MultiView")
    mrng = np.random.default_rng(45)
    mv_small_batch = {"im": mrng.standard_normal((8, 64, 64, 3)),
                      "shape": mrng.random((8, 4, 32, 32, 3)),
                      "label": random_labels(mrng, 8)}

    def small_mv_step(launched):
        def run(where):
            model = PoseEstimator(shape="MultiView", view_num=4, img_feature_dim=64,
                                  shape_feature_dim=16)
            model.load_state_dict(mv_small, strict=True)
            state = create_train_state(model.double().to(where), LR, [100], seed=0)
            batch = {k: torch.from_numpy(v).to(where) for k, v in mv_small_batch.items()}
            before = counts()
            metrics = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)(
                state, batch)
            torch.cuda.synchronize()
            launched[where] = tuple(a - b for a, b in zip(counts(), before))
            return metrics, [state.model]
        return run

    launched = {}
    loss_err, grad_err, stat_err = card_vs_cpu(small_mv_step(launched),
                                               ("loss", "pose_loss", "nce_loss"))
    if launched["cuda"] != (0, 0, 1, 1, 0, 0, 0, 0) or any(launched["cpu"]):
        raise RuntimeError(f"MultiView train step launches: card {launched['cuda']}, CPU "
                           f"{launched['cpu']}")
    phase("MultiView step", t0, f"card vs CPU at width 64 / 16 x 4 views, 64x64 images, 32x32 "
          f"renders, batch 8 (f64 model, f32 losses): losses rel {loss_err:.3g} (tol "
          f"{STEP_LOSS_RTOL}), gradients max|d|/max|ref| {grad_err:.3g} (tol "
          f"{STEP_GRAD_TOL}), running statistics max|d| {stat_err:.3g}; the card's step "
          f"launched NCE forward, backward {launched['cuda'][2:4]}")

    def mv_batch(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return {"im": torch.randn((n, 224, 224, 3), generator=g, device=dev),
                "shape": torch.rand((n, MV_VIEWS, 224, 224, 3), generator=g, device=dev),
                "label": torch.from_numpy(random_labels(np.random.default_rng(seed), n)).to(dev)}

    mv_state = create_train_state(PoseEstimator(
        shape="MultiView", view_num=MV_VIEWS, img_feature_dim=1024,
        shape_feature_dim=MV_SHAPE_DIM, generator=torch.Generator().manual_seed(46)).to(dev),
        LR, [10**9], seed=46)
    mv_step = steps.make_teacher_train_step(use_fused_nce=True)
    mb = mv_batch(MV_TRAIN_BATCH, 46)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history = [mv_step(mv_state, mb) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    mvt_counts = counts()
    mv_counts.append(mvt_counts)
    losses = [float(m["loss"]) for m in history]
    pose_losses = [float(m["pose_loss"]) for m in history]
    if mvt_counts != (0, 0, TRAIN_STEPS, TRAIN_STEPS, 0, 0, 0, 0):
        raise RuntimeError(f"MultiView teacher training: launches {mvt_counts}, expected one "
                           "NCE forward and backward a step")
    if not all(math.isfinite(v) for v in losses + pose_losses) or \
            not (losses[-1] < losses[0] and pose_losses[-1] < pose_losses[0]):
        raise RuntimeError(f"MultiView training on one repeated batch: losses {losses}, "
                           f"pose losses {pose_losses}")
    phase("MultiView training", t0, f"{sum(p.numel() for p in mv_state.model.parameters())} "
          f"params, batch {MV_TRAIN_BATCH} (x 12 renders), 224x224, {TRAIN_STEPS} steps on one "
          f"batch: loss {[round(v, 4) for v in losses]} (pose "
          f"{[round(v, 4) for v in pose_losses]}); NCE launches {mvt_counts[2:4]}; peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB over the resident")
    mv_steps, mv_peak = {"f32": [], "bf16": []}, {}
    set_compute_dtype(mv_state.model, torch.bfloat16)
    mv_step(mv_state, mb)  # bf16's first step (cuDNN's bf16 engines), untimed
    for who in ("f32", "bf16", "bf16", "f32"):
        set_compute_dtype(mv_state.model, torch.bfloat16 if who == "bf16" else None)
        torch.cuda.reset_peak_memory_stats()
        mv_steps[who].append(steps_ms(lambda: mv_step(mv_state, mb)))
        mv_peak[MV_TRAIN_BATCH, who] = (torch.cuda.max_memory_allocated() - base) / 2**30
    set_compute_dtype(mv_state.model, None)
    rows, device_ms, wall_ms = profile_steps(lambda: mv_step(mv_state, mb))
    nce_ms = sum(e.self_device_time_total for e in rows if "nce_" in e.key) / 1e3
    del mb
    for who in ("bf16", "f32"):  # batch 160: bf16, then f32 where it fits
        torch.cuda.empty_cache()
        set_compute_dtype(mv_state.model, torch.bfloat16 if who == "bf16" else None)
        try:
            mb = mv_batch(TRAIN_BATCH, 47)
            torch.cuda.reset_peak_memory_stats()
            mv_steps[TRAIN_BATCH, who] = steps_ms(lambda: mv_step(mv_state, mb), steps=3)
            mv_peak[TRAIN_BATCH, who] = (torch.cuda.max_memory_allocated() - base) / 2**30
        except torch.cuda.OutOfMemoryError:
            mv_steps[TRAIN_BATCH, who] = None
            mv_peak[TRAIN_BATCH, who] = (torch.cuda.max_memory_allocated() - base) / 2**30
        finally:
            mb = None
            mv_state.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
    set_compute_dtype(mv_state.model, None)
    capacity = torch.cuda.get_device_properties(0).total_memory / 2**30
    s_n = torch.randn((MV_TRAIN_BATCH, 200), device=dev)
    k_n = torch.randn((MV_TRAIN_BATCH, 200), device=dev)
    _, saved = nce.nce_forward(s_n, k_n, None, None, 0, 0.1, True)
    one = torch.ones((), device=dev)
    mv_nce_graph = (
        graph_kernel_launches(lambda: nce.nce_forward(s_n, k_n, None, None, 0, 0.1, True)),
        graph_kernel_launches(lambda: nce.nce_backward(
            saved, None, None, one, (MV_TRAIN_BATCH, MV_TRAIN_BATCH, 200), 0, 0.1, True)))
    if mv_nce_graph != (1, 1):
        raise RuntimeError(f"NCE at ({MV_TRAIN_BATCH}, 200): CUDA graph kernel nodes (forward, "
                           f"backward) {mv_nce_graph}")
    del s_n, k_n, saved
    b160 = {who: (f"{mv_steps[TRAIN_BATCH, who]:.3f} ms/step"
                  if mv_steps[TRAIN_BATCH, who] is not None else "out of memory")
            + f", peak {mv_peak[TRAIN_BATCH, who]:.2f} GiB" for who in ("bf16", "f32")}
    phase("time", t0, f"MultiView teacher step batch {MV_TRAIN_BATCH}, --fused_nce: f32 "
          f"{mv_steps['f32']} ms/step ({MV_TRAIN_BATCH * 1000.0 / mean(mv_steps['f32']):.1f} "
          f"samples/s, peak {mv_peak[MV_TRAIN_BATCH, 'f32']:.2f} GiB over the resident), bf16 "
          f"{mv_steps['bf16']} ms/step ({MV_TRAIN_BATCH * 1000.0 / mean(mv_steps['bf16']):.1f} "
          f"samples/s, peak {mv_peak[MV_TRAIN_BATCH, 'bf16']:.2f} GiB); batch {TRAIN_BATCH}: "
          f"bf16 {b160['bf16']}, f32 {b160['f32']} (of {capacity:.1f} GiB; {base / 2**30:.2f} "
          f"GiB resident); NCE CUDA graph kernel nodes a call (forward, backward) "
          f"{mv_nce_graph} [{card}]")
    phase("profile", t0, f"2 MultiView train steps f32 batch {MV_TRAIN_BATCH}: {device_ms:.2f} "
          f"ms device of {wall_ms:.2f} ms wall (busy {device_ms / wall_ms:.3f}); the NCE "
          f"kernels {nce_ms:.4f} ms [{card}]; by self device time:")
    print_rows(rows, device_ms, top=8)
    del mv_state, history

    # the training CLI on generated files: one epoch of the MultiView
    # teacher (12 PNG renders decoded a sample) with --fused_nce, then
    # --resume into a second; its testing CLI and single-image inference
    # on that checkpoint
    fixture = tempfile.TemporaryDirectory()
    tf = time.perf_counter()
    roots = write_fixtures(fixture.name, np.random.default_rng(48))
    fixture_s = time.perf_counter() - tf
    cwd = os.getcwd()
    os.chdir(fixture.name)
    try:
        mv_flags = ["--dataset", "ObjectNet3D", "--shape", "MultiView", "--data_root",
                    roots["train"], "--batch_size", "32", "--workers", "8", "--fused_nce",
                    "--decrease", "100", "--print_freq", "100"]
        reset_counts()
        quiet(training_cli.main, mv_flags + ["--n_epoch", "1"])
        quiet(training_cli.main, mv_flags + ["--n_epoch", "2", "--resume"])
        torch.cuda.synchronize()
        cli_train = counts()
        mv_counts.append(cli_train)
        run = os.path.join(fixture.name, "result", "MultiView_ObjectNet3D")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if cli_train != (4, 0, 6, 6, 0, 0, 0, 0) or [r["epoch"] for r in records] != [0, 1] \
                or not all(math.isfinite(r["train_loss"]) for r in records):
            raise RuntimeError(f"MultiView training CLI: launches {cli_train}, records {records}")
        # the train loader alone over the same files (no step): the host's
        # own rate
        opt = training_cli.parse_args(mv_flags)
        loader = cli_common.make_train_loader(
            cli_common.build_train_eval_datasets(opt)[0], opt)
        tl = time.perf_counter()
        loaded = sum(int(b["valid"].sum()) for b in loader)
        loader_rate = loaded / (time.perf_counter() - tl)
        ckpt = os.path.join(run, "ckpt", "checkpoint.pth")
        reset_counts()
        tested = quiet(testing_cli.main, [
            "--dataset", "ObjectNet3D", "--shape", "MultiView", "--data_root", roots["train"],
            "--model", ckpt, "--batch_size", "32", "--workers", "8",
            "--output_dir", os.path.join(fixture.name, "preds")])
        crop = os.path.join(roots["train"], "ObjectNet3D", "Renders_semi_sphere", "bed", "01",
                            "crop")
        vp1 = quiet(inference_cli.main, [
            "--ckpt", ckpt, "--img_path", os.path.join(roots["train"], "ObjectNet3D", "Images",
                                                       "bed_val_0.jpg"),
            "--render_dir", crop, "--shape_feature_dim", str(MV_SHAPE_DIM)])
        torch.cuda.synchronize()
        cli_test = counts()
        mv_counts.append(cli_test)
        if cli_test != (1, 0, 0, 0, 0, 0, 0, 0) or not np.isfinite(tested.sample_med) or \
                not np.all(np.isfinite(vp1)):
            raise RuntimeError(f"MultiView testing / inference CLI: launches {cli_test}, "
                               f"Med_Err {tested.sample_med}, prediction {vp1}")
    finally:
        os.chdir(cwd)
    phase("MultiView CLI", t0, f"files written in {fixture_s:.1f} s; training --shape "
          f"MultiView --fused_nce on the card, batch 32, 8 loader threads: epoch 0, then "
          f"--resume into epoch 1: train_loss {[round(r['train_loss'], 4) for r in records]}, "
          f"train samples/s "
          f"{[round(r['train_samples'] / r['train_seconds'], 1) for r in records]} (12 PNG "
          f"renders and one JPEG decoded a sample; the train loader alone over the files "
          f"{loader_rate:.1f} samples/s), launches (geodesic, NCE forward, "
          f"backward) {(cli_train[0],) + cli_train[2:4]}; testing --shape MultiView on its "
          f"checkpoint.pth: {len(tested.cat_ids)} rows, Med_Err {tested.sample_med:.2f}; "
          f"inference --render_dir: {np.round(vp1, 2).tolist()} [{card}]")

    # 43. KD with a MultiView teacher: --crd at batch 46 x 3 views (the
    # student at full width, the frozen teacher of phase 41 encoding each
    # sample's 12 renders once, view_tile 3), 6 steps f32 (its main path),
    # then 2 in bf16 (the bf16 stem's), the step in f32 and bf16 in turns;
    # --stage 1 with the MultiView vanilla teacher (ResNet-18 1024, 256 x 12)
    # at batch 46, 2 steps, then --stage 2 from its checkpoint.pth read by
    # the CLI's loader, 2 steps
    mv.requires_grad_(False)
    kmb = {k: v for k, v in mv_batch(KD_BATCH, 49).items()}
    g = torch.Generator(device=dev).manual_seed(50)
    for view in ("_flip", "_rot"):
        kmb["im" + view] = torch.randn((KD_BATCH, 224, 224, 3), generator=g, device=dev)
        kmb["label" + view] = torch.from_numpy(random_labels(np.random.default_rng(51),
                                                             KD_BATCH)).to(dev)
    kd_mv = create_train_state(BaselineEstimator(
        generator=torch.Generator().manual_seed(47)).to(dev), LR, [10**9], seed=47)
    kd_step = steps.make_kd_crd_step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history = [kd_step(kd_mv, mv, kmb) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    kdm_counts = counts()
    mv_counts.append(kdm_counts)
    kd_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    kd_losses = [float(m["loss"]) for m in history]
    if kdm_counts != (0, 0, 0, 0, TRAIN_STEPS, TRAIN_STEPS, 0, 0) or \
            not all(math.isfinite(v) for v in kd_losses):
        raise RuntimeError(f"KD --crd with the MultiView teacher: launches {kdm_counts}, "
                           f"losses {kd_losses}")
    set_compute_dtype(kd_mv.model, torch.bfloat16)
    set_compute_dtype(mv, torch.bfloat16)
    reset_counts()
    history16 = [kd_step(kd_mv, mv, kmb) for _ in range(2)]
    torch.cuda.synchronize()
    kd16 = bf16_counts()
    mv16_counts.append(kd16)
    if kd16[:2] != (2, 2) or counts()[4:6] != (0, 0) or \
            not all(math.isfinite(float(m["loss"])) for m in history16):
        raise RuntimeError(f"KD --crd bf16 with the MultiView teacher: bf16 stem launches "
                           f"{kd16}, f32 {counts()[4:6]}")
    kd_t = {"f32": [], "bf16": []}
    for who in ("f32", "bf16", "bf16", "f32"):
        for m in (kd_mv.model, mv):
            set_compute_dtype(m, torch.bfloat16 if who == "bf16" else None)
        kd_t[who].append(steps_ms(lambda: kd_step(kd_mv, mv, kmb), steps=4))
    for m in (kd_mv.model, mv):
        set_compute_dtype(m, None)
    with torch.no_grad():
        teacher_ms = cuda_ms(lambda: mv(torch.cat([kmb["im"], kmb["im_flip"], kmb["im_rot"]]),
                                        kmb["shape"], view_tile=3), iters=3)
    phase("KD MultiView", t0, f"--crd, student {sum(p.numel() for p in kd_mv.model.parameters())} "
          f"params, batch {KD_BATCH} x 3 views, the frozen MultiView teacher at view_tile 3: "
          f"{TRAIN_STEPS} steps f32, loss {[round(v, 4) for v in kd_losses]}, stem launches "
          f"{kdm_counts[4:6]}, peak {kd_peak:.2f} GiB over the resident; 2 steps bf16, loss "
          f"{[round(float(m['loss']), 4) for m in history16]}, bf16 stem launches {kd16[:2]}")
    phase("time", t0, f"KD --crd step with the MultiView teacher, batch {KD_BATCH} x 3 views: "
          f"f32 {kd_t['f32']} ms/step, bf16 {kd_t['bf16']} ms/step = "
          f"{KD_BATCH * 1000.0 / mean(kd_t['bf16']):.1f} samples/s (f32 "
          f"{KD_BATCH * 1000.0 / mean(kd_t['f32']):.1f}); the frozen teacher's forward "
          f"{teacher_ms:.3f} ms of it in f32 [{card}]")
    del kd_mv, history, history16

    t1 = create_train_state(PoseEstimatorVanilla(
        shape="MultiView", view_num=MV_VIEWS, img_feature_dim=1024,
        shape_feature_dim=MV_SHAPE_DIM, generator=torch.Generator().manual_seed(52)).to(dev),
        LR, [10**9], seed=52)
    s1 = create_train_state(BaselineEstimator(
        generator=torch.Generator().manual_seed(53)).to(dev), LR, [10**9], seed=53)
    s1_step = steps.make_stage1_step(tau=0.5, use_fused_nce=True)
    sbm = {k: kmb[k] for k in ("im", "shape", "label")}
    reset_counts()
    tt = time.perf_counter()
    history = [s1_step(t1, s1, sbm) for _ in range(2)]
    torch.cuda.synchronize()
    s1m_ms = (time.perf_counter() - tt) * 1e3 / 2
    s1m_counts = counts()
    mv_counts.append(s1m_counts)
    if s1m_counts != (0, 0, 4, 4, 2, 2, 0, 0) or \
            not all(math.isfinite(float(m["loss"])) for m in history):
        raise RuntimeError(f"stage 1 with the MultiView vanilla teacher: launches {s1m_counts}")
    with tempfile.TemporaryDirectory() as tmp:
        s1m_ckpt = os.path.join(tmp, "checkpoint.pth")
        torch.save({"teacher": t1.state_dict(), "student": s1.state_dict()}, s1m_ckpt)
        s2m_teacher = cli_common.build_vanilla(SimpleNamespace(
            img_feature_dim=1024, shape_feature_dim=MV_SHAPE_DIM, bin_size=15,
            shape="MultiView", view_num=MV_VIEWS), dev, s1m_ckpt).requires_grad_(False)
    same = all(torch.equal(v, t1.model.state_dict()[k])
               for k, v in s2m_teacher.state_dict().items())
    del t1, s1
    s2m = create_train_state(BaselineEstimator(
        generator=torch.Generator().manual_seed(54)).to(dev), LR, [10**9], seed=54)
    s2_step = steps.make_stage2_step()
    reset_counts()
    tt = time.perf_counter()
    history2 = [s2_step(s2m, s2m_teacher, kmb) for _ in range(2)]
    torch.cuda.synchronize()
    s2m_ms = (time.perf_counter() - tt) * 1e3 / 2
    s2m_counts = counts()
    mv_counts.append(s2m_counts)
    if not same or s2m_counts != (0, 0, 0, 0, 2, 2, 0, 0) or \
            not all(math.isfinite(float(m["loss"])) for m in history2):
        raise RuntimeError(f"stage 2 from the MultiView stage-1 checkpoint: teacher equal "
                           f"{same}, launches {s2m_counts}")
    phase("KD MultiView", t0, f"--stage 1 (--fused_nce) with the MultiView vanilla teacher, "
          f"batch {KD_BATCH}: 2 steps, loss {[round(float(m['loss']), 4) for m in history]}, "
          f"launches (NCE forward, backward, stem forward, backward) {s1m_counts[2:6]}, "
          f"{s1m_ms:.1f} ms/step (first steps); --stage 2 from its checkpoint.pth (the teacher "
          f"read by the CLI's loader, equal): 2 steps at {KD_BATCH} x 3 views, loss "
          f"{[round(float(m['loss']), 4) for m in history2]}, stem launches "
          f"{s2m_counts[4:6]}, {s2m_ms:.1f} ms/step (first steps) [{card}]")
    del s2m, s2m_teacher, history, history2, kmb, sbm, mv, xm, rm

    # 44. the datasets through the CLIs on the card: the testing CLI on
    # LineMod and on Pix3D with the student (full width, its seeded init),
    # and one epoch of the RGB-only baseline on ShapeNetCore validated on
    # Pix3D
    os.chdir(fixture.name)
    try:
        tested = {}
        reset_counts()
        for name in ("LineMod", "Pix3D"):
            tested[name] = quiet(testing_cli.main, [
                "--dataset", name, "--shape", "None", "--data_root", roots["test"],
                "--img_feature_dim", "2048", "--batch_size", "16", "--workers", "8",
                "--output_dir", os.path.join(fixture.name, f"preds_{name}")])
        torch.cuda.synchronize()
        ds_test = counts()
        mv_counts.append(ds_test)
        reset_counts()
        quiet(training_cli.main, ["--dataset", "ShapeNetCore", "--shape", "None",
                                  "--data_root", roots["train"], "--img_feature_dim", "2048",
                                  "--batch_size", "16", "--workers", "8", "--n_epoch", "1",
                                  "--decrease", "100"])
        torch.cuda.synchronize()
        ds_train = counts()
        mv_counts.append(ds_train)
        with open(os.path.join(fixture.name, "result", "baseline_ShapeNetCore",
                               "metrics.jsonl")) as f:
            sn = json.loads(f.readline())
    finally:
        os.chdir(cwd)
        fixture.cleanup()
    if ds_test != (2, 0, 0, 0, 4, 0, 0, 0) or ds_train[:2] != (1, 0) or \
            ds_train[4:6] != (5, 3) or not math.isfinite(sn["train_loss"]) or \
            not all(np.isfinite(r.sample_med) for r in tested.values()):
        raise RuntimeError(f"datasets: testing launches {ds_test}, ShapeNetCore launches "
                           f"{ds_train}, record {sn}")
    phase("datasets", t0, "testing --shape None on the card: " + "; ".join(
        f"{name} {len(r.cat_ids)} rows, categories {sorted(r.per_category_acc)}, Med_Err "
        f"{r.sample_med:.2f}" for name, r in tested.items()) + f" (launches: geodesic "
        f"{ds_test[0]}, stem forward {ds_test[4]}); training --dataset ShapeNetCore --shape "
        f"None: 3 steps of 16 at 224x224, train_loss {sn['train_loss']:.4f}, val_med "
        f"{sn['val_med']:.2f} on Pix3D's 24 rows, "
        f"train_samples_per_s {sn['train_samples_per_s']:.1f} (launches: geodesic "
        f"{ds_train[0]}, stem forward {ds_train[4]}, backward {ds_train[5]}) [{card}]")
    return ([sum(c[i] for c in mv_counts) for i in range(8)],
            [sum(c[i] for c in mv16_counts) for i in range(3)], geo_err)


def int8_record_shapes(i8, run) -> list:
    """The int8 convolutions one run() makes, in call order: (N, H, W, C,
    KH, KW, CO, stride, padding, relu, pool) each, the arguments recorded by
    a wrapper around `i8.int8_conv` (its kernel still launched)."""
    calls, kernel = [], i8.int8_conv

    def record(x, a, w, ws, shift, stride=1, padding=0, relu=False, pool=False):
        calls.append((*x.shape, *w.shape[:2], w.shape[3], stride, padding, bool(relu),
                      bool(pool)))
        return kernel(x, a, w, ws, shift, stride, padding, relu, pool)

    i8.int8_conv = record
    try:
        run()
    finally:
        i8.int8_conv = kernel
    return calls


@contextlib.contextmanager
def plain_int8(i8):
    """The int8 product's plain version in place of its kernel, on the card:
    the same forward through `int8_conv_plain` (exact int32 sums from
    float64 convolutions, the same dequantization as torch operations)."""
    kernel = i8.int8_conv
    i8.int8_conv = i8.int8_conv_plain
    try:
        yield
    finally:
        i8.int8_conv = kernel


def int8_case(gen: torch.Generator, shape, dtype, dev):
    """Seeded inputs of one int8 convolution (N, H, W, C, KH, KW, CO,
    stride, padding, relu, pool), made on the card from `gen`: x normal, w
    uniform in [-127, 127] stored K-major as the quantized trees store it
    (`int8_conv.k_major`), a = max|x| / 127, ws positive, shift normal."""
    from pose3d_tpu_torch.ops import int8_conv as i8

    n, h, w, c, kh, kw, co, stride, padding, relu, pool = shape
    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (kh, kw, c, co), generator=gen, device=dev, dtype=torch.int8)
    a = (x.float().abs().max() / 127.0).reshape(())
    ws = torch.rand((co,), generator=gen, device=dev) * 1e-2 + 1e-4
    shift = torch.randn((co,), generator=gen, device=dev)
    return (x, a, i8.k_major(wq), ws, shift, stride, padding, relu, pool)


def legacy_int8_conv(path: str):
    """fn(x, a, w, ws, shift, stride, padding, relu, pool) through another
    build of csrc/int8_conv.cu with the earlier C interface (HWIO weights,
    no pool argument), its 2x2 pool the separate max_pool2d that the
    student forward ran before the pool moved into the kernel. w must be
    HWIO contiguous."""
    import ctypes

    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.int8_conv.argtypes = [p, ctypes.c_int] + [p] * 7 + [i64] * 11 + [ctypes.c_int, p]
    lib.int8_conv.restype = ctypes.c_int
    lib.int8_conv_splits.argtypes = [i64] * 3
    lib.int8_conv_splits.restype = ctypes.c_int

    def conv(x, a, w, ws, shift, stride, padding, relu, pool):
        n, h, wd, c = x.shape
        kh, kw, _, co = w.shape
        oh, ow = (h + 2 * padding - kh) // stride + 1, (wd + 2 * padding - kw) // stride + 1
        y = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
        xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        m, k = n * oh * ow, kh * kw * c
        acc = (torch.empty((m, co), dtype=torch.int32, device=x.device)
               if lib.int8_conv_splits(m, co, k) > 1 else None)
        err = lib.int8_conv(x.data_ptr(), 0 if x.dtype == torch.float32 else 2, a.data_ptr(),
                            w.data_ptr(), ws.data_ptr(), shift.data_ptr(), y.data_ptr(),
                            xq.data_ptr(), None if acc is None else acc.data_ptr(), n, h, wd, c,
                            kh, kw, stride, padding, oh, ow, co, int(relu),
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{path}: int8_conv failed: cudaError_t {err}")
        if pool:
            y = torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return y

    return conv


def int8_im2col_mm(x, a, w, stride, padding):
    """The yardstick (`library_ms`): the quantized input's patches copied
    out (im2col, (M, K) s8) and torch._int_mm's s8 x s8 -> s32 product with
    the (K, CO) weights; the port never calls it. Needs M > 16."""
    from pose3d_tpu_torch.ops import int8_conv as i8

    xq = i8.quantize_act(x, a)
    kh, kw, c, co = w.shape
    xp = torch.nn.functional.pad(xq, (0, 0, padding, padding, padding, padding))
    patches = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # (N, OH, OW, C, KH, KW)
    cols = patches.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)
    return torch._int_mm(cols, w.reshape(-1, co))


def int8_bound(shape, dtype) -> tuple[float, str]:
    """The least time of one int8 convolution: x read once in its dtype, w
    once, y written once (and ws, shift) at 3.35 TB/s, against its 2 M CO K
    operations at the int8 tensor-core rate. A pooled call computes the
    4 (OH // 2) (OW // 2) pixels its windows cover and writes a quarter of
    them."""
    n, h, w, c, kh, kw, co, stride, padding, _, pool = shape
    oh, ow = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
    item = torch.tensor([], dtype=dtype).element_size()
    m = 4 * n * (oh // 2) * (ow // 2) if pool else n * oh * ow
    k, out = kh * kw * c, m // 4 if pool else m
    return bound(n * h * w * c * item + k * co + out * co * item + 8 * co, 2.0 * m * co * k,
                 INT8_OPS)


def int8_phases(dev, card: str, t0: float, reset_counts, counts, bf16_counts,
                others: dict | None = None):
    """Phases 45-50: int8 post-training-quantized serving. The int8 kernel
    against its plain version bit for bit on the main path's shapes, and
    its times (beside each `--source int8_conv=` build's in `others`, {path:
    library}: the earlier C interface, `legacy_int8_conv`); the student,
    the PointCloud teacher and the MultiView teacher served int8 (each forward: its heads bit-equal to the same
    forward through the int8 product's plain version on the card, JAX's
    drift rule against the float model in the same dtype, times beside the
    f32 and bf16 forwards, busy share, peak memory); `testing --int8` and
    `inference --int8 --save_quantized` / `--load_quantized` on generated
    files; KD --crd (PointCloud and MultiView teachers) and --stage 2 with
    --int8_teacher at 46 x 3. Each path is driven with the launch counts set
    to 0 just before it and read just after it. Returns (the int8 kernel's
    launches on these paths, the other kernels' launches on them as
    `counts` orders them, and as `bf16_counts` does, its largest difference
    from its plain version, its kernels-line times)."""
    from pose3d_tpu_torch import serving
    from pose3d_tpu_torch.cli import inference as inference_cli
    from pose3d_tpu_torch.cli import testing as testing_cli
    from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                    PoseEstimatorVanilla)
    from pose3d_tpu_torch.ops import _build
    from pose3d_tpu_torch.ops import int8_conv as i8
    from pose3d_tpu_torch.serving import quant_teacher
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.models.vgg import scaled_width
    from pose3d_tpu_torch.train.state import create_train_state

    bf16 = torch.bfloat16
    added, added16, launched = [0] * 8, [0] * 3, 0
    copies0 = i8.int8_conv.weight_copies  # none: the trees store their weights K-major

    def take(expect_int8):
        """The paths' launches since reset_counts(), added up; the int8
        kernel's held to expect_int8."""
        nonlocal launched
        torch.cuda.synchronize()
        got = i8.int8_conv.launches
        if got != expect_int8:
            raise RuntimeError(f"int8 kernel launches {got}, expected {expect_int8}")
        launched += got
        for i, v in enumerate(counts()):
            added[i] += v
        for i, v in enumerate(bf16_counts()):
            added16[i] += v
        return got

    def mean(v):
        return sum(v) / len(v)

    def heads_equal(got, want) -> bool:
        return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))

    def drift(got, want, rule) -> dict:
        """JAX's drift rule (tests/test_quant_student.py:52-54,
        test_quant_teacher.py:79-82): each head's cosine, max relative error
        and (the rule's heads) argmax agreement; raises where one fails."""
        cos_min, rel_max, argmax_heads = rule
        worst = {"cos": 1.0, "rel": 0.0, "argmax": 1.0}
        for i, (a, b) in enumerate(zip(got, want)):
            a, b = a.double().cpu(), b.double().cpu()
            cos = float((a * b).sum() / (a.norm() * b.norm() + 1e-9))
            rel = float((a - b).abs().max() / (b.abs().max() + 1e-9))
            agree = float((a.argmax(1) == b.argmax(1)).double().mean())
            if cos <= cos_min or rel >= rel_max or (i in argmax_heads and agree < 0.75):
                raise RuntimeError(f"int8 drift rule, head {i}: cosine {cos:.5f} (> {cos_min}), "
                                   f"max rel {rel:.4f} (< {rel_max}), argmax {agree:.3f}")
            worst = {"cos": min(worst["cos"], cos), "rel": max(worst["rel"], rel),
                     "argmax": min(worst["argmax"], agree) if i in argmax_heads
                     else worst["argmax"]}
        return {k: round(v, 5) for k, v in worst.items()}

    # 45. the int8 kernel vs its plain version on the card, bit for bit:
    # every distinct int8 conv of VGG-11 (224x224; its four pre-pool convs
    # pooled in the kernel), ResNet-50 and ResNet-18 (224x224; the shapes
    # recorded from the models' int8 forwards below), the dense layers at
    # batch 1 and 256, a narrower student's widths (width_mult 0.3: 80 and
    # 160 channels, no multiple of the 64-channel tile), channel counts that
    # no vector load takes (C 3 / 20, CO 30), stride 2 with padding, pooled
    # calls of odd sizes on both routes; f32 and bf16; IGMMA (wgmma's int8
    # instruction) in the wgmma route's SASS, IMMA (mma.sync's) in the
    # mma.sync route's, neither in the epilogue
    lib = _build.build("int8_conv")
    sass = {needle: sass_hmma(lib, "int8_conv", needle) for needle in ("IGMMA", "IMMA")}
    want = {"IGMMA": {"int8_conv_wgmma_kernel": True, "int8_conv_wgmma_kernel<bf16>": True,
                      "int8_conv_kernel": False, "int8_conv_kernel<bf16>": False,
                      "int8_conv_epilogue_kernel": False,
                      "int8_conv_epilogue_kernel<bf16>": False},
            "IMMA": {"int8_conv_wgmma_kernel": False, "int8_conv_wgmma_kernel<bf16>": False,
                     "int8_conv_kernel": True, "int8_conv_kernel<bf16>": True,
                     "int8_conv_epilogue_kernel": False,
                     "int8_conv_epilogue_kernel<bf16>": False}}
    if sass != want:
        raise RuntimeError(f"int8_conv SASS: {sass}, expected {want}")
    s_sd = convert.baseline_state_dict(student_variables(np.random.default_rng(45),
                                                         input_dim=INT8_IMAGE))
    t_sd = convert.pose_state_dict(teacher_variables(np.random.default_rng(46), 1024, 1024))
    mv_sd = convert.pose_state_dict(teacher_variables(np.random.default_rng(47), 1024,
                                                      MV_SHAPE_DIM, view_num=MV_VIEWS),
                                    "MultiView")
    v_sd = convert.pose_vanilla_state_dict(vanilla_variables(np.random.default_rng(48), 1024,
                                                             STAGE1_SHAPE_DIM))

    def built(cls, sd, **kw):
        with torch.device("meta"):
            m = cls(**kw)
        m.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True, assign=True)
        return m.eval().requires_grad_(False)

    student = built(BaselineEstimator, s_sd, input_dim=INT8_IMAGE)
    teacher = built(PoseEstimator, t_sd, img_feature_dim=1024, shape_feature_dim=1024)
    mv = built(PoseEstimator, mv_sd, shape="MultiView", view_num=MV_VIEWS, img_feature_dim=1024,
               shape_feature_dim=MV_SHAPE_DIM)
    vanilla = built(PoseEstimatorVanilla, v_sd, img_feature_dim=1024,
                    shape_feature_dim=STAGE1_SHAPE_DIM)
    irng = np.random.default_rng(49)
    x256 = torch.from_numpy(irng.standard_normal((max(INT8_SERVE_BATCHES), INT8_IMAGE,
                                                  INT8_IMAGE, 3), dtype=np.float32)).to(dev)
    xt = x256[:INT8_TEACHER_BATCH]
    gen = torch.Generator(device=dev).manual_seed(49)
    clouds = torch.rand((INT8_TEACHER_BATCH, POINT_NUM, 3), generator=gen, device=dev)
    renders = torch.rand((INT8_TEACHER_BATCH, MV_VIEWS, INT8_IMAGE, INT8_IMAGE, 3),
                         generator=gen, device=dev)
    # calibration as the inference CLI does it: on the requests themselves
    tq = time.perf_counter()
    q_s = serving.quantize_student(student, [x256[:64].cpu().numpy()])
    q_t = serving.quantize_teacher_resnet(teacher, [xt.cpu().numpy()])
    q_mv = serving.quantize_teacher_mv(mv, [xt.cpu().numpy()], [renders[:16].cpu().numpy()])
    q_v = serving.quantize_teacher_vanilla(vanilla, [xt[:32].cpu().numpy()])
    quantize_s = time.perf_counter() - tq
    shapes = {
        "VGG-11": int8_record_shapes(i8, lambda: serving.student_int8_infer(q_s, x256[:1])),
        "ResNet-50": int8_record_shapes(
            i8, lambda: serving.resnet50_int8_forward(q_t, xt[:1], torch.float32)),
        "ResNet-18": int8_record_shapes(i8, lambda: serving.resnet_int8_forward(
            q_mv["shape"], renders[0, :1], "resnet18", torch.float32))}
    if [len(v) for v in shapes.values()] != [10, 52, 19]:
        raise RuntimeError(f"int8 calls a forward: {[len(v) for v in shapes.values()]}")
    cases = sorted({(2 if s[1] > 1 else 1,) + s[1:] for v in shapes.values() for s in v})
    cases += [(max(INT8_SERVE_BATCHES),) + s[1:] for s in shapes["VGG-11"]
              if s[1] == 1]  # the dense layers at the largest serving batch
    narrow = [scaled_width(v, 0.3) for v in VGG11_CONV_WIDTHS]
    cases += [(2, 112, 112, narrow[0], 3, 3, narrow[1], 1, 1, True, False),
              (2, 56, 56, narrow[1], 3, 3, narrow[2], 1, 1, True, False),
              (2, 28, 28, narrow[3], 3, 3, narrow[4], 1, 1, True, False),
              (2, 112, 112, narrow[0], 3, 3, narrow[1], 1, 1, True, True),
              (2, 9, 11, 20, 3, 3, 30, 2, 1, True, False),
              (5, 8, 8, 3, 3, 3, 8, 1, 1, False, False),
              (3, 13, 13, 48, 3, 3, 40, 2, 1, False, False),
              (1, 1, 1, 1000, 1, 1, 7, 1, 0, False, False),
              # pooled at odd sizes (the last row and column dropped), on both
              # routes, the pool on a strided conv, and at batch 1 (K split)
              (2, 9, 11, 64, 3, 3, 128, 1, 1, True, True),
              (2, 9, 11, 20, 3, 3, 30, 1, 1, True, True),
              (3, 13, 13, 48, 3, 3, 40, 2, 1, False, True),
              (1, 15, 15, 512, 3, 3, 512, 1, 1, True, True)]
    kgen = torch.Generator(device=dev).manual_seed(50)
    max_d, n_checked = 0.0, 0
    routes_before = dict(i8.int8_conv.route_launches)
    copies_before = i8.int8_conv.weight_copies
    for shape in cases:
        for dtype in (torch.float32, bf16):
            args = int8_case(kgen, shape, dtype, dev)
            before = i8.int8_conv.launches
            y = i8.int8_conv(*args)
            ref = i8.int8_conv_plain(*args)
            torch.cuda.synchronize()
            if i8.int8_conv.launches != before + 1:
                raise RuntimeError("the int8 wrapper did not count its launch")
            if y.shape != ref.shape or not torch.equal(y, ref):
                d = (y.float() - ref.float()).abs()
                raise RuntimeError(f"int8 kernel vs plain at {shape} {dtype}: "
                                   f"{int((d > 0).sum())} of {d.numel()} differ, max {float(d.max())}")
            max_d = max(max_d, float((y.float() - ref.float()).abs().max()))
            n_checked += 1
    routes = {r: i8.int8_conv.route_launches[r] - routes_before[r] for r in i8.ROUTES}
    want_routes = {r: 2 * sum(i8.route(s[3]) == r for s in cases) for r in i8.ROUTES}
    if routes != want_routes or i8.int8_conv.weight_copies != copies_before:
        raise RuntimeError(f"int8 routes {routes}, expected {want_routes}; weights copied "
                           f"{i8.int8_conv.weight_copies - copies_before} times")
    pooled = sum(s[10] for s in cases)
    phase("int8 kernel", t0, f"kernel vs plain in {n_checked} cases ({len(cases)} shapes x f32 / "
          f"bf16: the {len(set(shapes['VGG-11']))} VGG-11, {len(set(shapes['ResNet-50']))} "
          f"ResNet-50 and {len(set(shapes['ResNet-18']))} ResNet-18 distinct int8 convs at 224, "
          f"the dense layers at batch 1 and 256, width_mult 0.3's {narrow[1]}/{narrow[2]}/"
          f"{narrow[4]} channels, C 3 / 20 and CO 7 / 30, stride 2 with padding; {pooled} of "
          f"them pooled in the kernel): bit-equal in all (max|d| {max_d}); routes {routes}; "
          f"no weights copied; cuobjdump -sass: IGMMA in {sass['IGMMA']}, IMMA in "
          f"{sass['IMMA']}; calibration of the four trees {quantize_s:.1f} s")

    # the kernel's times at the main path's shapes: each distinct call by
    # CUDA graph replay (in turns with each --source int8_conv= build: this
    # source, the other, the other, this one; the other's pool its separate
    # max_pool2d), the plain version and im2col + torch._int_mm (the
    # yardstick) by CUDA events; summed over one forward's calls
    stream = torch.cuda.Stream()
    tgen = torch.Generator(device=dev).manual_seed(51)
    olds = {path: legacy_int8_conv(lib) for path, lib in (others or {}).items()}
    per_forward, slower = {}, []
    for name, batch, calls in (("VGG-11", max(INT8_SERVE_BATCHES), shapes["VGG-11"]),
                               ("ResNet-50", INT8_TEACHER_BATCH, shapes["ResNet-50"]),
                               ("ResNet-18", INT8_TEACHER_BATCH * MV_VIEWS, shapes["ResNet-18"])):
        for dtype in (bf16, torch.float32):
            tot = {"kernel": 0.0, "plain": 0.0, "bound": 0.0, "by ops": 0.0, "library": 0.0,
                   **{path: 0.0 for path in olds}}
            timed = {}
            for s in calls:
                shape = (batch,) + s[1:]
                if shape not in timed:
                    args = int8_case(tgen, shape, dtype, dev)
                    x, a, w, ws, shift, stride, padding, relu, pool = args
                    bnd = int8_bound(shape, dtype)
                    timed[shape] = {"bound": bnd[0],
                                    "by ops": bnd[0] if bnd[1] == "operations" else 0.0}
                    if olds:
                        hwio = (x, a, w.contiguous(), *args[3:])  # the earlier weight layout
                        mine = lambda: i8.int8_conv(*args)  # noqa: E731
                        turns = {"kernel": [], **{path: [] for path in olds}}
                        for path, conv in olds.items():
                            theirs = lambda: conv(*hwio)  # noqa: E731
                            if not torch.equal(theirs(), mine()):
                                raise RuntimeError(f"int8 kernel vs {path} at {shape}")
                            for who, fn in (("kernel", mine), (path, theirs), (path, theirs),
                                            ("kernel", mine)):
                                turns[who].append(graph_ms(fn, stream, calls=3, replays=2))
                        for who, v in turns.items():
                            timed[shape][who] = sum(v) / len(v)
                            if who != "kernel" and timed[shape]["kernel"] > timed[shape][who]:
                                slower.append(f"{shape} {'bf16' if dtype == bf16 else 'f32'}: "
                                              f"{timed[shape]['kernel']:.4f} ms against "
                                              f"{timed[shape][who]:.4f}")
                        del hwio
                    else:
                        timed[shape]["kernel"] = graph_ms(lambda: i8.int8_conv(*args), stream,
                                                          calls=5, replays=3)
                    if dtype == bf16:  # the plain version and the yardstick once
                        timed[shape]["plain"] = cuda_ms(lambda: i8.int8_conv_plain(*args),
                                                        iters=2, warmup=1)
                        timed[shape]["library"] = cuda_ms(
                            lambda: int8_im2col_mm(x, a, w, stride, padding), iters=3,
                            warmup=1)
                    del args, x, w
                for k in tot:
                    tot[k] += timed[shape].get(k, 0.0)
            per_forward[name, dtype] = {k: round(v, 4) for k, v in tot.items()}
            torch.cuda.empty_cache()
    dense_args = [int8_case(tgen, (1,) + s[1:], bf16, dev) for s in shapes["VGG-11"]
                  if s[1] == 1]
    dense1 = sum(graph_ms(lambda: i8.int8_conv(*args), stream, 5, 3) for args in dense_args)
    dense1_bound = sum(int8_bound(tuple(args[0].shape[:1]) + (1, 1, args[2].shape[2], 1, 1,
                                                               args[2].shape[3], 1, 0, False,
                                                               False),
                                  bf16)[0] for args in dense_args)
    del dense_args
    for (name, dtype), t in per_forward.items():
        where = {"VGG-11": f"batch {max(INT8_SERVE_BATCHES)}", "ResNet-50": "batch 64",
                 "ResNet-18": "768 renders"}[name]
        extra = (f", plain {t['plain']} ms, im2col + torch._int_mm {t['library']} ms (no "
                 "quantization or dequantization in it)" if dtype == bf16 else "")
        extra += "".join(f", {path} {t[path]} ms (its pool separate; in turns)" for path in olds)
        phase("time", t0, f"int8 kernel, one {name} forward's int8 calls ({where}, "
              f"{'bf16' if dtype == bf16 else 'f32'} activations): kernel {t['kernel']} ms "
              f"(CUDA graph replay), bound {t['bound']} ms ({t['by ops']} of it by "
              f"operations; {100 * t['bound'] / t['kernel']:.1f} % of the kernel's time)"
              f"{extra} [{card}]")
    if olds:
        phase("time", t0, f"int8 kernel: shapes slower than another source: "
              f"{'; '.join(slower) if slower else 'none'} [{card}]")
    phase("time", t0, f"int8 kernel, the student's three dense layers at batch 1 (bf16): "
          f"{dense1:.4f} ms by graph replay, bound {dense1_bound:.4f} ms (bytes) [{card}]")

    # 46-48. serving: the student at batch 1, 64 and 256, the PointCloud
    # teacher (ResNet-50, 1024/1024, 2,500 points) and the MultiView
    # teacher (768 renders through ResNet-18) at batch 64; f32 and bf16 on
    # the same weights and trees
    def serve(name, int8_fn, float_fn, batches, rule, int8_calls):
        """int8_fn(dtype, b) and float_fn(dtype, b) -> the six heads (float
        model's compute dtype switched by float_fn); for each batch and
        dtype the int8 heads against the plain product's (bit-equal) and
        the float model's (the drift rule), then times in turns, the busy
        share and peak memory."""
        lines = []
        for b in batches:
            for dtype in (torch.float32, bf16):
                reset_counts()
                with torch.no_grad():
                    got = int8_fn(dtype, b)
                take(int8_calls)
                with torch.no_grad(), plain_int8(i8):
                    plain = int8_fn(dtype, b)
                    ref = float_fn(dtype, b)
                torch.cuda.synchronize()
                if not heads_equal(got, plain):
                    raise RuntimeError(f"{name} int8 batch {b} {dtype}: heads unlike the plain "
                                       "int8 product's")
                if not all(bool(torch.isfinite(h).all()) for h in got):
                    raise RuntimeError(f"{name} int8: non-finite heads")
                if b == max(batches):  # the rule's argmax share wants rows
                    lines.append(f"b {b} {'bf16' if dtype == bf16 else 'f32'}: "
                                 f"{drift(got, ref, rule)}")
            t = {"f32": [], "bf16": [], "int8 f32": [], "int8 bf16": []}
            peak = {}
            iters = 20 if b == 1 else 5
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            with torch.no_grad():
                for who in ("f32", "bf16", "int8 f32", "int8 bf16", "int8 bf16", "int8 f32",
                            "bf16", "f32"):
                    dtype = bf16 if who.endswith("bf16") else torch.float32
                    fn = int8_fn if who.startswith("int8") else float_fn
                    torch.cuda.reset_peak_memory_stats()
                    t[who].append(round(cuda_ms(lambda: fn(dtype, b), iters, warmup=1), 3))
                    peak[who] = round((torch.cuda.max_memory_allocated() - base) / 2**30, 3)
                busy = {}
                for who in ("int8 bf16", "bf16"):
                    dtype = bf16
                    fn = int8_fn if who.startswith("int8") else float_fn
                    rows, device_ms, wall_ms = profile_steps(lambda: fn(dtype, b), steps=3)
                    busy[who] = (round(device_ms / wall_ms, 3),
                                 rows[0].key[:48] if rows else "")
            phase("time", t0, f"{name} serving batch {b}: " + "; ".join(
                f"{who} {v} ms = {b * 1000.0 / mean(v):.1f} img/s, peak {peak[who]} GiB"
                for who, v in t.items()) + f"; busy and leading kernel {busy} [{card}]")
        phase(name, t0, f"int8 heads equal the plain int8 product's on the card in every "
              f"batch and dtype; {int8_calls} int8 launches a forward; JAX's drift rule "
              f"(cosine > {rule[0]}, max rel < {rule[1]}, argmax agreeing on >= 0.75 of the "
              f"rows in heads {list(rule[2])}) against the float model in the same dtype at "
              f"the largest batch, worst over the heads: " + "; ".join(lines))

    def student_int8(dtype, b):
        return serving.student_int8_infer(q_s, x256[:b], dtype)

    def student_float(dtype, b):
        set_compute_dtype(student, dtype if dtype == bf16 else None)
        return [h.float() for h in student(x256[:b])[0]]

    serve("int8 student", student_int8, student_float, INT8_SERVE_BATCHES, STUDENT_DRIFT, 10)

    def teacher_pair(model, q):
        def int8_fn(dtype, b):
            set_compute_dtype(model, dtype if dtype == bf16 else None)
            shape = clouds if q is q_t else renders
            return [h.float() for h in
                    serving.make_teacher_int8_infer(model)(q, xt[:b], shape[:b])]

        def float_fn(dtype, b):
            set_compute_dtype(model, dtype if dtype == bf16 else None)
            shape = clouds if q is q_t else renders
            return [h.float() for h in model(xt[:b], shape[:b])[0]]

        return int8_fn, float_fn

    serve("int8 PointCloud teacher", *teacher_pair(teacher, q_t), (INT8_TEACHER_BATCH,),
          TEACHER_DRIFT, 52)
    serve("int8 MultiView teacher", *teacher_pair(mv, q_mv), (INT8_TEACHER_BATCH,),
          TEACHER_DRIFT, 52 + 19)
    for m in (student, teacher, mv):
        set_compute_dtype(m, None)
    del x256, clouds, renders
    torch.cuda.empty_cache()

    # 49. the CLIs on generated files: testing --int8 (the student at full
    # width, calibrated on its first batch), inference --int8
    # --save_quantized then --load_quantized (the student, and the
    # MultiView teacher on a model's renders): the same predictions
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        roots = write_fixtures(tmp, np.random.default_rng(52))
        os.chdir(tmp)
        try:
            torch.save({"state_dict": {k: v.cpu() for k, v in s_sd.items()}}, "student.pth")
            torch.save({"state_dict": {k: v.cpu() for k, v in mv_sd.items()}}, "mv.pth")
            reset_counts()
            tested = quiet(testing_cli.main, [
                "--dataset", "ObjectNet3D", "--shape", "None", "--data_root", roots["train"],
                "--model", "student.pth", "--img_feature_dim", "2048", "--int8",
                "--input_dim", str(INT8_IMAGE),
                "--calib_batches", "1", "--batch_size", "32", "--workers", "8",
                "--output_dir", "preds"])
            n_eval = take(10 * math.ceil(len(tested.cat_ids) / 32))
            img = os.path.join(roots["train"], "ObjectNet3D", "Images", "bed_val_0.jpg")
            crop = os.path.join(roots["train"], "ObjectNet3D", "Renders_semi_sphere", "bed",
                                "01", "crop")
            reset_counts()
            vps = {}
            for who, flags in (("student", ["--ckpt", "student.pth"]),
                               ("MultiView teacher", ["--ckpt", "mv.pth", "--render_dir", crop,
                                                      "--shape_feature_dim", str(MV_SHAPE_DIM),
                                                      "--view_num", str(MV_VIEWS)])):
                npz = f"{who.split()[0]}_q.npz"
                flags += ["--img_path", img, "--input_dim", str(INT8_IMAGE), "--int8"]
                vps[who] = (quiet(inference_cli.main, flags + ["--save_quantized", npz]),
                            quiet(inference_cli.main, flags + ["--load_quantized", npz]))
            n_inf = take(2 * 10 + 2 * (52 + 19))
        finally:
            os.chdir(cwd)
    if not (np.isfinite(tested.sample_med) and all(np.array_equal(a, b) and
                                                     np.all(np.isfinite(a))
                                                     for a, b in vps.values())):
        raise RuntimeError(f"int8 CLIs: Med_Err {tested.sample_med}, predictions {vps}")
    phase("int8 CLIs", t0, f"testing --int8 on {len(tested.cat_ids)} rows (the student, 2048, "
          f"224): Med_Err {tested.sample_med:.2f}, Acc {tested.sample_acc:.2f}, int8 launches "
          f"{n_eval}; inference --int8 --save_quantized then --load_quantized: student "
          f"{np.round(vps['student'][0], 2).tolist()} both times, MultiView teacher "
          f"(--render_dir) {np.round(vps['MultiView teacher'][0], 2).tolist()} both times; "
          f"int8 launches {n_inf} [{card}]")

    # 50. KD with --int8_teacher at 46 x 3 views: --crd from the PointCloud
    # and the MultiView teachers, --stage 2 from the vanilla teacher; each
    # INT8_KD_STEPS steps (the frozen teacher's conv trunks int8), its
    # teacher forward on the step's views against the plain int8 product's
    # (bit-equal) and against the float teacher (the drift rule), and the
    # step's time beside the same step with the float teacher, in turns
    krng = np.random.default_rng(53)
    kb = {k: torch.from_numpy(v).to(dev) for k, v in
          kd_batch(krng, KD_BATCH, INT8_IMAGE, POINT_NUM).items()}
    mv_shape = torch.rand((KD_BATCH, MV_VIEWS, INT8_IMAGE, INT8_IMAGE, 3), generator=gen,
                          device=dev)
    views = torch.cat([kb["im"], kb["im_flip"], kb["im_rot"]])
    kd_lines = []
    for name, model, q, make, stage2, shape, calls in (
            ("--crd, PointCloud teacher", teacher, q_t, quant_teacher.make_teacher_int8_kd_fwd,
             False, kb["shape"], 52),
            ("--crd, MultiView teacher", mv, q_mv, quant_teacher.make_teacher_int8_kd_fwd,
             False, mv_shape, 52 + 19),
            ("--stage 2, vanilla teacher", vanilla, q_v, quant_teacher.make_vanilla_int8_kd_fwd,
             True, kb["shape"], 19)):
        batch = dict(kb, shape=shape)
        with torch.device("meta"):
            s_model = BaselineEstimator(input_dim=INT8_IMAGE)
        s_model.load_state_dict({k: v.to(dev) for k, v in s_sd.items()}, strict=True,
                                assign=True)
        state = create_train_state(s_model, LR, [10**9], seed=0)
        step = (steps.make_stage2_step(int8_teacher=True) if stage2
                else steps.make_kd_crd_step(int8_teacher=True))
        float_step = steps.make_stage2_step() if stage2 else steps.make_kd_crd_step()
        int8_teacher = {"model": model, "q8": q}
        reset_counts()
        losses = [float(step(state, int8_teacher, batch)["loss"]) for _ in range(INT8_KD_STEPS)]
        take(INT8_KD_STEPS * calls)
        with torch.no_grad():
            fwd = make(model)
            got = fwd(q, views, shape, 3)
            with plain_int8(i8):
                plain = fwd(q, views, shape, 3)
            want = model(views, shape, view_tile=3)
        got_heads = got if stage2 else got[0]
        plain_heads = plain if stage2 else plain[0]
        if not heads_equal([h for h in got_heads], [h for h in plain_heads]) or \
                (not stage2 and not torch.equal(got[1], plain[1])) or \
                not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"KD {name} --int8_teacher: losses {losses}, or the teacher's "
                               "outputs unlike the plain int8 product's")
        dr = drift([h.float() for h in got_heads], [h.float() for h in want[0]], TEACHER_DRIFT)
        t = {"int8 teacher": [], "f32 teacher": []}
        for who in ("int8 teacher", "f32 teacher", "f32 teacher", "int8 teacher"):
            run = ((lambda: step(state, int8_teacher, batch)) if who == "int8 teacher"
                   else (lambda: float_step(state, model, batch)))
            t[who].append(round(steps_ms(run, 2), 3))
        kd_lines.append(f"{name}: loss {[round(v, 4) for v in losses]}, teacher outputs equal "
                        f"the plain int8 product's, drift {dr}, step ms {t}")
        del state, s_model
        torch.cuda.empty_cache()
    phase("int8 KD", t0, f"--int8_teacher at {KD_BATCH} x 3 views, {INT8_KD_STEPS} steps each "
          f"(the student f32, 2048): " + "; ".join(kd_lines) + f" [{card}]")
    if i8.int8_conv.weight_copies != copies0:
        raise RuntimeError(f"int8 paths copied weights K-major on a call "
                           f"{i8.int8_conv.weight_copies - copies0} times")
    del student, teacher, mv, vanilla, kb, mv_shape, views
    torch.cuda.empty_cache()
    bf_vgg = per_forward["VGG-11", bf16]
    by = "operations" if bf_vgg["by ops"] >= bf_vgg["bound"] / 2 else "bytes"
    return launched, added, added16, max_d, {
        "ms": bf_vgg["kernel"], "plain_ms": bf_vgg["plain"], "bound_ms": bf_vgg["bound"],
        "bound_by": by, "library_ms": bf_vgg["library"]}


def write_clouds(root: str, rng: np.random.Generator, n_vertices: int = DD_CLOUD_VERTICES) -> None:
    """A binary PLY cloud of `n_vertices` points for each CAD model of
    `write_fixtures`' ObjectNet3D set (<root>/pointcloud/<cat>/<XX>/
    compressed.ply), for its PointCloud teachers."""
    for cat in ("bed", "bookshelf"):
        for cad in (1, 2):
            path = os.path.join(root, "ObjectNet3D", "pointcloud", cat, f"{cad:02d}")
            os.makedirs(path, exist_ok=True)
            verts = rng.standard_normal((n_vertices, 3)).astype("<f4")
            with open(os.path.join(path, "compressed.ply"), "wb") as f:
                f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex %d\n"
                        b"property float x\nproperty float y\nproperty float z\nend_header\n"
                        % n_vertices + verts.tobytes())


def loader_rate(loader) -> float:
    """Samples a second of one pass of the train loader alone (no step)."""
    tt = time.perf_counter()
    n = sum(int(b["valid"].sum()) for b in loader)
    return n / (time.perf_counter() - tt)


def device_data_phases(dev, card: str, t0: float, reset_counts, counts, bf16_counts,
                       pt16_counts):
    """Phases 51-53: the on-device data path (`--device_shapes` with the
    cloud and render banks, `--device_augment`, `--device_views`, the u8
    wire). 51: the banks' and the augmentation's ops card vs CPU, and a
    render bank of DD_BANK_SHAPE gathered at DD_GATHER; 52: the steps with
    the options card vs CPU at small width (f64 models, f32 losses); 53: the
    CLIs on generated files at full width with the options, each driven
    with the launch counts set to 0 just before it and read just after it,
    and the train loaders and steps with and without the options, in
    turns, f32 and bf16. Returns the paths' launches summed, as `counts`,
    `bf16_counts` and `pt16_counts` order them."""
    from pose3d_tpu_torch.cli import common as cli_common
    from pose3d_tpu_torch.cli import testing as testing_cli
    from pose3d_tpu_torch.cli import training as training_cli
    from pose3d_tpu_torch.cli import trainingKD as kd_cli
    from pose3d_tpu_torch.data import transforms as T
    from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                    PoseEstimatorVanilla)
    from pose3d_tpu_torch.ops import augment, shape_bank
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.train.evaluate import host_array
    from pose3d_tpu_torch.train.state import create_train_state

    cpu = torch.device("cpu")
    added, added16, added_pt16 = [0] * 8, [0] * 3, [0] * 2

    def drive(run):
        """run() with the launch counts set to 0 before it and read after
        it; the launches join the phases' sums. Returns (run's result, the
        f32 counts, the bf16 counts, the bf16 train-mode PointNet's)."""
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        c, c16, p16 = counts(), bf16_counts(), pt16_counts()
        for acc, got in ((added, c), (added16, c16), (added_pt16, p16)):
            for i, v in enumerate(got):
                acc[i] += v
        return out, c, c16, p16

    # 51. the ops card vs CPU: sample_from_bank (counts above and below
    # POINT_NUM, rot 0 and +-15) the same indices and clouds within 1e-6
    # abs; gather_renders and synthesize_views bit-equal; device_augment
    # with given draws within 1e-6 of max|ref|
    g = np.random.default_rng(51)
    n_counts = np.array([6000, POINT_NUM, 3100, 1200, 800, 4000], np.int32)
    verts = np.zeros((len(n_counts), int(n_counts.max()), 3), np.float32)
    for s, c in enumerate(n_counts):
        verts[s, :c] = g.standard_normal((c, 3))
    ids = torch.from_numpy(g.integers(0, len(n_counts), 64))
    rot = torch.from_numpy(g.choice([0.0, 15.0, -15.0], 64).astype(np.float32))
    seeds = torch.from_numpy(g.integers(0, 2**32, 64, dtype=np.uint32).astype(np.int64))
    out = []  # the CPU's, then the card's
    for where in (cpu, dev):
        bank = shape_bank.ShapeBank.from_arrays(verts, n_counts, POINT_NUM, where)
        a = [t.to(where) for t in (ids, rot, seeds)]
        out.append((shape_bank.sample_indices(bank.counts[a[0]], a[2], verts.shape[1],
                                              POINT_NUM).cpu(),
                    shape_bank.sample_from_bank(bank, *a).cpu()))
    idx_same = torch.equal(out[0][0], out[1][0])
    cloud_err = float((out[0][1] - out[1][1]).abs().max())
    wor = [len(set(r.tolist())) == POINT_NUM and int(r.max()) < n_counts[i]
           for r, i in zip(out[1][0], ids.tolist()) if n_counts[i] >= POINT_NUM]
    if not idx_same or cloud_err > 1e-6 or not all(wor) or len(wor) in (0, len(ids)):
        raise RuntimeError(f"sample_from_bank card vs CPU: indices equal {idx_same}, clouds "
                           f"max|d| {cloud_err:.3g}, distinct subsets {sum(wor)}/{len(wor)}")
    renders = torch.from_numpy(g.integers(0, 256, (5, 144, 64, 64, 3), dtype=np.uint8))
    table = np.stack([T.multiview_ids(MV_VIEWS, 2, m) for m in range(72)])
    rids = torch.from_numpy(g.integers(0, 5, 16))
    muts = torch.from_numpy(g.integers(0, 72, 16))
    signs = torch.from_numpy(g.choice([-1.0, 1.0], 16).astype(np.float32))
    raw = torch.from_numpy(g.random((16, 224, 224, 3), dtype=np.float32))
    draws = augment.augment_draws(48, torch.Generator().manual_seed(51), cpu)
    ops = []  # the CPU's, then the card's
    for where in (cpu, dev):
        rb = shape_bank.RenderBank.from_arrays(renders.numpy(), table, where)
        views = augment.synthesize_views(raw.to(where), signs.to(where))
        ops.append((shape_bank.gather_renders(rb, rids.to(where), muts.to(where)).cpu(),
                    views.cpu(),
                    augment.device_augment(views, draws={
                        k: v.to(where) for k, v in draws.items()}).cpu()))
    if not torch.equal(ops[0][0], ops[1][0]) or not torch.equal(ops[0][1], ops[1][1]):
        raise RuntimeError("gather_renders / synthesize_views: card and CPU differ")
    aug_err = rel_err(ops[1][2], ops[0][2])
    if aug_err > 1e-6:
        raise RuntimeError(f"device_augment card vs CPU: max|d|/max|ref| {aug_err:.3g}")
    del out, ops
    phase("device data ops", t0, f"sample_from_bank card vs CPU, 64 samples of {POINT_NUM} "
          f"points from clouds of {n_counts.tolist()} vertices at rot 0 / +-15: the same "
          f"indices, clouds max|d| {cloud_err:.3g} (tol 1e-6), {len(wor)} subsets without "
          f"replacement distinct; gather_renders (16 x {MV_VIEWS} of 64x64) and "
          f"synthesize_views (16 x 224x224) bit-equal; device_augment of those 48 views with "
          f"given draws max|d|/max|ref| {aug_err:.3g} (tol 1e-6)")

    # the realistic sizes: a render bank of DD_BANK_SHAPE u8 made on the
    # card (no files) gathered at DD_GATHER; a cloud bank of 100 models x
    # 10,000 vertices sampled at TRAIN_BATCH x POINT_NUM; the augmentation
    # over the KD step's 3 x KD_BATCH views and the view synthesis of
    # KD_BATCH views
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    big = shape_bank.RenderBank(
        torch.randint(0, 256, DD_BANK_SHAPE, dtype=torch.uint8, device=dev),
        torch.from_numpy(table).to(dev))
    bank_gb = big.nbytes / 1e9
    b_n, b_k = DD_GATHER
    gid = torch.randint(0, DD_BANK_SHAPE[0], (b_n,), device=dev)
    gmut = torch.randint(0, 72, (b_n,), device=dev)
    got = shape_bank.gather_renders(big, gid, gmut)
    want = augment.dewire(big.renders[gid[:, None], big.id_table[gmut]])
    if not torch.equal(got, want):
        raise RuntimeError("gather_renders at the realistic size differs from plain indexing")
    del want
    gather_ms = cuda_ms(lambda: shape_bank.gather_renders(big, gid, gmut), iters=10)
    view_bytes = math.prod(DD_BANK_SHAPE[2:])
    gather_bytes = b_n * b_k * view_bytes * 5  # u8 read, f32 written
    gather_bound = bound(gather_bytes, 0)[0]
    del big, got
    torch.cuda.empty_cache()
    cb = shape_bank.ShapeBank(torch.randn((100, 10_000, 3), device=dev),
                              torch.full((100,), 10_000, dtype=torch.int64, device=dev),
                              POINT_NUM)
    cids = torch.randint(0, 100, (TRAIN_BATCH,), device=dev)
    crot = torch.zeros(TRAIN_BATCH, device=dev)
    cseed = torch.randint(0, 2**32, (TRAIN_BATCH,), dtype=torch.int64, device=dev)
    sample_ms = cuda_ms(lambda: shape_bank.sample_from_bank(cb, cids, crot, cseed), iters=10)
    views = torch.rand((3 * KD_BATCH, 224, 224, 3), device=dev)
    vdraws = augment.augment_draws(3 * KD_BATCH, None, dev)
    aug_ms = cuda_ms(lambda: augment.device_augment(views, draws=vdraws), iters=10)
    one = views[:KD_BATCH].contiguous()
    vsign = torch.ones(KD_BATCH, device=dev)
    synth_ms = cuda_ms(lambda: augment.synthesize_views(one, vsign), iters=10)
    aug_bound = bound(views.nbytes * 2, 0)[0]
    del cb, views, one
    torch.cuda.empty_cache()
    phase("time", t0, f"render bank {DD_BANK_SHAPE} u8 on the card, {bank_gb:.2f} GB "
          f"({(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB peak over the "
          f"resident): gather_renders of {b_n} x {b_k} views {gather_ms:.3f} ms "
          f"({gather_bytes / 1e6:.1f} MB moved, bound {gather_bound:.3f} ms by bytes, "
          f"{gather_bytes / gather_ms / 1e6:.1f} GB/s); sample_from_bank {TRAIN_BATCH} x "
          f"{POINT_NUM} of 100 x 10,000 vertices {sample_ms:.3f} ms; device_augment "
          f"({3 * KD_BATCH}, 224, 224, 3) {aug_ms:.3f} ms (one read and one write: bound "
          f"{aug_bound:.3f} ms); synthesize_views of {KD_BATCH} {synth_ms:.3f} ms [{card}]")

    # 52. the steps with the options, card vs CPU at small width (f64
    # models, f32 losses): the PointCloud teacher step with a ShapeBank at
    # the full subset, also against the host-cloud step on the card; the
    # MultiView teacher step with a RenderBank, also against host renders;
    # KD --crd with --device_views and given augment draws; --stage 1 with
    # a ShapeBank
    sg = np.random.default_rng(52)
    pc_verts = sg.standard_normal((4, 100, 3)).astype(np.float32)
    pc_counts = np.full(4, 100, np.int32)
    ref = {"shape_id": sg.integers(0, 4, 8), "shape_rot": np.zeros(8, np.float32),
           "shape_seed": sg.integers(0, 2**32, 8, dtype=np.uint32).astype(np.int64)}
    host_clouds = np.stack([T.sample_pointcloud(pc_verts[i], 100, 0.0, sg)
                            for i in ref["shape_id"]])
    small_t = convert.pose_state_dict(teacher_variables(np.random.default_rng(52), 64, 64))
    small_im = sg.standard_normal((8, 64, 64, 3))
    labels = random_labels(sg, 8)

    def pc_teacher_step(with_bank):
        def run(where):
            model = PoseEstimator(img_feature_dim=64, shape_feature_dim=64)
            model.load_state_dict(small_t, strict=True)
            state = create_train_state(model.double().to(where), LR, [100], seed=0)
            batch = {"im": torch.from_numpy(small_im).to(where),
                     "label": torch.from_numpy(labels).to(where)}
            bank = None
            if with_bank:
                bank = shape_bank.ShapeBank.from_arrays(pc_verts, pc_counts, 100, where)
                batch.update({k: torch.from_numpy(v).to(where) for k, v in ref.items()})
            else:
                batch["shape"] = torch.from_numpy(host_clouds).double().to(where)
            step = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True,
                                                 shape_bank=bank)
            return step(state, batch), [state.model]
        return run

    pc_err = card_vs_cpu(pc_teacher_step(True), ("loss", "pose_loss", "nce_loss"))
    pc_host = (pc_teacher_step(True)(dev)[0], pc_teacher_step(False)(dev)[0])
    pc_vs_host = max(abs(float(pc_host[0][k]) / float(pc_host[1][k]) - 1)
                     for k in ("loss", "pose_loss", "nce_loss"))

    mv_renders = sg.integers(0, 256, (3, 144, 32, 32, 3), dtype=np.uint8)
    mv_table = np.stack([T.multiview_ids(4, 2, m) for m in range(72)])
    mv_ref = {"shape_id": sg.integers(0, 3, 8), "shape_mut": sg.integers(0, 72, 8)}
    small_mv = convert.pose_state_dict(teacher_variables(np.random.default_rng(53), 64, 16,
                                                         view_num=4), "MultiView")

    def mv_teacher_step(with_bank):
        def run(where):
            model = PoseEstimator(shape="MultiView", view_num=4, img_feature_dim=64,
                                  shape_feature_dim=16)
            model.load_state_dict(small_mv, strict=True)
            state = create_train_state(model.double().to(where), LR, [100], seed=0)
            bank = shape_bank.RenderBank.from_arrays(mv_renders, mv_table, where)
            batch = {"im": torch.from_numpy(small_im).to(where),
                     "label": torch.from_numpy(labels).to(where)}
            ref_t = {k: torch.from_numpy(v).to(where) for k, v in mv_ref.items()}
            if with_bank:
                batch.update(ref_t)
            else:
                batch["shape"] = shape_bank.gather_renders(bank, ref_t["shape_id"],
                                                           ref_t["shape_mut"]).double()
            step = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True,
                                                 shape_bank=bank if with_bank else None)
            return step(state, batch), [state.model]
        return run

    mv_err = card_vs_cpu(mv_teacher_step(True), ("loss", "pose_loss", "nce_loss"))
    mv_host = (mv_teacher_step(True)(dev)[0], mv_teacher_step(False)(dev)[0])
    mv_vs_host = max(abs(float(mv_host[0][k]) / float(mv_host[1][k]) - 1)
                     for k in ("loss", "pose_loss", "nce_loss"))

    s_small = convert.baseline_state_dict(student_variables(np.random.default_rng(54), 64,
                                                            0.25, 32))
    kd_small = kd_batch(np.random.default_rng(55), 4, 32, 100)
    kd_raw = {"im": sg.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
              "rot_sign": np.array([1.0, -1.0, -1.0, 1.0], np.float32),
              "valid": np.arange(4) < 3,
              **{k: kd_small[k] for k in ("label", "label_flip", "label_rot", "shape")}}
    kd_draws = augment.augment_draws(12, torch.Generator().manual_seed(55), cpu)

    def kd_views_step(where):
        model = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                  dropout_rate=0.0)
        model.load_state_dict(s_small, strict=True)
        state = create_train_state(model.double().to(where), LR, [100], seed=0)
        teacher = PoseEstimator(img_feature_dim=64, shape_feature_dim=64)
        teacher.load_state_dict(small_t, strict=True)
        teacher = teacher.to(where).eval().requires_grad_(False)
        batch = {k: torch.from_numpy(v).to(where) for k, v in kd_raw.items()}
        step = steps.make_kd_crd_step(device_views=True)
        return step(state, teacher, batch, aug={k: v.to(where) for k, v in kd_draws.items()}), \
            [state.model]

    kd_err = card_vs_cpu(kd_views_step, ("loss", "gt_loss"))

    small_v = convert.pose_vanilla_state_dict(vanilla_variables(np.random.default_rng(56), 64,
                                                                64))

    def stage1_bank_step(where):
        teacher = PoseEstimatorVanilla(img_feature_dim=64, shape_feature_dim=64)
        teacher.load_state_dict(small_v, strict=True)
        student = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                    dropout_rate=0.0)
        student.load_state_dict(s_small, strict=True)
        t_state = create_train_state(teacher.double().to(where), LR, [100], seed=1)
        s_state = create_train_state(student.double().to(where), LR, [100], seed=2)
        bank = shape_bank.ShapeBank.from_arrays(pc_verts, pc_counts, 100, where)
        batch = {"im": torch.from_numpy(kd_small["im"]).double().to(where),
                 "label": torch.from_numpy(kd_small["label"]).to(where),
                 **{k: torch.from_numpy(v[:4]).to(where) for k, v in ref.items()}}
        step = steps.make_stage1_step(use_fused_nce=True, shape_bank=bank)
        keep = [torch.ones((4, 200), dtype=torch.bool, device=where)] * 2
        return step(t_state, s_state, batch, keep=keep), [t_state.model, s_state.model]

    s1_err = card_vs_cpu(stage1_bank_step, ("loss", "teacher_loss"))
    if pc_vs_host > 2e-5 or mv_vs_host > 1e-6:
        raise RuntimeError(f"bank steps vs host steps on the card: PointCloud {pc_vs_host:.3g} "
                           f"(tol 2e-5), MultiView {mv_vs_host:.3g} (tol 1e-6)")
    phase("device data steps", t0, "card vs CPU (losses rel, gradients max|d|/max|ref|, "
          "running statistics max|d|; tol " f"{STEP_LOSS_RTOL}, {STEP_GRAD_TOL}, 1e-5): "
          + "; ".join(f"{name} {e[0]:.3g} / {e[1]:.3g} / {e[2]:.3g}" for name, e in (
              ("PointCloud teacher step with a ShapeBank (100 of 100 vertices)", pc_err),
              ("MultiView teacher step with a RenderBank", mv_err),
              ("KD --crd --device_views with given draws", kd_err),
              ("--stage 1 with a ShapeBank", s1_err)))
          + f"; on the card the bank steps' losses against the host-shape steps': PointCloud "
          f"{pc_vs_host:.3g} rel (tol 2e-5: the subset in another order, normalised in f32), "
          f"MultiView {mv_vs_host:.3g} (tol 1e-6: the same renders)")

    # 53. the CLIs on generated files at full width with the options, then
    # the train loaders and the steps with and without them, in turns
    fixture = tempfile.TemporaryDirectory()
    roots = write_fixtures(fixture.name, np.random.default_rng(57))
    write_clouds(roots["train"], np.random.default_rng(58))
    pc_ckpt = os.path.join(fixture.name, "pc_teacher.pth")
    pc_sd = convert.pose_state_dict(teacher_variables(np.random.default_rng(59), 1024, 1024))
    torch.save({"state_dict": pc_sd}, pc_ckpt)
    cwd = os.getcwd()
    os.chdir(fixture.name)
    peaks, cli = {}, {}
    try:
        data = ["--dataset", "ObjectNet3D", "--data_root", roots["train"], "--workers", "8",
                "--decrease", "100"]
        mv_flags = data + ["--shape", "MultiView", "--batch_size", "32", "--fused_nce",
                           "--print_freq", "100"]
        pc_flags = data + ["--shape", "PointCloud", "--shape_dir", "pointcloud",
                           "--batch_size", str(KD_BATCH)]

        def metrics_of(path):
            with open(os.path.join(path, "metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        def cli_run(main, argv, name):
            torch.cuda.reset_peak_memory_stats()
            _, c, c16, p16 = drive(lambda: quiet(main, argv))
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
            return c, c16, p16

        opts = ["--device_shapes", "--device_augment"]
        cli["mv"] = cli_run(training_cli.main, mv_flags + opts + ["--n_epoch", "1"], "mv")
        cli["mv resume"] = cli_run(training_cli.main, mv_flags + opts + ["--n_epoch", "2",
                                                                          "--resume"], "mv")
        cli["mv bf16"] = cli_run(training_cli.main, mv_flags + opts + [
            "--n_epoch", "1", "--bf16", "--result_dir", "result_bf16"], "mv bf16")
        mv_records = metrics_of(os.path.join("result", "MultiView_ObjectNet3D"))
        mv16_records = metrics_of(os.path.join("result_bf16", "MultiView_ObjectNet3D"))
        kd_opts = ["--crd", "--device_views", "--device_shapes", "--teacher_model", pc_ckpt]
        cli["kd"] = cli_run(kd_cli.main, pc_flags + kd_opts + ["--n_epoch", "1"], "kd")
        cli["kd resume"] = cli_run(kd_cli.main, pc_flags + kd_opts + ["--n_epoch", "2",
                                                                       "--resume"], "kd")
        cli["kd bf16"] = cli_run(kd_cli.main, pc_flags + kd_opts + [
            "--n_epoch", "1", "--bf16", "--result_dir", "result_bf16"], "kd bf16")
        kd_records = metrics_of(os.path.join("result", "KD_ObjectNet3D"))
        kd16_records = metrics_of(os.path.join("result_bf16", "KD_ObjectNet3D"))
        s1_flags = pc_flags + ["--stage", "1", "--device_shapes", "--fused_nce",
                               "--shape_feature_dim", str(STAGE1_SHAPE_DIM), "--n_epoch", "1",
                               "--result_dir", "result_s1"]
        cli["stage1"] = cli_run(kd_cli.main, s1_flags, "stage1")
        s1_records = metrics_of(os.path.join("result_s1", "KD_ObjectNet3D"))
        tested = {}

        def test_both():
            for name, flags, model in (
                    ("PointCloud", ["--shape", "PointCloud", "--shape_dir", "pointcloud",
                                    "--shape_feature_dim", "1024"], pc_ckpt),
                    ("MultiView", ["--shape", "MultiView"],
                     os.path.join("result", "MultiView_ObjectNet3D", "ckpt", "checkpoint.pth"))):
                for banked in (False, True):
                    tested[name, banked] = quiet(testing_cli.main, (
                        data[:4] + flags + ["--model", model, "--batch_size", "32",
                                            "--workers", "8", "--output_dir",
                                            os.path.join(fixture.name, f"preds_{name}")]
                        + (["--device_shapes"] if banked else [])))

        _, test_c, _, _ = drive(test_both)
        cli["testing"] = (test_c,)
    finally:
        os.chdir(cwd)
    expected = {"mv": (2, 0, 3, 3, 0, 0, 0, 0), "mv resume": (2, 0, 3, 3, 0, 0, 0, 0),
                "mv bf16": (2, 0, 3, 3, 0, 0, 0, 0), "kd": (1, 2, 0, 0, 3, 2, 0, 0),
                "kd resume": (1, 2, 0, 0, 3, 2, 0, 0), "kd bf16": (1, 0, 0, 0, 0, 0, 0, 0),
                "stage1": (1, 1, 4, 4, 2, 2, 2, 2), "testing": (4, 2, 0, 0, 0, 0, 0, 0)}
    got = {k: v[0] for k, v in cli.items()}
    if got != expected or cli["kd bf16"][1] != (3, 2, 2):
        raise RuntimeError(f"device data CLIs: launches {got} (bf16 KD {cli['kd bf16'][1]}), "
                           f"expected {expected} (bf16 KD (3, 2, 2))")
    records = {"mv": mv_records, "mv bf16": mv16_records, "kd": kd_records,
               "kd bf16": kd16_records, "stage1": s1_records}
    if [r["epoch"] for r in mv_records] != [0, 1] or [r["epoch"] for r in kd_records] != [0, 1] \
            or not all(math.isfinite(r["train_loss"]) for rs in records.values() for r in rs):
        raise RuntimeError(f"device data CLIs: records {records}")
    # the MultiView bank's renders are the files' bit for bit; a PointCloud
    # bank samples other subsets than the host, so only its rows are held
    for name in ("PointCloud", "MultiView"):
        host, banked = tested[name, False], tested[name, True]
        diff = float(np.abs(host.errors - banked.errors).max())
        if len(banked.cat_ids) != len(host.cat_ids) or not np.all(np.isfinite(banked.errors)) \
                or (name == "MultiView" and diff > 1e-3):
            raise RuntimeError(f"testing --device_shapes ({name}) vs host shapes: rows "
                               f"{len(banked.cat_ids)} / {len(host.cat_ids)}, errors max|d| "
                               f"{diff}")
    mv_test_diff = float(np.abs(tested["MultiView", False].errors
                                - tested["MultiView", True].errors).max())
    phase("device data CLIs", t0, "launches (geodesic, pointnet, NCE fwd, bwd, stem fwd, bwd, "
          "train-mode pointnet fwd, bwd): " + "; ".join(f"{k} {v}" for k, v in got.items())
          + f"; bf16 KD (stem fwd, bwd, pointnet) {cli['kd bf16'][1]}; train samples/s: "
          + "; ".join(f"{k} {[round(r['train_samples'] / r['train_seconds'], 1) for r in rs]}"
                      for k, rs in records.items())
          + "; peak GiB allocated: " + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
          + f"; testing --device_shapes vs host shapes: PointCloud Med_Err "
          f"{tested['PointCloud', True].sample_med:.3f} / "
          f"{tested['PointCloud', False].sample_med:.3f} (other {POINT_NUM}-point subsets of "
          f"{DD_CLOUD_VERTICES}), MultiView errors max|d| {mv_test_diff:.3g} deg (tol 1e-3) "
          f"[{card}]")

    # the train loaders alone, with and without the options, in turns (host,
    # options, options, host): the MultiView teacher's (host: 12 PNG renders
    # and three JPEG views decoded and augmented a sample) and KD --crd's
    # (host: three views and a 2,500-point subset a sample)
    def train_sets(options):
        mv_opt = training_cli.parse_args(mv_flags)
        mv_ds = cli_common.build_train_eval_datasets(mv_opt)[0]
        kd_opt = kd_cli.parse_args(pc_flags + ["--crd"])
        kd_ds = cli_common.build_kd_datasets(kd_opt)[0]
        if options:
            mv_ds.host_augment, mv_ds.device_shapes = False, True
            kd_ds.device_views, kd_ds.device_shapes = True, True
        return {"mv": (mv_ds, mv_opt), "kd": (kd_ds, kd_opt)}

    os.chdir(fixture.name)
    try:
        sets = {False: train_sets(False), True: train_sets(True)}
        rates = {(k, o): [] for k in ("mv", "kd") for o in (False, True)}
        for options in (False, True, True, False):
            for k, (ds, opt) in sets[options].items():
                rates[k, options].append(loader_rate(cli_common.make_train_loader(ds, opt)))
        first = {(k, o): next(iter(cli_common.make_train_loader(ds, opt)))
                 for o in (False, True) for k, (ds, opt) in sets[o].items()}
        banks = {"mv": shape_bank.RenderBank.from_arrays(
                     *sets[True]["mv"][0].build_render_bank(), dev),
                 "kd": shape_bank.ShapeBank.from_arrays(
                     *sets[True]["kd"][0].build_shape_bank(), POINT_NUM, dev)}
    finally:
        os.chdir(cwd)
        fixture.cleanup()
    bank_mb = {k: b.nbytes / 2**20 for k, b in banks.items()}

    def pinned(batch, keys):
        return {k: torch.from_numpy(np.ascontiguousarray(host_array(batch[k]))).pin_memory()
                for k in keys if k in batch}

    mv_keys = ("im", "label", "shape", "shape_id", "shape_mut")
    kd_keys = ("im", "im_flip", "im_rot", "label", "label_flip", "label_rot", "rot_sign",
               "shape", "shape_id", "shape_rot", "shape_seed")
    wire = {(k, o): pinned(first[k, o], mv_keys if k == "mv" else kd_keys)
            for k in ("mv", "kd") for o in (False, True)}
    wire_mb = {key: sum(v.nbytes for v in b.values()) / 2**20 for key, b in wire.items()}
    mv_model = PoseEstimator(shape="MultiView", view_num=MV_VIEWS, img_feature_dim=1024,
                             shape_feature_dim=MV_SHAPE_DIM,
                             generator=torch.Generator().manual_seed(60)).to(dev)
    mv_state = create_train_state(mv_model, LR, [10**9], seed=60)
    student = BaselineEstimator(generator=torch.Generator().manual_seed(61)).to(dev)
    kd_state = create_train_state(student, LR, [10**9], seed=61)
    pc_teacher = PoseEstimator(img_feature_dim=1024, shape_feature_dim=1024)
    pc_teacher.load_state_dict(pc_sd, strict=True)
    pc_teacher = pc_teacher.to(dev).eval().requires_grad_(False)
    runs = {
        ("mv", False): (lambda b: steps.make_teacher_train_step(use_fused_nce=True)(
            mv_state, b), [mv_state.model]),
        ("mv", True): (lambda b: steps.make_teacher_train_step(
            use_fused_nce=True, device_augment=True, shape_bank=banks["mv"])(mv_state, b),
            [mv_state.model]),
        ("kd", False): (lambda b: steps.make_kd_crd_step()(kd_state, pc_teacher, b),
                        [kd_state.model, pc_teacher]),
        ("kd", True): (lambda b: steps.make_kd_crd_step(
            device_views=True, shape_bank=banks["kd"])(kd_state, pc_teacher, b),
            [kd_state.model, pc_teacher]),
    }

    def on_card(key):
        step, _ = runs[key]
        return lambda: step({k: v.to(dev, non_blocking=True) for k, v in wire[key].items()})

    step_t, busy, step_peak = {}, {}, {}
    for dtype in ("f32", "bf16"):
        for key, (_, models) in runs.items():
            for m in models:
                set_compute_dtype(m, torch.bfloat16 if dtype == "bf16" else None)
        for options in (False, True, True, False):
            for k in ("mv", "kd"):
                steps_ms(on_card((k, options)), steps=1)  # its allocations, untimed
                torch.cuda.reset_peak_memory_stats()
                step_t.setdefault((k, options, dtype), []).append(
                    steps_ms(on_card((k, options)), steps=4))
                step_peak[k, options, dtype] = torch.cuda.max_memory_allocated() / 2**30
        for key in runs:
            _, device_ms, wall_ms = profile_steps(on_card(key))
            busy[(*key, dtype)] = device_ms / wall_ms
    for _, models in runs.values():
        for m in models:
            set_compute_dtype(m, None)
    del mv_state, kd_state, pc_teacher, runs, banks, wire
    torch.cuda.empty_cache()
    names = {"mv": f"MultiView teacher step (batch 32, --fused_nce; options --device_shapes "
                   f"--device_augment, render bank {bank_mb['mv']:.1f} MiB)",
             "kd": f"KD --crd step from the PointCloud teacher (batch {KD_BATCH} x 3 views; "
                   f"options --device_views --device_shapes, cloud bank "
                   f"{bank_mb['kd']:.2f} MiB)"}
    for k, what in names.items():
        phase("time", t0, f"{what}: the train loader alone (8 threads) host "
              f"{[round(v, 1) for v in rates[k, False]]}, options "
              f"{[round(v, 1) for v in rates[k, True]]} samples/s; the batch on the wire host "
              f"{wire_mb[k, False]:.2f} MiB, options {wire_mb[k, True]:.2f} MiB; the step with "
              f"its batch's copy from pinned memory, ms: " + "; ".join(
                  f"{dtype} host {[round(v, 3) for v in step_t[k, False, dtype]]} (busy "
                  f"{busy[k, False, dtype]:.3f}, peak {step_peak[k, False, dtype]:.2f} GiB), "
                  f"options {[round(v, 3) for v in step_t[k, True, dtype]]} (busy "
                  f"{busy[k, True, dtype]:.3f}, peak {step_peak[k, True, dtype]:.2f} GiB)"
                  for dtype in ("f32", "bf16")) + f" [{card}]")
    return added, added16, added_pt16


def aot_phases(dev, card: str, t0: float, reset_counts, counts, bf16_counts):
    """Phases 54-55: exported serving (`serving/aot.py`). 54: the student
    (2048, 224), the PointCloud teacher (1024/1024, 2,500 points) and the
    MultiView teacher (1024/256, 12 renders of 224) each exported on the
    card in f32, bf16 and int8 (`torch.export`, the batch symbolic), saved,
    reloaded to the card and served (the student at 1, 64 and 256 from one
    file, the teachers at 1 and 64): the stem, the eval PointNet and the
    int8 convolution run as custom ops, each artifact's launches counted
    (exactly its hand kernels' per-call launches, none from a plain
    version), its predictions held against the eager model on the card, its
    time beside eager's in turns by CUDA events; the f32 student's and the
    f32 PointCloud teacher's files also loaded to the CPU and held against
    the CPU eager model (the canary). 55: `inference --export_aot` then
    `--load_aot` for the three families on generated files, the two
    predictions equal. Each serving path is driven with the counts set to 0
    just before it and read just after it. Returns (the int8 kernel's
    launches, the other kernels' launches as `counts` orders them and as
    `bf16_counts` does)."""
    from pose3d_tpu_torch import geometry, serving
    from pose3d_tpu_torch.cli import inference as inference_cli
    from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
    from pose3d_tpu_torch.ops import int8_conv as i8
    from pose3d_tpu_torch.serving import aot
    from pose3d_tpu_torch.train import convert

    added, added16, launched = [0] * 8, [0] * 3, 0
    copies0 = i8.int8_conv.weight_copies  # none: an artifact keeps its leaves' K-major storage
    # the launches one artifact call makes, by (family, dtype): (counts()
    # index or "bf16" index, per call), and the int8 kernel's
    expect = {("student", "f32"): ({4: 1}, {}, 0), ("student", "bf16"): ({}, {0: 1}, 0),
              ("student", "int8"): ({}, {0: 1}, 10),
              ("PointCloud", "f32"): ({1: 1}, {}, 0), ("PointCloud", "bf16"): ({}, {2: 1}, 0),
              ("PointCloud", "int8"): ({1: 1}, {}, 52),
              ("MultiView", "f32"): ({}, {}, 0), ("MultiView", "bf16"): ({}, {}, 0),
              ("MultiView", "int8"): ({}, {}, 52 + 19)}

    def take(key, calls):
        """The launches since reset_counts(), held to `calls` artifact
        calls' worth and added up."""
        nonlocal launched
        torch.cuda.synchronize()
        f32_want, bf16_want, i8_want = expect[key]
        got = (counts(), bf16_counts(), i8.int8_conv.launches)
        want = (tuple(f32_want.get(i, 0) * calls for i in range(8)),
                tuple(bf16_want.get(i, 0) * calls for i in range(3)), i8_want * calls)
        if got != want:
            raise RuntimeError(f"{key} artifact: launches {got}, expected {want}")
        added[:] = [a + b for a, b in zip(added, got[0])]
        added16[:] = [a + b for a, b in zip(added16, got[1])]
        launched += got[2]
        return got

    s_sd = convert.baseline_state_dict(student_variables(np.random.default_rng(54),
                                                         input_dim=AOT_IMAGE))
    t_sd = convert.pose_state_dict(teacher_variables(np.random.default_rng(55), 1024, 1024))
    mv_sd = convert.pose_state_dict(teacher_variables(np.random.default_rng(56), 1024,
                                                      MV_SHAPE_DIM, view_num=MV_VIEWS),
                                    "MultiView")

    def built(cls, sd, device, **kw):
        with torch.device("meta"):
            m = cls(**kw)
        m.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True, assign=True)
        return m.eval().requires_grad_(False)

    kw = {"student": dict(input_dim=AOT_IMAGE),
          "PointCloud": dict(img_feature_dim=1024, shape_feature_dim=1024),
          "MultiView": dict(shape="MultiView", view_num=MV_VIEWS, img_feature_dim=1024,
                            shape_feature_dim=MV_SHAPE_DIM)}
    sds = {"student": s_sd, "PointCloud": t_sd, "MultiView": mv_sd}
    image = (AOT_IMAGE, AOT_IMAGE, 3)
    per_sample = {"student": (image,), "PointCloud": (image, (POINT_NUM, 3)),
                  "MultiView": (image, (MV_VIEWS, *image))}
    batches = {"student": AOT_STUDENT_BATCHES, "PointCloud": AOT_TEACHER_BATCHES,
               "MultiView": AOT_TEACHER_BATCHES}
    gen = torch.Generator(device=dev).manual_seed(54)

    def inputs(family, b):
        x = [torch.randn((b, *image), generator=gen, device=dev)]
        if family != "student":
            x.append(torch.rand((b,) + per_sample[family][1], generator=gen, device=dev))
        return x

    def decode(outputs):
        outputs = [o.float() for o in outputs]
        return geometry.decode_predictions_inference(outputs[:3], outputs[3:], 15)

    lines, ops_seen, files = [], {}, {}
    tmp = tempfile.TemporaryDirectory()
    for family in ("student", "PointCloud", "MultiView"):
        cls = BaselineEstimator if family == "student" else PoseEstimator
        model = built(cls, sds[family], dev, **kw[family])
        ins = {b: inputs(family, b) for b in batches[family]}
        big = max(ins)
        calib = [a.cpu().numpy() for a in ins[big]]  # on the requests, as the CLI does
        if family == "student":
            q = serving.quantize_student(model, calib[:1])
        elif family == "MultiView":
            q = serving.quantize_teacher_mv(model, calib[:1], [calib[1][:16]])
        else:
            q = serving.quantize_teacher_resnet(model, calib[:1])
        for dtype in ("f32", "bf16", "int8"):
            set_compute_dtype(model, torch.bfloat16 if dtype == "bf16" else None)
            if dtype == "int8":
                fn = (aot.student_int8_decode_fn(q, 15) if family == "student"
                      else aot.teacher_int8_decode_fn(model, q, 15))
                infer = ((lambda x: decode(serving.student_int8_infer(q, x)))
                         if family == "student" else
                         (lambda x, s: decode(serving.make_teacher_int8_infer(model)(q, x, s))))
            else:
                fn = (aot.student_decode_fn(model, 15) if family == "student"
                      else aot.teacher_decode_fn(model, 15))
                infer = model.predict_viewpoint
            te = time.perf_counter()
            program = aot.export_fn(fn, per_sample[family])
            export_s = time.perf_counter() - te
            if dtype == "f32":
                ops_seen[family] = sorted({str(n.target).rsplit(".", 1)[0].replace("aten.", "")
                                           for n in program.graph.nodes
                                           if n.op == "call_function"})
            path = os.path.join(tmp.name, f"{family}_{dtype}.pt2")
            tl = time.perf_counter()
            aot.save_serving(program, path, kind=family, dtype=dtype,
                             tour=2 if family == "MultiView" else None)
            del program
            art = aot.load_serving(path, dev)
            load_s = time.perf_counter() - tl
            reset_counts()
            served = {b: art(*x) for b, x in ins.items()}
            take((family, dtype), len(ins))
            with torch.no_grad():
                eager = {b: infer(*x) for b, x in ins.items()}
            equal, worst = 0, 0.0
            for b in ins:
                g, w = served[b], eager[b]
                if tuple(g.shape) != (b, 3) or not torch.isfinite(g).all():
                    raise RuntimeError(f"{family} {dtype} artifact at {b}: {g.shape}")
                equal += bool(torch.equal(g, w))
                d = float((g - w).abs().max() / max(1.0, float(w.abs().max())))
                worst = max(worst, d)
                if d > AOT_TOL[dtype]:
                    raise RuntimeError(f"{family} {dtype} artifact at {b}: {d:.3g} of "
                                       f"max|eager| from the eager model (> {AOT_TOL[dtype]})")
            times = {}
            for b, iters in ((big, 3), (1, 10)):
                t = {"eager": [], "artifact": []}
                for who in ("eager", "artifact", "artifact", "eager"):
                    run = (lambda: art(*ins[b])) if who == "artifact" else \
                        (lambda: infer(*ins[b]))
                    with torch.no_grad():
                        t[who].append(round(cuda_ms(run, iters, warmup=1), 4))
                times[b] = t
            lines.append(f"{family} {dtype}: export {export_s:.2f} s, "
                         f"{os.path.getsize(path) / 2**20:.1f} MiB, save + load {load_s:.2f} s; "
                         f"batches {list(ins)} equal to eager in {equal} of {len(ins)} "
                         f"(largest {worst:.3g} of max|eager|); ms {times}")
            if dtype == "f32" and family != "MultiView":
                files[family] = path
            else:
                os.remove(path)
            del art, served, eager
        if family in files:
            # the canary: the same file on the CPU against the CPU eager model
            cpu_model = built(cls, sds[family], "cpu", **kw[family])
            cpu_in = [a[:2].cpu() for a in ins[big]]
            got = aot.load_serving(files[family], "cpu")(*cpu_in)
            with torch.no_grad():
                want = cpu_model.predict_viewpoint(*cpu_in)
            card_got = aot.load_serving(files[family], dev)(*[a[:2] for a in ins[big]]).cpu()
            d = float((got - want).abs().max())
            dc = float((card_got - got).abs().max() / max(1.0, float(got.abs().max())))
            if d > AOT_TOL["f32"] * max(1.0, float(want.abs().max())) or dc > AOT_TOL["f32"]:
                raise RuntimeError(f"{family} canary: CPU artifact {d:.3g} from CPU eager, "
                                   f"card {dc:.3g} of max from CPU")
            lines.append(f"{family} f32 file on the CPU: equal to the CPU eager model "
                         f"{torch.equal(got, want)} (max|d| {d:.3g}); card against CPU "
                         f"{dc:.3g} of max|ref|")
            os.remove(files[family])
            del cpu_model
        del model, ins, q
        torch.cuda.empty_cache()
    tmp.cleanup()
    phase("exported serving", t0, "; ".join(lines) + f"; f32 graphs' call_function targets: "
          f"{ops_seen} [{card}]")

    # 55. the CLI on generated files: --export_aot, then --load_aot with no
    # --ckpt and no geometry flags
    from PIL import Image

    cwd = os.getcwd()
    rng = np.random.default_rng(57)
    vps = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            Image.fromarray((rng.random((256, 256, 3)) * 255).astype(np.uint8)).save("im.jpg")
            verts = rng.standard_normal((DD_CLOUD_VERTICES, 3)).astype("<f4")
            with open("cloud.ply", "wb") as f:
                f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex %d\n"
                        b"property float x\nproperty float y\nproperty float z\nend_header\n"
                        % DD_CLOUD_VERTICES + verts.tobytes())
            os.makedirs("crop")
            for k in range(216):  # two rings of 72 and one more; 12 renders distinct
                if k < 12:
                    Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8)).save(
                        f"crop/render_{k:03d}.png")
                else:
                    with open(f"crop/render_{k % 12:03d}.png", "rb") as src, \
                            open(f"crop/render_{k:03d}.png", "wb") as dst:
                        dst.write(src.read())
            model_flags = {"student": [], "PointCloud": [],
                           "MultiView": ["--shape_feature_dim", str(MV_SHAPE_DIM),
                                         "--view_num", str(MV_VIEWS)]}
            for family, shape_flags in (("student", []),
                                        ("PointCloud", ["--ply_path", "cloud.ply"]),
                                        ("MultiView", ["--render_dir", "crop"])):
                torch.save({"state_dict": sds[family]}, f"{family}.pth")
                base = ["--img_path", "im.jpg", *shape_flags]
                reset_counts()
                tc = time.perf_counter()
                live = quiet(inference_cli.main, base + [
                    "--ckpt", f"{family}.pth", "--input_dim", str(AOT_IMAGE), *model_flags[family],
                    "--export_aot", f"{family}.pt2"])
                served = quiet(inference_cli.main, base + ["--load_aot", f"{family}.pt2"])
                take((family, "f32"), 2)  # the live forward and the served one
                if not (np.array_equal(live, served) and np.all(np.isfinite(live))):
                    raise RuntimeError(f"inference --export_aot / --load_aot, {family}: "
                                       f"{live} against {served}")
                vps[family] = (np.round(live, 2).tolist(), round(time.perf_counter() - tc, 2),
                               round(os.path.getsize(f"{family}.pt2") / 2**20, 1))
                os.remove(f"{family}.pth")
                os.remove(f"{family}.pt2")
        finally:
            os.chdir(cwd)
    phase("exported serving CLI", t0, "inference --export_aot then --load_aot (no --ckpt, no "
          "geometry flags), the same prediction both times (prediction, seconds of both runs, "
          f"MiB): {vps} [{card}]")
    if i8.int8_conv.weight_copies != copies0:
        raise RuntimeError(f"exported int8 artifacts copied weights K-major on a call "
                           f"{i8.int8_conv.weight_copies - copies0} times")
    return launched, added, added16


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--source", action="append", default=[], type=parse_source,
                    metavar="NAME=FILE",
                    help="another version of csrc/NAME.cu (info_nce, vgg_stem, pointnet_eval, "
                    "int8_conv or pointnet_train; an earlier commit's, with the same C "
                    "interface, pointnet_eval as of d190092, or int8_conv with the HWIO, "
                    "pool-less interface) to time beside this one: info_nce in phases 18 and "
                    "26, vgg_stem in phases 22, 33 and 37, pointnet_eval in phase 13, int8_conv "
                    "in phase 45, "
                    "pointnet_train's bf16 instance in phases 39 and 40; repeatable")
    ap.add_argument("--phase39_only", action="store_true",
                    help="build the libraries, run phase 39 (the bf16 train-mode PointNet "
                    "against its plain version, its times and passes, each --source "
                    "pointnet_train= build in turns) and stop, without the result line")
    args = ap.parse_args()
    t0 = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from pose3d_tpu_torch import geometry
    from pose3d_tpu_torch.cli import common as cli_common
    from pose3d_tpu_torch.models.estimators import (BaselineEstimator, PoseEstimator,
                                                    PoseEstimatorVanilla)
    from pose3d_tpu_torch.data.loader import DataLoader
    from pose3d_tpu_torch.ops import (_build, geodesic, int8_conv, nce, pointnet, pointnet_train,
                                      vgg_stem)
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
        vgg_stem.stem_forward.bf16_launches = vgg_stem.stem_backward.bf16_launches = 0
        pointnet.pointnet_eval_bf16.launches = 0
        pointnet_train.train_forward_bf16.launches = 0
        pointnet_train.train_backward_bf16.launches = 0
        int8_conv.int8_conv.launches = 0

    def counts():
        """(geodesic, pointnet, NCE forward, NCE backward, stem forward,
        stem backward, train-mode pointnet forward, its backward) launches."""
        return (geodesic.rotation_err.launches, pointnet.pointnet_eval.launches,
                nce.nce_forward.launches, nce.nce_backward.launches,
                vgg_stem.stem_forward.launches, vgg_stem.stem_backward.launches,
                pointnet_train.train_forward.launches, pointnet_train.train_backward.launches)

    def bf16_counts():
        """The bf16 instances' launches: (stem forward, stem backward, eval
        pointnet)."""
        return (vgg_stem.stem_forward.bf16_launches, vgg_stem.stem_backward.bf16_launches,
                pointnet.pointnet_eval_bf16.launches)

    def pt16_counts():
        """The train-mode PointNet's bf16 instance's launches: (forward,
        backward)."""
        return (pointnet_train.train_forward_bf16.launches,
                pointnet_train.train_backward_bf16.launches)

    def blocked_counts():
        """NCE forward and backward launches for the blocked entries (JAX's
        kernel 5, nce_blocked.py)."""
        return nce.nce_forward.blocked_launches, nce.nce_backward.blocked_launches

    card = card_line()
    # the CLIs' settings: TF32 off for cuDNN and matmuls, bf16 GEMMs reduced
    # in float32
    dev = cli_common.setup_device(argparse.Namespace(device="cuda"))
    phase("device", t0, f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for cuDNN and matmul, cuBLAS's reduced-precision bf16 reductions off")

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
          f"{pointnet.shared_memory_bytes()} bytes of dynamic shared memory a block (its "
          f"bf16 instance {pointnet.shared_memory_bytes(torch.bfloat16)}); "
          f"info_nce at D 200 (forward, backward): {nce.shared_memory_bytes(200)} bytes; "
          f"vgg_stem at F 64 (forward, weight gradient): "
          f"{vgg_stem.shared_memory_bytes(64)} bytes (bf16 "
          f"{vgg_stem.shared_memory_bytes(64, torch.bfloat16)}); pointnet_train's largest block "
          f"(f32, f64): {pointnet_train.shared_memory_bytes()}, "
          f"{pointnet_train.shared_memory_bytes(torch.float64)} bytes; CUDA launches a "
          f"forward and a backward call, as the libraries report them: pointnet_train "
          f"{pointnet_train.kernel_launches_per_call()}, info_nce "
          f"{nce.kernel_launches_per_call()}")
    if args.phase39_only:
        pt16_phase(dev, card, t0, libs[4], other_libs["pointnet_train"], torch.cuda.Stream())
        phase("total", t0, "phase 39 alone (--phase39_only): no result line")
        return 0

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
    # pass. Layer 3 runs on the tensor cores: HMMA (mma.sync) in the f32
    # encoder's SASS only (the bf16 encoder's wgmma, HGMMA: phase 34)
    hmma = sass_hmma(libs[1], "pne_")
    want = {"pne_split_w3_kernel": False, "pne_encoder_kernel": True,
            "pne_segment_max_kernel": False, "pne_pack_w3_bf16_kernel": False,
            "pne_encoder_bf16_kernel": False, "pne_segment_max_bf16_kernel": False}
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
    # kernels and the f32 weight gradient on the CUDA cores; the bf16
    # kernels (every instantiation: index or not, TMA or registers) on the
    # tensor cores
    hmma = sass_hmma(libs[3], "stem_", bools=True)
    want = {"stem_forward_tf32x3_kernel": True, "stem_wgrad_stream_kernel": False,
            "stem_forward_f64_kernel": False, "stem_wgrad_f64_kernel": False}
    want.update({f"stem_forward_bf16_kernel<{i},{t}>": True for i in (0, 1) for t in (0, 1)})
    want.update({f"stem_wgrad_bf16_kernel<{t}>": True for t in (0, 1)})
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
    from pose3d_tpu_torch.losses.memory_bank import MemoryBank, enqueue, init_memory_bank
    from pose3d_tpu_torch.train.ckpt import Checkpointer
    tr = time.perf_counter()
    s2_teacher = cli_common.build_vanilla(
        SimpleNamespace(img_feature_dim=1024, shape_feature_dim=STAGE1_SHAPE_DIM, bin_size=15,
                        shape="PointCloud", view_num=12), dev, s1_ckpt).requires_grad_(False)
    load_s = time.perf_counter() - tr
    same = all(torch.equal(v.cpu(), s1_teacher_sd[k])
               for k, v in s2_teacher.state_dict().items())
    if not same or s2_teacher.training:
        raise RuntimeError(f"stage 2: the teacher read from stage 1's checkpoint equal {same}, "
                           f"in train mode {s2_teacher.training}")
    del s1_teacher_sd
    # the same checkpoint read by the CLI's loader under --bf16 (phase 38)
    s2_teacher16 = cli_common.build_vanilla(
        SimpleNamespace(img_feature_dim=1024, shape_feature_dim=STAGE1_SHAPE_DIM, bin_size=15,
                        shape="PointCloud", view_num=12, bf16=True), dev,
        s1_ckpt).requires_grad_(False)
    if s2_teacher16.shape_encoder.compute_dtype != torch.bfloat16:
        raise RuntimeError("stage 2: the CLI's loader built no bf16 teacher under --bf16")
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

    # --- bf16 (--bf16): the stem's and the eval PointNet's bf16 instances,
    # then the paths that run on them at full width; each path's launches
    # of the bf16 kernels counted from 0, its time by CUDA events beside the
    # f32 path's in this run (the same weights, in turns), and what leads
    # its profile
    bf16 = torch.bfloat16

    def in_turns(models, run, iters):
        """ms of run() by CUDA events with `models` in f32 and in bf16
        compute, in turns (f32, bf16, bf16, f32); left in bf16."""
        times = {"f32": [], "bf16": []}
        for who in ("f32", "bf16", "bf16", "f32"):
            for m in models:
                set_compute_dtype(m, None if who == "f32" else bf16)
            times[who].append(round(cuda_ms(run, iters, warmup=1), 3))
        for m in models:
            set_compute_dtype(m, bf16)
        return times

    def leads(run, top=5) -> str:
        """A profile of one run(): its busy share and the rows that lead."""
        rows, device_ms, wall_ms = profile_steps(run, steps=1)
        return (f"busy {device_ms / wall_ms:.3f}; leads: " + "; ".join(
            f"{e.key[:56]} {100 * e.self_device_time_total / 1e3 / device_ms:.1f} %"
            for e in rows[:top]))

    def mean(v):
        return sum(v) / len(v)

    def pt16_in_step(run) -> str:
        """One bf16 step's busy share and the train-mode PointNet's bf16
        kernels' share of its device time (a one-step profile); with
        --source pointnet_train=, its ms by CUDA events with each build in
        turns (this source, other, other, this source)."""
        rows, device_ms, wall_ms = profile_steps(run, steps=1)
        pnb_ms = sum(e.self_device_time_total for e in rows if "pnb_" in e.key) / 1e3
        text = (f"{device_ms:.3f} ms device of {wall_ms:.3f} ms wall (busy "
                f"{device_ms / wall_ms:.3f}), the train-mode pointnet's bf16 kernels "
                f"{pnb_ms:.4f} ms of it")
        for src, lib in other_libs["pointnet_train"].items():
            turns = {"this source": [], src: []}
            for label, path in (("this source", None), (src, lib), (src, lib),
                                ("this source", None)):
                turns[label].append(round(using(pointnet_train, path,
                                                lambda: cuda_ms(run, 3, warmup=1)), 3))
            text += f"; ms a step in turns: {turns}"
        return text

    def kernel_in_step(run, others, swap, prefix: str, what: str) -> str:
        """A bf16 run's device time and busy share, and the share of it of
        the kernels whose names hold `prefix` (`what`), from a one-run
        profile, with this source's kernels and (--source) each other's in
        turns (this source, other, other, this source); swap(path, thunk)
        runs thunk with the kernels built from path (None: this source's)."""
        turns = {}
        for label in ("this source", *others, *others, "this source"):
            rows, device_ms, wall_ms = swap(others.get(label),
                                            lambda: profile_steps(run, steps=1))
            ms = sum(e.self_device_time_total for e in rows if prefix in e.key) / 1e3
            turns.setdefault(label, []).append(
                f"{device_ms:.3f} ms device ({what} {ms:.4f}) of {wall_ms:.3f} wall, "
                f"busy {device_ms / wall_ms:.3f}")
        return "; ".join(f"{k}: {v}" for k, v in turns.items())

    def stem16_in_step(run) -> str:
        return kernel_in_step(run, stem16_others, lambda p, f: using(vgg_stem, p, f),
                              "stem_", "the stem")

    def pn16_in_step(run) -> str:
        return kernel_in_step(run, other_libs["pointnet_eval"],
                              lambda p, f: with_pointnet_source(p, lambda _: f()),
                              "pne_", "the eval PointNet")

    # 33. the bf16 stem kernels vs their plain bf16 version on phase 5's
    # cases (the tied image and the bars too) and the TMA route's edges
    # (widths 232 and 40, a multiple of 8 with a partial last tile; one
    # 16 x 16 image; F 8 and 256 through the weight gradient): y within one
    # bf16 ulp of max|ref|, the window index equal where the plain version's
    # decision is more than an ulp clear and, on the tied and bars images,
    # wherever the plain version's window sums tie exactly between windows
    # equal on every weighed tap, dW and db within one ulp of the gradient
    # routed by the kernel's own index; both routes taken; a tensor-core
    # instruction (HMMA.16816.F32.BF16 or HGMMA) in every instantiation of
    # both bf16 kernels, none in the f32 weight-gradient stream or the f64
    # kernels
    tc = {needle: sass_hmma(libs[3], "stem_", needle=needle, bools=True)
          for needle in ("HMMA.16816.F32.BF16", "HGMMA")}
    tensor_cores = {k: tc["HMMA.16816.F32.BF16"][k] or tc["HGMMA"].get(k, False)
                    for k in tc["HMMA.16816.F32.BF16"]}
    bf16_kernels = [f"stem_forward_bf16_kernel<{i},{t}>" for i in (0, 1) for t in (0, 1)] + \
        [f"stem_wgrad_bf16_kernel<{t}>" for t in (0, 1)]
    if not all(tensor_cores.get(k) for k in bf16_kernels) or any(
            tensor_cores.get(k) for k in ("stem_wgrad_stream_kernel", "stem_forward_f64_kernel",
                                          "stem_wgrad_f64_kernel")):
        raise RuntimeError(f"vgg_stem SASS: a bf16 tensor-core instruction in {tensor_cores}")
    srng = np.random.default_rng(33)
    stem_cases = [(n_c, hw, f_c, "rand") for n_c in (1, 7, 138) for hw in (224, 64, 30)
                  for f_c in (16, 64)]
    stem_cases += [(7, 224, 64, "ties"), (7, 224, 64, "negative"), (7, 31, 8, "rand"),
                   (7, 64, 256, "rand"), (7, 224, 64, "bars")]
    stem_cases += STEM16_EDGE_CASES
    worst, routes, tie_checked = {}, {}, {}
    for case in stem_cases:
        x_s, w_s, b_s, g_s = stem_inputs(srng, *case, dev, dtype=bf16)
        routes[case] = vgg_stem.bf16_route(x_s.permute(0, 2, 3, 1))
        before = bf16_counts()
        r = stem_bf16_vs_plain(vgg_stem, x_s, w_s, b_s, g_s, ties=case[3] in ("ties", "bars"))
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(bf16_counts()[:2], before[:2]))
        if launched != (2, 1) or r["y_err"] > BF16_ULP or r["index_bad"] or r["tie_bad"] or \
                r["dw_err"] > BF16_ULP or r["db_err"] > BF16_ULP:
            raise RuntimeError(f"bf16 stem case {case} ({routes[case]} route): launches "
                               f"(forward, backward) {launched}, {r}")
        if case[3] in ("ties", "bars"):
            tie_checked[case[3]] = r["tie_checked"]
        worst = {k: max(worst.get(k, 0), v) for k, v in r.items()}
    del x_s, w_s, b_s, g_s
    if set(routes.values()) != {"tma", "registers"}:
        raise RuntimeError(f"bf16 stem cases: routes {routes}, want both")
    stem16_err, stem16_wgrad_err = worst["max_abs_err"], max(worst["dw_abs"], worst["db_abs"])
    phase("vgg_stem bf16", t0, f"kernels vs the plain bf16 version in {len(stem_cases)} cases "
          f"(phase 5's and {len(STEM16_EDGE_CASES)} of the TMA route's edges; routes "
          f"{sum(v == 'tma' for v in routes.values())} TMA, "
          f"{sum(v == 'registers' for v in routes.values())} registers): y max|d|/max|ref| "
          f"{worst['y_err']:.3g} (one ulp {BF16_ULP:.3g}), unequal share at most "
          f"{worst['y_unequal']:.3g}; window index unequal share at most "
          f"{worst['index_unequal']:.3g}, {worst['index_bad']} differing where the plain "
          f"version's decision is more than an ulp clear, {worst['tie_bad']} where its sums "
          f"tie exactly (windows equal on every weighed tap; outputs x channels checked "
          f"{tie_checked}); dW {worst['dw_err']:.3g} and db {worst['db_err']:.3g} of max|ref| "
          f"given the kernel's index (tol one ulp; max|d| {worst['dw_abs']:.3g} and "
          f"{worst['db_abs']:.3g}); cuobjdump -sass: HMMA.16816.F32.BF16 or HGMMA in "
          f"{tensor_cores}")
    # times at the KD shape (138, 224, 224) F 64: the kernels by CUDA graph
    # replay, this source and (--source vgg_stem=...) the others' in turns
    # (this, others, others reversed, this), serving also at (256, 224,
    # 224); the plain version by CUDA events; the forward with indices also
    # on the tied and bars images
    stem16_others = other_libs["vgg_stem"]
    side16 = torch.cuda.Stream()
    whos16 = ("this source", *stem16_others)
    stem16_runs, stem16_serve_bounds = {}, {}
    for n_s in (3 * KD_BATCH, 256):
        x_s, w_s, b_s, g_s = stem_inputs(np.random.default_rng(25), n_s, 224, 64, "rand", dev,
                                         dtype=bf16)
        x_nhwc, w_d, b_d = x_s.permute(0, 2, 3, 1), w_s.detach(), b_s.detach()
        _, index = vgg_stem.stem_forward(x_nhwc, w_d, b_d, with_index=True)
        fns = {"forward, serving": lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, False)}
        if n_s == 3 * KD_BATCH:
            fns["forward"] = lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, True)
            fns["backward"] = lambda: vgg_stem.stem_backward(x_nhwc, index, g_s)
        for order in (whos16, whos16[::-1]):
            for who in order:
                path = stem16_others.get(who)
                for part, fn in fns.items():
                    stem16_runs.setdefault((n_s, who, part), []).append(round(using(
                        vgg_stem, path, functools.partial(graph_ms, fn, side16)), 4))
        pooled = n_s * 112 * 112 * 64
        in_bytes = 2.0 * (n_s * 224 * 224 * 3 + 64 * 28)
        products = 2.0 * 27 * 4 * pooled
        stem16_serve_bounds[n_s] = bound(in_bytes + 2.0 * pooled, products, BF16_FLOPS)
        if n_s == 3 * KD_BATCH:
            unmasked = int((index < 4).sum())
            y_plain = vgg_stem.vgg_stem_plain(x_s, w_s, b_s)

            def plain16_fwd():
                with torch.no_grad():
                    vgg_stem.vgg_stem_plain(x_s, w_d, b_d)

            stem16 = {k: round(cuda_ms(fn, 10), 4) for k, fn in (
                ("plain forward", plain16_fwd),
                ("plain backward", lambda: torch.autograd.grad(y_plain, (w_s, b_s), g_s,
                                                               retain_graph=True)))}
            stem16_bounds = (bound(in_bytes + 2.0 * pooled + pooled, products, BF16_FLOPS),
                             bound(in_bytes + 2.0 * pooled + pooled, 2.0 * 28 * unmasked),
                             stem16_serve_bounds[n_s])
            del y_plain
        del x_s, x_nhwc, index, g_s
    for part in ("forward", "forward, serving", "backward"):
        v = stem16_runs[3 * KD_BATCH, "this source", part]
        stem16[f"kernel {part}"] = round(sum(v) / len(v), 4)
    tied = {}
    for kind, bars in (("ties", 0.0), ("bars", 0.25), ("bars", 0.5)):
        x_s, w_s, b_s, _ = stem_inputs(np.random.default_rng(25), 3 * KD_BATCH, 224, 64, kind,
                                       dev, dtype=bf16, bars=bars)
        x_nhwc, w_d, b_d = x_s.permute(0, 2, 3, 1), w_s.detach(), b_s.detach()
        tied[f"{kind} {bars}"] = round(cuda_ms(
            lambda: vgg_stem.stem_forward(x_nhwc, w_d, b_d, True), 10), 4)
        del x_s, x_nhwc
    fb, bb, sb = stem16_bounds
    kd_pooled = 3 * KD_BATCH * 112 * 112 * 64
    for (n_s, who, part), v in stem16_runs.items():
        b_ms = (stem16_serve_bounds[n_s] if part == "forward, serving" else
                fb if part == "forward" else bb)[0]
        phase("time", t0, f"stem bf16 ({n_s}, 224, 224) F 64, {who}: {part} {v} ms by CUDA "
              f"graph replay (in turns), bound {b_ms:.4f} ms, {b_ms / (sum(v) / len(v)):.3f} of "
              f"it [{card}]")
    phase("time", t0, f"stem bf16 ({3 * KD_BATCH}, 224, 224) F 64: {stem16} ms (the plain "
          f"version by CUDA events); the forward with indices where windows tie (every "
          f"window; bars over 25 / 50 %) by CUDA events: {tied} ms; bound forward "
          f"{fb[0]:.4f} ms ({fb[1]}), serving {sb[0]:.4f} ({sb[1]}; at 256 "
          f"{stem16_serve_bounds[256][0]:.4f}), backward {bb[0]:.4f} ({bb[1]}; "
          f"{unmasked / kd_pooled:.3f} of the outputs pass the ReLU) [{card}]")

    # 34. the bf16 eval PointNet kernel vs its plain bf16 version: the
    # shapes of the paths (64 / 46 / 1, 2500, 1024) and (46, 2500, 256),
    # every output negative, identical points, a ragged column chunk, a D
    # that 8 does not divide (W3 copied into rows of a multiple of 8), a
    # cloud one point past a 256-point tile; HGMMA (wgmma) in the bf16
    # encoder's SASS alone; times by graph replay, this source and (--source
    # pointnet_eval=...) the others' in turns, with their launches a call
    hgmma = sass_hmma(libs[1], "pne_", needle="HGMMA")
    if not hgmma.get("pne_encoder_bf16_kernel") or any(
            v for k, v in hgmma.items() if k != "pne_encoder_bf16_kernel"):
        raise RuntimeError(f"pointnet_eval SASS: HGMMA in {hgmma}")
    prng = np.random.default_rng(34)
    pn16_err = pn16_rel = pn16_unequal = 0.0
    pn16_cases = [(64, 2500, 1024, None, False), (46, 2500, 1024, None, False),
                  (1, 2500, 1024, None, False), (46, 2500, 256, None, False),
                  (3, 2500, 256, -100.0, False), (2, 700, 1024, None, True),
                  (3, 511, 1000, None, False), (2, 1, 256, None, False),
                  (2, 300, 1001, None, False), (2, 257, 1024, None, False)]
    for n_c, p_c, d_c, b3, identical in pn16_cases:
        layers = pointnet_bf16_params(prng, d_c, dev, b3)
        pts = prng.uniform(-1, 1, (n_c, 1 if identical else p_c, 3)).astype(np.float32)
        pts = torch.from_numpy(np.broadcast_to(pts, (n_c, p_c, 3)).copy()).to(dev, bf16)
        before = pointnet.pointnet_eval_bf16.launches
        out = pointnet.pointnet_eval_bf16(pts, layers)
        ref = pointnet.pointnet_eval_bf16_plain(pts, layers)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        unequal = float((out != ref).float().mean())
        if pointnet.pointnet_eval_bf16.launches != before + 1 or out.shape != (n_c, d_c) or \
                out.dtype != bf16 or err > BF16_ULP * scale or unequal >= 0.01 or \
                (b3 is not None and float(out.float().max()) >= 0) or \
                not torch.equal(out, pointnet.pointnet_eval_bf16(pts, layers)):
            raise RuntimeError(f"bf16 pointnet {(n_c, p_c, d_c, b3, identical)}: shape "
                               f"{tuple(out.shape)}, max|d| {err:.3g}, max|ref| {scale:.3g}, "
                               f"unequal {unequal:.3g} (or other bits on a second call)")
        pn16_err, pn16_rel = max(pn16_err, err), max(pn16_rel, err / scale)
        pn16_unequal = max(pn16_unequal, unequal)
    phase("pointnet bf16", t0, f"kernel vs the plain bf16 version in {len(pn16_cases)} cases "
          f"((64 / 46 / 1, 2500, 1024), (46, 2500, 256), all outputs negative, identical "
          f"points, (3, 511, 1000), one point, (2, 300, 1001), (2, 257, 1024)): max|d|/max|ref| "
          f"{pn16_rel:.3g} (one ulp {BF16_ULP:.3g}), unequal share at most "
          f"{pn16_unequal:.3g}, the same bits on a second call; cuobjdump -sass: HGMMA in "
          f"{hgmma}")
    pn16_times, pn16_bounds, pn16_runs, pn16_launches = {}, {}, {}, {}
    pn16_others = other_libs["pointnet_eval"]
    pn16_whos = ("this source", *pn16_others)
    side = torch.cuda.Stream()
    for n_c, d_c in ((64, 1024), (46, 1024), (1, 1024), (46, 256)):
        layers = pointnet_bf16_params(np.random.default_rng(35), d_c, dev)
        pts = torch.rand((n_c, POINT_NUM, 3), device=dev).to(bf16)
        call = functools.partial(pointnet.pointnet_eval_bf16, pts, layers)
        for order in (pn16_whos, pn16_whos[::-1]):
            for who in order:
                pn16_runs.setdefault((n_c, d_c, who), []).append(round(with_pointnet_source(
                    pn16_others.get(who), lambda _: graph_ms(call, side)), 4))
        for who in pn16_whos:
            pn16_launches[n_c, d_c, who] = with_pointnet_source(
                pn16_others.get(who), lambda _: graph_kernel_launches(call))
        plain_ms = cuda_ms(lambda: pointnet.pointnet_eval_bf16_plain(pts, layers), 5)
        flops = 2.0 * n_c * POINT_NUM * (3 * 64 + 64 * 128 + 128 * d_c)
        pn16_bounds[n_c, d_c] = bound(2.0 * (pts.numel() + n_c * d_c) + sum(
            t.numel() * t.element_size() for layer in layers for t in layer), flops, BF16_FLOPS)
        pn16_times[n_c, d_c] = (mean(pn16_runs[n_c, d_c, "this source"]), plain_ms)
    for (n_c, d_c, who), v in pn16_runs.items():
        b_ms = pn16_bounds[n_c, d_c][0]
        phase("time", t0, f"pointnet bf16 ({n_c}, {POINT_NUM}, {d_c}), {who}: {v} ms by CUDA "
              f"graph replay (in turns), {pn16_launches[n_c, d_c, who]} CUDA launches a call, "
              f"bound {b_ms:.4f} ms ({pn16_bounds[n_c, d_c][1]}), {b_ms / mean(v):.3f} of it "
              f"[{card}]")
    phase("time", t0, "pointnet bf16, the plain version by CUDA events, ms: " + "; ".join(
        f"({n_c}, {POINT_NUM}, {d_c}) {p:.4f}" for (n_c, d_c), (_, p) in pn16_times.items()) +
          f" [{card}]")

    # 35. the student in bf16 at full width (phase 6's weights): serving,
    # then an evaluation; card vs CPU at the small width by the oracle rule;
    # serving times beside f32 at batch 256 and 1
    state = convert.baseline_state_dict(student_variables(np.random.default_rng(1)))
    with torch.device("meta"):
        student16 = BaselineEstimator(compute_dtype=bf16)
    student16.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True,
                              assign=True)
    student16.eval().requires_grad_(False)
    del state
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (256, 224, 224, 3), dtype=np.float32)).to(dev)
    reset_counts()
    vp = student16.predict_viewpoint(x[:64])
    torch.cuda.synchronize()
    serving16 = bf16_counts()
    if vp.shape != (64, 3) or not bool(((vp >= 0) & (vp <= 360)).all()) or \
            serving16 != (1, 0, 0) or counts()[4] != 0:
        raise RuntimeError(f"bf16 student serving: {tuple(vp.shape)}, bf16 launches "
                           f"{serving16}, f32 stem launches {counts()[4]}")
    result = evaluate_categories(steps.make_eval_step(student16, "student"),
                                 eval_batches(3, False), EVAL_CATEGORIES, dev)
    torch.cuda.synchronize()
    eval16 = tuple(a - b for a, b in zip(bf16_counts(), serving16))
    if eval16 != (len(EVAL_COUNTS), 0, 0) or geodesic.rotation_err.launches != 1:
        raise RuntimeError(f"bf16 student evaluation: bf16 launches {eval16}, geodesic "
                           f"{geodesic.rotation_err.launches}")
    check_eval(result, geometry, "bf16 student")
    small_in = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (4, 32, 32, 3), dtype=np.float32))

    def small_eval(kind):
        """The small student (kind "student") or teacher in eval mode on the
        CPU in f64 (the teacher in f32: its eval PointNet takes f32 only), in
        bf16, and on the card in bf16; each output held to `bf16_oracle`,
        the largest share of its bound returned."""
        outs = []
        for where, dtype in (("cpu", None), ("cpu", bf16), ("cuda", bf16)):
            if kind == "student":
                m = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                      dropout_rate=0.0, compute_dtype=dtype)
                m.load_state_dict(s_small, strict=True)
                args = (small_in,)
            else:
                m = PoseEstimator(img_feature_dim=64, shape_feature_dim=64, compute_dtype=dtype)
                m.load_state_dict(t_small, strict=True)
                args = (small_in, torch.from_numpy(kd_small["shape"]))
            if dtype is None and kind == "student":
                m, args = m.double(), tuple(a.double() for a in args)
            with torch.no_grad():
                out = m.to(where).eval()(*(a.to(where) for a in args))
            outs.append([o.float() if dtype is None else o for o in list(out[0]) + list(out[1:])])
        return max(bf16_oracle(bf16_errors(g, c, r), BF16_ORACLE_FLOOR * float(
            r.abs().max()), f"{kind} output {i}") for i, (r, c, g) in enumerate(zip(*outs)))

    small_ratio = small_eval("student")
    times16 = {b: in_turns([student16], lambda: student16(x[:b]), 10 if b > 1 else 20)
               for b in (256, 1)}
    with torch.no_grad():
        lead = leads(lambda: student16(x[:256]))
    phase("student bf16", t0, f"serving 64 requests -> {tuple(vp.shape)} degrees in [0, 360], "
          f"bf16 launches (stem forward, backward, pointnet) {serving16}; evaluation of "
          f"{len(result.cat_ids)} rows: {eval16}, Acc {result.per_category_acc}, equal to the "
          f"plain CPU recomputation; card vs CPU at width 0.25 (bf16, against f64): the card's "
          f"error at most {small_ratio:.3g} of the oracle's bound (twice the CPU's + 2^-10 "
          f"max|ref|, by the largest and by the RMS difference) [{card}]")
    for b, t in times16.items():
        phase("time", t0, f"student serving batch {b}: f32 {t['f32']} ms/batch, bf16 "
              f"{t['bf16']} ms/batch = {b * 1000.0 / mean(t['bf16']):.1f} img/s (f32 "
              f"{b * 1000.0 / mean(t['f32']):.1f}) [{card}]")
    phase("profile", t0, f"student serving bf16 batch 256: {lead}")
    student16_serving = serving16[0] + eval16[0]
    del student16, x

    # 36. the PointCloud teacher in bf16 at full width (phase 9's weights):
    # serving at batch 64, then an evaluation; card vs CPU at the small
    # width; serving times beside f32
    state = convert.pose_state_dict(teacher_variables(np.random.default_rng(5)))
    with torch.device("meta"):
        teacher16 = PoseEstimator(compute_dtype=bf16)
    teacher16.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True,
                              assign=True)
    teacher16.eval().requires_grad_(False)
    del state
    trng = np.random.default_rng(6)
    xt = torch.from_numpy(trng.standard_normal((TEACHER_BATCH, 224, 224, 3),
                                               dtype=np.float32)).to(dev)
    pc = torch.from_numpy(trng.uniform(0, 1, (TEACHER_BATCH, POINT_NUM, 3))
                          .astype(np.float32)).to(dev)
    reset_counts()
    vp = teacher16.predict_viewpoint(xt, pc)
    torch.cuda.synchronize()
    t_serving16 = bf16_counts()
    if vp.shape != (TEACHER_BATCH, 3) or not bool(((vp >= 0) & (vp <= 360)).all()) or \
            t_serving16 != (0, 0, 1) or counts()[1] != 0:
        raise RuntimeError(f"bf16 teacher serving: {tuple(vp.shape)}, bf16 launches "
                           f"{t_serving16}, f32 pointnet launches {counts()[1]}")
    result = evaluate_categories(steps.make_eval_step(teacher16, "teacher"),
                                 eval_batches(7, True), EVAL_CATEGORIES, dev)
    torch.cuda.synchronize()
    t_eval16 = tuple(a - b for a, b in zip(bf16_counts(), t_serving16))
    if t_eval16 != (0, 0, len(EVAL_COUNTS)) or geodesic.rotation_err.launches != 1 or \
            not math.isfinite(result.val_nce_loss):
        raise RuntimeError(f"bf16 teacher evaluation: bf16 launches {t_eval16}, geodesic "
                           f"{geodesic.rotation_err.launches}, val_nce {result.val_nce_loss}")
    check_eval(result, geometry, "bf16 teacher")
    small_ratio = small_eval("teacher")
    t_times16 = {b: in_turns([teacher16], lambda: teacher16(xt[:b], pc[:b]),
                             10 if b > 1 else 20) for b in (TEACHER_BATCH, 1)}
    lead = leads(lambda: teacher16(xt, pc))
    phase("teacher bf16", t0, f"serving {TEACHER_BATCH} requests -> {tuple(vp.shape)} degrees "
          f"in [0, 360], bf16 launches (stem forward, backward, pointnet) {t_serving16}; "
          f"evaluation of {len(result.cat_ids)} rows: {t_eval16}, Acc "
          f"{result.per_category_acc}, val_nce_loss {result.val_nce_loss:.4f}, equal to the "
          f"plain CPU recomputation; card vs CPU at 64/64 (bf16, against f64): the card's "
          f"error at most {small_ratio:.3g} of the oracle's bound [{card}]")
    for b, t in t_times16.items():
        phase("time", t0, f"teacher serving batch {b}: f32 {t['f32']} ms/batch, bf16 "
              f"{t['bf16']} ms/batch = {b * 1000.0 / mean(t['bf16']):.1f} img/s (f32 "
              f"{b * 1000.0 / mean(t['f32']):.1f}) [{card}]")
    phase("profile", t0, f"teacher serving bf16 batch {TEACHER_BATCH}: {lead}")
    with torch.no_grad():
        phase("time", t0, f"teacher serving bf16 batch {TEACHER_BATCH}, one batch's profile "
              f"each (eval PointNet sources in turns): "
              f"{pn16_in_step(lambda: teacher16(xt, pc))} [{card}]")
    teacher16_serving = t_serving16[2] + t_eval16[2]
    del xt, pc

    # 37. the KD --crd student's training in bf16 at batch 46 x 3 (the
    # student and the frozen teacher in bf16): small steps card vs CPU by
    # the oracle rule (phase 19's size: 4 samples x 3 views at the small
    # width; phase 19's batch, one sample padded, and three more, the last
    # unpadded; each tensor's errors summed over the four), 6 steps on one
    # batch, the trainer's epoch and a resume; the step's time beside
    # f32's; a profile; then --contrast and --vid
    small16 = [kd_batch(np.random.default_rng(seed), 4, 32, 100) for seed in BF16_STEP_SEEDS]
    for b in small16[:-1]:  # the last unpadded: BatchNorm's unmasked library call
        b["valid"] = np.arange(4) < 3

    def small_bf16_step(make_step, teacher_cls, teacher_sd):
        """small_step(where, bf16, batch) for `bf16_card_vs_cpu`: one
        student step of make_step() against the small frozen teacher, both
        in bf16 compute, or (bf16 False) the student in f64 and the teacher
        in f32."""
        def run(where, as_bf16, batch_np):
            dtype = bf16 if as_bf16 else None
            model = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                      dropout_rate=0.0, compute_dtype=dtype)
            model.load_state_dict(s_small, strict=True)
            state = create_train_state((model if as_bf16 else model.double()).to(where), LR,
                                       [100], seed=0)
            batch = {k: torch.from_numpy(v).to(where) for k, v in batch_np.items()}
            if teacher_cls is None:  # the baseline
                batch = {k: v for k, v in batch.items() if k in ("im", "label", "valid")}
                return make_step()(state, batch), [state.model]
            teacher = teacher_cls(img_feature_dim=64, shape_feature_dim=64, compute_dtype=dtype)
            teacher.load_state_dict(teacher_sd, strict=True)
            teacher = teacher.to(where).eval().requires_grad_(False)
            return make_step()(state, teacher, batch), [state.model]
        return run

    kd_ratio = bf16_card_vs_cpu(small_bf16_step(steps.make_kd_crd_step, PoseEstimator, t_small),
                                ("loss", "gt_loss"), small16)
    set_compute_dtype(teacher16, bf16)
    kd16_state = create_train_state(set_compute_dtype(kd_student(46), bf16), LR, [10**9],
                                    seed=46)
    kd_step = steps.make_kd_crd_step()
    kb = {k: torch.from_numpy(v).to(dev) for k, v in
          kd_batch(np.random.default_rng(22), KD_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [kd_step(kd16_state, teacher16, kb) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    kd16_counts = bf16_counts()
    kd16_losses = [float(m["loss"]) for m in history]
    if kd16_counts != (TRAIN_STEPS,) * 3 or any(counts()[i] for i in (1, 4, 5)) or \
            not all(math.isfinite(v) for v in kd16_losses):
        raise RuntimeError(f"bf16 KD training: bf16 launches {kd16_counts}, f32 {counts()}, "
                           f"losses {kd16_losses}")
    with tempfile.TemporaryDirectory() as tmp:
        def kd_loaders():
            return (DataLoader(KDMemorySet(2 * KD_BATCH, 23, 224), KD_BATCH, shuffle=True,
                               drop_last=True, num_workers=2),
                    DataLoader(KDMemorySet(40, 24, 224, train=False), KD_BATCH,
                               shuffle=False, num_workers=2))

        fit_state = create_train_state(set_compute_dtype(kd_student(23), bf16), LR, [10**9],
                                       seed=46)
        trainer = KDTrainer(fit_state, teacher16, *kd_loaders(), EVAL_CATEGORIES, tmp)
        reset_counts()
        trainer.fit_crd(1)
        torch.cuda.synchronize()
        kd16_fit = bf16_counts()
        saved = trainer.ckpt.restore("checkpoint")["model"]
        if kd16_fit != (3, 2, 2) or not all(v.dtype != bf16 for v in saved.values()):
            raise RuntimeError(f"bf16 KD trainer epoch: bf16 launches {kd16_fit}, checkpoint "
                               f"dtypes {sorted({str(v.dtype) for v in saved.values()})}")
        resumed = create_train_state(set_compute_dtype(kd_student(99), bf16), LR, [10**9],
                                     seed=0)
        resumed.load_state_dict(trainer.ckpt.restore("checkpoint"))
        del fit_state, trainer, saved
        KDTrainer(resumed, teacher16, *kd_loaders(), EVAL_CATEGORIES, tmp).fit_crd(
            2, start_epoch=1)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if resumed.step != 4 or [r["epoch"] for r in records] != [0, 1] or not all(
                math.isfinite(r["train_loss"]) and math.isfinite(r["val_med"])
                for r in records):
            raise RuntimeError(f"bf16 KD trainer resume: step {resumed.step}, records {records}")
    del resumed
    kd16_times = in_turns([kd16_state.model, teacher16],
                          lambda: kd_step(kd16_state, teacher16, kb), 3)
    lead = leads(lambda: kd_step(kd16_state, teacher16, kb))
    phase("KD bf16", t0, f"{len(small16)} small steps card vs CPU (bf16, against f64): the card's "
          f"error summed over them at most {kd_ratio['share']:.3g} of the oracle's bound (each "
          f"batch alone, phase 19's first: {kd_ratio['batches']}, not held); {TRAIN_STEPS} "
          f"steps at batch {KD_BATCH} x 3 views: loss {[round(v, 4) for v in kd16_losses]}, "
          f"bf16 launches (stem forward, backward, pointnet) {kd16_counts}; trainer epoch "
          f"{kd16_fit}, its checkpoint f32, resumed into epoch 1; val_med "
          f"{[round(r['val_med'], 3) for r in records]} [{card}]")
    phase("time", t0, f"KD --crd step batch {KD_BATCH} x 3 views: f32 {kd16_times['f32']} "
          f"ms/step, bf16 {kd16_times['bf16']} ms/step = "
          f"{KD_BATCH * 1000.0 / mean(kd16_times['bf16']):.1f} samples/s (f32 "
          f"{KD_BATCH * 1000.0 / mean(kd16_times['f32']):.1f}) [{card}]")
    phase("profile", t0, f"KD --crd step bf16: {lead}")
    phase("time", t0, f"KD --crd step bf16 at batch {KD_BATCH} x 3 views, one step's profile "
          f"each (stem sources in turns): "
          f"{stem16_in_step(lambda: kd_step(kd16_state, teacher16, kb))} [{card}]")
    phase("time", t0, f"KD --crd step bf16 at batch {KD_BATCH} x 3 views, one step's profile "
          f"each (eval PointNet sources in turns): "
          f"{pn16_in_step(lambda: kd_step(kd16_state, teacher16, kb))} [{card}]")
    # --contrast and --vid in bf16, 2 steps each (then 3 timed)
    variant16_counts = (0, 0, 0)
    for variant in ("contrast", "vid"):
        v_step = steps.make_kd_crd_step(loss_variant=variant)
        reset_counts()
        losses = [float(v_step(kd16_state, teacher16, kb)["loss"]) for _ in range(2)]
        torch.cuda.synchronize()
        launched = bf16_counts()
        if launched != (2, 2, 2) or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"bf16 KD --{variant}: bf16 launches {launched}, losses {losses}")
        variant16_counts = tuple(a + b for a, b in zip(variant16_counts, launched))
        v_ms = cuda_ms(lambda: v_step(kd16_state, teacher16, kb), 3, warmup=0)
        phase(f"KD --{variant} bf16", t0, f"2 steps: loss {[round(v, 4) for v in losses]}, bf16 "
              f"launches (stem forward, backward, pointnet) {launched}; {v_ms:.3f} ms/step by "
              f"CUDA events [{card}]")
    del kd16_state, teacher16, history

    # 38. the stage-2 step in bf16 (its teacher read from phase 26's
    # stage-1 checkpoint.pth under --bf16, phase 28) and the RGB-only
    # baseline in bf16 at batch 64: each phase 37's small steps card vs
    # CPU, 2 steps, their bf16 launches, time beside f32's, a profile
    s2_ratio = bf16_card_vs_cpu(small_bf16_step(steps.make_stage2_step, PoseEstimatorVanilla,
                                                v_small), ("loss", "gt_loss"), small16)
    bl_small_step = small_bf16_step(lambda: steps.make_vanilla_train_step(False), None, None)
    bl_ratio = bf16_card_vs_cpu(bl_small_step, ("loss",), small16)
    # the witness: phase 19's batch with cuBLAS's reduced-precision bf16
    # reductions on (PyTorch's default, which setup_device turns off)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    bl_reduced = bf16_card_vs_cpu(bl_small_step, ("loss",), small16[:1],
                                  hold=False)["batches"][0]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    s2_state16 = create_train_state(set_compute_dtype(kd_student(47), bf16), LR, [10**9],
                                    seed=47)
    s2_step = steps.make_stage2_step()
    reset_counts()
    s2_losses16 = [float(s2_step(s2_state16, s2_teacher16, kb)["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    s2_counts16 = bf16_counts()
    bl_state16 = create_train_state(set_compute_dtype(kd_student(51), bf16), LR, [10**9],
                                    seed=51)
    blb = {k: torch.from_numpy(v).to(dev) for k, v in
           train_batch(np.random.default_rng(40), 64, 224, POINT_NUM).items() if k != "shape"}
    bl_step = steps.make_vanilla_train_step(False)
    reset_counts()
    bl_losses16 = [float(bl_step(bl_state16, blb)["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    bl_counts16 = bf16_counts()
    if s2_counts16 != (2, 2, 2) or bl_counts16 != (2, 2, 0) or not all(
            math.isfinite(v) for v in s2_losses16 + bl_losses16):
        raise RuntimeError(f"bf16 stage 2 / baseline: bf16 launches {s2_counts16} / "
                           f"{bl_counts16}, losses {s2_losses16} / {bl_losses16}")
    s2_times16 = in_turns([s2_state16.model, s2_teacher16],
                          lambda: s2_step(s2_state16, s2_teacher16, kb), 3)
    bl_times16 = in_turns([bl_state16.model], lambda: bl_step(bl_state16, blb), 3)
    s2_lead = leads(lambda: s2_step(s2_state16, s2_teacher16, kb))
    bl_lead = leads(lambda: bl_step(bl_state16, blb))
    for name, what, ratio, losses, launched, t, rows, lead in (
            ("stage 2 bf16", f"KD --stage 2 step batch {KD_BATCH} x 3 views", s2_ratio,
             s2_losses16, s2_counts16, s2_times16, KD_BATCH, s2_lead),
            ("baseline bf16", "baseline step batch 64", bl_ratio, bl_losses16, bl_counts16,
             bl_times16, 64, bl_lead)):
        witness = (f"; with cuBLAS's reduced-precision bf16 reductions on, phase 19's batch "
                   f"{bl_reduced}" if name.startswith("baseline") else "")
        phase(name, t0, f"{len(small16)} small steps card vs CPU (bf16, against f64): the "
              f"card's error summed over them at most {ratio['share']:.3g} of the oracle's bound "
              f"(each batch alone, phase 19's first: {ratio['batches']}, not held{witness}); 2 "
              f"steps: loss "
              f"{[round(v, 4) for v in losses]}, bf16 launches (stem forward, backward, "
              f"pointnet) {launched}")
        phase("time", t0, f"{what}: f32 {t['f32']} ms/step, bf16 {t['bf16']} ms/step = "
              f"{rows * 1000.0 / mean(t['bf16']):.1f} samples/s (f32 "
              f"{rows * 1000.0 / mean(t['f32']):.1f}) [{card}]")
        phase("profile", t0, f"{name}: {lead}")
    del s2_state16, s2_teacher16, bl_state16, blb, kb
    bf16_paths = [sum(c) for c in zip(kd16_counts, variant16_counts, s2_counts16, bl_counts16)]

    pt16_worst, pt16_times, pt16_bounds = pt16_phase(dev, card, t0, libs[4],
                                                     other_libs["pointnet_train"], side)

    # 40. the teacher's training (batch 160, --fused_nce, shape feature 256)
    # and KD --stage 1 (batch 46, --fused_nce) in bf16, through the bf16
    # kernel above: small steps card vs CPU by the oracle rule (the small
    # teacher of phase 15 and a small vanilla teacher and student, their
    # ResNets' residual branches damped (`damp_residuals`), each tensor's
    # errors summed over eight batches, the last unpadded, each loss a
    # tensor of its own; and the card against the same steps on the card
    # with the PointNet's plain version, `plain_train_pointnet`), 6 steps at full
    # width, the trainer's epoch and a resume (checkpoints f32), each step's
    # time beside f32's in turns, and what leads a one-step profile
    t_small16 = convert.pose_state_dict(damp_residuals(teacher_variables(
        np.random.default_rng(14), 64, 64)))
    v_small16 = convert.pose_vanilla_state_dict(damp_residuals(vanilla_variables(
        np.random.default_rng(30), 64, 64)))
    t_batches = [train_batch(np.random.default_rng(seed), 8, 64, 100)
                 for seed in BF16_TRAIN_STEP_SEEDS]
    s1_batches = [train_batch(np.random.default_rng(seed), 8, 32, 100)
                  for seed in BF16_TRAIN_STEP_SEEDS]
    for b in t_batches[:-1] + s1_batches[:-1]:
        b["valid"] = np.arange(8) < 7
    keep_np = [np.random.default_rng(40 + i).uniform(size=(8, 200)) < 0.7 for i in range(2)]

    def small_teacher16(where, as_bf16, batch_np):
        """One small teacher step (--fused_nce, no dropout) in bf16, or in
        f64 with bf16 False, for `bf16_card_vs_cpu`."""
        model = PoseEstimator(img_feature_dim=64, shape_feature_dim=64,
                              compute_dtype=bf16 if as_bf16 else None)
        model.load_state_dict(t_small16, strict=True)
        state = create_train_state((model if as_bf16 else model.double()).to(where), LR, [100],
                                   seed=0)
        batch = {k: torch.from_numpy(v).to(where) for k, v in batch_np.items()}
        if not as_bf16:
            batch["im"], batch["shape"] = batch["im"].double(), batch["shape"].double()
        m = steps.make_teacher_train_step(nce_dropout=0.0, use_fused_nce=True)(state, batch)
        return {k: m[k] for k in T16_LOSSES}, [state.model]

    def small_stage1_16(where, as_bf16, batch_np):
        """One small KD --stage 1 step (--fused_nce, fixed NCE keep-masks)
        of the vanilla teacher and the student, in bf16 or in f64."""
        dtype = bf16 if as_bf16 else None
        teacher = PoseEstimatorVanilla(img_feature_dim=64, shape_feature_dim=64,
                                       compute_dtype=dtype)
        teacher.load_state_dict(v_small16, strict=True)
        student = BaselineEstimator(img_feature_dim=64, width_mult=0.25, input_dim=32,
                                    dropout_rate=0.0, compute_dtype=dtype)
        student.load_state_dict(s_small, strict=True)
        states = [create_train_state((m if as_bf16 else m.double()).to(where), LR, [100], seed=i)
                  for i, m in enumerate((teacher, student))]
        batch = {k: torch.from_numpy(v).to(where) for k, v in batch_np.items()}
        if not as_bf16:
            batch["im"], batch["shape"] = batch["im"].double(), batch["shape"].double()
        keep = [torch.from_numpy(k).to(where) for k in keep_np]
        m = steps.make_stage1_step(tau=0.5, use_fused_nce=True)(*states, batch, keep=keep)
        return {k: m[k] for k in S1_16_LOSSES}, [s.model for s in states]

    # each loss its own tensor; the witness: the same steps on the card with
    # the PointNet through its plain bf16 version
    t16_ratio = bf16_card_vs_cpu(small_teacher16, T16_LOSSES, t_batches,
                                 witness=plain_train_pointnet)
    s116_ratio = bf16_card_vs_cpu(small_stage1_16, S1_16_LOSSES, s1_batches,
                                  witness=plain_train_pointnet)

    def fit_twice(make_state, make_trainer, fit, name):
        """The trainer's epoch 0 in bf16, its checkpoint (float32 values
        only), then a fresh bf16 state resumed from it into epoch 1.
        Returns (the bf16 train-mode PointNet's launches in epoch 0, the
        records)."""
        with tempfile.TemporaryDirectory() as tmp:
            states = make_state(16)
            reset_counts()
            fit(make_trainer(states, tmp), 1, 0)
            torch.cuda.synchronize()
            fitted = pt16_counts()
            saved = torch.load(os.path.join(tmp, "ckpt", "checkpoint.pth"), map_location="cpu",
                               weights_only=True)
            floats = [v for v in torch.utils._pytree.tree_leaves(saved)
                      if isinstance(v, torch.Tensor) and v.is_floating_point()]
            if fitted != (2, 2) or not floats or any(v.dtype != torch.float32 for v in floats):
                raise RuntimeError(f"{name}: bf16 train-mode pointnet launches {fitted}, "
                                   f"checkpoint dtypes {sorted({str(v.dtype) for v in floats})}")
            resumed = make_state(99)
            if len(resumed) == 1:  # fit_stage1 restores both train states itself
                resumed[0].load_state_dict(torch.load(
                    os.path.join(tmp, "ckpt", "checkpoint.pth"), map_location="cpu",
                    weights_only=True))
            fit(make_trainer(resumed, tmp), 2, 1)
            with open(os.path.join(tmp, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            if [r["epoch"] for r in records] != [0, 1] or any(s.step != 4 for s in resumed) or \
                    not all(math.isfinite(r["train_loss"]) for r in records):
                raise RuntimeError(f"{name} resume: steps {[s.step for s in resumed]}, "
                                   f"records {records}")
        return fitted, records

    # the teacher step
    teacher16_state = create_train_state(set_compute_dtype(recipe_teacher(46), bf16), LR,
                                         [10**9], seed=46)
    t16_step = steps.make_teacher_train_step(use_fused_nce=True)
    tb16 = {k: torch.from_numpy(v).to(dev) for k, v in
            train_batch(np.random.default_rng(15), TRAIN_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [t16_step(teacher16_state, tb16) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    t16_counts = pt16_counts()
    t16_losses = [float(m["loss"]) for m in history]
    if t16_counts != (TRAIN_STEPS,) * 2 or counts()[2:4] != (TRAIN_STEPS,) * 2 or \
            any(counts()[i] for i in (6, 7)) or not all(math.isfinite(v) for v in t16_losses) \
            or not t16_losses[-1] < t16_losses[0]:
        raise RuntimeError(f"bf16 teacher training: bf16 train-mode pointnet launches "
                           f"{t16_counts}, f32 {counts()}, losses {t16_losses}")

    def teacher_fit_trainer(states, tmp):
        sets = (MemorySet(64, 16, 224), MemorySet(40, 17, 224), MemorySet(40, 18, 224))
        return TeacherTrainer(states[0], DataLoader(sets[0], 32, shuffle=True, drop_last=True,
                                                    num_workers=2),
                              DataLoader(sets[1], 32, shuffle=False, num_workers=2),
                              EVAL_CATEGORIES, tmp, print_freq=100,
                              cat_eval_loader=DataLoader(sets[2], 32, shuffle=False,
                                                         num_workers=2), use_fused_nce=True)

    t16_fit, t16_records = fit_twice(
        lambda seed: [create_train_state(set_compute_dtype(recipe_teacher(seed), bf16), LR,
                                         [10**9], seed=seed)],
        teacher_fit_trainer, lambda tr, n, start: tr.fit(n, start_epoch=start), "bf16 teacher")
    t16_times = in_turns([teacher16_state.model], lambda: t16_step(teacher16_state, tb16), 3)
    t16_lead = leads(lambda: t16_step(teacher16_state, tb16))
    t16_pt = pt16_in_step(lambda: t16_step(teacher16_state, tb16))
    del teacher16_state, tb16, history
    # the stage-1 step
    t1_16, s1_16 = stage1_states(46)
    for st in (t1_16, s1_16):
        set_compute_dtype(st.model, bf16)
    s1_16_step = steps.make_stage1_step(tau=0.5, use_fused_nce=True)
    sb16 = {k: torch.from_numpy(v).to(dev) for k, v in
            train_batch(np.random.default_rng(26), KD_BATCH, 224, POINT_NUM).items()}
    reset_counts()
    history = [s1_16_step(t1_16, s1_16, sb16) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    s116_counts, s116_stem = pt16_counts(), bf16_counts()[:2]
    s116_losses = [float(m["loss"]) for m in history]
    if s116_counts != (TRAIN_STEPS,) * 2 or s116_stem != (TRAIN_STEPS,) * 2 or \
            any(counts()[i] for i in (4, 5, 6, 7)) or \
            not all(math.isfinite(v) for v in s116_losses):
        raise RuntimeError(f"bf16 stage 1: bf16 train-mode pointnet launches {s116_counts}, "
                           f"bf16 stem {s116_stem}, f32 {counts()}, losses {s116_losses}")

    def stage1_fit_state(seed):
        states = stage1_states(seed)
        for st in states:
            set_compute_dtype(st.model, bf16)
        return list(states)

    def stage1_fit_trainer(states, tmp):
        return KDTrainer(states[1], None,
                         DataLoader(MemorySet(2 * KD_BATCH, 27, 224), KD_BATCH, shuffle=True,
                                    drop_last=True, num_workers=2),
                         DataLoader(MemorySet(40, 28, 224), KD_BATCH, shuffle=False,
                                    num_workers=2),
                         EVAL_CATEGORIES, tmp, teacher_state=states[0], tau=0.5,
                         use_fused_nce=True)

    s116_fit, s116_records = fit_twice(stage1_fit_state, stage1_fit_trainer,
                                       lambda tr, n, start: tr.fit_stage1(n, start_epoch=start),
                                       "bf16 stage 1")
    s116_times = in_turns([t1_16.model, s1_16.model], lambda: s1_16_step(t1_16, s1_16, sb16), 3)
    s116_lead = leads(lambda: s1_16_step(t1_16, s1_16, sb16))
    s116_pt = pt16_in_step(lambda: s1_16_step(t1_16, s1_16, sb16))
    del t1_16, s1_16, sb16, history
    for name, what, ratio, losses, launched, fitted, records, t, rows, lead, in_step in (
            ("teacher training bf16", f"teacher train step batch {TRAIN_BATCH}, --fused_nce",
             t16_ratio, t16_losses, t16_counts, t16_fit, t16_records, t16_times, TRAIN_BATCH,
             t16_lead, t16_pt),
            ("stage 1 bf16", f"KD --stage 1 step batch {KD_BATCH}, --fused_nce", s116_ratio,
             s116_losses, s116_counts, s116_fit, s116_records, s116_times, KD_BATCH,
             s116_lead, s116_pt)):
        phase(name, t0, f"{len(t_batches)} small steps card vs CPU (bf16, against f64; "
              f"residual branches damped): the card's error summed over them at most "
              f"{ratio['share']:.3g} of the oracle's bound, each loss {ratio['keys']}; over the "
              f"first {len(BF16_STEP_SEEDS)} each loss {ratio['first']}, with the PointNet's "
              f"plain version on the card {ratio['witness_first']} (not held); against that "
              f"witness at most {ratio['vs_witness']:.3g} of the bound, bit-equal in "
              f"{ratio['equal'][0]} of {ratio['equal'][1]} (batch, tensor) pairs; each batch "
              f"alone: {ratio['batches']}, each loss {ratio['key_batches']}, not held; "
              f"{TRAIN_STEPS} steps at full width: loss "
              f"{[round(v, 4) for v in losses]}, bf16 train-mode pointnet launches (forward, "
              f"backward) {launched}; trainer epoch {fitted}, its checkpoint f32, resumed into "
              f"epoch 1: train_loss {[round(r['train_loss'], 4) for r in records]} [{card}]")
        phase("time", t0, f"{what}: f32 {t['f32']} ms/step, bf16 {t['bf16']} ms/step = "
              f"{rows * 1000.0 / mean(t['bf16']):.1f} samples/s (f32 "
              f"{rows * 1000.0 / mean(t['f32']):.1f}) [{card}]")
        phase("profile", t0, f"{name}: {lead}")
        phase("time", t0, f"{what} in bf16: {in_step} [{card}]")
    # 41-44. the MultiView teacher's paths and the remaining datasets
    mv_added, mv16_added, mv_geo_err = multiview_phases(dev, card, t0, reset_counts, counts,
                                                        bf16_counts)
    geo_err = max(geo_err, mv_geo_err)
    # 45-50. int8 serving
    i8_launched, i8_added, i8_added16, i8_err, i8_times = int8_phases(
        dev, card, t0, reset_counts, counts, bf16_counts, other_libs["int8_conv"])
    # 51-53. the on-device data path
    dd_added, dd_added16, dd_pt16 = device_data_phases(dev, card, t0, reset_counts, counts,
                                                       bf16_counts, pt16_counts)
    # 54-55. exported serving
    aot_i8, aot_added, aot_added16 = aot_phases(dev, card, t0, reset_counts, counts,
                                                bf16_counts)
    i8_launched += aot_i8
    # the int8, the on-device data and the exported serving paths' launches
    # of the other kernels join the MultiView paths' (the stem's, the
    # PointNet's, the NCE's and the geodesic's; the train-mode PointNet's
    # join its own)
    mv_added = [a + b + c + d for a, b, c, d in zip(mv_added, i8_added, dd_added, aot_added)]
    mv16_added = [a + b + c + d for a, b, c, d in zip(mv16_added, i8_added16, dd_added16,
                                                      aot_added16)]
    pt16_paths = [a + b + c + d + e for a, b, c, d, e in zip(t16_counts, t16_fit, s116_counts,
                                                             s116_fit, dd_pt16)]

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
             tuple(a - b + c for a, b, c in zip(train_counts[2:4], train_blocked,
                                                mv_added[2:4]))),
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
              "pose3d_tpu/ops/geodesic.py:65", student_geo + teacher_geo + mv_added[0], geo_err,
              geo_times[1_000_000][0], geo_times[1_000_000][1], geo_bound),
        entry("pointnet_eval", "pose3d_tpu_torch/csrc/pointnet_eval.cu",
              "pose3d_tpu/ops/pointnet_fused.py:78", teacher_pn + added[1] + mv_added[1], pn_err,
              *pn_times[TEACHER_BATCH, 1024], pn_bounds[TEACHER_BATCH, 1024]),
        *nce_entries,
        entry("vgg_stem_forward", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", kd_counts[4] + added[4] + mv_added[4], stem_err,
              stem_times[3 * KD_BATCH]["kernel forward"],
              stem_times[3 * KD_BATCH]["plain forward"], stem_bounds[3 * KD_BATCH][0]),
        entry("vgg_stem_backward", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", kd_counts[5] + added[5] + mv_added[5], stem_err,
              stem_times[3 * KD_BATCH]["kernel backward"],
              stem_times[3 * KD_BATCH]["plain backward"], stem_bounds[3 * KD_BATCH][1]),
        entry("pointnet_train_forward", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:372", train_counts[6] + added[6] + mv_added[6],
              pt_err,
              pt_times[TRAIN_BATCH]["kernel forward"], pt_times[TRAIN_BATCH]["plain forward"],
              pt_bounds[TRAIN_BATCH][0]),
        entry("pointnet_train_backward", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:372", train_counts[7] + added[7] + mv_added[7],
              pt_err,
              pt_times[TRAIN_BATCH]["kernel backward"], pt_times[TRAIN_BATCH]["plain backward"],
              pt_bounds[TRAIN_BATCH][1]),
        # the bf16 instances, their launches on the bf16 paths (phases 35-38)
        entry("vgg_stem_forward_bf16", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", bf16_paths[0] + student16_serving + mv16_added[0],
              stem16_err,
              stem16["kernel forward"], stem16["plain forward"], stem16_bounds[0]),
        entry("vgg_stem_wgrad_bf16", "pose3d_tpu_torch/csrc/vgg_stem.cu",
              "pose3d_tpu/ops/vgg_stem.py:93", bf16_paths[1] + mv16_added[1], stem16_wgrad_err,
              stem16["kernel backward"], stem16["plain backward"], stem16_bounds[1]),
        entry("pointnet_eval_bf16", "pose3d_tpu_torch/csrc/pointnet_eval.cu",
              "pose3d_tpu/ops/pointnet_fused.py:78",
              bf16_paths[2] + teacher16_serving + mv16_added[2],
              pn16_err, *pn16_times[TEACHER_BATCH, 1024], pn16_bounds[TEACHER_BATCH, 1024]),
        # the train-mode PointNet's bf16 instance, its launches on the bf16
        # teacher's and stage 1's paths (phase 40)
        entry("pointnet_train_forward_bf16", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:545", pt16_paths[0],
              pt16_worst["max_abs_err"], pt16_times[TRAIN_BATCH]["bf16 forward"],
              pt16_times[TRAIN_BATCH]["plain forward"], pt16_bounds[TRAIN_BATCH][0]),
        entry("pointnet_train_backward_bf16", "pose3d_tpu_torch/csrc/pointnet_train.cu",
              "pose3d_tpu/ops/pointnet_train_fused.py:545", pt16_paths[1],
              pt16_worst["grad_abs"], pt16_times[TRAIN_BATCH]["bf16 backward"],
              pt16_times[TRAIN_BATCH]["plain backward"], pt16_bounds[TRAIN_BATCH][1]),
        # the int8 convolution replaces no TPU kernel (XLA's int8 conv); its
        # launches on the int8 paths (phases 46-50), its times summed over
        # one int8 student forward's ten calls at batch 256 (bf16), the
        # yardstick im2col + torch._int_mm at the same shapes
        dict(entry("int8_conv", "pose3d_tpu_torch/csrc/int8_conv.cu",
                   "none: pose3d_tpu/serving/quant_student.py:47 is XLA's int8 convolution "
                   "(lax.conv_general_dilated), no Pallas kernel",
                   i8_launched, i8_err, i8_times["ms"], i8_times["plain_ms"],
                   (i8_times["bound_ms"], i8_times["bound_by"])),
             library_ms=i8_times["library_ms"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
