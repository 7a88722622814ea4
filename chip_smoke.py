"""Smoke run of the PyTorch port (pose3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, and drives the port's two paths once at full
width with random weights from a seed:
  * the student (VGG-11, img_feature_dim 2048, 224x224): serving a batch of
    requests, then a per-category evaluation whose geodesic errors go
    through the geodesic kernel;
  * the PointCloud teacher (ResNet-50 and PointNet, img/shape_feature_dim
    1024, DeformNet bottleneck 2048, 224x224 images, 2,500-point clouds):
    serving, then evaluation, with the shape encoder in the PointNet kernel.
Phases:

  1 device    2 build    3 geodesic kernel vs plain
  4 pointnet kernel vs plain    5 student at full width
  6 student serving    7 student evaluation
  8 teacher at full width    9 teacher serving    10 teacher evaluation
  11 view_tile    12 times
Each path (6-7 and 9-10) is the main path of its model: the kernels' launch
counts are set to 0 just before it and read just after it.

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
import subprocess
import sys
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


def main() -> int:
    t0 = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from pose3d_tpu_torch import geometry
    from pose3d_tpu_torch.models.estimators import BaselineEstimator, PoseEstimator
    from pose3d_tpu_torch.ops import _build, geodesic, pointnet
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.train.evaluate import evaluate_categories

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", t0, f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for cuDNN and matmul")

    # 2. build: one nvcc per source, all started together
    tb = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(_build.build, ("geodesic", "pointnet_eval")))
    build_s = time.perf_counter() - tb
    for lib in libs:
        with open(lib[:-3] + ".log") as f:
            ptxas = " | ".join(line.strip() for line in f
                               if "ptxas info" in line or "spill" in line)
        phase("build", t0, f"nvcc {lib}; {ptxas}")
    phase("build", t0, f"both libraries in {build_s:.2f} s; pointnet_eval_kernel: "
          f"{pointnet.shared_memory_bytes()} bytes of dynamic shared memory a block")

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
    geodesic.rotation_err.launches = pointnet.pointnet_eval.launches = 0
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
    geodesic.rotation_err.launches = pointnet.pointnet_eval.launches = 0
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

    print(card)
    print(json.dumps({"kernels": [{
        "name": "geodesic_rotation_err", "route": "cuda",
        "source": "pose3d_tpu_torch/csrc/geodesic.cu",
        "replaces": "pose3d_tpu/ops/geodesic.py:65",
        "launches": student_geo + teacher_geo, "max_abs_err": geo_err,
        "ms": geo_times[1_000_000][0], "plain_ms": geo_times[1_000_000][1]}, {
        "name": "pointnet_eval", "route": "cuda",
        "source": "pose3d_tpu_torch/csrc/pointnet_eval.cu",
        "replaces": "pose3d_tpu/ops/pointnet_fused.py:78",
        "launches": teacher_pn, "max_abs_err": pn_err,
        "ms": pn_times[64][0], "plain_ms": pn_times[64][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
