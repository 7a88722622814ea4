"""Smoke run of the PyTorch port (pose3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from csrc/, holds it against its plain PyTorch
version on the card, and drives the port's main path once at the full width
of the student (VGG-11, img_feature_dim 2048, 224x224, random weights from a
seed): serving a batch of requests, then a per-category evaluation whose
geodesic errors go through the kernel. Phases:

  1 device    2 build    3 kernel vs plain    4 student at full width
  5 serving   6 evaluation (5 and 6 are the main path; the kernel launch
              count is read over them alone)    7 times

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

import numpy as np
import torch

VGG11_CONV_WIDTHS = (64, 128, 256, 256, 512, 512, 512, 512)
HEAD_BINS = (24, 12, 24)
GEODESIC_RTOL, GEODESIC_ATOL = 1e-4, 0.05  # degrees; arccos is ill-conditioned near 0
HEADS_REL_TOL = 1e-3  # card vs CPU, f32 with TF32 off: summation order only
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


def main() -> int:
    t0 = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from pose3d_tpu_torch import geometry
    from pose3d_tpu_torch.models.estimators import BaselineEstimator
    from pose3d_tpu_torch.ops import _build, geodesic
    from pose3d_tpu_torch.train import convert, steps
    from pose3d_tpu_torch.train.evaluate import evaluate_categories

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", t0, f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for cuDNN and matmul")

    # 2. build
    tb = time.perf_counter()
    lib = _build.build("geodesic")
    build_s = time.perf_counter() - tb
    with open(lib[:-3] + ".log") as f:
        ptxas = " | ".join(line.strip() for line in f if "ptxas info" in line)
    phase("build", t0, f"nvcc {lib} in {build_s:.2f} s; {ptxas}")

    # 3. kernel vs plain version on the card, 1,000,003 rows + edge rows
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
    max_abs_err = float((out - ref).abs().max())
    edge = out[n:].cpu().numpy()
    phase("kernel", t0, f"geodesic kernel vs plain on {n + len(EDGE_ROWS)} rows: "
          f"max|d| {max_abs_err:.3g} deg (rtol {GEODESIC_RTOL}, atol {GEODESIC_ATOL}); "
          f"edge rows {np.round(edge, 4).tolist()}")

    # 4. student at full width, random weights from a seed, loaded strictly
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
    worst = 0.0
    for got, want in zip(heads + [proj], heads_ref + [proj_ref]):
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        if rel > HEADS_REL_TOL:
            raise RuntimeError(f"card vs CPU: max|d|/max|ref| {rel:.3g} > {HEADS_REL_TOL}")
        worst = max(worst, rel)
    phase("student", t0, f"{n_params} params loaded strict; batch 64 and 1 finite; "
          f"batch 2 card vs CPU max|d|/max|ref| {worst:.3g} (tol {HEADS_REL_TOL})")
    del model_cpu

    # main path: serving, then evaluation; the launch count is read over it
    geodesic.rotation_err.launches = 0
    # 5. serving: NHWC batch -> forward -> inference decoder
    vp = model.predict_viewpoint(x.to(dev))
    if vp.shape != (64, 3) or not bool(((vp >= 0) & (vp <= 360)).all()):
        raise RuntimeError(f"serving output {tuple(vp.shape)} outside [0, 360]")
    phase("serving", t0, f"64 requests -> {tuple(vp.shape)} degrees in [0, 360]; "
          f"first {np.round(vp[0].cpu().numpy(), 2).tolist()}")

    # 6. evaluation: 8 batches of 64 + a ragged 37 padded to 64, 3 categories
    categories = ["bed", "bookshelf", "calculator"]
    eval_rng = np.random.default_rng(3)

    def batches():
        for count in [64] * 8 + [37]:
            valid = np.arange(64) < count
            yield {"im": eval_rng.standard_normal((64, 224, 224, 3), dtype=np.float32),
                   "label": random_labels(eval_rng, 64),
                   "cat_id": eval_rng.integers(0, 3, 64).astype(np.int32),
                   "valid": valid}

    result = evaluate_categories(steps.make_eval_step(model, "student"), batches(),
                                 categories, dev)
    torch.cuda.synchronize()
    launches = geodesic.rotation_err.launches
    if launches < 1:
        raise RuntimeError("evaluation did not launch the geodesic kernel")
    n_eval = len(result.cat_ids)
    if n_eval != 8 * 64 + 37 or not np.all(np.isfinite(result.errors)):
        raise RuntimeError(f"evaluation kept {n_eval} rows, or errors not finite")
    # the same predictions through the plain version on the CPU
    errs_cpu = geometry.rotation_err(torch.from_numpy(result.predictions),
                                     torch.from_numpy(result.labels).float()).numpy()
    for ci, cat in enumerate(categories):
        e = errs_cpu[result.cat_ids == ci]
        acc, med = 100.0 * float(np.mean(e <= 30.0)), float(np.median(e))
        if acc != result.per_category_acc[cat] or \
                abs(med - result.per_category_med[cat]) > 1e-3:
            raise RuntimeError(f"{cat}: card Acc/Med {result.per_category_acc[cat]}/"
                               f"{result.per_category_med[cat]} vs CPU {acc}/{med}")
    # the kernel against its plain version at the main path's shape
    p_eval = torch.from_numpy(result.predictions).to(dev)
    l_eval = torch.from_numpy(result.labels).float().to(dev)
    d_eval = geodesic.rotation_err(p_eval, l_eval) - geometry.rotation_err(p_eval, l_eval)
    max_abs_err = max(max_abs_err, float(d_eval.abs().max()))
    phase("evaluation", t0, f"{n_eval} rows, {launches} geodesic launch(es); "
          f"Acc {result.per_category_acc} Med "
          f"{ {k: round(v, 3) for k, v in result.per_category_med.items()} } "
          f"val_loss {result.val_loss:.4f}; equal to the plain CPU recomputation")

    # 7. times (CUDA events, after warm-up), with the card beside each
    with torch.no_grad():
        for b in (1, 64, 256):
            xb = torch.from_numpy(np.random.default_rng(4).standard_normal(
                (b, 224, 224, 3), dtype=np.float32)).to(dev)
            ms = cuda_ms(lambda: model(xb), iters=20 if b < 256 else 10)
            phase("time", t0, f"student serving f32 batch {b}: {ms:.3f} ms/batch = "
                  f"{b * 1000.0 / ms:.1f} img/s [{card}]")
    times = {}
    for rows in (10_000, 1_000_000):
        p, l_ = p_dev[:rows].contiguous(), l_dev[:rows].contiguous()
        k_ms = cuda_ms(lambda: geodesic.rotation_err(p, l_), iters=200)
        plain_ms = cuda_ms(lambda: geometry.rotation_err(p, l_), iters=200)
        times[rows] = (k_ms, plain_ms)
        phase("time", t0, f"geodesic {rows} rows: kernel {k_ms * 1000:.2f} us, plain "
              f"{plain_ms * 1000:.2f} us ({plain_ms / k_ms:.2f}x) [{card}]")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "geodesic_rotation_err", "route": "cuda",
        "source": "pose3d_tpu_torch/csrc/geodesic.cu",
        "replaces": "pose3d_tpu/ops/geodesic.py:65",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": times[1_000_000][0], "plain_ms": times[1_000_000][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
