"""How close the train-mode PointNet kernels' statistics and ReLU decisions
come to float64's, beside the f32 plain version's, on the card.

    python -m pose3d_tpu_torch.tools.pointnet_train_precision [--source OTHER.cu]

For each case (the teacher step's and stage 1's shapes, and N 160 at P 100
and D 1024, seeded clouds and He-scaled layers) it prints one JSON line a
build: the batch statistics' errors against float64's (each mean's in units
of its channel's standard deviation, each variance's relative), the ReLU
decisions (h1, h2 > 0) that differ from float64's, and at up to 8 of them
the float64 ReLU input and the kernels' output, both over the channel's
max|input|. The f32 plain version's errors and decisions on the same inputs
come first. With --source, another version of csrc/pointnet_train.cu (an
earlier commit's, from `git show`, with or without the Gram sums in its
entry point) is built beside this one and measured on the same inputs. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import numpy as np
import torch

from pose3d_tpu_torch.models.common import BN_EPS, batch_stats
from pose3d_tpu_torch.ops import _build, pointnet_train as pt

CASES = ((160, 2500, 256), (46, 2500, 256), (160, 100, 1024), (160, 2500, 1024))
SHOWN = 8  # flipped entries printed a case


def inputs(seed: int, n: int, p: int, d: int, dev):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, p, 3)) * rng.uniform(0.2, 1.0, (n, 1, 3))
    layers = [[rng.standard_normal((out, fan_in)) * math.sqrt(2.0 / fan_in),
               0.1 * rng.standard_normal(out), 1.0 + 0.1 * rng.standard_normal(out),
               0.1 * rng.standard_normal(out)]
              for fan_in, out in ((3, 64), (64, 128), (128, d))]
    as_dev = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return as_dev(pts), [[as_dev(a) for a in layer] for layer in layers]


def forward_parts(pts, layers, valid=None, masks=None):
    """The plain version's operations in the inputs' dtype, with what it
    keeps to itself: returns (the layer-3 output before the max (N, P, D),
    (y1, y2) the two ReLUs' inputs, the three (mean, var)). With `masks`
    ((N, P, 64) and (N, P, 128) bool), the ReLUs open where those are set
    instead of where their inputs are positive."""
    x, pre, stats = pts, [], []
    for i, (w, b, gamma, beta) in enumerate(layers):
        x = torch.nn.functional.linear(x, w, b)
        mean, var = batch_stats(x, (0, 1), valid)
        stats.append((mean, var))
        x = (x - mean) * (torch.rsqrt(var + BN_EPS) * gamma) + beta
        if i < 2:
            pre.append(x)
            x = torch.relu(x) if masks is None else x * masks[i]
    return x, pre, stats


def stat_errors(stats, ref) -> list[list[float]]:
    """Per layer [max |mean error| / std, max |variance error| / variance]."""
    return [[float(((m.double() - mr).abs() / vr.sqrt()).max()),
             float(((v.double() - vr).abs() / vr).max())]
            for (m, v), (mr, vr) in zip(stats, ref)]


def flips(h_pairs, pre_ref) -> tuple[int, list]:
    """Decisions other than float64's, and [layer, f64 input, kernel output]
    (over the channel's max|input|) at the first SHOWN of them."""
    count, shown = 0, []
    for layer, (h, y) in enumerate(zip(h_pairs, pre_ref)):
        differ = (h > 0) != (y > 0)
        count += int(differ.sum())
        scale = y.abs().amax((0, 1))
        for at in differ.nonzero()[:SHOWN - len(shown)].tolist():
            c = at[-1]
            shown.append([layer + 1, float(y[tuple(at)] / scale[c]),
                          float(h[tuple(at)].double() / scale[c])])
    return count, shown


def with_lib(lib: ctypes.CDLL):
    """The wrapper's forward on another build of its own interface:
    (points, prm, d) -> (stats, h1, h2)."""
    def run(pts, prm, d):
        own = pt._lib
        pt._lib = lambda: lib
        try:
            _, stats, _, h1, h2, _ = pt.train_forward(pts, prm, d, None)
        finally:
            pt._lib = own
        return stats, h1, h2
    return run


def without_gram(lib: ctypes.CDLL):
    """The forward of a version whose entry point keeps no Gram sums
    (csrc/pointnet_train.cu before the Gram form of layer 3), called as
    its wrapper called it."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.pointnet_train_forward_f32
    fn.argtypes = [vp, vp, i64, i64, i64] + [vp] * 8 + [ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    lib.pointnet_train_workspace.argtypes = [i64, i64, i64, ctypes.c_int, ctypes.c_int]
    lib.pointnet_train_workspace.restype = i64

    def run(pts, prm, d):
        n, p, _ = pts.shape
        sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
        new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,
                                                              device=pts.device)
        stats, out, idx = new(2 * (64 + 128 + d)), new(n, d), new(n, d, dtype=torch.int32)
        h1, h2 = new(n, p, 64), new(n, p, 128)
        ws = new(lib.pointnet_train_workspace(n, p, d, sms, 0))
        iws = new(lib.pointnet_train_workspace(n, p, d, sms, 1), dtype=torch.int32)
        err = fn(pts.data_ptr(), None, n, p, d, prm.data_ptr(), stats.data_ptr(), out.data_ptr(),
                 idx.data_ptr(), h1.data_ptr(), h2.data_ptr(), ws.data_ptr(), iws.data_ptr(),
                 sms, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"forward kernel launch failed: cudaError_t {err}")
        return stats, h1, h2
    return run


def load(source: str):
    """Build another version of csrc/pointnet_train.cu; return its forward
    as `with_lib` returns it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "libpointnet_train_other.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    with open(source) as f:
        has_gram = "double* gram" in f.read()
    if not has_gram:
        return without_gram(ctypes.CDLL(out))
    load_own = _build.load
    _build.load = lambda name: ctypes.CDLL(out)
    try:
        return with_lib(pt._lib.__wrapped__())
    finally:
        _build.load = load_own


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", help="another version of csrc/pointnet_train.cu to measure")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pointnet_train_precision: no CUDA device")
    dev = torch.device("cuda")
    builds = {"this source": with_lib(pt._lib())}
    if args.source:
        builds[args.source] = load(args.source)
    for seed, (n, p, d) in enumerate(CASES):
        pts, layers = inputs(seed, n, p, d, dev)
        _, pre64, stats64 = forward_parts(pts.double(), [[t.double() for t in l] for l in layers])
        _, pre32, stats32 = forward_parts(pts, layers)
        count, _ = flips([y > 0 for y in pre32], pre64)
        print(json.dumps({"case": [n, p, d], "build": "f32 plain version",
                          "stats": stat_errors(stats32, stats64), "flips": count}), flush=True)
        del pre32
        prm = pt.pack_params(layers)
        for name, forward in builds.items():
            stats, h1, h2 = forward(pts, prm, d)
            count, shown = flips((h1, h2), pre64)
            print(json.dumps({"case": [n, p, d], "build": name,
                              "stats": stat_errors(pt.split_stats(stats, d), stats64),
                              "flips": count, "at flips [layer, f64 input, kernel output]": shown}),
                  flush=True)
        del pre64
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
