"""Where the bf16 eval PointNet kernel's time goes, on the card: copies of a
version of csrc/pointnet_eval.cu with one part of its bf16 encoder dropped,
each timed by CUDA graph replay in turns with the whole source.

    python -m pose3d_tpu_torch.tools.pointnet_eval_parts [--source FILE ...]
        [--shape N,P,D ...] [--part NAME ...]

Each part is a text substitution on the source (the patterns of the
source as of commit daad727, whose encoder runs layer 3 on mma.sync, and
of the wgmma encoder that replaced it, whose dropped parts' calls go to
stand-ins that move their inputs into their outputs, so that what feeds a
part is still computed and what it feeds still runs; a part that matches
nothing in a source is skipped):
  products  layer 3's tensor-core products (daad727: one integer op on
            their operands in their place);
  ring      W3's copies into shared memory (the products read whatever
            the stages hold);
  layers12  layers 1-2 (layer 3 reads a stale or opaque h2);
  negate    (wgmma encoder) the negation of W3's columns in shared memory;
  fold      (wgmma encoder) the max's fold across a warp's rows (the row
            pairs' max kept: a stand-in for it lets ptxas serialize the
            products, C7511);
  epilogue  (daad727) the max over the points, the accumulators summed in
            its place.
The outputs of a copy are garbage.
For each shape (default the bf16 teacher's serving shape (64, 2500, 1024)
and the KD step's (46, 2500, 1024)) it prints one JSON line: the card's
name and power limit, each copy's device time a call in ms by graph replay
(the copies in order, then in reverse), and each copy's largest
difference from pointnet_eval_bf16_plain over max|ref| (a whole source's
is one bf16 ulp, 2^-7, at most). Then one line a copy with its registers
and spills from `nvcc -Xptxas -v` (for a kernel that moves registers
between its warpgroups by setmaxnreg, the count at launch) and the highest
register its SASS names (cuobjdump). Needs a CUDA device and nvcc; run
from the repository's root.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke
from pose3d_tpu_torch.ops import _build, pointnet

# the old encoder's pass without its max: the accumulators summed and the
# sum stored where it cannot be (so that ptxas keeps every product)
_KEEP_ALIVE = """
      float keep = 0.0f;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) keep += acc[i][j][0];
      if (keep == -1.0f) row[0] = keep;
"""

# The wgmma encoder's parts are its device functions: a dropped part's calls
# go to a stand-in (inserted before `struct BParams`) that moves its inputs
# into its outputs, so that what feeds it is still computed and what it
# feeds still runs.
_STAND_INS = """
template <int kSteps>
__device__ __forceinline__ void stand_in_product(float (&acc)[64], const uint32_t (&a)[kSteps][4],
                                                 uint32_t, uint32_t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __uint_as_float(a[i % kSteps][i % 4]);
}
__device__ __forceinline__ void stand_in_tma_chunk(uint32_t, const CUtensorMap*, uint32_t bar,
                                                   long long) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void stand_in_layer1(uint32_t (&a)[kC1 / 16][4], const float (&x)[2][3],
                                                const float*, int) {
#pragma unroll
  for (int i = 0; i < 4 * (kC1 / 16); ++i) a[i / 4][i % 4] = __float_as_uint(x[i % 2][i % 3]);
}
__device__ __forceinline__ void stand_in_layer2_out(uint32_t (&a)[kC2 / 16][4], const float (&acc)[64],
                                                    const float*, int) {
#pragma unroll
  for (int i = 0; i < 4 * (kC2 / 16); ++i) a[i / 4][i % 4] = __float_as_uint(acc[i]);
}
__device__ __forceinline__ float stand_in_xor8(const float* v) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x ^= __float_as_uint(v[i]);
  return __uint_as_float(x);
}
__device__ __forceinline__ float4 stand_in_fold_columns(const float (&m)[32], float*, int, int, int) {
  return make_float4(stand_in_xor8(m), stand_in_xor8(m + 8), stand_in_xor8(m + 16),
                     stand_in_xor8(m + 24));
}

struct BParams {"""

# part -> [(pattern, replacement)]: the old encoder's, then the new one's
PARTS = {
    "products": [
        (r"for \(int i = 0; i < kMT; \+\+i\) mma_bf16\(acc\[i\]\[j\], a\[i\], b\.x, b\.y\);",
         "for (int i = 0; i < kMT; ++i) acc[i][j][0] = __uint_as_float("
         "__float_as_uint(acc[i][j][0]) ^ a[i][0] ^ b.x);"),
        (r"\bproduct_issue<kKB3>\(", "stand_in_product<kKB3>("),
    ],
    "ring": [
        (r"(i < kNT \* 16; i \+= kSliceThreads\)\n\s*)cp_async16\(buf \+ 4 \* i, src \+ 4 \* i\);",
         r"\1(void)src;"),
        (r"\btma_chunk\((?=ring_a)", "stand_in_tma_chunk("),
    ],
    "layers12": [
        (r"(?s)    \{  // layers 1 and 2 for the warp's m-tile.*?\n    \}\n"
         r"(    __syncthreads\(\);  // h2 is stored)", r"\1"),
        (r"\blayer1\((?=a1)", "stand_in_layer1("),
        (r"\bproduct_issue<kKB2>\(", "stand_in_product<kKB2>("),
        (r"\blayer2_out\((?=a2)", "stand_in_layer2_out("),
    ],
    "negate": [(r"if \(mk\.x \| mk\.y \| mk\.z \| mk\.w\)", "if (false)")],
    "fold": [(r"\bfold_columns\((?=m, my_fold)", "stand_in_fold_columns(")],
    "epilogue": [
        (r"(?s)      // the pass's max over the tile's valid points, as the f32 kernel's\n.*?"
         r"row\[c\] = tile == tile_lo \? m : fmaxf\(row\[c\], m\);\n      \}\n",
         _KEEP_ALIVE),
    ],
}
SHAPES = ((64, 2500, 1024), (46, 2500, 1024))


def variants(text: str) -> dict[str, str]:
    """{"whole": text, part: text with that part dropped} for the parts
    whose patterns match."""
    out = {"whole": text}
    for part, subs in PARTS.items():
        dropped, hits = text, 0
        for pattern, repl in subs:
            dropped, k = re.subn(pattern, repl, dropped)
            hits += k
        if hits:
            out[part] = dropped.replace("struct BParams {", _STAND_INS.lstrip("\n"), 1)
    return out


def build(tag: str, text: str) -> tuple[str, str]:
    """nvcc with the package's flags; (library path, ptxas report)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"pne_parts_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = src[:-3] + ".so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def encoder_report(log: str) -> str:
    """ptxas's registers and spills of the bf16 encoder kernel(s)."""
    lines = log.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "encoder_bf16" in line:
            stats = " ".join(x.split("ptxas info    : ", 1)[-1] for x in lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", stats)
            spill = re.search(r"(\d+) bytes spill stores", stats)
            found.append(f"{regs.group(1) if regs else '?'} registers, "
                         f"{spill.group(1) if spill else '?'} bytes spilled")
    found += sorted({line.split("warning : ")[-1][:160] for line in lines if "C75" in line})
    return "; ".join(found)


def sass_top_register(lib: str) -> int:
    """The highest register R<n> that the bf16 encoder's SASS names."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    parts = [p for p in sass.split("Function : ")[1:] if "encoder_bf16" in p.split(None, 1)[0]]
    return max((int(r) for p in parts for r in re.findall(r"\bR(\d+)\b", p)), default=-1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="a version of csrc/pointnet_eval.cu (default: this one)")
    ap.add_argument("--shape", action="append", default=[],
                    type=lambda s: tuple(int(v) for v in s.split(",")))
    ap.add_argument("--part", action="append", default=[], choices=["whole", *PARTS],
                    help="the copies to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pointnet_eval_parts needs a CUDA device")
    sources = args.source or [os.path.join(_build.CSRC_DIR, "pointnet_eval.cu")]
    shapes = args.shape or SHAPES
    card = chip_smoke.card_line()
    jobs = {}
    for k, path in enumerate(sources):
        with open(path) as f:
            for name, text in variants(f.read()).items():
                if not args.part or name in args.part:
                    jobs[k, name] = text
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(f"{kv[0][0]}_{kv[0][1]}", kv[1]),
                                        jobs.items())))
    dev = torch.device("cuda")
    side = torch.cuda.Stream()
    for n, p, d in shapes:
        layers = chip_smoke.pointnet_bf16_params(np.random.default_rng(35), d, dev)
        pts = (2 * torch.rand((n, p, 3), generator=torch.Generator().manual_seed(p)) - 1).to(
            dev, torch.bfloat16)
        ref = pointnet.pointnet_eval_bf16_plain(pts, layers).float()
        times, errs = {}, {}
        for order in (list(built), list(built)[::-1]):
            for key in order:
                lib = built[key][0]
                call = lambda: pointnet.pointnet_eval_bf16(pts, layers)  # noqa: E731
                times.setdefault(f"{sources[key[0]]}: {key[1]}", []).append(round(
                    chip_smoke.with_pointnet_source(
                        lib, lambda _: chip_smoke.graph_ms(call, side)), 4))
                name = f"{sources[key[0]]}: {key[1]}"
                if name not in errs:
                    out = chip_smoke.with_pointnet_source(lib, lambda _: call()).float()
                    errs[name] = round(float((out - ref).abs().max() / ref.abs().max()), 6)
        print(json.dumps({"shape": [n, p, d], "card": card, "ms": times,
                          "err_over_max_ref": errs}), flush=True)
    for (k, name), (lib, log) in built.items():
        print(json.dumps({"source": sources[k], "copy": name, "ptxas": encoder_report(log),
                          "sass_top_register": sass_top_register(lib)}))


if __name__ == "__main__":
    main()
