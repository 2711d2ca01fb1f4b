#!/usr/bin/env python3
"""Where a K1 (decode attention) call on the tensor-core body spends its
time, stage by stage.

    python3 scripts/k1_stages.py [--src DIR] [--tag NAME]

Needs a CUDA card and nvcc.  It copies the decode headers
(``csrc/decode_tile.cuh``, ``csrc/mma_bf16.cuh``) of ``--src`` (a
checkout's ``src`` directory; this one by default) into
``build/k1_stages/<tag>/``, inserts an early exit after each stage of
``decode_tc_kernel`` and its ``block_fold`` (``#if STOP == n``), builds
one small benchmark per exit point with nvcc (all at once) and times
each with CUDA events over 200 back-to-back launches queued behind a
spin kernel.  Shapes: bf16, B 1, a 512-slot ring (a cluster of 8 blocks
per KV head), at the served head layouts (H/KV/hd) of gemma-2b (8/1/256),
qwen3-32b (64/8/128), llama4-maverick (40/8/128) and gemma3-4b-edge
(8/4/256, the G 2 control), at fill levels 23 (rank 0 alone), 127 and
511.  A stage's cost is the difference between two exit points: what the
kernel does up to an exit point is kept alive by a store that never
happens.  The exits are found by anchor lines, with one set for the body
before the wide-group redesign and one after, so two revisions can be
staged in one run (``--src`` of the other checkout).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels._build import _nvcc  # noqa: E402

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
HEADERS = ("decode_tile.cuh", "mma_bf16.cuh")
LAYOUTS = [("gemma2b", 8, 1, 256), ("qwen3", 64, 8, 128),
           ("llama4", 40, 8, 128), ("gemma3", 8, 4, 256)]
LEVELS = (23, 127, 511)

SINK = "if (a.scale == 12345.f) static_cast<float*>(a.o)[tid] = "
TC = "decode_tc_kernel(DecodeArgs a) {\n"
FOLD = "__device__ __forceinline__ void block_fold("
# (exit point, the stage it ends, alternatives); an alternative is a list
# of insertions (region, anchor, before or after it, code), taken when all
# its anchors are found after their region's start.  The first
# alternative is the body before the wide-group redesign, the second the
# one after.
STAGES = [
    (0, "launch + fill-level read",
     [[(TC, "  const int hi = min(live, lo + per);\n", "after",
        f"  {SINK}(float)hi; return;\n")]]),
    (1, "q load + slot loop",
     [[(TC, "  // the pair's partial: l summed over the slot lanes; m is "
        "already theirs\n", "before",
        "  { float z = m[0] + m[1] + l[0] + l[1];\n"
        "    for (int i = 0; i < MT; ++i)\n"
        "      z += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];\n"
        f"    {SINK}z; return; }}\n")]]),
    (2, "pair stores to shared memory",
     [[(TC, "  __syncthreads();\n  block_fold<", "before",
        f"  __syncthreads();\n  {SINK}wacc[tid] + sh.wl[0][0]; return;\n")]]),
    (3, "warp fold (solo: and the output store)",
     [[(FOLD, "    pacc[g * hd + d] = asum;\n", "before",
        f"    {SINK}asum + lsum + mx; continue;\n"),
       (FOLD, "  cluster.sync();", "before", "  return;\n")],
      [(FOLD, "    // push: columns to their rank", "before",
        f"    {SINK}s[0] + s[U - 1]; continue;\n"),
       (FOLD, "  cluster.sync();", "before", "  return;\n")]]),
    (4, "push into the ranks + cluster barrier",
     [[(FOLD, "  cluster.sync();", "after",
        f"  {SINK}sh.cl[0][0]; return;")]]),
    (9, "rank fold and output store (not solo)", []),
]

BENCH = r"""
#include "decode_tile.cuh"
#include <cstdio>
__global__ void spin(long long c) {
  long long t0 = clock64();
  while (clock64() - t0 < c) {}
}
int main() {
  const int S = 512, B = 1, n_split = 8;
  const int layouts[4][3] = {LAYOUTS};
  for (int li = 0; li < 4; ++li) {
    const int H = layouts[li][0], KV = layouts[li][1], hd = layouts[li][2];
    __nv_bfloat16 *q, *k, *v, *o;
    int* t;
    cudaMalloc(&q, H * hd * 2);
    cudaMalloc(&o, H * hd * 2);
    cudaMalloc(&k, S * KV * hd * 2);
    cudaMalloc(&v, S * KV * hd * 2);
    cudaMalloc(&t, 4);
    cudaMemset(q, 0, H * hd * 2);
    cudaMemset(k, 0, S * KV * hd * 2);
    cudaMemset(v, 0, S * KV * hd * 2);
    for (int tt : {LEVELS}) {
      cudaMemcpy(t, &tt, 4, cudaMemcpyHostToDevice);
      DecodeArgs a{};
      a.q = q; a.k = k; a.v = v; a.t = t; a.o = o; a.S = S; a.G = H / KV;
      a.hd = hd; a.page = 1; a.q_sb = H * hd; a.q_sh = hd;
      a.o_sb = H * hd; a.o_sh = hd; a.c_sb = S * KV * hd;
      a.c_ss = KV * hd; a.c_sh = hd;
      for (int i = 0; i < 10; ++i)
        dispatch_dtype<false>(1, a, B, KV, n_split, 0);
      cudaDeviceSynchronize();
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      spin<<<1, 1>>>(40000000);
      cudaEventRecord(e0);
      int err = 0;
      for (int i = 0; i < 200; ++i)
        err |= dispatch_dtype<false>(1, a, B, KV, n_split, 0);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      if (err || cudaGetLastError() != cudaSuccess) return 1;
      printf("%d %d %.4f\n", li, tt, ms / 200 * 1000);
    }
    cudaFree(q); cudaFree(o); cudaFree(k); cudaFree(v); cudaFree(t);
  }
  return 0;
}
"""


def variant_source(src: str) -> str:
    """``src`` with every stage's early exit inserted under ``#if``."""
    for stop, _, alternatives in STAGES:
        for edits in alternatives:
            spots = []
            for region, anchor, where, code in edits:
                start = src.find(region)
                i = src.find(anchor, start) if start >= 0 else -1
                if i < 0:
                    break
                spots.append((i + (len(anchor) if where == "after" else 0),
                              f"\n#if STOP == {stop}\n{code}\n#endif\n"))
            else:
                for i, text in sorted(spots, reverse=True):
                    src = src[:i] + text + src[i:]
                break
        else:
            if alternatives:
                raise ValueError(f"no anchor set of stage {stop} fits: "
                                 "the kernel changed")
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="a checkout's src directory (default: this one)")
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    csrc = Path(args.src) / "repro_torch" / "csrc"
    out = ROOT / "build" / "k1_stages" / args.tag
    out.mkdir(parents=True, exist_ok=True)
    for name in HEADERS:
        text = (csrc / name).read_text()
        (out / name).write_text(variant_source(text) if name ==
                                "decode_tile.cuh" else text)
    layouts = ", ".join("{%d, %d, %d}" % lay[1:] for lay in LAYOUTS)
    (out / "bench.cu").write_text(
        BENCH.replace("{LAYOUTS}", "{" + layouts + "}")
        .replace("{LEVELS}", "{" + ", ".join(map(str, LEVELS)) + "}"))

    def build(stop):
        exe = out / f"stop{stop}"
        subprocess.run([_nvcc(), *FLAGS, f"-DSTOP={stop}", "-o", str(exe),
                        str(out / "bench.cu")], check=True,
                       capture_output=True, text=True)
        return exe

    with ThreadPoolExecutor(len(STAGES)) as pool:
        exes = list(pool.map(build, [s[0] for s in STAGES]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    us = {}
    for (stop, *_), exe in zip(STAGES, exes):
        lines = subprocess.run([str(exe)], capture_output=True, text=True,
                               check=True).stdout.split("\n")
        for line in filter(None, lines):
            li, t, x = line.split()
            us[stop, int(li), int(t)] = float(x)
    print(f"[k1-stages {args.tag}] bf16 B1 S512, 8 splits, us per call "
          f"(200 back to back), {csrc}  [{smi}]")
    for li, (name, H, KV, hd) in enumerate(LAYOUTS):
        for t in LEVELS:
            prev, parts = 0.0, []
            for stop, stage, _ in STAGES:
                parts.append(f"{stage} {us[stop, li, t] - prev:.3f}")
                prev = us[stop, li, t]
            print(f"[k1-stages {args.tag}] {name} H{H}/KV{KV} hd{hd} "
                  f"t={t}: total {prev:.3f} = " + " + ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
