#!/usr/bin/env python3
"""Where a K1 (decode attention) call spends its time, stage by stage.

    python3 scripts/k1_stages.py

Needs a CUDA card and nvcc.  It copies ``csrc/decode_tile.cuh`` into
``build/k1_stages/``, inserts an early exit after each stage of the
kernel (``#if STOP == n``), builds one small benchmark per exit point
with nvcc (all at once) and times each with CUDA events over 200
back-to-back launches queued behind a spin kernel, at the serial path's
shape: bf16, B 1, 15 query heads over 5 KV heads, hd 64, a 512-slot ring
(a cluster of 8 blocks per KV head), fill levels 23 (rank 0 alone), 127
and 511.  A stage's cost is the difference between two exit points: what
the kernel does up to an exit point is kept alive by a store that never
happens.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels._build import _nvcc  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "csrc" / "decode_tile.cuh"
OUT = ROOT / "build" / "k1_stages"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

SINK = "if (a.scale == 12345.f) static_cast<float*>(a.o)[tid] = "
STATE = ("  { float z = 0.f;\n#pragma unroll\n"
         "    for (int g = 0; g < GM; ++g) { z += m[g] + l[g];\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < V; ++i) z += acc[g][i]; }\n"
         f"    {SINK}z; return; }}\n")
# (exit point, stage it ends, where in the kernel, before or after it,
# the early exit)
STAGES = [
    (0, "launch + fill-level read",
     "  const int hi = min(live, lo + per);\n", "after",
     f"  {SINK}(float)hi; return;\n"),
    (1, "q load + slot loop",
     "        acc[g][i] = fmaf(acc[g][i], alpha, pg * vf[i]);\n    }\n  }\n",
     "after", STATE),
    (2, "row-group merge (shuffles)", "  if (rg == 0) {\n", "before",
     STATE),
    (3, "warp partials to shared memory", "  if (!solo) cluster_wait();\n",
     "before", f"  {SINK}sh.wl[0][0] + wacc[tid]; return;\n"),
    (4, "block fold (solo: and the output store; else: the push into rank "
     "0 and the cluster barrier)",
     "  if (rank != 0) return;             // nothing reads this block "
     "any more\n", "after", f"  {SINK}sh.cl[0][0]; return;\n"),
    (9, "rank-0 fold and output store (not solo)", None, None, None),
]

BENCH = r"""
#include "decode_tile.cuh"
#include <cstdio>
__global__ void spin(long long c) {
  long long t0 = clock64();
  while (clock64() - t0 < c) {}
}
int main() {
  const int S = 512, KV = 5, G = 3, hd = 64, B = 1, n_split = 8;
  __nv_bfloat16 *q, *k, *v, *o;
  int* t;
  cudaMalloc(&q, 15 * hd * 2);
  cudaMalloc(&o, 15 * hd * 2);
  cudaMalloc(&k, S * KV * hd * 2);
  cudaMalloc(&v, S * KV * hd * 2);
  cudaMalloc(&t, 4);
  cudaMemset(q, 0, 15 * hd * 2);
  cudaMemset(k, 0, S * KV * hd * 2);
  cudaMemset(v, 0, S * KV * hd * 2);
  for (int tt : {23, 127, 511}) {
    cudaMemcpy(t, &tt, 4, cudaMemcpyHostToDevice);
    DecodeArgs a{};
    a.q = q; a.k = k; a.v = v; a.t = t; a.o = o; a.S = S; a.G = G;
    a.hd = hd; a.page = 1; a.q_sb = 15 * hd; a.q_sh = hd;
    a.o_sb = 15 * hd; a.o_sh = hd; a.c_sb = S * KV * hd;
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
    printf("%d %.4f\n", tt, ms / 200 * 1000);
  }
  return 0;
}
"""


def _variant_source() -> str:
    src = SRC.read_text()
    for stop, _, anchor, where, code in STAGES:
        if anchor is None:
            continue
        i = src.index(anchor)            # ValueError: the kernel changed
        i += len(anchor) if where == "after" else 0
        src = src[:i] + f"#if STOP == {stop}\n{code}#endif\n" + src[i:]
    return src


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "decode_tile.cuh").write_text(_variant_source())
    (OUT / "bench.cu").write_text(BENCH)

    def build(stop):
        exe = OUT / f"stop{stop}"
        subprocess.run([_nvcc(), *FLAGS, f"-DSTOP={stop}", "-o", str(exe),
                        str(OUT / "bench.cu")], check=True,
                       capture_output=True, text=True)
        return exe

    with ThreadPoolExecutor(len(STAGES)) as pool:
        exes = list(pool.map(build, [s[0] for s in STAGES]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    us = {}
    for (stop, *_), exe in zip(STAGES, exes):
        out = subprocess.run([str(exe)], capture_output=True, text=True,
                             check=True).stdout.split()
        us[stop] = {int(t): float(x) for t, x in zip(out[::2], out[1::2])}
    print(f"[k1-stages] bf16 B1 H15/KV5 hd64 S512, 8 splits, us per call "
          f"(200 back to back)  [{smi}]")
    for t in (23, 127, 511):
        prev, parts = 0.0, []
        for stop, name, *_ in STAGES:
            parts.append(f"{name} {us[stop][t] - prev:.3f}")
            prev = us[stop][t]
        print(f"[k1-stages] t={t}: total {prev:.3f} = " + " + ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
