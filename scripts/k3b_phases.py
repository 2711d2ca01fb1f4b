#!/usr/bin/env python3
"""Where K3b's bf16 pass 2 (dK, dV at head widths 128 and 256) spends its
time, phase by phase, block by block.

    python3 scripts/k3b_phases.py

Needs a CUDA card and nvcc.  It copies ``csrc/flash_attention_bwd.cu``
into ``build/k3b_phases/``, stamps pass 2's thread 0 (set-up, the
cluster barrier) and thread 128 (the K/V tiles in, the first Q/dO tile
in, the end of each of the first 7 steps, the end of the walk, the wait
for the other ranks' partials, the fold) with ``clock64`` and both
threads with ``globaltimer`` at the block's start and end, builds it
with nvcc three times, with causal query chunks of 16, 32 (the kernel's
own) and 64 steps (full attention: four times as many), and runs each at the trained stacks' shapes
(llama-3.2-vision-90b's cross-attention and self-attention, hd 128;
gemma3-4b-edge, hd 256).  Prints, per case and chunk, the device time of
a whole K3b call (``chip_smoke``'s clock), the blocks launched and those
that walked, the span of their ``globaltimer`` stamps, each phase's
median in thousands of SM cycles and the median steps a block.  The
stamps cost a few stores a block; compare phases, not these device times
with the package's.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts ROOT/src on the path)

SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
OUT = ROOT / "build" / "k3b_phases"
STAMPS = 18
STEPS = (16, 32, 64)
# (anchor in flash_attention_bwd.cu, what replaces it)
EDITS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     f"__device__ unsigned long long g_t[8192][{STAMPS}];\n"
     "__device__ __forceinline__ unsigned long long wall() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("constexpr int kChunkSteps = 32;", "constexpr int kChunkSteps = K3B_STEPS;"),
    ("  const int n_split = (int)cluster_size(), rank = (int)cluster_rank();\n"
     "  const int kvh = blockIdx.x / n_split, b = blockIdx.y;\n",
     "  const int n_split = (int)cluster_size(), rank = (int)cluster_rank();\n"
     "  const int kvh = blockIdx.x / n_split, b = blockIdx.y;\n"
     "  const int blin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
     "blockIdx.z);\n"
     "  unsigned long long* T = g_t[blin < 8192 ? blin : 0];\n"
     "  const bool rec0 = blin < 8192 && threadIdx.x == 0;\n"
     "  const bool rec = blin < 8192 && threadIdx.x == 128;\n"
     "  if (rec0) { T[0] = clock64(); T[12] = wall(); }\n"),
    ("  if (rank < c_lo) return;",
     "  if (rec0) { T[1] = clock64(); T[16] = n_steps; unsigned sm; "
     "asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm)); T[17] = sm; }\n"
     "  if (rank < c_lo) return;"),
    ("  mbar_wait(kv_ready, 0);\n",
     "  mbar_wait(kv_ready, 0);\n  if (rec) T[2] = clock64();\n"),
    ("    mbar_wait(&full[s], (i / kStages) & 1);\n"
     "    float st[8][4], dpt[8][4];\n",
     "    mbar_wait(&full[s], (i / kStages) & 1);\n"
     "    if (rec && i == 0) T[3] = clock64();\n"
     "    float st[8][4], dpt[8][4];\n"),
    ("    if (ctid == 0) mbar_arrive(&empty[s]);   // the stage may be "
     "refilled\n  }\n",
     "    if (ctid == 0) mbar_arrive(&empty[s]);   // the stage may be "
     "refilled\n    if (rec && i < 7) T[4 + i] = clock64();\n  }\n"
     "  if (rec) { T[11] = clock64(); T[13] = wall(); }\n"),
    ("  mbar_wait_cluster(ready, 0);\n",
     "  mbar_wait_cluster(ready, 0);\n  if (rec) T[14] = clock64();\n"),
    ("  // stay until every active rank has read this one's partial\n",
     "  if (rec) { T[15] = clock64(); T[13] = wall(); }\n"
     "  // stay until every active rank has read this one's partial\n"),
    ('#include "mma_bf16.cuh"', f'#include "{SRC.parent}/mma_bf16.cuh"'),
    ('#include "wgmma_bf16.cuh"', f'#include "{SRC.parent}/wgmma_bf16.cuh"'),
]
READ = f"""
extern "C" int phases_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, g_t, sizeof(g_t));
}}
extern "C" int phases_clear() {{
  static unsigned long long z[8192][{STAMPS}];
  return (int)cudaMemcpyToSymbol(g_t, z, sizeof(z));
}}
"""


def build() -> dict:
    """One library a chunk length, built by parallel nvcc runs."""
    from repro_torch.kernels import _build
    src = SRC.read_text()
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:60]!r}")
        src = src.replace(anchor, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "bwd_phases.cu").write_text(src + READ)
    procs = {}
    for steps in STEPS:
        lib = OUT / f"bwd_phases_{steps}.so"
        procs[steps] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DK3B_STEPS={steps}", "-o",
             str(lib), str(OUT / "bwd_phases.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for steps, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
        libs[steps] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3b_phases: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    smi = chip_smoke.phase_device()
    libs = build()
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.flash_attention_bwd_launch.argtypes = [P] * 10 + [I] * 8 + [P]
        lib.phases_read.argtypes = [P]
    buf = np.zeros((8192, STAMPS), dtype=np.uint64)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def med(x):
        return float(np.median(x)) / 1e3 if len(x) else float("nan")

    cases = [("cross", 2, 512, 1024, chip_smoke.VISION_HEADS, False),
             ("vision self", 2, 512, 512, chip_smoke.VISION_HEADS, True),
             ("gemma3 hd 256", 4, 512, 512, chip_smoke.GEMMA_HEADS, True)]
    for name, B, Sq, Skv, (H, KV, hd), causal in cases:
        q, do = (torch.randn(B, Sq, H, hd, generator=gen,
                             device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(B, Skv, KV, hd, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        D = torch.empty(B, H, Sq, dtype=torch.float32, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        for steps, lib in libs.items():
            def launch():
                err = lib.flash_attention_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), D.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, B, Sq,
                    Skv, H, KV, hd, int(causal),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            ms = chip_smoke._device_ms(launch)
            lib.phases_clear()
            launch()
            torch.cuda.synchronize()
            if lib.phases_read(buf.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            t = buf.astype(np.int64)
            t = t[t[:, 0] > 0]
            work = t[t[:, 2] > 0]             # blocks that walked a chunk
            step_kc = [med(work[work[:, 4 + j] > 0, 4 + j]
                           - work[work[:, 4 + j] > 0, 3 + j])
                       for j in range(1, 7) if (work[:, 4 + j] > 0).any()]
            fold = work[:, 14] > 0
            print(f"[k3b_phases steps {steps}] {name}: device ms {ms:.4f}; "
                  f"blocks {len(t)} ({len(work)} walked, median "
                  f"{np.median(work[:, 16]):.0f} steps, on "
                  f"{len(set(t[:, 17].tolist()))} SMs); stamps span "
                  f"{(work[:, 13].max() - t[:, 12].min()) / 1e3:.1f} us; "
                  f"kcycles: set-up and cluster barrier "
                  f"{med(t[:, 1] - t[:, 0]):.2f}, K/V in "
                  f"{med(work[:, 2] - t[:, 1][t[:, 2] > 0]):.2f}, first "
                  f"Q/dO in {med(work[:, 3] - work[:, 2]):.2f}, step 0 "
                  f"{med(work[:, 4] - work[:, 3]):.2f}, steps "
                  + " ".join(f"{x:.2f}" for x in step_kc)
                  + (f"; folding blocks {int(fold.sum())}: wait "
                     f"{med(work[fold, 14] - work[fold, 11]):.2f}, fold "
                     f"{med(work[fold, 15] - work[fold, 14]):.2f}"
                     if fold.any() else ""))
    print(f"[k3b_phases] [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
