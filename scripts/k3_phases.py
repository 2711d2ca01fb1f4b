#!/usr/bin/env python3
"""Where a bf16 K3 call on the wgmma body (head widths 128 and 256, and
64 over ungrouped heads) spends its time, phase by phase, block by
block.

    python3 scripts/k3_phases.py

Needs a CUDA card and nvcc.  It copies ``csrc/flash_attention.cu`` into
``build/k3_phases/``, stamps the wgmma kernel's consumer thread 0 of each
block with ``clock64`` after each phase (barrier set-up and, split, the
cluster barrier; the q tile staged; each of the first 8 tile steps; rank
0's wait for the other ranks' partials and its fold; the end before the
output store) and with ``globaltimer`` at its start and end, builds it
with nvcc and runs it at the serving shapes (jamba-v0.1-52b's and
llama-3.2-vision-90b's heads at hd 128, gemma3-4b-edge's at hd 256;
causal S 32 and 512, the vision cross-attention's Sq 1 and 45 over 1024
keys; musicgen-large's ungrouped hd-64 heads at S 32 and 512), each
with the launcher's own split plan, then forced to split (whenever 2..8
chunks) and forced whole.  Prints, per case, the device
time of a launch (``chip_smoke``'s clock), the blocks' spread in
``globaltimer`` microseconds and each phase's median in thousands of SM
cycles.  The stamps cost a few stores a block; compare phases, not these
device times with the package's.
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

SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "k3_phases"
STAMPS = 16
# (anchor in flash_attention.cu, what replaces it)
EDITS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     f"__device__ unsigned long long g_t[8192][{STAMPS}];\n"
     "__device__ __forceinline__ unsigned long long wall() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "int g_force_split = 0;\n"),
    ("  constexpr int kC = Cfg::kConsumers;\n",
     "  constexpr int kC = Cfg::kConsumers;\n"
     "  const unsigned long long t_start = clock64();\n"
     "  const int blin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
     "blockIdx.z);\n"
     "  unsigned long long* T = g_t[blin < 8192 ? blin : 0];\n"
     "  const bool rec = blin < 8192 && threadIdx.x == 0;\n"
     "  if (rec) { T[0] = t_start; T[12] = wall(); }\n"),
    ("  if (rank >= active) return;",
     "  if (rec) T[1] = clock64();\n  if (rank >= active) return;"),
    ("  named_sync(bar_id, 128);\n  const uint32_t q_base",
     "  named_sync(bar_id, 128);\n  if (rec) T[2] = clock64();\n"
     "  const uint32_t q_base"),
    ("    if (ctid == 0) mbar_arrive(&empty[s]);  // the stage may be "
     "refilled\n  }",
     "    if (ctid == 0) mbar_arrive(&empty[s]);  // the stage may be "
     "refilled\n    if (rec && i < 8) T[3 + i] = clock64();\n  }"),
    ("    if (active > 1) mbar_wait_cluster(ready, 0);",
     "    if (active > 1) mbar_wait_cluster(ready, 0);\n"
     "    if (rec) T[14] = clock64();"),
    ("    named_sync(bar_id, 128);\n    if (ctid == 0)\n"
     "      for (int c = 1; c < active; ++c) mbar_arrive_remote(done, c);",
     "    if (rec) T[15] = clock64();\n    named_sync(bar_id, 128);\n"
     "    if (ctid == 0)\n"
     "      for (int c = 1; c < active; ++c) mbar_arrive_remote(done, c);"),
    ("#pragma unroll\n  for (int i = 0; i < 2; ++i) {\n    float li = l[i];",
     "  if (rec) { T[11] = clock64(); T[13] = wall(); }\n"
     "#pragma unroll\n  for (int i = 0; i < 2; ++i) {\n    float li = l[i];"),
    ("  const int n = wgmma_split(",
     "  const int n = g_force_split > 0 ? g_force_split\n"
     "      : g_force_split < 0 ? wgmma_split(1, 1, Sq, Skv, q_offset, "
     "causal, 1 << 30)\n      : wgmma_split("),
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
extern "C" void phases_force_split(int n) {{ g_force_split = n; }}
"""


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = SRC.read_text()
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:60]!r}")
        src = src.replace(anchor, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "flash_phases.cu").write_text(src + READ)
    lib = OUT / "flash_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "flash_phases.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.phase_device()
    lib = build()
    fn = lib.flash_attention_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P] * 4 + [I] * 9 + [L] * 12 + [P, P]
    lib.phases_force_split.argtypes = [I]
    lib.phases_read.argtypes = [P]
    buf = np.zeros((8192, STAMPS), dtype=np.uint64)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def launch(q, k, v, causal):
        B, Sq, H, hd = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                 B, Sq, k.shape[1], 0, H, k.shape[2], hd, int(causal),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], torch.cuda.current_stream().cuda_stream,
                 None)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def med(x):
        return float(np.median(x)) / 1e3 if len(x) else float("nan")

    cases = [("jamba S=512", 512, 512, chip_smoke.JAMBA_HEADS, True),
             ("vision S=512", 512, 512, chip_smoke.VISION_HEADS, True),
             ("gemma3 S=512", 512, 512, chip_smoke.GEMMA_HEADS, True),
             ("jamba S=32", 32, 32, chip_smoke.JAMBA_HEADS, True),
             ("gemma3 S=32", 32, 32, chip_smoke.GEMMA_HEADS, True),
             ("cross Sq=1", 1, 1024, chip_smoke.VISION_HEADS, False),
             ("cross Sq=45", 45, 1024, chip_smoke.VISION_HEADS, False),
             ("musicgen S=512", 512, 512, chip_smoke.MUSICGEN_HEADS, True),
             ("musicgen S=32", 32, 32, chip_smoke.MUSICGEN_HEADS, True)]
    for force, plan in ((0, "plan"), (-1, "split"), (1, "whole")):
        lib.phases_force_split(force)
        for name, Sq, Skv, (H, KV, hd), causal in cases:
            q = torch.randn(1, Sq, H, hd, generator=gen,
                            device="cuda").bfloat16()
            k, v = (torch.randn(1, Skv, KV, hd, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            ms = chip_smoke._device_ms(lambda: launch(q, k, v, causal))
            lib.phases_clear()
            launch(q, k, v, causal)
            torch.cuda.synchronize()
            if lib.phases_read(buf.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            t = buf.astype(np.int64)
            t = t[t[:, 0] > 0]
            work = t[t[:, 2] > 0]             # blocks that walked keys
            steps = [med(work[work[:, 3 + j] > 0, 3 + j]
                         - work[work[:, 3 + j] > 0, 2 + j])
                     for j in range(8) if (work[:, 3 + j] > 0).any()]
            last = np.array([r[3:11][r[3:11] > 0].max() for r in work])
            done = work[:, 11] > 0
            r0 = work[:, 14] > 0
            fold = (f"; rank 0: wait {med(work[r0, 14] - last[r0]):.2f}, "
                    f"fold {med(work[r0, 15] - work[r0, 14]):.2f}"
                    if r0.any() else "")
            print(f"[k3_phases {plan}] {name}: device ms {ms:.4f}; blocks "
                  f"{len(t)} ({len(work)} walked); blocks start within "
                  f"{(t[:, 12].max() - t[:, 12].min()) / 1e3:.1f} us, end "
                  f"{(work[done, 13].max() - t[:, 12].min()) / 1e3:.1f} us "
                  f"after the first; kcycles: set-up "
                  f"{med(t[:, 1] - t[:, 0]):.2f}, q tile "
                  f"{med(work[:, 2] - work[:, 1]):.2f}, steps "
                  + " ".join(f"{x:.2f}" for x in steps)
                  + ", after the last step "
                  f"{med(work[done, 11] - last[done]):.2f}" + fold)
    print(f"[k3_phases] [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
