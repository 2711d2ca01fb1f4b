#!/usr/bin/env python3
"""K3b's bf16 instances and K3 at head width 64, timed on one card beside
the library call.

    python3 scripts/k3b_timing.py [--src DIR] [--tag NAME] [--check]

Needs a CUDA card and nvcc.  Each row is timed with ``chip_smoke``'s
device clock in turns, kernel, library, kernel, and once more with the L2
flushed before every launch (``_cold_device_ms``); each K3b row also
prints its passes' device ms from one profiled call.  The rows: K3b at
llama-3.2-vision-90b's cross-attention (full, B 2, Sq 512 over Skv 1024,
H 64 over KV 8, hd 128) and self-attention (causal B 2 S 512), at
gemma3-4b-edge's heads (causal B 4 S 512, H 8 over KV 4, hd 256), at
smollm-360m's (causal B 8 S 512, H 15 over KV 5, hd 64; also S 128 and
1000) and at musicgen-large's (causal B 4 S 512, H 32 over KV 32, hd
64), beside autograd's backward of ``scaled_dot_product_attention``
(K/V expanded to the query heads, masked alike); K3 at musicgen's heads
(G 1) and
smollm's (G 3), causal B 1 at S 16, 32 and 512 and extend 48 + 16 and 64
+ 64, beside ``scaled_dot_product_attention``.

Before timing, every row's kernel is held to its plain version on the
same inputs (within 2e-2 of max|plain| for K3b, 2e-2 for K3), two calls
are compared bit for bit, and K3's extend rows to the cold prefill's bit
for bit; ``--check`` stops there.  ``--src`` names another checkout's
``src`` directory to import ``repro_torch`` from (an older revision of
the kernels, built into that checkout), so two revisions can be timed in
turns in one run on one card.  Prints one line per row, tagged with
``--tag``, and the ``-Xptxas -v`` lines of the attention kernels.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts ROOT/src on the path)

#: (name, B, Sq, Skv, (H, KV, hd), causal)
K3B_ROWS = (
    ("cross", 2, 512, 1024, chip_smoke.VISION_HEADS, False),
    ("hd256", 4, 512, 512, chip_smoke.GEMMA_HEADS, True),
    ("vision-self", 2, 512, 512, chip_smoke.VISION_HEADS, True),
    ("smollm", 8, 512, 512, chip_smoke.SMOLLM_HEADS, True),
    ("musicgen", 4, 512, 512, chip_smoke.MUSICGEN_HEADS, True),
    ("smollm S128", 8, 128, 128, chip_smoke.SMOLLM_HEADS, True),
    ("smollm S1000", 8, 1000, 1000, chip_smoke.SMOLLM_HEADS, True),
)
#: extra K3b shapes held to the plain version before timing: ragged and
#: short lengths, cross lengths
K3B_CHECKS = (
    (2, 45, 1000, chip_smoke.VISION_HEADS, False),
    (2, 100, 100, (15, 5, 128), True),
    (2, 1000, 1000, (15, 5, 128), True),
    (2, 16, 16, (8, 4, 256), True),
    (2, 300, 300, (8, 4, 256), True),
    (2, 37, 130, (8, 4, 256), False),
)


def _row(tag, what, kern, lib, bound, extra=""):
    """Time ``kern`` beside ``lib`` (kernel, library, kernel; then cold)
    and print one line."""
    a = chip_smoke._device_ms(kern)
    lib_ms = chip_smoke._device_ms(lib)
    b = chip_smoke._device_ms(kern)
    cold = chip_smoke._cold_device_ms(kern)
    ms = (a + b) / 2
    print(f"[k3b_timing {tag}] {what}: device ms kernel {a:.4f} / {b:.4f}, "
          f"library {lib_ms:.4f} (ratio {ms / lib_ms:.2f}), cold "
          f"{cold:.4f}; bound {bound * 1e3:.3f} us{extra}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", help="import repro_torch from this directory")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--check", action="store_true",
                    help="hold the kernels to their plain versions only")
    args = ap.parse_args()
    if args.src:                # chip_smoke imported this checkout's
        for name in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("k3b_timing: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.phase_device()
    secs = _build.build(["flash_attention", "flash_attention_bwd"])
    print(f"[k3b_timing {args.tag}] nvcc: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in ("flash_attention", "flash_attention_bwd"):
        for kernel, lines in (chip_smoke._k3b_ptxas_lines(
                _build.PTXAS_REPORT.get(name, ""))
                + chip_smoke._wide_ptxas_lines(
                    _build.PTXAS_REPORT.get(name, ""))):
            print(f"[k3b_timing {args.tag}] ptxas {kernel}: "
                  + "; ".join(lines))
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, tag = torch.bfloat16, args.tag

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    def bwd_inputs(B, Sq, Skv, heads, causal):
        H, KV, hd = heads
        q, do = randn(B, Sq, H, hd), randn(B, Sq, H, hd)
        k, v = randn(B, Skv, KV, hd), randn(B, Skv, KV, hd)
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        return q, k, v, o, do, lse

    def check_bwd(B, Sq, Skv, heads, causal):
        args_ = bwd_inputs(B, Sq, Skv, heads, causal)
        got = flash_attention_bwd_cuda(*args_, causal=causal)
        again = flash_attention_bwd_cuda(*args_, causal=causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K3b not bitwise repeatable at B{B} "
                                 f"Sq{Sq} Skv{Skv} {heads}")
        worst = {}
        for label, rd in (("f32 P", None), ("bf16 P", torch.bfloat16)):
            want = flash_attention_bwd_plain(*args_, causal=causal,
                                             round_dtype=rd)
            worst[label] = chip_smoke._k3b_errs(
                f"B{B} Sq{Sq} Skv{Skv} {heads} {label}", got, want,
                chip_smoke.TOL["bf16"])
        print(f"[k3b_timing {tag}] K3b B{B} Sq{Sq} Skv{Skv} H/KV/hd {heads} "
              f"{'causal' if causal else 'full'}: max|err|/max|plain| "
              + ", ".join(f"{k} {e:.2e}" for k, e in worst.items())
              + "; two calls bitwise equal")

    for B, Sq, Skv, heads, causal in [r[1:] for r in K3B_ROWS] + list(
            K3B_CHECKS):
        check_bwd(B, Sq, Skv, heads, causal)
    for heads in (chip_smoke.MUSICGEN_HEADS, chip_smoke.SMOLLM_HEADS):
        H, KV, hd = heads
        for S in (16, 45, 96, 512):
            q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), \
                randn(1, S, KV, hd)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True)
            want, want_lse = flash_attention_plain(q, k, v, return_lse=True)
            chip_smoke._check(f"K3 {heads} S {S}",
                              chip_smoke._max_err(o, want),
                              chip_smoke.TOL["bf16"])
            chip_smoke._check(f"K3 lse {heads} S {S}",
                              chip_smoke._max_err(lse, want_lse), 1e-3)
            if not torch.equal(o, flash_attention_cuda(q, k, v)):
                raise AssertionError("K3 output with an lse differs")
        for prefix, suffix in ((48, 16), (64, 64), (200, 100), (300, 300)):
            n = prefix + suffix
            qf, k, v = randn(1, n, H, hd), randn(1, n + 16, KV, hd), \
                randn(1, n + 16, KV, hd)
            ext = flash_attention_cuda(qf[:, prefix:], k, v, q_offset=prefix)
            cold = flash_attention_cuda(qf, k[:, :n].contiguous(),
                                        v[:, :n].contiguous())
            if not torch.equal(ext, cold[:, prefix:]):
                raise AssertionError(f"K3 extend != cold at {heads} "
                                     f"{prefix}+{suffix}")
        print(f"[k3b_timing {tag}] K3 H/KV/hd {heads}: within 2e-2 of plain "
              f"(lse 1e-3) at S 16/45/96/512, extend == cold bitwise")
    if args.check:
        print(f"[k3b_timing {tag}] package {repro_torch.__file__} [{smi}]")
        return 0

    for name, B, Sq, Skv, heads, causal in K3B_ROWS:
        H, KV, hd = heads
        q, k, v, o, do, lse = bwd_inputs(B, Sq, Skv, heads, causal)

        def kern():
            return flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                            causal=causal)
        lib = chip_smoke._sdpa_bwd(q, k, v, do, causal=causal)
        n_bytes = ((4 * B * Sq * H * hd + 4 * B * Skv * KV * hd) * 2
                   + B * H * Sq * 4)
        plane = Sq * (Sq + 1) / 2 if causal else Sq * Skv
        bound = chip_smoke._bound(n_bytes, 10 * B * H * hd * plane, bf16)[0]
        passes, occ = chip_smoke._k3b_pass_ms(kern)
        _row(tag, f"K3b {name} B{B} Sq{Sq} Skv{Skv} H{H}/KV{KV} hd{hd}", kern,
             lib, bound, "; passes " + ", ".join(
                 f"{t} {x:.4f}" for t, x in passes.items()) + " ms; regs / "
             "warps an SM / est. occupancy " + ", ".join(
                 f"{t} {' / '.join(map(str, x))}" for t, x in occ.items()))
        del q, k, v, o, do, lse, lib
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, heads in (("musicgen", chip_smoke.MUSICGEN_HEADS),
                        ("smollm", chip_smoke.SMOLLM_HEADS)):
        H, KV, hd = heads
        G = H // KV
        for S in (16, 32, 512):
            q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), \
                randn(1, S, KV, hd)
            qx = q.transpose(1, 2)
            kx = k.transpose(1, 2).repeat_interleave(G, dim=1)
            vx = v.transpose(1, 2).repeat_interleave(G, dim=1)
            _row(tag, f"K3 {name} H{H}/KV{KV} hd{hd} S={S}",
                 lambda: flash_attention_cuda(q, k, v),
                 lambda: sdpa(qx, kx, vx, is_causal=True),
                 chip_smoke._bound((2 * S * H * hd + 2 * S * KV * hd) * 2,
                                   4 * H * hd * S * (S + 1) / 2, bf16)[0])
        for prefix, suffix in ((48, 16), (64, 64)):
            extent = prefix + suffix + 16
            q, k, v = randn(1, suffix, H, hd), randn(1, extent, KV, hd), \
                randn(1, extent, KV, hd)
            mask = (torch.arange(extent, device="cuda")[None, :]
                    <= prefix + torch.arange(suffix, device="cuda")[:, None])
            qx = q.transpose(1, 2)
            kx = k.transpose(1, 2).repeat_interleave(G, dim=1)
            vx = v.transpose(1, 2).repeat_interleave(G, dim=1)
            pairs = sum(prefix + i + 1 for i in range(suffix))
            _row(tag, f"K3 {name} extend {prefix}+{suffix}",
                 lambda: flash_attention_cuda(q, k, v, q_offset=prefix),
                 lambda: sdpa(qx, kx, vx,
                              attn_mask=mask.view(1, 1, suffix, extent)),
                 chip_smoke._bound((2 * suffix * H * hd
                                    + 2 * extent * KV * hd) * 2,
                                   4 * H * hd * pairs, bf16)[0])
    print(f"[k3b_timing {tag}] package {repro_torch.__file__} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
