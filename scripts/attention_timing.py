#!/usr/bin/env python3
"""K1, K2 and K3 at the served head layouts timed on one card, beside SDPA.

    python3 scripts/attention_timing.py [--src DIR] [--tag NAME]

Needs a CUDA card and nvcc.  In bf16 it times, with ``chip_smoke``'s
device clock, each K1 row (B 1 over a 512-slot ring at t 23, 63, 127 and
511, and the ring lanes' B 4 over 128 slots at t 5, 60, 131 and 484) at
the heads (H over KV, hd) of smollm-360m (15/5/64), musicgen-large
(32/32/64), jamba-v0.1-52b (32/8/128), llama-3.2-vision-90b (64/8/128;
also its decode over 1024 image rows), gemma3-4b-edge (8/4/256),
gemma-2b (8/1/256) and llama4-maverick (40/8/128); K2 beside K1 on the
same logical window (B 4, page 16, 32 pages a lane) at smollm's,
gemma3's, qwen3-32b's (64/8/128) and gemma-2b's heads; and each K3 row
(causal prefill at S 16, 32 and 512, exact S 45 at jamba's heads, extend
64 + 64 at gemma3's; non-causal Sq 1, 16 and 45 over the image rows).
Each row runs in turns, kernel, ``scaled_dot_product_attention`` (K/V
expanded to the query heads, masked alike), kernel, and once more with
the L2 flushed before every launch (``_cold_device_ms``).

``--src`` names another checkout's ``src`` directory to import
``repro_torch`` from (an older revision of the kernels, built into that
checkout), so two revisions can be timed in turns in one run on one
card.  Every row's inputs come from a generator seeded by the row's
name.  A run with ``--src`` saves each K1/K2 row's bf16 output and the
output of the same inputs in float32 to ``build/attention_timing_bits.pt``;
a run without it compares its own outputs with that file bit for bit
and prints one ``bits`` line per row.  Prints one line per row, tagged
with ``--tag``.
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts ROOT/src on the path)

BITS = ROOT / "build" / "attention_timing_bits.pt"
K1_HEADS = {"smollm": chip_smoke.SMOLLM_HEADS,
            "musicgen": chip_smoke.MUSICGEN_HEADS,
            "jamba": chip_smoke.JAMBA_HEADS,
            "vision": chip_smoke.VISION_HEADS,
            "gemma3": chip_smoke.GEMMA_HEADS,
            "gemma2b": chip_smoke.GEMMA2B_HEADS,
            "llama4": chip_smoke.LLAMA4_HEADS}
K2_HEADS = {"smollm": chip_smoke.SMOLLM_HEADS,
            "gemma3": chip_smoke.GEMMA_HEADS,
            "qwen3": chip_smoke.QWEN3_HEADS,
            "gemma2b": chip_smoke.GEMMA2B_HEADS}
K3_HEADS = {"jamba": chip_smoke.JAMBA_HEADS,
            "vision": chip_smoke.VISION_HEADS,
            "gemma3": chip_smoke.GEMMA_HEADS}
LANE_LEVELS = (5, 60, chip_smoke.L_MAX_LEN + 3,
               3 * chip_smoke.L_MAX_LEN + 100)


def _row(tag, what, kern, lib, bound):
    """Time ``kern`` beside ``lib`` (kernel, library, kernel; then cold)
    and print one line."""
    a = chip_smoke._device_ms(kern)
    lib_ms = chip_smoke._device_ms(lib) if lib else None
    b = chip_smoke._device_ms(kern)
    cold = chip_smoke._cold_device_ms(kern)
    ms = (a + b) / 2
    vs = (f", sdpa {lib_ms:.5f} (ratio {ms / lib_ms:.3f})" if lib_ms
          else "")
    print(f"[attention_timing {tag}] {what}: device ms kernel {a:.5f} / "
          f"{b:.5f}{vs}, cold {cold:.5f}; bound {bound * 1e3:.3f} us")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", help="import repro_torch from this directory")
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    if args.src:                # chip_smoke imported this checkout's
        for name in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda

    smi = chip_smoke.phase_device()
    _build.build(["decode_attention", "paged_decode_attention",
                  "flash_attention"])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, tag = torch.bfloat16, args.tag
    outputs = {}                # row -> (bf16 output, f32 output)

    def rng(what):
        return torch.Generator(device="cuda").manual_seed(
            zlib.crc32(what.encode()))

    def randn(gen, *shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    def expand(x, G):                   # (B, S, KV, hd) -> (B, H, S, hd)
        return x.transpose(1, 2).repeat_interleave(G, dim=1)

    def bound(n_bytes, flops):
        return chip_smoke._bound(n_bytes, flops, bf16)[0]

    def keep(what, fn, *inputs):
        """The row's bf16 output and its float32 twin on the same values."""
        outputs[what] = (fn(*inputs).cpu(),
                         fn(*(x.float() if x.is_floating_point() else x
                              for x in inputs)).cpu())

    for name, (H, KV, hd) in K1_HEADS.items():
        G, S = H // KV, chip_smoke.MAX_LEN
        for t_host in (23, 63, 127, 511):
            what = f"K1 {name} H{H}/KV{KV} hd{hd} S{S} t={t_host}"
            gen = rng(what)
            q = randn(gen, 1, 1, H, hd)
            ck, cv = randn(gen, 1, S, KV, hd), randn(gen, 1, S, KV, hd)
            t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
            n = t_host + 1
            qx, kx, vx = (q.transpose(1, 2), expand(ck[:, :n], G),
                          expand(cv[:, :n], G))
            keep(what, decode_attention_cuda, q, ck, cv, t)
            _row(tag, what, lambda: decode_attention_cuda(q, ck, cv, t),
                 lambda: sdpa(qx, kx, vx),
                 bound(2 * n * KV * hd * 2 + 4 * H * hd + 4, 4 * H * n * hd))
        B, S = chip_smoke.L_LANES, chip_smoke.L_MAX_LEN
        what = f"K1 {name} lanes B{B} S{S} t={list(LANE_LEVELS)}"
        gen = rng(what)
        q = randn(gen, B, 1, H, hd)
        ck, cv = randn(gen, B, S, KV, hd), randn(gen, B, S, KV, hd)
        t = torch.tensor(LANE_LEVELS, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, :]
                <= t[:, None]).view(B, 1, 1, S)
        qx, kx, vx = q.transpose(1, 2), expand(ck, G), expand(cv, G)
        n = sum(min(S, x + 1) for x in LANE_LEVELS)
        keep(what, decode_attention_cuda, q, ck, cv, t)
        _row(tag, what, lambda: decode_attention_cuda(q, ck, cv, t),
             lambda: sdpa(qx, kx, vx, attn_mask=mask),
             bound(2 * n * KV * hd * 2 + 2 * B * H * hd * 2 + 4 * B,
                   4 * H * n * hd))
    for name, (H, KV, hd) in K3_HEADS.items():
        G = H // KV
        for Sq in (16, 32, 512) + ((45,) if name == "jamba" else ()):
            what = f"K3 {name} H{H}/KV{KV} hd{hd} S={Sq}"
            gen = rng(what)
            qs, ks, vs = randn(gen, 1, Sq, H, hd), randn(gen, 1, Sq, KV, hd), \
                randn(gen, 1, Sq, KV, hd)
            qx, kx, vx = qs.transpose(1, 2), expand(ks, G), expand(vs, G)
            _row(tag, what, lambda: flash_attention_cuda(qs, ks, vs),
                 lambda: sdpa(qx, kx, vx, is_causal=True),
                 bound((2 * Sq * H * hd + 2 * Sq * KV * hd) * 2,
                       4 * H * hd * Sq * (Sq + 1) / 2))
    # the vision cross-attention over its image rows
    H, KV, hd = chip_smoke.VISION_HEADS
    T = chip_smoke.IMAGE_ROWS
    gen = rng("vision cross")
    k, v = randn(gen, 1, T, KV, hd), randn(gen, 1, T, KV, hd)
    kx, vx = expand(k, H // KV), expand(v, H // KV)
    for Sq in (1, 16, 45):
        q = randn(gen, 1, Sq, H, hd)
        qx = q.transpose(1, 2)
        _row(tag, f"K3 vision cross Sq={Sq} Skv={T}",
             lambda: flash_attention_cuda(q, k, v, causal=False),
             lambda: sdpa(qx, kx, vx),
             bound((2 * Sq * H * hd + 2 * T * KV * hd) * 2,
                   4 * H * hd * Sq * T))
    q = randn(gen, 1, 1, H, hd)
    t = torch.tensor(T - 1, dtype=torch.int32, device="cuda")
    qx = q.transpose(1, 2)
    what = f"K1 vision cross t={T - 1} over {T} slots"
    keep(what, decode_attention_cuda, q, k, v, t)
    _row(tag, what, lambda: decode_attention_cuda(q, k, v, t),
         lambda: sdpa(qx, kx, vx),
         bound(2 * T * KV * hd * 2 + 4 * H * hd + 4, 4 * H * T * hd))
    # gemma3's extend prefill
    H, KV, hd = chip_smoke.GEMMA_HEADS
    prefix, suffix = 64, 64
    extent = prefix + suffix + 16
    gen = rng("gemma3 extend")
    q, k, v = (randn(gen, 1, suffix, H, hd), randn(gen, 1, extent, KV, hd),
               randn(gen, 1, extent, KV, hd))
    mask = (torch.arange(extent, device="cuda")[None, :]
            <= prefix + torch.arange(suffix, device="cuda")[:, None])
    qx, kx, vx = q.transpose(1, 2), expand(k, H // KV), expand(v, H // KV)
    pairs = sum(prefix + i + 1 for i in range(suffix))
    _row(tag, f"K3 gemma3 extend {prefix}+{suffix}",
         lambda: flash_attention_cuda(q, k, v, q_offset=prefix),
         lambda: sdpa(qx, kx, vx, attn_mask=mask.view(1, 1, suffix, extent)),
         bound((2 * suffix * H * hd + 2 * extent * KV * hd) * 2,
               4 * H * hd * pairs))
    # K2 beside K1 on the same logical window
    for name, (H, KV, hd) in K2_HEADS.items():
        B, page, P = 4, chip_smoke.L_PAGE, chip_smoke.MAX_LEN // 16
        levels = [3, 130, 400, P * page + 70]
        what = f"K2 {name} H{H}/KV{KV} hd{hd} B{B} page {page} P{P} t={levels}"
        gen = rng(what)
        pk = randn(gen, B * P + 1, page, KV, hd)
        pv = randn(gen, B * P + 1, page, KV, hd)
        bt = (torch.randperm(B * P, generator=gen, device="cuda") + 1) \
            .view(B, P).to(torch.int32)
        t = torch.tensor(levels, dtype=torch.int32, device="cuda")
        q = randn(gen, B, 1, H, hd)
        ring_k = pk[bt.long()].reshape(B, P * page, KV, hd)
        ring_v = pv[bt.long()].reshape(B, P * page, KV, hd)
        n = sum(min(P * page, x + 1) for x in levels)
        by = bound(2 * n * KV * hd * 2 + 2 * B * H * hd * 2 + bt.numel() * 4
                   + 4 * B, 4 * H * n * hd)
        keep(what, paged_decode_attention_cuda, q, pk, pv, bt, t)
        _row(tag, what,
             lambda: paged_decode_attention_cuda(q, pk, pv, bt, t), None, by)
        what = f"K1 {name} B{B} same window t={levels}"
        keep(what, decode_attention_cuda, q, ring_k, ring_v, t)
        _row(tag, what,
             lambda: decode_attention_cuda(q, ring_k, ring_v, t), None, by)
    if args.src:
        BITS.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"src": args.src, "rows": outputs}, BITS)
        print(f"[attention_timing {tag}] saved {len(outputs)} rows' bf16 "
              f"and f32 outputs to {BITS}")
    elif BITS.exists():
        saved = torch.load(BITS)
        for what, pair in outputs.items():
            theirs = saved["rows"].get(what)
            verdict = ("not in" if theirs is None else "equal to" if all(
                torch.equal(a, b) for a, b in zip(pair, theirs))
                else "DIFFER from")
            print(f"[attention_timing {tag}] bits {what}: bf16 and f32 "
                  f"{verdict} {saved['src']}")
    print(f"[attention_timing {tag}] package {repro_torch.__file__} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
