#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/csrc`` with
nvcc, holds each against its plain PyTorch version at the serving path's
shapes and times both, then serves the paper's head-of-line burst (6 long
requests, then 10 short) through predictor -> SJF queue -> ``RealEngine``
at the full width of smollm-360m (bf16, seeded random weights), under FCFS
and then SJF.  It fails (nonzero exit, no result line) without a CUDA
device, without the repository beside it, when a kernel does not build,
launch or agree with its plain version, when a response is not ``ok``, or
when a kernel of the path was never launched while the burst was served.

The second-to-last line of standard output is a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
MAX_LEN, SEGMENT, MAX_NEW = 512, 16, 64
N_LONG, N_SHORT = 6, 10
TOL = {"bf16": 2e-2, "f32": 1e-4}


def _ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Milliseconds per call from CUDA events around ``iters``
    back-to-back calls after ``warmup``: for kernels this small it is the
    host's launch pace, not the kernel's time (see ``_device_ms``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _busy_us(events):
    """Length of the union of the CUDA kernel intervals among profiler
    ``events`` (microseconds), or None when there is none."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def _device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Device milliseconds per call, without the host's launch gaps: a
    spin kernel holds the stream while the host enqueues ``iters`` calls,
    so the CUDA events bracket back-to-back device work.  If the spin
    ended before the host finished enqueueing (the start event had
    already passed), the run is repeated with a longer spin and fewer
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 50_000_000                        # cycles, ~25 ms at ~2 GHz
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        late = start.query()                 # device already reached start
        end.record()
        end.synchronize()
        if not late:
            return start.elapsed_time(end) / iters
        spin, iters = spin * 4, max(1, iters // 2)
    raise RuntimeError("could not enqueue ahead of the device")


def _bound(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(name: str, err: float, tol: float) -> None:
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:g} > {tol}")


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    secs = _build.build()
    print(f"[build] nvcc sm_90a, {len(secs)} kernels in parallel: "
          f"{time.monotonic() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name, log in _build.PTXAS_REPORT.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_decode_kernel(gen) -> dict:
    """K1 at the serving shapes: B 1, H 15 over KV 5, hd 64, ring S 512."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    B, H, KV, hd, S = 1, 15, 5, 64, MAX_LEN
    errs = {}
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dt)
        ck = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        cv = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        for t_host in (0, 17, 127, 300, S - 1, S + 200):   # last: wrapped
            t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
            got = decode_attention_cuda(q, ck, cv, t)
            want = decode_attention_plain(q, ck, cv, t)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"decode_attention {label} t={t_host}", err, TOL[label])
            errs[(label, t_host)] = err
    print("[K1 decode_attention] max|err| " + " ".join(
        f"{l}@t={t}:{e:.2e}" for (l, t), e in errs.items()))
    # timing at a mid-ring fill level, bf16 (the serving dtype)
    q = torch.randn(B, 1, H, hd, generator=gen, device="cuda",
                    dtype=torch.float32).bfloat16()
    ck = torch.randn(B, S, KV, hd, generator=gen, device="cuda").bfloat16()
    cv = torch.randn(B, S, KV, hd, generator=gen, device="cuda").bfloat16()
    rows = []
    for t_host in (63, 127, 511):
        t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
        n = min(S, t_host + 1)
        kx = ck[:, :n].transpose(1, 2).repeat_interleave(H // KV, dim=1)
        vx = cv[:, :n].transpose(1, 2).repeat_interleave(H // KV, dim=1)
        qx = q.transpose(1, 2).contiguous()
        kern = lambda: decode_attention_cuda(q, ck, cv, t)    # noqa: E731
        ms = _device_ms(kern)
        plain = _device_ms(lambda: decode_attention_plain(q, ck, cv, t))
        lib = _device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qx, kx, vx))
        esz = 2
        bound, by = _bound(2 * n * KV * hd * esz + 2 * B * H * hd * esz + 4,
                           4 * B * H * n * hd, torch.bfloat16)
        rows.append((t_host, ms, plain, lib, bound, by))
        print(f"[K1 decode_attention] bf16 S={S} t={t_host}: device ms "
              f"kernel {ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f}; bound "
              f"{bound * 1e3:.3f} us ({by}); host-paced kernel "
              f"{_ms(kern):.4f} ms/call")
    t_host, ms, plain, lib, bound, by = rows[1]
    print(f"[K1 decode_attention] kernels line: bf16 B1 H15 KV5 hd64 S{S} "
          f"t={t_host}")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:163",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def phase_flash_kernel(gen) -> dict:
    """K3 at the serving prefill buckets 16..512: B 1, H 15 over KV 5."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    B, H, KV, hd = 1, 15, 5, 64
    errs = {}
    timed = []
    for S in (16, 32, 64, 96, 128, 256, 512):        # 96: a ragged bucket
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
            got = flash_attention_cuda(q, k, v, causal=True)
            want = flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"flash_attention {label} S={S}", err, TOL[label])
            errs[(label, S)] = err
            if label != "bf16" or S == 96:
                continue
            qx, kx, vx = (x.transpose(1, 2) for x in (q, k, v))
            kx = kx.repeat_interleave(H // KV, dim=1)
            vx = vx.repeat_interleave(H // KV, dim=1)
            kern = lambda: flash_attention_cuda(q, k, v)    # noqa: E731
            ms = _device_ms(kern)
            plain = _device_ms(lambda: flash_attention_plain(q, k, v))
            lib = _device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qx, kx, vx, is_causal=True))
            bound, by = _bound(
                (2 * B * S * H * hd + 2 * B * S * KV * hd) * 2,
                4 * B * H * hd * S * (S + 1) / 2, torch.bfloat16)
            timed.append((S, ms, plain, lib, bound, by))
            print(f"[K3 flash_attention] bf16 S={S}: device ms kernel "
                  f"{ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f}; bound "
                  f"{bound * 1e3:.3f} us ({by}); host-paced kernel "
                  f"{_ms(kern):.4f} ms/call")
    print("[K3 flash_attention] max|err| " + " ".join(
        f"{l}@S={s}:{e:.2e}" for (l, s), e in errs.items()))
    S, ms, plain, lib, bound, by = timed[1]          # the 32-token bucket
    print(f"[K3 flash_attention] kernels line: bf16 causal B1 H15 KV5 hd64 "
          f"S={S}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:71",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def phase_gbdt_kernel(model, prompts) -> dict:
    """K4 on the trained 60-round ensemble (T 180, N 127) over real
    admission features, at batch 16 and 512."""
    import torch
    from repro_torch.core.features import extract_batch
    from repro_torch.kernels.gbdt_infer import (gbdt_margins_cuda,
                                                gbdt_margins_plain)
    feat, thr, val = model.tensors("cuda")
    T, N = feat.shape
    K = model.n_classes
    rows = []
    err = 0.0
    for B in (16, 512):
        X = torch.as_tensor(extract_batch(prompts[:B]), device="cuda")
        got = gbdt_margins_cuda(X, feat, thr, val, n_classes=K)
        want = gbdt_margins_plain(X, feat, thr, val, n_classes=K)
        torch.cuda.synchronize()
        e = _max_err(got, want)
        _check(f"gbdt_margins B={B}", e, TOL["f32"])
        again = gbdt_margins_cuda(X, feat, thr, val, n_classes=K)
        if not torch.equal(got, again):
            raise AssertionError("gbdt_margins is not deterministic")
        err = max(err, e)
        kern = lambda: gbdt_margins_cuda(X, feat, thr, val,    # noqa: E731
                                         n_classes=K)
        ms = _device_ms(kern)
        plain = _device_ms(lambda: gbdt_margins_plain(X, feat, thr, val,
                                                      n_classes=K), iters=5)
        # bytes this data needs: every distinct node visited (feature,
        # threshold and value, 12 B each) plus X and the margins
        visited = _visited_nodes(X, feat, thr)
        bound, by = _bound(visited * 12 + X.numel() * 4 + B * K * 4,
                           B * T * (math.log2(N + 1) - 1), torch.float32)
        rows.append((B, ms, plain, bound, by))
        print(f"[K4 gbdt_margins] B={B} T={T} N={N}: device ms kernel "
              f"{ms:.4f}, plain {plain:.4f}; bound {bound * 1e3:.3f} us "
              f"({by}); host-paced kernel {_ms(kern):.4f} ms/call; "
              f"max|err| {e:.2e}")
    B, ms, plain, bound, by = rows[0]
    print(f"[K4 gbdt_margins] kernels line: f32 B={B} T={T} N={N}")
    return {"name": "gbdt_margins", "route": "cuda",
            "source": "src/repro_torch/csrc/gbdt_infer.cu",
            "replaces": "src/repro/kernels/gbdt_infer.py:111",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _visited_nodes(X, feat, thr) -> int:
    """Distinct (tree, node) pairs that the walks over X touch."""
    import torch
    T, N = feat.shape
    idx = torch.zeros(T, X.shape[0], dtype=torch.long, device=X.device)
    seen = [idx.clone()]
    f64 = feat.long()
    for _ in range(int(math.log2(N + 1)) - 1):
        f = torch.gather(f64, 1, idx)
        xi = X.T.gather(0, f.clamp(min=0))
        nxt = torch.where(xi < torch.gather(thr, 1, idx), 2 * idx + 1,
                          2 * idx + 2)
        idx = torch.where(f < 0, idx, nxt)
        seen.append(idx.clone())
    tree = torch.arange(T, device=X.device)[:, None]
    flat = torch.cat([s + tree * N for s in seen], dim=1)
    return int(torch.unique(flat).numel())


def phase_full_width_reference(cfg) -> float:
    """The card's path (K1, K3, cuBLAS) against the CPU's plain path on
    the same full-width float32 weights: prefill logits and 8 greedy
    decode steps.  Returns the largest logit difference."""
    import dataclasses
    import torch
    from repro_torch.models.model import LM
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gpu = LM(cfg32, device="cuda", seed=1)
    cpu = LM(cfg32, device="cpu", seed=1)
    cpu.load_state_dict(gpu.state_dict())
    ids = torch.arange(3, 3 + 40) * 97 % cfg.vocab_size
    toks = torch.zeros(1, 64, dtype=torch.long)
    toks[0, :40] = ids
    lg, cg = gpu.prefill(toks.cuda(), pad_to=MAX_LEN, prompt_len=40)
    lc, cc = cpu.prefill(toks, pad_to=MAX_LEN, prompt_len=40)
    worst = _max_err(lg.cpu(), lc)
    for _ in range(8):
        tok = lg.argmax(-1).view(1, 1)
        if int(tok) != int(lc.argmax()):
            raise AssertionError("greedy token differs between card and CPU")
        lg = gpu.decode_step(cg, tok)
        lc = cpu.decode_step(cc, tok.cpu())
        worst = max(worst, _max_err(lg.cpu(), lc))
    scale = float(lc.abs().max())
    if not math.isfinite(worst) or worst > 1e-3 * max(1.0, scale):
        raise AssertionError(f"full-width f32 logits differ by {worst:g}")
    print(f"[reference] full-width f32, card vs CPU plain path: max|logit "
          f"diff| {worst:.3e} (logit scale {scale:.2f}), greedy tokens equal")
    del gpu, cpu
    torch.cuda.empty_cache()
    return worst


def phase_slice(cfg, predictor, smi) -> dict:
    """The main path at full width: burst -> predictor -> SJF -> engine."""
    import torch
    from repro_torch.data.corpus import sample_dataset
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.openai_api import CompletionRequest
    from repro_torch.serving.server import ClairvoyantServer

    pool = sample_dataset("sharegpt", n=4000, seed=1)
    shorts = [i for i in range(len(pool)) if pool.lengths[i] < 120][:N_SHORT]
    longs = [i for i in range(len(pool)) if pool.lengths[i] >= 1000][:N_LONG]
    order = longs + shorts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = RealEngine(cfg, max_len=MAX_LEN, segment_len=SEGMENT, seed=0)
    torch.cuda.synchronize()
    print(f"[slice] {cfg.name} {cfg.dtype} {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_count() / 1e6:.0f}M params, seeded init "
          f"{time.monotonic() - t0:.1f} s")
    for b in eng.buckets[:3]:                  # first-call set-up
        eng.generate(list(range(1, b)), max_new_tokens=2)

    ops.reset_launches()
    per_policy = {}
    for policy in ("fcfs", "sjf"):
        eng.busy_until = 0.0
        before = dict(ops.LAUNCHES)
        server = ClairvoyantServer(policy=policy, tau=None,
                                   predictor=predictor, engines=[eng])
        server.submit_many(
            [CompletionRequest(prompt=pool.prompts[i]) for i in order],
            arrivals=[j * 1e-4 for j in range(len(order))],
            true_output_tokens=[64 if i in longs else 8 for i in order],
            klasses=["long" if i in longs else "short" for i in order])
        w0 = time.monotonic()
        resp = server.drain(max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        wall = time.monotonic() - w0
        if len(resp) != len(order) or not all(r.ok for r in resp):
            raise AssertionError(f"{policy}: not every response is ok")
        for r in resp:
            if not r.token_ids or not all(0 <= x < cfg.vocab_size
                                          for x in r.token_ids):
                raise AssertionError(f"{policy}: bad tokens for request "
                                     f"{r.request_id}")
        per_policy[policy] = {
            "short_p50_ms": server.percentile(50, "short") * 1e3,
            "long_p50_ms": server.percentile(50, "long") * 1e3,
            "ttft_p50_ms": server.percentile(50, attr="ttft_s") * 1e3,
            "tokens": sum(r.tokens_generated for r in resp),
            "wall_s": wall,
            "order": [r.request_id for r in resp],
            "launches": {k: ops.LAUNCHES[k] - before[k] for k in before}}
    launches = dict(ops.LAUNCHES)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched while "
                                 f"the burst was served")
    sjf, fcfs = per_policy["sjf"], per_policy["fcfs"]
    for p, v in per_policy.items():
        print(f"[slice] {p}: short P50 {v['short_p50_ms']:.1f} ms, long P50 "
              f"{v['long_p50_ms']:.1f} ms, sojourn-TTFT P50 "
              f"{v['ttft_p50_ms']:.1f} ms, {v['tokens']} tokens in "
              f"{v['wall_s']:.2f} s, launches {v['launches']}, dispatch "
              f"order {v['order']}  [{smi}]")
    print(f"[slice] SJF short P50 vs FCFS: "
          f"{100 * (1 - sjf['short_p50_ms'] / fcfs['short_p50_ms']):.1f}% "
          f"lower  [{smi}]")

    # fused decode == per-token oracle, and the engine's own timings
    ids = list(range(5, 5 + 24))
    fused = eng.generate(ids, max_new_tokens=MAX_NEW)
    ref = eng.generate_reference(ids, max_new_tokens=MAX_NEW)
    if fused["tokens"] != ref["tokens"]:
        raise AssertionError("fused decode differs from generate_reference")
    n = len(fused["tokens"])
    per_tok = (fused["service_s"] - fused["ttft_s"]) / max(1, n - 1)
    per_tok_ref = (ref["service_s"] - ref["ttft_s"]) / max(1, n - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    phase_profile(eng, smi)
    print(f"[slice] fused == reference over {n} tokens; prompt 24 tokens: "
          f"TTFT {fused['ttft_s'] * 1e3:.2f} ms, decode "
          f"{per_tok * 1e3:.3f} ms/token ({1 / per_tok:.0f} tok/s; per-token "
          f"oracle loop {per_tok_ref * 1e3:.3f} ms/token), peak memory "
          f"{peak:.0f} MiB  [{smi}]")
    return launches


def phase_profile(eng, smi) -> None:
    """Where a decode step's time goes: kernels launched per token and the
    device's busy share while the engine serves one request (the union of
    CUDA kernel intervals over the span of the whole trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ids = list(range(7, 7 + 24))
    eng.generate(ids, max_new_tokens=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = eng.generate(ids, max_new_tokens=9)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = _busy_us(events)
    if busy is None:
        print("[profile] device busy share: not measured (the profiler "
              "recorded no CUDA kernel)")
        return
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    n = len(out["tokens"])
    print(f"[profile] one request, 24-token prompt, {n} tokens (prefill + "
          f"{n - 1} decode steps), profiler on: {len(kernels)} kernels "
          f"(~{len(kernels) / n:.0f} per token), device busy "
          f"{busy / 1e3:.2f} ms of {span / 1e3:.2f} ms traced "
          f"({100 * busy / span:.1f}% busy, {100 - 100 * busy / span:.1f}% "
          f"idle)  [{smi}]")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]   {us / 1e3:8.3f} ms  {name[:90]}")


def main() -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.predictor import Predictor
    from repro_torch.data.corpus import sample_dataset

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()

    ds = sample_dataset("sharegpt", n=2400, seed=42, balanced=True)
    t0 = time.monotonic()
    predictor = Predictor.train(ds.prompts, ds.lengths,
                                GBDTParams(num_rounds=60), device="cuda")
    print(f"[predictor] trained 60 rounds on {len(ds)} prompts in "
          f"{time.monotonic() - t0:.1f} s (host)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_decode_kernel(gen), phase_flash_kernel(gen),
               phase_gbdt_kernel(predictor.model, ds.prompts)]
    cfg = get_config("smollm-360m")
    phase_full_width_reference(cfg)
    launches = phase_slice(cfg, predictor, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"[done] {time.monotonic() - t_start:.1f} s  [{smi}]")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
