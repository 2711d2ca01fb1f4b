#!/usr/bin/env python3
"""What slows the host side of a train step: one process, the same bf16
train step of smollm-360m at full width (32 layers, batch 8 x 512, AdamW
lr 3e-4), timed in turns under three host states.

    python3 scripts/train_host_probe.py [--objects 3000000]

Needs a CUDA card and nvcc.  ``fresh``: the process as it starts.
``heap``: after ``--objects`` one-element lists are kept alive (a
long-lived process's heap: lists stay tracked by the cyclic collector,
which walks all of them in every full collection).
``frozen``: the same heap moved out of the collector's view with
``gc.freeze()``.  Each state times 8 steps (median of the last 5, host
clock around work that ends in a synchronise) and counts the cyclic
collections of each generation during them; the order is fresh, heap,
frozen, heap, so a drift of the card shows as two heap numbers apart.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream  # noqa: E402
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.training.train_loop import (init_train_state,  # noqa: E402
                                             make_train_step)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=3_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_host_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = get_config("smollm-360m")
    opt = OptConfig(lr=3e-4, warmup_steps=2)
    state = init_train_state(cfg, opt, device="cuda", seed=0)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=512, global_batch=8))
    batches = [{k: torch.from_numpy(x).long().cuda()
                for k, x in data.batch(s).items()} for s in range(8)]
    collections = [0, 0, 0]

    def count(phase, info):
        if phase == "start":
            collections[info["generation"]] += 1

    gc.callbacks.append(count)
    heap = []

    def timed(label):
        nonlocal state
        collections[:] = [0, 0, 0]
        secs = []
        for b in batches:
            t0 = time.monotonic()
            state, m = step_fn(state, b)
            float(m["loss"])
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
        ms = 1e3 * statistics.median(secs[-5:])
        print(f"{label}: {ms:.1f} ms/step, gc collections by generation "
              f"{collections}, tracked objects {len(gc.get_objects())}  "
              f"[{smi}]", flush=True)

    timed("fresh")
    heap.extend([i] for i in range(args.objects))
    timed("heap")
    gc.freeze()
    timed("frozen")
    gc.unfreeze()
    timed("heap")


if __name__ == "__main__":
    main()
