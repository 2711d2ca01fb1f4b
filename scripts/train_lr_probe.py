#!/usr/bin/env python3
"""Loss of the first AdamW steps of smollm-360m at full width on the card,
by learning rate, dtype and attention path.

    python3 scripts/train_lr_probe.py [--steps 20]

Needs a CUDA card and nvcc.  All 32 layers, batch 8 x 512 tokens of the
Markov stream (``data.lm_data``), seed 0, warmup 2 steps, TF32 off.  Runs
bf16 through the kernels (K3 forward, K3b backward) at lr 3e-3, 1e-3 and
3e-4, bf16 through the plain attention at 3e-3, and float32 through the
kernels at 3e-3, and prints each run's ms/step (median of the last 10),
losses and gradient norms: whether a trajectory comes from the
hyperparameters or from a path shows as the paths agreeing or not.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.training.train_loop import (init_train_state,  # noqa: E402
                                             make_train_step)

RUNS = (("bf16 kernels", 3e-3, "bfloat16", False),
        ("bf16 plain attention", 3e-3, "bfloat16", True),
        ("f32 kernels", 3e-3, "float32", False),
        ("bf16 kernels", 1e-3, "bfloat16", False),
        ("bf16 kernels", 3e-4, "bfloat16", False))


def _plain(q, k, v, *, causal=True):
    return flash_attention_plain(q, k, v, causal=causal)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_lr_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = get_config("smollm-360m")
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=512, global_batch=8))
    for label, lr, dtype, plain in RUNS:
        c = dataclasses.replace(cfg, dtype=dtype)
        opt = OptConfig(lr=lr, warmup_steps=2)
        state = init_train_state(c, opt, device="cuda", seed=0)
        step_fn = make_train_step(c, opt)
        losses, norms, secs = [], [], []
        with (mock.patch.object(ops, "flash_attention_train", _plain)
              if plain else nullcontext()):
            for s in range(args.steps):
                b = {k: torch.from_numpy(x).long().cuda()
                     for k, x in data.batch(s).items()}
                t0 = time.monotonic()
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                secs.append(time.monotonic() - t0)
        ms = 1e3 * statistics.median(secs[-10:])
        print(f"{label} lr {lr:g}: {ms:.1f} ms/step  [{smi}]")
        print("  loss " + " ".join(f"{x:.3f}" for x in losses))
        print("  gnorm " + " ".join(f"{x:.2f}" for x in norms))
        del state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
