#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[tp]`` phase alone on an otherwise idle card:
the kernels built, K3 and K3b held and timed at the ``[tp]`` ranks'
shapes (``chip_smoke.TP_K3_SHARES`` and the ``*_tp`` rows of
``K3B_INSTANCES``: gemma3-4b-edge's heads over model 2, causal B 2, S
512, H 4 over KV 2, hd 256; dbrx-132b's H 24 over KV 4, hd 128;
llama-3.2-vision-90b's H 32 over KV 4, hd 128, causal and, for its
cross-attention, full over 1024 image rows; musicgen-large's H 16 over
KV 16, hd 64), then the first pair of ranks and the checks that follow
it (``chip_smoke.start_tp`` / ``collect_tp``: the gemma3, smollm and
dbrx parts with dbrx's one-group step (e′), and the recurrent stacks,
(f) jamba's Mamba layer in float32, (g) its Mamba + MoE layers in bf16,
(h) xlstm-350m in float32), then the late pair (``start_tp("late")``
/ ``collect_tp_late``: (i) llama-3.2-vision-90b, (j) musicgen-large),
then (k)'s eight ranks (``start_tp("apart")`` / ``collect_tp_apart``:
xlstm-350m's first two layers over (1, 8), its heads across the ranks),
each with nothing beside it, so that each part's ms a step and
collectives are read alone; last, ``[tp_alone] dbrx``: the ranks'
dbrx-132b steps (one layer, bf16) taken on one device from the same
weights and batches, routed in the same two dispatch groups (a
shape-only (1, 2) mesh), their losses beside the ranks' (the one-device
state, ~54 GB, fits only on an idle card).

    python3 scripts/tp_alone.py

Needs a CUDA card and nvcc.  Its ``[tp]`` lines are the smoke run's;
their ms a step are the ranks' alone, to set beside the smoke run's,
where the ranks share the card and the host with the smollm phases (the
first pair), with ``[speculative]`` (the late pair) or with the phases
from ``[speculative]``'s end to ``[mesh]`` ((k)).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts ROOT/src on the path)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_alone: no CUDA device", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    chip_smoke.K3B_INSTANCES = tuple(
        k for k in chip_smoke.K3B_INSTANCES if k[0].endswith("_tp"))
    chip_smoke.phase_flash_bwd_instances(gen)
    chip_smoke.phase_tp_flash_shares(gen)
    run = chip_smoke.start_tp()
    try:
        launched = chip_smoke.collect_tp(run, smi, "nothing")
        ranks = [json.loads(next(x for x in r["lines"]
                                 if x.startswith('{"tp_rank"')))["dbrx"]
                 for r in run["ranks"]]
    finally:
        chip_smoke.stop_tp(run)
        if torch.distributed.is_initialized():      # collect_tp's (1, 1)
            torch.distributed.destroy_process_group()
    chip_smoke._free_card("tp late")
    launched.update(chip_smoke.collect_tp_late(
        chip_smoke.start_tp("late"), smi, "nothing"))
    chip_smoke.collect_tp_apart(chip_smoke.start_tp("apart"), smi, "nothing")
    dbrx_one_device(ranks[0]["losses"], smi)
    print(f"[tp_alone] launches {launched}; {time.monotonic() - t0:.1f} s "
          f"[{smi}]")
    return 0


def dbrx_one_device(rank_losses, smi) -> None:
    """The ranks' dbrx steps on one device (see the module docstring)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.rules import MeshShape
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    cfg = dataclasses.replace(get_config("dbrx-132b"), num_layers=1)
    opt = OptConfig(lr=chip_smoke.TRAIN_LR, warmup_steps=1)
    batch = chip_smoke._arch_batch(cfg, chip_smoke.TP_B, None)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt, device="cuda",
                             seed=chip_smoke.TP_SEED)
    step = make_train_step(cfg, opt)
    losses = []
    with use_mesh(MeshShape(("data", "model"), (1, 2))):
        for i in range(len(rank_losses)):
            state, m = step(state, batch(i))
            losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    torch.cuda.empty_cache()
    print("[tp_alone] dbrx-132b 1 layer bf16 on one device, the ranks' "
          "two dispatch groups: losses " + " ".join(
              f"{x:.4f}" for x in losses) + " against the ranks' "
          + " ".join(f"{x:.4f}" for x in rank_losses) + "; rel " + " ".join(
              f"{abs(a - b) / abs(b):.2e}" for a, b in zip(rank_losses,
                                                            losses))
          + f"; peak {peak:.2f} GiB  [{smi}]")


if __name__ == "__main__":
    sys.exit(main())
