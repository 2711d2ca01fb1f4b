#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[tp]`` phase alone on an otherwise idle card:
the kernels built, K3 and K3b held and timed at a ``[tp]`` rank's shape
(gemma3-4b-edge's heads over model 2: causal B 2, S 512, H 4 over KV 2,
hd 256; ``[K3 flash_attention_hd256_tp]``,
``[K3b flash_attention_bwd_hd256_tp]``), then the two ranks and the
checks that follow them (``chip_smoke.start_tp`` / ``collect_tp``), with
nothing beside them.

    python3 scripts/tp_alone.py

Needs a CUDA card and nvcc.  Its ``[tp]`` lines are the smoke run's;
their ms a step are the ranks' alone, to set beside the smoke run's,
where the ranks share the card and the host with the smollm phases.
"""

from __future__ import annotations

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
    chip_smoke.phase_tp_flash_kernel(gen)
    run = chip_smoke.start_tp()
    try:
        launched = chip_smoke.collect_tp(run, smi, "nothing")
    finally:
        chip_smoke.stop_tp(run)
        if torch.distributed.is_initialized():      # collect_tp's (1, 1)
            torch.distributed.destroy_process_group()
    print(f"[tp_alone] launches {launched}; {time.monotonic() - t0:.1f} s "
          f"[{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
