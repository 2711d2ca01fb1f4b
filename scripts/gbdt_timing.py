#!/usr/bin/env python3
"""K4 and K5 (GBDT admission scoring) timed warm and cold on one card.

    python3 scripts/gbdt_timing.py [--src DIR] [--tag NAME]

Needs a CUDA card and nvcc.  It trains the predictor ``chip_smoke.py``
trains (60 rounds on 2,400 balanced sharegpt-profile prompts: T 180, K
3), extracts real admission features and, at B = 1, 16 and 512, times
K4 (dense) and K5 (packed) with ``chip_smoke``'s device clock: warm (the
trees in L2 from the call before) and cold (a buffer larger than the 50
MB L2 written before every launch, its own time measured alone and
subtracted).  ``--src`` names another checkout's ``src`` directory to
import ``repro_torch`` from (an older revision of the kernels; its
kernels build into that checkout), so two revisions can be timed in
turns in one run on one card.  Prints one line per (kernel, B), tagged
with ``--tag``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts ROOT/src on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", help="import repro_torch from this directory")
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("gbdt_timing: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.core.features import extract_batch
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.predictor import Predictor
    from repro_torch.data.corpus import sample_dataset
    from repro_torch.kernels import _build, ops

    smi = chip_smoke.phase_device()
    _build.build(["gbdt_infer"])
    ds = sample_dataset("sharegpt", n=2400, seed=42, balanced=True)
    model = Predictor.train(ds.prompts, ds.lengths, GBDTParams(num_rounds=60),
                            device="cuda").model
    packed = model.packed()
    dense_t, packed_t = model.tensors("cuda"), packed.tensors("cuda")
    K = model.n_classes
    kw = dict(depth=packed.depth, n_classes=K, base_score=packed.base_score)
    for B in (1, 16, 512):
        X = torch.as_tensor(extract_batch(ds.prompts[:B]), device="cuda")
        k4 = lambda: ops.gbdt_margins(X, *dense_t, n_classes=K)  # noqa
        k5 = lambda: ops.gbdt_margins_packed(X, *packed_t, **kw)  # noqa
        for name, fn in (("K4", k4), ("K5", k5)):
            warm = chip_smoke._device_ms(fn)
            cold = chip_smoke._cold_device_ms(fn)
            print(f"[gbdt_timing {args.tag}] {name} B={B} T={len(dense_t[0])}"
                  f": device ms warm {warm:.4f}, cold {cold:.4f}")
    print(f"[gbdt_timing {args.tag}] package {repro_torch.__file__} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
