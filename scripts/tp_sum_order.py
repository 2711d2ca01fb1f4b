#!/usr/bin/env python3
"""How far the order of one sum moves a Mamba layer's float32 gradient.

``chip_smoke.py``'s ``[tp] (f)`` holds jamba-v0.1-52b's first layer over
model 2 to one device's step that sums its row-split products (``x_proj``,
``out_proj``, the MLP's ``w_down``) over the two ranks' blocks of rows
(``chip_smoke._rank_order``): the same function, summed in the ranks'
order.  This script shows why on one process: jamba's first layer at
``--width`` (d_model; d_inner twice it, vocabulary ``--vocab``), float32,
B 2 x S 512 of the Markov stream, its loss and gradient plain and in the
ranks' order, the gradient norms in float64 and each parameter's relative
difference between the two.

    python3 scripts/tp_sum_order.py --device cpu --width 1024 2048

On the card (the default device) the full width, 4096, fits; on a CPU
keep to the narrower ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts ROOT/src on the path)


def grads(cfg, batch, device, specs=None):
    """(loss, {name: gradient}) of ``LM(cfg)`` from ``chip_smoke.TP_SEED``;
    with ``specs`` its row-split products summed in the ranks' order."""
    import contextlib
    from repro_torch.models.model import LM
    lm = LM(cfg, device=device, seed=chip_smoke.TP_SEED)
    lm.requires_grad_(True)
    with (chip_smoke._rank_order(lm, specs, 2) if specs
          else contextlib.nullcontext()):
        loss = lm.loss(batch)
        loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  lm.named_parameters()}


def main(argv=None) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.sharding.rules import MeshShape
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import state_specs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    ap.add_argument("--width", type=int, nargs="+", default=[4096])
    ap.add_argument("--vocab", type=int, default=8192)
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("tp_sum_order: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 1
    device = args.device or "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    data = SyntheticLMStream(LMDataConfig(vocab_size=args.vocab, seq_len=512,
                                          global_batch=2))
    batch = {k: torch.from_numpy(v).long().to(device)
             for k, v in data.batch(0).items()}
    mesh = MeshShape(("data", "model"), (1, 2))
    for width in args.width:
        cfg = dataclasses.replace(
            get_config("jamba-v0.1-52b"), dtype="float32", num_layers=1,
            d_model=width, d_ff=2 * width, vocab_size=args.vocab)
        specs = state_specs(cfg, OptConfig(), mesh)
        loss_a, plain = grads(cfg, batch, device)
        loss_b, ranked = grads(cfg, batch, device, specs)

        def norm(g):
            return float(sum(t.double().square().sum()
                             for t in g.values()).sqrt())
        a, b = norm(plain), norm(ranked)
        print(f"[tp_sum_order] jamba-v0.1-52b 1 layer f32, d_model {width}, "
              f"vocab {args.vocab}, B2 x S512 on {device}: loss plain "
              f"{loss_a:.7f}, in the ranks' order {loss_b:.7f}; gradient "
              f"norm (float64) {a:.7f} / {b:.7f}, rel {abs(a - b) / a:.2e}")
        for n, g in plain.items():
            rel = float((g - ranked[n]).double().norm()
                        / g.double().norm().clamp(min=1e-30))
            print(f"[tp_sum_order]   {n}: |g| {float(g.norm()):.4f}, rel "
                  f"{rel:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
