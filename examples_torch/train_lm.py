"""Train a language model end-to-end with the framework's training stack.

    PYTHONPATH=src python examples_torch/train_lm.py --device cpu   # CPU-sized
    PYTHONPATH=src python examples_torch/train_lm.py                # the card
    PYTHONPATH=src python examples_torch/train_lm.py --full         # ~360M config

Exercises: the train step, deterministic data pipeline, AdamW, activation
remat, async checkpointing + resume, straggler monitor.  The default
config is the reduced smollm (a few hundred steps take ~a minute on a
CPU, which is the point of the example); ``--full`` selects the real
smollm-360m, all 32 layers in bf16 on the card, where every attention
layer runs K3 forward (twice a step with remat) and K3b backward.
Checkpoints go to ``build/repro_lm_ckpt`` in the checkout unless
``--ckpt`` names another directory; a directory that already holds one
resumes from its latest step.
"""

import argparse
import os

from repro_torch.launch import train as train_mod

DEFAULT_CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "repro_lm_ckpt")


def train(steps, ckpt, device=None, full=False):
    """``steps`` AdamW steps of smollm-360m (reduced unless ``full``)
    through ``launch.train``, checkpointing into ``ckpt``.  Returns the
    losses."""
    argv = ["--arch", "smollm-360m", "--steps", str(steps),
            "--ckpt", ckpt, "--ckpt-every", "50",
            "--batch", "8", "--seq", "128", "--lr", "3e-3"]
    if not full:
        argv.append("--reduced")
    if device is not None:
        argv += ["--device", str(device)]
    losses = train_mod.main(argv)
    drop = losses[0] - losses[-1]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (-{drop:.3f}) "
          f"over {steps} steps; checkpoints in {ckpt}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return train(args.steps, args.ckpt, args.device, args.full)


if __name__ == "__main__":
    main()
