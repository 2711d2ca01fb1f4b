"""End-to-end training CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --batch 8 --seq 128 --ckpt /tmp/ckpt
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --reduced --device cpu --steps 20

Runs on the card unless given ``--device cpu`` (``--reduced`` is the tiny
CPU config of any text arch: dense, MoE, hybrid or xLSTM).  It trains on
``make_local_mesh``: every process of the group (``torchrun``'s, gloo on
the CPU and NCCL on the cards, else a group of one) on a (world, 1)
("data", "model") mesh, the state laid out by the sharding rules
(``abstract_train_state`` -> specs), data parallel with FSDP over
``data`` (``make_train_step(mesh=)``); at world 1 the step is the
single-device one.  Every rank draws the global batch from the stream
and trains on its rows; only rank 0 prints and writes checkpoints (the
sharded leaves are gathered first), and a resume lays the checkpoint out
on whatever mesh is running.  The multimodal archs
(llama-3.2-vision-90b, musicgen-large) are refused with the JAX CLI's
message before any weight is built (their card path is the train step,
with ``frames`` or ``image_embeds`` in the batch, as in JAX).  On the
card a stack with an attention layer whose head width K3b is not
compiled for (K3b takes 16, 32, 64, 128 and 256: every registered
arch's), or whose weights, gradients and float32 AdamW moments would not
fit one card's memory (jamba-v0.1-52b's 51 B parameters), is refused
before any weight is built.  Features exercised: the train step with
per-block remat (every attention layer through K3 forward and K3b
backward on the card), the
deterministic synthetic data stream (resume-safe), async checkpointing
with atomic commits, auto-resume from the latest step and straggler
monitoring.  ``main`` returns the per-step losses (on every rank).
"""

from __future__ import annotations

import argparse
import time

import torch

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, ATTN_MOE, XATTN
from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
from repro_torch.kernels.flash_attention_bwd import check_head_dim
from repro_torch.launch.mesh import init_group, make_local_mesh
from repro_torch.models.model import resolve_device
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.straggler import StepTimer
from repro_torch.training.train_loop import (abstract_train_state,
                                             init_train_state,
                                             make_train_step, state_specs)


def train_state_bytes(cfg) -> int:
    """Bytes of a train state: the weights and their gradients in the
    model's dtype and AdamW's two float32 moments, for every parameter
    (activations not counted)."""
    w = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return cfg.param_count() * (2 * w + 8)


def check_attention_backward(cfg) -> None:
    """Raise ValueError unless K3b is compiled for the head width of every
    attention layer the stack has (self- or cross-attention); a stack
    without one (xlstm-350m) never reaches K3b."""
    if any(k in (ATTN, ATTN_MOE, XATTN) for k in cfg.block_pattern):
        check_head_dim(cfg.head_dim)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        raise SystemExit(f"train.py: {e.args[0]}")
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.audio_frontend or cfg.num_image_tokens:
        raise SystemExit("train.py drives text archs; use examples/ for "
                         "multimodal smoke runs")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # refused before any weight is built: no plain-backward fallback
        try:
            check_attention_backward(cfg)
        except ValueError as e:
            raise SystemExit(f"train.py: {cfg.name}: {e}")
        need = train_state_bytes(cfg)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(
                f"train.py: {cfg.name}: weights, gradients and float32 "
                f"AdamW moments need {need / 2 ** 30:.1f} GiB, the card "
                f"has {have / 2 ** 30:.1f} GiB")
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    device = init_group(device)              # this rank's card, or the CPU
    mesh = make_local_mesh(device)
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    data = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))
    _, s_axes = abstract_train_state(cfg, opt_cfg)
    specs = state_specs(cfg, opt_cfg, mesh)
    state = init_train_state(cfg, opt_cfg, device=device, seed=0)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              mesh=mesh)

    start_step = 0
    if args.ckpt and ckpt_lib.latest_step(args.ckpt) is not None:
        start_step = ckpt_lib.latest_step(args.ckpt)
        state = ckpt_lib.restore(state, args.ckpt, device=device, mesh=mesh,
                                 axes=s_axes)
        say(f"resumed from step {start_step}")

    saver = ckpt_lib.AsyncCheckpointer(args.ckpt, mesh=mesh, specs=specs) \
        if args.ckpt else None
    timer = StepTimer()
    losses = []
    for step in range(start_step, start_step + args.steps):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in data.batch(step).items()}
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        if timer.observe(step, dt):
            say(f"step {step}: straggler flagged ({dt:.2f}s)")
        losses.append(loss)
        if step % args.log_every == 0:
            say(f"step {step}: loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if saver and (step + 1) % args.ckpt_every == 0:
            saver.save(state, step + 1)
    if saver:
        saver.save(state, start_step + args.steps)
        saver.wait()
    say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
