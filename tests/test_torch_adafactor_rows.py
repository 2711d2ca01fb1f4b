"""Adafactor's elementwise update runs a run of rows at a time
(``training.optimizer.apply_updates``, ``CHUNK`` elements of float32
temporaries): any run length gives the bits of one pass over each
group, for single, stacked (one norm vector a layer), matrix and expert
stacks, in float32 and bf16."""

import torch_threads  # noqa: F401  (first: caps torch threads)

import pytest
import torch

from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                            init_opt_state)

SHAPES = {"embed": (37, 16), "final_norm": (16,),
          "blocks.0.attn.wq": (16, 24), "blocks.1.attn.wq": (16, 24),
          "blocks.0.norm": (16,), "blocks.1.norm": (16,),
          "blocks.0.moe.experts.w_gate": (4, 16, 8),
          "blocks.1.moe.experts.w_gate": (4, 16, 8)}


def _run(dtype, chunk, monkeypatch, steps=3):
    monkeypatch.setattr(opt_mod, "CHUNK", chunk)
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s, generator=gen).to(dtype)
              for k, s in SHAPES.items()}
    grads = {k: torch.randn(s, generator=gen).to(dtype)
             for k, s in SHAPES.items()}
    cfg = OptConfig(kind="adafactor", warmup_steps=1)
    state = init_opt_state(params, cfg)
    for _ in range(steps):
        _, state, _ = apply_updates(params, grads, state, cfg)
    return params, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [7, 64])
def test_row_runs_give_the_bits_of_one_pass(dtype, chunk, monkeypatch):
    """Three steps with runs of a few rows (7 and 64 elements: one row or
    several of a 16- or 24-wide matrix) equal three steps in one pass
    bit for bit: parameters and both statistics."""
    whole, ws = _run(dtype, 1 << 26, monkeypatch)
    runs, rs = _run(dtype, chunk, monkeypatch)
    for k in SHAPES:
        assert torch.equal(whole[k], runs[k]), k
    for k in ws.m:
        assert torch.equal(ws.m[k], rs.m[k]) and torch.equal(ws.v[k],
                                                              rs.v[k]), k
