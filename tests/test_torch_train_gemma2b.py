"""gemma-2b trained: the port's train step and K3b's plan at its
multi-query heads (8 query heads over 1 KV head of width 256, G 8),
held on the CPU.

* Five ``make_train_step`` steps of a reduced gemma-2b (its 8 over 1
  heads at head width 256, GeGLU, the tied head) against the JAX
  package's, the weights and optimizer state of a JAX ``TrainState``
  after one JAX step carried across (``models/bridge``), float32, lr
  3e-4, as ``tests/test_torch_train_archs.py`` does for the other
  trained stacks, with its tolerances: each step's loss rtol 1e-5 and
  grad norm rtol 1e-4, every parameter after step 5 atol and rtol 1e-4.
* K3b's plain version (``flash_attention_bwd_plain``) at G 8 over one KV
  head against autograd of the plain attention and ``jax.vjp`` of the
  JAX package's chunked flash attention.
* The bf16 kernel's plan at the card's train shape (B 4, S 512, 8/1/256):
  two 256-row chunks, 64-key tiles, 48 of pass 2's blocks walking a
  chunk, and every (query head, 64-row tile) that a key tile sees
  walked by exactly one rank.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.attention import flash_attention as jax_flash
from repro.training import optimizer as jopt
from repro.training.train_loop import init_train_state as jinit
from repro.training.train_loop import make_train_step as jmake_step
from repro_torch.configs import get_config as port_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import (
    TILE, flash_attention_bwd_plain, flash_bwd_launch_plan, flash_bwd_walk)
from repro_torch.models.bridge import (opt_state_from_jax, params_from_jax,
                                       params_to_jax)
from repro_torch.models.model import LM
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import TrainState, make_train_step

ARCH = "gemma-2b"
#: gemma-2b's own heads on the reduced width
OVER = dict(num_heads=8, num_kv_heads=1, head_dim=256)
B, S = 4, 24
#: the card's bf16 train shape (chip_smoke.py's [gemma2b-train])
TRAIN_B, TRAIN_S, HEADS = 4, 512, (8, 1, 256)


def _batch(cfg, i):
    """Step i's tokens and next-token labels, from seed i."""
    rng = np.random.default_rng(200 + i)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def _torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def test_reduced_config_keeps_the_heads_and_the_tied_head():
    full = port_config(ARCH)
    cfg = dataclasses.replace(port_config(ARCH).reduced(), **OVER)
    assert (full.num_heads, full.num_kv_heads, full.head_dim) == HEADS
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == HEADS
    assert cfg.tie_embeddings and cfg.mlp_activation == "gelu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(get_config(ARCH).reduced(), **OVER))


def test_five_train_steps_match_jax():
    jcfg = dataclasses.replace(get_config(ARCH).reduced(), **OVER)
    tcfg = dataclasses.replace(port_config(ARCH).reduced(), **OVER)
    opt = dict(lr=3e-4, kind="adamw", warmup_steps=2)
    jo, to = jopt.OptConfig(**opt), topt.OptConfig(**opt)
    jstep = jax.jit(jmake_step(jcfg, jo))
    jstate = jinit(jcfg, jo, jax.random.key(3))
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, _batch(jcfg, 0)))
    np_state = jax.tree.map(np.asarray, jstate)
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(params_from_jax(np_state.params, tcfg))
    state = TrainState(lm, opt_state_from_jax(np_state.opt, tcfg))
    step = make_train_step(tcfg, to)
    for i in range(1, 6):
        batch = _batch(jcfg, i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    got = params_to_jax(state.model.state_dict(), tcfg)
    paths = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for (path, want), g in zip(paths, jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("Sq,hd", [(100, 256), (64, 16)])
def test_k3b_plain_at_eight_heads_over_one_matches_autograd_and_jax(Sq, hd):
    """K3b's plain recurrence, causal, 8 query heads over 1 KV head, on
    K3's plain (o, lse): within 1e-5 of max|grad| of autograd through the
    plain attention, and within 2e-5 of ``jax.vjp`` of the JAX flash."""
    rng = np.random.default_rng(Sq + hd)
    H, KV = 8, 1
    qn, don = (rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
               for _ in range(2))
    kn, vn = (rng.standard_normal((2, Sq, KV, hd)).astype(np.float32)
              for _ in range(2))
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in (qn, kn, vn))
    do = torch.from_numpy(don)
    o, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), do, lse.detach(),
                                    causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()),
                                   err_msg=name)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                               q_chunk=32, kv_chunk=64),
                     *map(jnp.asarray, (qn, kn, vn)))
    for a, w in zip(got, vjp(jnp.asarray(don))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)


def test_k3b_plan_at_the_train_shape():
    """Pass 2 at B 4, S 512, 8 over 1 at hd 256: 256-row chunks (32 steps
    of 64 rows over 8 heads), a cluster of 2, 64-key tiles, a (2, 4, 8)
    grid of which the 48 blocks of key tiles 0-3 (both chunks) and 4-7
    (the second only) walk; pass 3 a (4, 64) grid, one block an SM."""
    plan = flash_bwd_launch_plan(TRAIN_B, TRAIN_S, TRAIN_S, *HEADS)
    assert plan == {"chunk": 256, "split": 2, "keys": 64,
                    "dkdv_grid": (2, 4, 8), "dkdv_active": 48,
                    "dq_grid": (4, 64), "dq_blocks_per_sm": 1}


def test_k3b_walk_at_the_train_shape_visits_every_tile_once():
    """For each of the 8 key tiles, the two ranks' walks visit every
    (query head, 64-row tile) at or after the tile's first key exactly
    once, each rank inside its own chunk, head by head; rank 0 walks
    nothing for key tiles past its chunk."""
    H, KV, hd = HEADS
    G = H // KV
    plan = flash_bwd_launch_plan(TRAIN_B, TRAIN_S, TRAIN_S, *HEADS)
    keys, chunk, n = plan["keys"], plan["chunk"], plan["split"]
    walking = 0
    for kt in range(plan["dkdv_grid"][2]):
        k0 = kt * keys
        seen = []
        for rank in range(n):
            steps = flash_bwd_walk(kt, rank, TRAIN_S, G, True, keys)
            walking += bool(steps)
            assert steps == sorted(steps)
            assert all(rank * chunk <= q0 < (rank + 1) * chunk
                       for _, q0 in steps)
            if rank < k0 // chunk:
                assert steps == []
            seen += steps
        want = [(g, t * TILE) for g in range(G)
                for t in range(k0 // TILE, TRAIN_S // TILE)]
        assert sorted(seen) == want
        assert len(set(seen)) == len(seen)
    assert walking * KV * TRAIN_B == plan["dkdv_active"] == 48
