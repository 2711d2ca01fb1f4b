"""Five train steps of the port's ``make_train_step`` against the JAX
package's on the three stacks whose training reaches K3b's new shapes:
gemma3-4b-edge at head width 256 (tests/test_torch_gemma.py's
``gemma3-hd256``), llama-3.2-vision-90b on ``image_embeds`` (its
cross-attention layer: full attention at Sq != Skv) under AdamW and
Adafactor, and musicgen-large on ``frames``.

Float32 on the CPU, reduced configs, the weights and optimizer state of
a JAX ``TrainState`` after one JAX step carried across
(``models/bridge``), then five steps in each package on the same seeded
numpy batches.  lr 3e-4: AdamW's first steps are about +-lr a weight
whatever the gradient's size, so at a larger lr an element whose
gradient is ~0 in float noise may step the other way in one package.
Tolerances: each step's loss rtol 1e-5 and grad norm rtol 1e-4 (the
backward sums in another order); every parameter after step 5 atol and
rtol 1e-4.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.training import optimizer as jopt
from repro.training.train_loop import init_train_state as jinit
from repro.training.train_loop import make_train_step as jmake_step
from repro_torch.configs import get_config as port_config
from repro_torch.models.bridge import (opt_state_from_jax, params_from_jax,
                                       params_to_jax)
from repro_torch.models.model import LM
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import TrainState, make_train_step

#: (arch, config overrides, optimizer)
CASES = {"gemma3-hd256": ("gemma3-4b-edge", {"head_dim": 256}, "adamw"),
         "vision-adamw": ("llama-3.2-vision-90b", {}, "adamw"),
         "vision-adafactor": ("llama-3.2-vision-90b", {}, "adafactor"),
         "musicgen": ("musicgen-large", {}, "adamw")}
B, S = 4, 24


def _batch(cfg, i):
    """Step i's batch: tokens (or frames), next-token labels and, for a
    stack with cross-attention, image embeddings, all from seed i."""
    rng = np.random.default_rng(100 + i)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.audio_frontend:
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    if cfg.num_image_tokens:
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_train_steps_match_jax(case):
    arch, over, kind = CASES[case]
    jcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(port_config(arch).reduced(), **over)
    opt = dict(lr=3e-4, kind=kind, warmup_steps=2)
    jo, to = jopt.OptConfig(**opt), topt.OptConfig(**opt)
    jstep = jax.jit(jmake_step(jcfg, jo))
    jstate = jinit(jcfg, jo, jax.random.key(2))
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
