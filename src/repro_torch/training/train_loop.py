"""The train step: loss -> gradients -> optimizer (port of
``repro.training.train_loop`` on one device).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  Microbatching slices the batch along its first axis,
runs forward and backward on each slice and sums the gradients in
``accum_dtype``, as the JAX ``lax.scan`` does.  There is no mesh yet, so
no abstract (shape-only) state either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.model import LM
from repro_torch.training.optimizer import (OptConfig, OptState,
                                            apply_updates, init_opt_state)


class TrainState(NamedTuple):
    """The model, whose parameters the step updates in place, and the
    optimizer state.  ``params`` is the model's parameters by name."""
    model: LM
    opt: OptState

    @property
    def params(self):
        return dict(self.model.named_parameters())


def init_train_state(cfg, opt_cfg: OptConfig, *, device=None,
                     seed: int = 0) -> TrainState:
    """A freshly initialised ``LM(cfg)`` (weights from ``seed``) with its
    parameters set to require gradients, and zero optimizer state."""
    lm = LM(cfg, device=device, seed=seed)
    lm.requires_grad_(True)
    return TrainState(lm, init_opt_state(dict(lm.named_parameters()),
                                         opt_cfg, len(cfg.block_pattern)))


def make_train_step(cfg, opt_cfg: OptConfig, microbatches: int = 1,
                    remat: bool = True, accum_dtype: str = "float32"):
    """``accum_dtype``: the gradient-accumulation buffers' dtype when
    ``microbatches`` > 1.  The batch's leading axis must divide by
    ``microbatches``."""
    acc_dt = getattr(torch, accum_dtype)

    def grads_of(lm, batch):
        for p in lm.parameters():
            p.grad = None
        loss = lm.loss(batch, remat=remat)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in lm.named_parameters()}

    def train_step(state: TrainState, batch):
        lm = state.model
        lm.requires_grad_(True)
        if microbatches == 1:
            loss, grads = grads_of(lm, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            acc = {name: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for name, p in lm.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=lm.device)
            for i in range(microbatches):
                mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                mb_loss, g = grads_of(lm, mb)
                for name, a in acc.items():
                    acc[name] = (a + g[name].to(acc_dt)).to(acc_dt)
                loss = loss + mb_loss
            loss = loss / microbatches
            grads = {name: a.float() / microbatches
                     for name, a in acc.items()}
        for p in lm.parameters():
            p.grad = None
        _, opt, metrics = apply_updates(dict(lm.named_parameters()), grads,
                                        state.opt, opt_cfg,
                                        len(cfg.block_pattern))
        metrics["loss"] = loss
        return TrainState(lm, opt), metrics

    return train_step
