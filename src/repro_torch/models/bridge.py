"""Carry weights and optimizer state between the JAX package and the port.

``params_from_jax`` takes the pytree of ``repro.models.model.init_model``
as numpy arrays (the caller does the ``jax.device_get``; this module never
imports JAX) and returns a state dict for ``repro_torch.models.model.LM``;
``params_to_jax`` is its inverse.  ``opt_state_from_jax`` carries a JAX
``OptState`` (AdamW or Adafactor) into ``training.optimizer.OptState``,
so a JAX ``TrainState`` crosses whole.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^blocks\.(\d+)\.(.+)$")
#: the leaves outside the blocks (``embed`` absent with the audio
#: frontend, ``head`` with tied embeddings)
_TOP = ("embed", "final_norm", "head")


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flat(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict: ``{"moe": {"experts":
    {"w_up": a}}}`` -> ``("moe.experts.w_up", a)``."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flat(val, name + ".")
        else:
            yield name, val


def _nest(flat: dict) -> dict:
    """The inverse of :func:`_flat`."""
    out: dict = {}
    for name, val in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def params_from_jax(np_params, cfg) -> dict:
    """State dict of ``LM(cfg)`` from the JAX params.

    ``np_params["blocks"]`` is a tuple over the pattern's positions; each
    position's leaves are stacked over the pattern's repeats (the JAX
    scan layout).  Leaf r of position p becomes layer ``r * P + p``
    (P the pattern's length), named ``blocks.<layer>.<part>.<name>``
    with the nested names dotted (``moe.experts.w_gate``).  Dense
    weights are (in, out) in both packages (``x @ W``), and every leaf
    keeps its dtype (the xLSTM gate weights stay float32 in a bf16
    model).  A tied head is the embedding itself, so it has no entry of
    its own; a model with the audio frontend has no embedding.
    """
    P, R = len(cfg.block_pattern), cfg.pattern_repeats
    if len(np_params["blocks"]) != P:
        raise ValueError(f"{len(np_params['blocks'])} pattern positions, "
                         f"config has {P}")
    sd = {k: _tensor(np_params[k]) for k in _TOP if k in np_params}
    for p, tree in enumerate(np_params["blocks"]):
        for name, stacked in _flat(tree):
            if stacked.shape[0] != R:
                raise ValueError(f"{name}: {stacked.shape[0]} repeats, "
                                 f"config has {R}")
            for r in range(R):
                sd[f"blocks.{r * P + p}.{name}"] = _tensor(stacked[r])
    return sd


def _array(t: torch.Tensor) -> np.ndarray:
    """numpy copy of a tensor; bf16 (which numpy lacks) widens to f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_jax(state_dict, cfg) -> dict:
    """The JAX params pytree (numpy) of an ``LM(cfg)`` state dict: the
    per-layer tensors ``blocks.<i>.<name>`` restacked over the pattern's
    repeats into the tuple ``blocks`` over its positions."""
    P, R = len(cfg.block_pattern), cfg.pattern_repeats
    out = {k: _array(state_dict[k]) for k in _TOP if k in state_dict}
    names = [[] for _ in range(P)]
    for key in state_dict:
        m = _LAYER.match(key)
        if m and int(m.group(1)) < P:
            names[int(m.group(1))].append(m.group(2))
    out["blocks"] = tuple(
        _nest({name: np.stack([_array(state_dict[f"blocks.{r * P + p}."
                                                 f"{name}"])
                               for r in range(R)])
               for name in names[p]})
        for p in range(P))
    return out


def _grouped(tree) -> dict:
    """A params-shaped JAX tree keyed as the port's Adafactor groups
    (``training.optimizer.group_of``): the non-block leaves by name, each
    stacked block leaf as ``blocks.<name>`` (a one-block pattern) or
    ``blocks.pos<p>.<name>`` (pattern position p)."""
    out = {k: _tensor(tree[k]) for k in _TOP if k in tree}
    single = len(tree["blocks"]) == 1
    for p, leaves in enumerate(tree["blocks"]):
        prefix = "blocks." if single else f"blocks.pos{p}."
        for name, stacked in _flat(leaves):
            out[prefix + name] = _tensor(stacked)
    return out


def opt_state_from_jax(np_opt_state, cfg):
    """``training.optimizer.OptState`` from a JAX ``OptState`` (numpy).
    AdamW moments mirror the params and unstack into state-dict names;
    Adafactor's row/column statistics stay stacked over repeats under
    their group names (the port's Adafactor factors the stacked tensor,
    as the JAX one does).  Adafactor is recognised by the 0-d column
    statistic of ``final_norm``."""
    from repro_torch.training.optimizer import OptState
    step, m, v = np_opt_state
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32)
    if np.ndim(v["final_norm"]) == 0:
        return OptState(step, _grouped(m), _grouped(v))
    return OptState(step, params_from_jax(m, cfg), params_from_jax(v, cfg))
