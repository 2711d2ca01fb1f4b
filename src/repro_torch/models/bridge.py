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

_LAYER = re.compile(r"^blocks\.(\d+)\.(attn|mlp)\.(\w+)$")


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_params, cfg) -> dict:
    """State dict of ``LM(cfg)`` from the JAX params.

    ``np_params["blocks"]`` is a 1-tuple (pattern ``(attn,)``) whose leaves
    are stacked over layers; each is unstacked into ``blocks.<i>``.  Dense
    weights are (in, out) in both packages (``x @ W``).  A tied head is the
    embedding itself, so it has no entry of its own.
    """
    if len(np_params["blocks"]) != 1:
        raise ValueError("only the (attn,) block pattern is ported")
    blocks = np_params["blocks"][0]
    sd = {"embed": _tensor(np_params["embed"]),
          "final_norm": _tensor(np_params["final_norm"])}
    if not cfg.tie_embeddings:
        sd["head"] = _tensor(np_params["head"])
    for part in ("attn", "mlp"):
        for name, stacked in blocks[part].items():
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"{part}.{name}: {stacked.shape[0]} layers, "
                                 f"config has {cfg.num_layers}")
            for i in range(cfg.num_layers):
                sd[f"blocks.{i}.{part}.{name}"] = _tensor(stacked[i])
    return sd


def _array(t: torch.Tensor) -> np.ndarray:
    """numpy copy of a tensor; bf16 (which numpy lacks) widens to f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_jax(state_dict, cfg) -> dict:
    """The JAX params pytree (numpy) of an ``LM(cfg)`` state dict: the
    per-layer tensors ``blocks.<i>.<part>.<name>`` restacked over layers
    into the 1-tuple ``blocks`` of pattern ``(attn,)``."""
    out = {"embed": _array(state_dict["embed"]),
           "final_norm": _array(state_dict["final_norm"])}
    if not cfg.tie_embeddings:
        out["head"] = _array(state_dict["head"])
    parts = {"attn": {}, "mlp": {}}
    for key in state_dict:
        m = _LAYER.match(key)
        if m and m.group(1) == "0":
            part, name = m.group(2), m.group(3)
            parts[part][name] = np.stack(
                [_array(state_dict[f"blocks.{i}.{part}.{name}"])
                 for i in range(cfg.num_layers)])
    out["blocks"] = (parts,)
    return out


def _grouped(tree) -> dict:
    """A params-shaped JAX tree keyed as the port's Adafactor groups: the
    non-block leaves by name, each stacked block leaf as
    ``blocks.<part>.<name>``."""
    out = {k: _tensor(tree[k]) for k in ("embed", "final_norm", "head")
           if k in tree}
    for part, leaves in tree["blocks"][0].items():
        for name, stacked in leaves.items():
            out[f"blocks.{part}.{name}"] = _tensor(stacked)
    return out


def opt_state_from_jax(np_opt_state, cfg):
    """``training.optimizer.OptState`` from a JAX ``OptState`` (numpy).
    AdamW moments mirror the params and unstack into state-dict names;
    Adafactor's row/column statistics stay stacked over layers under
    their group names (the port's Adafactor factors the stacked tensor,
    as the JAX one does).  Adafactor is recognised by the 0-d column
    statistic of ``final_norm``."""
    from repro_torch.training.optimizer import OptState
    step, m, v = np_opt_state
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32)
    if np.ndim(v["final_norm"]) == 0:
        return OptState(step, _grouped(m), _grouped(v))
    return OptState(step, params_from_jax(m, cfg), params_from_jax(v, cfg))
