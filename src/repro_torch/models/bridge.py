"""Carry weights from the JAX package into the port.

``params_from_jax`` takes the pytree of ``repro.models.model.init_model``
as numpy arrays (the caller does the ``jax.device_get``; this module never
imports JAX) and returns a state dict for ``repro_torch.models.model.LM``.
"""

from __future__ import annotations

import numpy as np
import torch


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
