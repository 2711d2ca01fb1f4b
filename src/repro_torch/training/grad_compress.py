"""Int8 gradient compression with error feedback (port of
``repro.training.grad_compress``).

Replaces the float32 data-axis all-reduce with a two-phase quantized
exchange:

    q = quant8(g + e)                      # error-feedback input
    chunks = all_to_all(q)                 # phase 1: 1 byte/elem on the wire
    partial = sum(dequant(chunks)) / n     # local reduction of my chunk
    out = all_gather(quant8(partial))      # phase 2: 1 byte/elem
    e' = (g + e) - dequant(q)              # residual kept locally

Wire bytes: ~2 x 1 B/elem against 2 x 4 B/elem for a ring float32
all-reduce.  Error feedback turns the quantization noise into a delayed
correction instead of a bias.  The exchange runs over the process group
of the mesh's ``data`` axis (``all_to_all_single`` of int8 chunks, an
all-gather of the per-rank float32 scales); the per-tensor scale is
float32.  ``EXCHANGED["bytes"]`` counts the bytes this rank hands to the
collectives (the int8 payloads and the float32 scales).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.compat import all_gather_single

#: bytes this rank has handed to the exchange's collectives
EXCHANGED = {"bytes": 0}


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: the divisor is a tensor
    (CUDA multiplies by the reciprocal of a Python-number divisor)."""
    return x / x.new_tensor(d)


def _quant8(x: torch.Tensor):
    scale = _div(torch.clamp(x.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, rank-major."""
    EXCHANGED["bytes"] += x.numel() * x.element_size()
    return all_gather_single(x, group=group)


def compressed_psum_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of ``group`` of float32 ``g`` via the int8
    two-phase exchange; every rank gets the same result.  g: any shape,
    flattened and zero-padded to a multiple of the group's size."""
    n = dist.get_world_size(group)
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = _quant8(flat)
    # phase 1: scatter chunks to owners
    mine = torch.empty_like(q)
    dist.all_to_all_single(mine, q, group=group)
    EXCHANGED["bytes"] += q.numel()
    scales = _gather(scale.reshape(()), group)               # (n,)
    part = _div(torch.sum(mine.view(n, -1).float() * scales[:, None],
                          dim=0), float(n))
    # phase 2: gather reduced chunks back
    q2, s2 = _quant8(part)
    full_q = _gather(q2, group)                              # (n, chunk)
    full_s = _gather(s2.reshape(()), group)
    out = (full_q.float() * full_s[:, None]).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(g.shape)


def make_compressed_allreduce(mesh, axis_name: str = "data"):
    """Returns mean_fn(tree) -> tree, each leaf reduced over the mesh's
    ``axis_name`` group with the int8 exchange (error feedback is the
    caller's: :func:`apply_error_feedback`)."""
    group = mesh.get_group(axis_name)

    def mean_fn(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: compressed_psum_mean(g, group) for k, g in tree.items()}

    return mean_fn


def apply_error_feedback(grads: Dict[str, Any], error: Dict[str, Any],
                         quantize=_quant8, dequantize=_dequant8
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(compensated quantized grads, new error) per leaf."""
    deq, new_err = {}, {}
    for k, g in grads.items():
        comp = g.float() + error[k]
        q, s = quantize(comp)
        deq[k] = dequantize(q, s)
        new_err[k] = comp - deq[k]
    return deq, new_err


def init_error_state(grads_template: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_template.items()}
