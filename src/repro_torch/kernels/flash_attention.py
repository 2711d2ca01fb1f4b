"""K3: causal (or full) flash attention for the bucketed prefill and the
extend prefill.

``flash_attention_cuda`` launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_kernel``.
``flash_attention_plain`` is the same function in plain PyTorch.  Both
take model layout: q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H,
hd), with query row i at absolute position ``q_offset + i`` of the keys
(a host int; 0 and Sq == Skv for a cold prefill, the cached prefix's
length for an extend prefill).  Unlike the Pallas kernel, any lengths are
accepted (the ragged edge is masked).

``return_lse=True`` (training) also returns each query row's log-sum-exp,
(B, H, Sq) float32, which the backward kernel K3b
(``kernels.flash_attention_bwd``) recomputes the probabilities from.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: int = 0, return_lse: bool = False):
    """Plain version: f32 einsum, (causal) softmax, einsum (model layout);
    with ``return_lse``, (o, lse)."""
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              q_offset=q_offset, return_lse=return_lse)
    if return_lse:
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 9 + [_L] * 12 + [_P, _P]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         q_offset: int = 0, return_lse: bool = False):
    """Launch K3 on q's device and stream: bf16 on the tensor cores with
    the G query heads of a KV head stacked into one row tile, float32 on
    the CUDA cores in full f32.  With ``return_lse``, (o, lse)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    q_offset = int(q_offset)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Skv, KV, hd) or v.shape != k.shape or H % KV \
            or hd not in _HEAD_DIMS or q_offset < 0 \
            or (causal and q_offset + Sq > Skv):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"q_offset {q_offset}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("head_dim must be contiguous")
    if q.dtype == torch.bfloat16 and not (
            _build.rows_aligned(q, 4) and _build.rows_aligned(k)
            and _build.rows_aligned(v)):
        raise ValueError("bf16 rows must start on 4-byte (q) and 16-byte "
                         "(k, v) boundaries")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if Sq == 0:
        return (o, lse) if return_lse else o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                _DTYPES[q.dtype], B, Sq, Skv, q_offset, H, KV, hd,
                int(causal),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], stream,
                lse.data_ptr() if return_lse else None)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return (o, lse) if return_lse else o
