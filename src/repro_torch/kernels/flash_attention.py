"""K3: causal (or full) flash attention for the bucketed prefill.

``flash_attention_cuda`` launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_kernel``.
``flash_attention_plain`` is the same function in plain PyTorch.  Both
take model layout: q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd).
Unlike the Pallas kernel, any S is accepted (the ragged edge is masked).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain version: f32 einsum, (causal) softmax, einsum (model layout)."""
    o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 7 + [_L] * 12 + [_P]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch K3 on q's device and stream."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV \
            or hd not in _HEAD_DIMS:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("head_dim must be contiguous")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if S == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                _DTYPES[q.dtype], B, S, H, KV, hd, int(causal),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], stream)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return o
