"""K1: one-token GQA decode attention over the ring KV cache.

``decode_attention_cuda`` launches the hand-written Hopper kernel
(``csrc/decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_kernel``.
``decode_attention_plain`` is the same function in plain PyTorch.  Both
take the engine's layouts: q (B, 1, H, hd), cache (B, S, KV, hd) read in
place, and the fill level ``t`` (slots <= t attend; all once t >= S): one
level shared by the batch, or one per lane ((B,), the decode lanes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_G, _MAX_HD = 16, 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def decode_attention_plain(q, cache_k, cache_v, t):
    """Plain version: f32 einsum, masked softmax, einsum (model layout)."""
    B, _, H, hd = q.shape
    KV = cache_k.shape[2]
    o = decode_attention_ref(q.reshape(B, KV, H // KV, hd),
                             cache_k.transpose(1, 2),
                             cache_v.transpose(1, 2), t)
    return o.reshape(B, 1, H, hd)


@functools.cache
def _fn():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_L] * 7 + [_P]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, cache_k, cache_v, t):
    """Launch K1 on q's device and stream.  ``t`` is an int32 tensor of
    one element (shared by the batch) or of B elements (one per lane) on
    the same device, read by the kernel and never by the host; every
    level must be >= 0."""
    B, one, H, hd = q.shape
    _, S, KV, _ = cache_k.shape
    if not (q.is_cuda and cache_k.device == q.device
            and cache_v.device == q.device and t.device == q.device):
        raise ValueError("decode_attention_cuda needs q, caches and t on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}/{cache_k.dtype}")
    if one != 1 or cache_v.shape != cache_k.shape or H % KV \
            or H // KV > _MAX_G or hd > _MAX_HD:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"cache {tuple(cache_k.shape)}")
    if q.stride(3) != 1 or cache_k.stride(3) != 1 \
            or cache_v.stride() != cache_k.stride():
        raise ValueError("head_dim must be contiguous and both caches "
                         "share one layout")
    if t.dtype != torch.int32 or t.numel() not in (1, B) \
            or not t.is_contiguous():
        raise TypeError("t must be a contiguous int32 tensor of 1 or B "
                        "elements")
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                t.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], B, S, KV,
                H // KV, hd, int(t.numel() == B and B > 1), q.stride(0),
                q.stride(2), cache_k.stride(0),
                cache_k.stride(1), cache_k.stride(2), o.stride(0),
                o.stride(2), stream)
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return o
