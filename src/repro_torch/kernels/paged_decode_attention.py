"""K2: one-token GQA decode attention through a block table into the
block-paged KV pool.

``paged_decode_attention_cuda`` launches the hand-written Hopper kernel
(``csrc/paged_decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.paged_decode_attention_kernel``.
``paged_decode_attention_plain`` is the same function in plain PyTorch.
Both take the engine's layouts: q (B, 1, H, hd), one layer's pools
(n_pages, page, KV, hd) read in place, the block table ``bt`` (B, P) int32
(physical page of each logical block; 0 is the trash page) and the
per-lane fill levels ``t`` (B,) int32 (logical slots <= t attend; a level
past the P * page window attends the whole window).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import check_fits, split_plan
from repro_torch.kernels.ref import paged_decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_G, _MAX_HD = 16, 256
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def paged_decode_attention_plain(q, pool_k, pool_v, bt, t):
    """Plain version: gather the logical window through the table, then
    the f32 masked softmax of ``decode_attention_ref`` (model layout)."""
    B, _, H, hd = q.shape
    KV = pool_k.shape[2]
    o = paged_decode_attention_ref(q.reshape(B, KV, H // KV, hd),
                                   pool_k.transpose(1, 2),
                                   pool_v.transpose(1, 2), bt, t)
    return o.reshape(B, 1, H, hd)


@functools.cache
def _fn():
    fn = _build.load("paged_decode_attention").paged_decode_attention_launch
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 8 + [_I, _P]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_cuda(q, pool_k, pool_v, bt, t):
    """Launch K2 on q's device and stream, split as K1 splits a window of
    ``P * page`` slots.  ``bt`` (B, P) and ``t`` (B,) are int32 tensors on
    the same device, read by the kernel and never by the host; table
    entries must be valid page ids and every t >= 0.  head_dim and the
    shared memory a block needs are limited as for K1."""
    B, one, H, hd = q.shape
    n_pages, page, KV, _ = pool_k.shape
    if not (q.is_cuda and all(x.device == q.device
                              for x in (pool_k, pool_v, bt, t))):
        raise ValueError("paged_decode_attention_cuda needs q, pools, bt "
                         "and t on one CUDA device")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}/{pool_k.dtype}")
    if one != 1 or pool_v.shape != pool_k.shape or H % KV \
            or H // KV > _MAX_G or hd > _MAX_HD or hd % 8 \
            or pool_k.shape[3] != hd:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"pool {tuple(pool_k.shape)}")
    if q.stride(3) != 1 or pool_k.stride(3) != 1 \
            or pool_v.stride() != pool_k.stride() \
            or not all(map(_build.rows_aligned, (q, pool_k, pool_v))):
        raise ValueError("head_dim must be contiguous, rows 16-byte "
                         "aligned, and both pools share one layout")
    if bt.dtype != torch.int32 or bt.dim() != 2 or bt.shape[0] != B \
            or bt.stride(1) != 1:
        raise TypeError("bt must be a (B, P) int32 table with contiguous "
                        "rows")
    if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
        raise TypeError("t must be a contiguous (B,) int32 tensor")
    check_fits(H // KV, hd, split_plan(bt.shape[1] * page), bt.shape[1])
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                bt.data_ptr(), t.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
                B, bt.shape[1], page, KV, H // KV, hd, q.stride(0),
                q.stride(2), pool_k.stride(0), pool_k.stride(1),
                pool_k.stride(2), bt.stride(0), o.stride(0), o.stride(2),
                split_plan(bt.shape[1] * page), stream)
    _build.check(err, "paged_decode_attention")
    _build.LAUNCHES["paged_decode_attention"] += 1
    return o
