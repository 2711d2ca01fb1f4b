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

In bf16 at head widths 128 and 256 the kernel cuts each row's keys into
partials of ``KEY_CHUNK`` keys by absolute key index (chunk c = keys
[c * KEY_CHUNK, (c + 1) * KEY_CHUNK)), walks each chunk from a fresh
(max, sum, accumulator) and folds the partials in chunk order, whether
one block walked them all or a thread-block cluster of
:func:`flash_launch_plan` blocks walked one each.  The plan depends on
absolute key indices only, so a row's result does not depend on Sq, Skv,
the batch or the grid: an extend row equals its cold-prefill row.
:func:`key_chunks` and :func:`flash_launch_plan` state it on the host, in
the kernel's integer arithmetic, for the tests.
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
#: keys of one partial of the bf16 wgmma kernel (kKeyChunk in
#: csrc/flash_attention.cu), the head widths it serves and the portable
#: cluster size
KEY_CHUNK = 256
WGMMA_HEAD_DIMS = (128, 256)
MAX_SPLITS = 8


def key_chunks(lo: int, hi: int) -> list:
    """The partials that cover keys [lo, hi): (c, first, end) for each
    chunk c meeting the range, chunk c being keys [c * KEY_CHUNK,
    (c + 1) * KEY_CHUNK) cut to the range.  A key's chunk is
    ``key // KEY_CHUNK`` whatever the call's lengths."""
    return [(c, max(lo, c * KEY_CHUNK), min(hi, (c + 1) * KEY_CHUNK))
            for c in range(lo // KEY_CHUNK, -(-hi // KEY_CHUNK))]


def flash_launch_plan(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int,
                      q_offset: int = 0, causal: bool = True,
                      sms: int = 132) -> tuple:
    """(stacked rows a block, blocks of the cluster that walks one row
    tile's keys) of the bf16 wgmma kernel (``wgmma_consumers`` and
    ``wgmma_split``).  At hd 128 a block takes two consumer warpgroups
    (128 rows) once 64-row blocks would outnumber the ``sms``, else one
    (64 rows; two such blocks fit an SM); hd 256 takes one.  A row
    tile's walk is split, one chunk a block, when its keys (causal:
    ``q_offset + Sq``, else Skv) take 2 .. ``MAX_SPLITS`` chunks and the
    split grid still runs at once; else one block walks every chunk.
    The output depends on neither."""
    G = H // KV
    rows64 = -(-G * Sq // 64) * KV * B
    consumers = 2 if hd == 128 and rows64 > sms else 1
    per_sm = 2 if hd == 128 and consumers == 1 else 1
    rows = 64 * consumers
    blocks = -(-G * Sq // rows) * KV * B
    keys = q_offset + Sq if causal else Skv
    chunks = -(-keys // KEY_CHUNK)
    if 2 <= chunks <= MAX_SPLITS and blocks * chunks <= per_sm * sms:
        return rows, chunks
    return rows, 1


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
    the G query heads of a KV head stacked into one row tile (``wgmma``
    with TMA-fed K/V at head widths 128 and 256, ``mma.sync`` below),
    float32 on the CUDA cores in full f32.  With ``return_lse``, (o,
    lse)."""
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
    q_align = 16 if hd in WGMMA_HEAD_DIMS else 4
    if q.dtype == torch.bfloat16 and not (
            _build.rows_aligned(q, q_align) and _build.rows_aligned(k)
            and _build.rows_aligned(v)):
        raise ValueError(f"bf16 rows must start on {q_align}-byte (q) and "
                         "16-byte (k, v) boundaries")
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
