"""K1: one-token GQA decode attention over the ring KV cache.

``decode_attention_cuda`` launches the hand-written Hopper kernel
(``csrc/decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_kernel``.
``decode_attention_plain`` is the same function in plain PyTorch.  Both
take the engine's layouts: q (B, 1, H, hd), cache (B, S, KV, hd) read in
place, and the fill level ``t`` (slots <= t attend; all once t >= S): one
level shared by the batch, or one per lane ((B,), the decode lanes).

The kernel splits each lane's live slots over a cluster of up to eight
blocks per (lane, KV head); :func:`split_plan` and :func:`split_ranges`
state that plan on the host, in the same integer arithmetic as the
kernel, so the tests can hold it without a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_G, _MAX_HD = 16, 256
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the portable thread-block-cluster size of Hopper (kMaxSplits in
#: csrc/decode_tile.cuh)
MAX_SPLITS = 8
#: ring slots per split that set the cluster size; up to as many live
#: slots, rank 0 takes them all alone (kSplitSlots in the kernel)
SLOTS_PER_SPLIT = 64
#: dynamic shared memory one block may use on an H100 (kMaxSmem)
MAX_SMEM_BYTES = 232_448
_WARPS = 8                      # kWarps in csrc/decode_tile.cuh


def decode_smem_bytes(G: int, hd: int, n_split: int, P: int = 0) -> int:
    """Shared memory of one K1/K2 block (``smem_bytes`` in
    csrc/decode_tile.cuh) at the group width the kernel is compiled for
    (G up to 4, then 8, then 16): the warps' and the cluster's (m, l)
    pairs, the warps' accumulators, in a cluster
    (``n_split`` > 1) the columns of every rank's accumulator that this
    rank folds (``hd / n_split`` of each head from each of the
    ``n_split`` ranks), and K2's table row of P entries."""
    gm = G if G <= 4 else 8 if G <= 8 else 16
    return 4 * (2 * (_WARPS + MAX_SPLITS) * gm
                + (_WARPS + (n_split > 1)) * gm * hd) + 4 * P


def check_fits(G: int, hd: int, n_split: int, P: int = 0) -> None:
    """Raise when a K1/K2 block at this shape would not fit: the shared
    memory past the card's 227 KB, or more than 8 query heads a KV head
    past hd 128 (two chunks a lane are compiled up to a group of 8)."""
    need = decode_smem_bytes(G, hd, n_split, P)
    if need > MAX_SMEM_BYTES or (hd > 128 and G > 8):
        raise ValueError(
            f"decode attention at G={G} hd={hd} over {n_split} splits "
            f"needs {need} bytes of shared memory a block (at most "
            f"{MAX_SMEM_BYTES}, and G <= 8 past hd 128)")


def split_plan(S: int) -> int:
    """Blocks of the cluster that one (lane, KV head) runs on: the
    smallest power of two that gives each at most ``SLOTS_PER_SPLIT`` of
    the ``S``-slot window, capped at ``MAX_SPLITS``.  It depends on S
    alone, so K2 (window ``P * page``) splits a window as K1 does."""
    n = 1
    while n < MAX_SPLITS and n * SLOTS_PER_SPLIT < S:
        n *= 2
    return n


def split_ranges(t, S: int) -> torch.Tensor:
    """The slot range ``[lo, hi)`` that each block of a lane's cluster
    attends: (..., split_plan(S), 2) int64 for fill levels ``t`` of any
    shape.  Up to ``SLOTS_PER_SPLIT`` live slots ``[0, min(S, t + 1))``
    rank 0 takes them all and runs alone; past that they are cut into
    contiguous ranges of ``ceil(live / n)`` slots in rank order.  Ranks
    past the end get an empty range.  A lane's ranges depend on its own
    level and S only, never on the batch."""
    n = split_plan(S)
    live = torch.clamp(torch.as_tensor(t, dtype=torch.int64) + 1, max=S)
    per = torch.where(live <= SLOTS_PER_SPLIT, live, (live + n - 1) // n)
    rank = torch.arange(n)
    lo = torch.minimum(rank * per[..., None], live[..., None])
    hi = torch.minimum(lo + per[..., None], live[..., None])
    return torch.stack([lo, hi], dim=-1)


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
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_L] * 7 + [_I, _P]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, cache_k, cache_v, t):
    """Launch K1 on q's device and stream: one launch of
    ``split_plan(S)``-block clusters.  ``t`` is an int32 tensor of one
    element (shared by the batch) or of B elements (one per lane) on the
    same device, read by the kernel and never by the host; every level
    must be >= 0.  head_dim is a multiple of 8, at most 256; a shape
    whose block would not fit in shared memory is refused
    (:func:`check_fits`)."""
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
            or H // KV > _MAX_G or hd > _MAX_HD or hd % 8:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"cache {tuple(cache_k.shape)}")
    if q.stride(3) != 1 or cache_k.stride(3) != 1 \
            or cache_v.stride() != cache_k.stride() \
            or not all(map(_build.rows_aligned, (q, cache_k, cache_v))):
        raise ValueError("head_dim must be contiguous, rows 16-byte "
                         "aligned, and both caches share one layout")
    if t.dtype != torch.int32 or t.numel() not in (1, B) \
            or not t.is_contiguous():
        raise TypeError("t must be a contiguous int32 tensor of 1 or B "
                        "elements")
    check_fits(H // KV, hd, split_plan(S))
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                t.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], B, S, KV,
                H // KV, hd, int(t.numel() == B and B > 1), q.stride(0),
                q.stride(2), cache_k.stride(0),
                cache_k.stride(1), cache_k.stride(2), o.stride(0),
                o.stride(2), split_plan(S), stream)
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return o
