"""K3b: the backward of causal (or full) flash attention, for training.

``flash_attention_bwd_cuda`` launches the hand-written Hopper kernel
(``csrc/flash_attention_bwd.cu``).  The JAX package has no Pallas kernel
here: it takes this gradient by autodiff of its chunked jnp flash
attention (``repro.models.attention.flash_attention``, whose nested
``jax.checkpoint`` replays the same recurrence).
``flash_attention_bwd_plain`` is the recurrence in plain PyTorch, f32;
with ``round_dtype=torch.bfloat16`` it rounds P and dS where the bf16
kernel does, before the products that consume them.

Both take model layout and the training shapes: q, o, do (B, Sq, H, hd),
k, v (B, Skv, KV, hd) and K3's per-row log-sum-exp ``lse`` (B, H, Sq)
f32.  Causal attention has Sq == Skv, query row i at key position i (the
train step has no offset); full attention takes any Sq and Skv (the
cross-attention layer: Sq text rows over Skv image rows).  They return
(dq, dk, dv) in the inputs' dtype:

    P = exp(q k^T * scale - lse),  D = rowsum(do * o),
    dS = P * (do v^T - D),
    dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T do,

with dk and dv summed over the G query heads of each KV head.

In bf16 at head widths 64, 128 and 256 the kernel's pass 2 (dK, dV of
one key tile: 128 keys at hd 64 and 128, 64 at hd 256) cuts the (head,
query) rows
that see the key tile into
partials by absolute query index: chunk c is query rows [c * chunk, (c +
1) * chunk) of every query head of the KV head, ``chunk =
query_chunk(Sq, G, causal)``: a function of the model's shape, not of the
batch.  Rank c of a thread-block cluster walks chunk c alone,
head by head and 64 rows a step, and the partials are added in chunk
order, so each key's dK/dV is the same sum in the same order whatever
the grid or the batch.  :func:`flash_bwd_launch_plan` and
:func:`flash_bwd_walk` state the plan on the host, in the kernel's
integer arithmetic, for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths K3b is compiled for: K3's (the forward's)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the bf16 head widths whose passes 2 and 3 run on wgmma (csrc
#: flash_attention_bwd.cu; 16 and 32 keep mma.sync), a causal pass-2
#: partial's 64-row steps
#: (kChunkSteps), the most partials a key tile has (the portable cluster
#: size) and the rows of a tile (keys of a pass-2 warpgroup, query rows
#: of its step, stacked rows of a pass-3 block)
WGMMA_HEAD_DIMS = (64, 128, 256)
CHUNK_STEPS = 32
MAX_SPLITS = 8
TILE = 64


def query_chunk(Sq: int, G: int, causal: bool) -> int:
    """Query rows of one pass-2 partial, from the model's shape alone:
    about ``CHUNK_STEPS`` 64-row steps of its G query heads when causal
    (the key tiles' walks differ, and splitting them evens the blocks
    out), four times that at full attention (every key tile walks the
    same rows, and a split mostly adds its fold); widened where Sq would
    take more than ``MAX_SPLITS`` partials."""
    steps = CHUNK_STEPS if causal else 4 * CHUNK_STEPS
    chunk = TILE * -(-steps // G)
    least = TILE * -(-(-(-Sq // TILE)) // MAX_SPLITS)
    return max(chunk, least)


def bwd_tile_keys(hd: int) -> int:
    """Keys of one pass-2 block: two 64-key warpgroups at hd 64 and 128,
    one 64-key group shared by the dV and dK roles at hd 256."""
    return 2 * TILE if hd <= 128 else TILE


def flash_bwd_launch_plan(B: int, Sq: int, Skv: int, H: int, KV: int,
                          hd: int, causal: bool = True) -> dict:
    """The bf16 wgmma passes' grids (head widths 64, 128 and 256), as the
    launcher computes them: ``chunk`` query rows a partial, ``split``
    blocks a cluster (one a chunk), pass 2's ``keys`` a block,
    ``dkdv_grid`` (split x KV, B, key tiles) and ``dkdv_active`` (blocks
    that walk a chunk: causal, a key tile's chunks start at that of its
    first key), pass 3's ``dq_grid`` (KV x B, 64-row tiles of the G * Sq
    stacked rows) and its blocks an SM."""
    if hd not in WGMMA_HEAD_DIMS:
        raise ValueError(f"K3b's wgmma passes take head widths "
                         f"{WGMMA_HEAD_DIMS}, not {hd}")
    G = H // KV
    chunk = query_chunk(Sq, G, causal)
    split = -(-Sq // chunk)
    keys = bwd_tile_keys(hd)
    key_tiles = -(-Skv // keys)
    active = sum(split - (kt * keys // chunk if causal else 0)
                 for kt in range(key_tiles)) * KV * B
    return {"chunk": chunk, "split": split, "keys": keys,
            "dkdv_grid": (split * KV, B, key_tiles), "dkdv_active": active,
            "dq_grid": (KV * B, -(-G * Sq // TILE)),
            "dq_blocks_per_sm": 1 if hd > 128 else 2}


def flash_bwd_walk(kt: int, rank: int, Sq: int, G: int,
                   causal: bool = True, keys: int = TILE) -> list:
    """Pass 2's steps for key tile ``kt`` (of ``keys`` keys) on cluster
    rank ``rank``, in the kernel's order: (query head g of the KV head,
    first query row of the 64-row step).  Rank r walks the query tiles
    of chunk r that see the key tile (causal: from its first key on),
    head by head; an empty list for a rank below the key tile's first
    chunk."""
    chunk = query_chunk(Sq, G, causal)
    k0 = kt * keys
    lo = max(rank * chunk, k0 if causal else 0) // TILE
    hi = min((rank + 1) * chunk, Sq + TILE - 1) // TILE
    return [(g, qt * TILE) for g in range(G) for qt in range(lo, hi)]


def check_head_dim(hd: int) -> None:
    """Raise unless K3b is compiled for head width ``hd``."""
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_bwd (K3b) takes head widths {HEAD_DIMS}; "
            f"head_dim {hd} has no backward kernel on the card")


def check_lengths(Sq: int, Skv: int, causal: bool) -> None:
    """Raise on causal attention at Sq != Skv: the train step puts query
    row i at key position i, so causal training has one length."""
    if causal and Sq != Skv:
        raise ValueError(f"causal training attention needs Sq == Skv, got "
                         f"{Sq} and {Skv}")


_P, _I = ctypes.c_void_p, ctypes.c_int


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              round_dtype=None):
    """Plain version: the recurrence over the whole (Sq, Skv) plane in
    f32.  ``round_dtype`` (e.g. ``torch.bfloat16``) rounds P before dV and
    dS before dQ and dK, as the bf16 kernel feeds them to the tensor
    cores; None keeps them in f32."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    check_lengths(Sq, Skv, causal)
    G = H // KV
    scale = hd ** -0.5
    qg = q.float().reshape(B, Sq, KV, G, hd)
    dog = do.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(B, KV, G, Sq, 1))
    D = (do.float() * o.float()).sum(-1).reshape(B, Sq, KV, G)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    if round_dtype is not None:
        p, ds = (x.to(round_dtype).float() for x in (p, ds))
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.cache
def _fn():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [_P] * 10 + [_I] * 8 + [_P]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True):
    """Launch K3b's three passes (D, then dK/dV per key tile, then dQ per
    tile of stacked query rows) on q's device and stream; counts one
    launch per call.  bf16 runs on the tensor cores: ``wgmma`` with
    TMA-fed tiles at head widths 64, 128 and 256 (pass 2 split over a
    cluster by :func:`flash_bwd_launch_plan`), ``mma.sync`` at 16 and
    32; float32 on the CUDA cores in full f32."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    tensors = (q, k, v, o, do, lse)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_attention_bwd_cuda needs every input on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError(f"unsupported dtypes {[t.dtype for t in tensors]}")
    check_head_dim(hd)
    check_lengths(Sq, Skv, causal)
    if k.shape != (B, Skv, KV, hd) or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, H, Sq) or KV == 0 or H % KV or Sq == 0 \
            or Skv == 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"o {tuple(o.shape)} do {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)}")
    # the kernel reads rows in 16-byte vectors: a view that starts off
    # such a boundary is copied, as a strided one is
    q, k, v, o, do = (c if _build.rows_aligned(c) else c.clone()
                      for c in (t.contiguous() for t in tensors[:5]))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    D = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv,
                H, KV, hd, int(causal), stream)
    _build.check(err, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv

