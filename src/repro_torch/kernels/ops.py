"""The kernels as the model and the predictor call them.

Each wrapper dispatches on where its input lies: a CPU tensor takes the
kernel's plain PyTorch version (how the CPU tests run the port); a CUDA
tensor launches the hand-written Hopper kernel, or the call raises.  There
is no fallback from one to the other.  Layouts are the model's: the
kernels read (B, S, H|KV, hd) in place, so unlike ``repro.kernels.ops``
nothing here transposes a cache.

``LAUNCHES`` counts kernel launches per kernel (see ``_build.LAUNCHES``).
"""

from __future__ import annotations

from repro_torch.kernels._build import LAUNCHES
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.gbdt_infer import (gbdt_margins_cuda,
                                            gbdt_margins_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_plain)

__all__ = ["LAUNCHES", "reset_launches", "decode_attention",
           "paged_decode_attention", "flash_attention", "gbdt_margins"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd); query row i sits
    at key position q_offset + i (a host int)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q, cache_k, cache_v, t):
    """q (B,1,H,hd), ring cache (B,S,KV,hd), fill level t (int32 tensor on
    the cache's device: one level, or (B,) per lane) -> (B,1,H,hd)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, t)
    return decode_attention_cuda(q, cache_k, cache_v, t)


def paged_decode_attention(q, pool_k, pool_v, bt, t):
    """q (B,1,H,hd), one layer's pools (n_pages,page,KV,hd), block table
    bt (B,P) and fill levels t (B,), both int32 on the pools' device ->
    (B,1,H,hd)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool_k, pool_v, bt, t)
    return paged_decode_attention_cuda(q, pool_k, pool_v, bt, t)


def gbdt_margins(X, feature, threshold, value, *, n_classes: int = 3):
    """X (B,F) f32, ensemble tensors (T,N) -> (B, n_classes) margins."""
    if X.device.type == "cpu":
        return gbdt_margins_plain(X, feature, threshold, value,
                                  n_classes=n_classes)
    return gbdt_margins_cuda(X, feature, threshold, value,
                             n_classes=n_classes)
