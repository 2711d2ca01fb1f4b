"""The kernels as the model and the predictor call them.

Each wrapper dispatches on where its input lies: a CPU tensor takes the
kernel's plain PyTorch version (how the CPU tests run the port); a CUDA
tensor launches the hand-written Hopper kernel, or the call raises.  There
is no fallback from one to the other.  A ``meta`` tensor (the dry run's
shape computation, ``launch.dryrun``: nothing is computed) takes the
plain version's shapes.  Layouts are the model's: the
kernels read (B, S, H|KV, hd) in place, so unlike ``repro.kernels.ops``
nothing here transposes a cache.

``flash_attention_train`` is the training attention: differentiable, with
K3 (emitting its log-sum-exp) forward and K3b backward on the card.

``LAUNCHES`` counts kernel launches per kernel (see ``_build.LAUNCHES``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import LAUNCHES
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (check_lengths,
                                                     flash_attention_bwd_cuda)
from repro_torch.kernels.gbdt_infer import (gbdt_margins_cuda,
                                            gbdt_margins_packed_cuda,
                                            gbdt_margins_packed_plain,
                                            gbdt_margins_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_plain)

#: the devices whose tensors take the plain versions
PLAIN = ("cpu", "meta")

__all__ = ["LAUNCHES", "reset_launches", "decode_attention",
           "paged_decode_attention", "flash_attention",
           "flash_attention_train", "gbdt_margins",
           "gbdt_margins_packed", "gbdt_margins_packed_from"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd); query row i sits
    at key position q_offset + i (a host int)."""
    if q.device.type in PLAIN:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


class _FlashTrain(torch.autograd.Function):
    """K3 with its log-sum-exp forward, K3b backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, *, causal: bool = True):
    """Differentiable attention over the training shapes: q (B,Sq,H,hd),
    k/v (B,Skv,KV,hd) -> (B,Sq,H,hd); causal with Sq == Skv (query row i
    at key position i), full at any Sq and Skv (cross-attention).  A CPU
    tensor runs the plain forward under autograd; a CUDA tensor runs K3
    forward and K3b backward (``torch.autograd.Function``)."""
    if q.device.type in PLAIN:
        return flash_attention_plain(q, k, v, causal=causal)
    check_lengths(q.shape[1], k.shape[1], causal)
    return _FlashTrain.apply(q, k, v, causal)


def decode_attention(q, cache_k, cache_v, t):
    """q (B,1,H,hd), ring cache (B,S,KV,hd), fill level t (int32 tensor on
    the cache's device: one level, or (B,) per lane) -> (B,1,H,hd)."""
    if q.device.type in PLAIN:
        return decode_attention_plain(q, cache_k, cache_v, t)
    return decode_attention_cuda(q, cache_k, cache_v, t)


def paged_decode_attention(q, pool_k, pool_v, bt, t):
    """q (B,1,H,hd), one layer's pools (n_pages,page,KV,hd), block table
    bt (B,P) and fill levels t (B,), both int32 on the pools' device ->
    (B,1,H,hd)."""
    if q.device.type in PLAIN:
        return paged_decode_attention_plain(q, pool_k, pool_v, bt, t)
    return paged_decode_attention_cuda(q, pool_k, pool_v, bt, t)


def gbdt_margins(X, feature, threshold, value, *, n_classes: int = 3):
    """X (B,F) f32, ensemble tensors (T,N) -> (B, n_classes) margins."""
    if X.device.type == "cpu":
        return gbdt_margins_plain(X, feature, threshold, value,
                                  n_classes=n_classes)
    return gbdt_margins_cuda(X, feature, threshold, value,
                             n_classes=n_classes)


def gbdt_margins_packed(X, feature, threshold, child, value, *, depth: int,
                        n_classes: int = 3, base_score: float = 0.0):
    """X (B,F) f32, packed ensemble tensors (T,M) walked ``depth`` steps
    -> (B, n_classes) margins + ``base_score``."""
    kw = dict(depth=depth, n_classes=n_classes, base_score=base_score)
    if X.device.type == "cpu":
        return gbdt_margins_packed_plain(X, feature, threshold, child, value,
                                         **kw)
    return gbdt_margins_packed_cuda(X, feature, threshold, child, value,
                                    **kw)


def gbdt_margins_packed_from(packed, X):
    """Score X (B,F) f32, on its device, with a
    :class:`~repro_torch.core.ensemble_pack.PackedEnsemble` (base score
    included)."""
    if X.shape[1] < packed.n_features:
        raise ValueError(f"X has {X.shape[1]} features, the ensemble reads "
                         f"{packed.n_features}")
    return gbdt_margins_packed(X, *packed.tensors(X.device),
                               depth=int(packed.depth),
                               n_classes=int(packed.n_classes),
                               base_score=float(packed.base_score))
