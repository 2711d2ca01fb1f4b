"""Plain PyTorch versions of the ported kernels, in the JAX package's
kernel layout (``repro.kernels.ref``): the allclose ground truth the Hopper
kernels and the CPU path are held against."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd)."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def decode_attention_ref(q, k, v, t):
    """q: (B, KV, G, hd); k, v: (B, KV, S, hd); slots <= t attend (all of
    them once the ring has wrapped, t >= S).  ``t``: int or 0-d tensor."""
    hd = q.shape[-1]
    S = k.shape[2]
    s = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) * hd ** -0.5
    t = torch.as_tensor(t, device=q.device)
    mask = torch.arange(S, device=q.device) <= t
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", w, v.float())
    return o.to(q.dtype)


def gbdt_margins_ref(X, feature, threshold, value, *, n_classes: int = 3):
    """Level-by-level walk of complete binary trees.  X: (B, F) f32;
    feature/threshold/value: (T, N); ``feature < 0`` marks a leaf, go left
    iff ``x < threshold``, children of i at 2i+1 / 2i+2.  Tree t adds its
    leaf value to class ``t % n_classes``.  Returns (B, n_classes) f32."""
    X = X.float()
    B = X.shape[0]
    T, N = feature.shape
    max_depth = int(math.log2(N + 1)) - 1
    feature = feature.long()
    idx = torch.zeros(T, B, dtype=torch.long, device=X.device)
    for _ in range(max_depth):
        f = torch.gather(feature, 1, idx)                    # (T, B)
        xi = X.T.gather(0, f.clamp(min=0))                   # (T, B)
        go_left = xi < torch.gather(threshold, 1, idx)
        nxt = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(f < 0, idx, nxt)
    vals = torch.gather(value, 1, idx)                       # (T, B)
    return vals.reshape(T // n_classes, n_classes, B).sum(0).T.contiguous()
