"""Plain PyTorch versions of the ported kernels, in the JAX package's
kernel layout (``repro.kernels.ref``): the allclose ground truth the Hopper
kernels and the CPU path are held against."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        return_lse: bool = False):
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) -> (B, H, Sq, hd).

    Query row i sits at absolute position ``q_offset + i`` of the key
    buffer (the extend prefill: a suffix over a cached prefix); causal rows
    attend keys at positions <= their own, as
    ``repro.models.attention.flash_attention(q_offset=...)`` does.
    ``return_lse`` also returns each row's log-sum-exp of the scaled,
    masked scores, (B, H, Sq) float32."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = torch.arange(Skv, device=q.device)[None, :] <= pos
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    o = o.reshape(B, H, Sq, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def decode_attention_ref(q, k, v, t):
    """q: (B, KV, G, hd); k, v: (B, KV, S, hd); slots <= t attend (all of
    them once the ring has wrapped, t >= S).  ``t``: int or 0-d tensor
    shared by the batch, or (B,) per-sequence fill levels (decode
    lanes)."""
    hd = q.shape[-1]
    S = k.shape[2]
    s = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) * hd ** -0.5
    t = torch.as_tensor(t, device=q.device)
    if t.dim():
        t = t.view(-1, 1, 1, 1)
    mask = torch.arange(S, device=q.device) <= t
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", w, v.float())
    return o.to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, t):
    """Block-paged decode: gather each sequence's logical window through
    its block table, then :func:`decode_attention_ref`.

    q: (B, KV, G, hd); k_pages, v_pages: (n_pages, KV, page, hd) shared
    physical pool; block_table: (B, P) int32 physical page per logical
    block; t: (B,) int32 fill levels (logical slots <= t attend)."""
    B = q.shape[0]
    KV, ps, hd = k_pages.shape[1:]
    P = block_table.shape[1]
    bt = block_table.long()
    k = k_pages[bt].transpose(1, 2).reshape(B, KV, P * ps, hd)
    v = v_pages[bt].transpose(1, 2).reshape(B, KV, P * ps, hd)
    return decode_attention_ref(q, k, v, t)


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


def gbdt_margins_packed_ref(X, feature, threshold, child, value, *,
                            depth: int, n_classes: int = 3):
    """Pruned-layout walk (see ``core.ensemble_pack``).  Tensors (T, M):
    in-tree left-child indices, leaf self-loops with +inf thresholds;
    every walk takes exactly ``depth`` steps, going right iff
    ``not x < threshold``.  Returns (B, n_classes) f32 (no base score)."""
    X = X.float()
    B = X.shape[0]
    T = feature.shape[0]
    feature, child = feature.long(), child.long()
    idx = torch.zeros(T, B, dtype=torch.long, device=X.device)
    for _ in range(depth):
        f = torch.gather(feature, 1, idx)                    # (T, B)
        xi = X.T.gather(0, f)                                # (T, B)
        go_right = ~(xi < torch.gather(threshold, 1, idx))
        idx = torch.gather(child, 1, idx) + go_right.long()
    vals = torch.gather(value, 1, idx)                       # (T, B)
    return vals.reshape(T // n_classes, n_classes, B).sum(0).T.contiguous()
