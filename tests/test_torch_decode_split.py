"""K1's split plan (``repro_torch.kernels.decode_attention``), held on the
CPU: the cluster of ``split_plan(S)`` blocks that one (lane, KV head)
runs on, and the slot range each block attends.

The card kernel (csrc/decode_tile.cuh) computes the same ranges in the
same integer arithmetic.  Here the plan must cover every live slot of a
lane exactly once, before and after the ring wraps, and depend on the
lane's own fill level and S only.  A plain-PyTorch mirror of the kernel's
arithmetic -- one (max, sum, accumulator) partial per split, folded in
rank order -- is held to the JAX package's ``decode_attention_ref`` and
to its Pallas kernel in interpret mode at 1e-6 in float32 (the same
softmax, summed in another order).
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_kernel
from repro_torch.kernels.decode_attention import (MAX_SMEM_BYTES, MAX_SPLITS,
                                                  SLOTS_PER_SPLIT, check_fits,
                                                  decode_smem_bytes,
                                                  split_plan, split_ranges)

NEG_INF = -1e30
WINDOWS = [16, 96, 128, 512]


def _boundaries(S):
    """Fill levels on both sides of every split boundary of the full
    window, plus the empty ring, a wrapped ring and far past the end."""
    n = split_plan(S)
    per = -(-S // n)
    ts = {0, 1, 63, 64, 65, S - 2, S - 1, S, S + 5, 2 * S + 3}
    for r in range(1, n):
        ts |= {r * per - 2, r * per - 1, r * per}
    return sorted(t for t in ts if t >= 0)


@pytest.mark.parametrize("S", WINDOWS)
def test_split_plan_covers_every_live_slot_once(S):
    n = split_plan(S)
    assert 1 <= n <= MAX_SPLITS and n & (n - 1) == 0
    assert n == MAX_SPLITS or n * SLOTS_PER_SPLIT >= S
    for t in range(0, 2 * S + 3):
        live = min(S, t + 1)
        ranges = split_ranges(t, S)
        assert ranges.shape == (n, 2)
        slots = [s for lo, hi in ranges.tolist() for s in range(lo, hi)]
        assert slots == list(range(live)), (S, t)
        lo, hi = ranges[:, 0], ranges[:, 1]
        assert bool((lo <= hi).all()) and bool((hi[:-1] == lo[1:]).all())
        if live <= SLOTS_PER_SPLIT:                # rank 0 runs alone
            assert ranges[0].tolist() == [0, live]


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("S", WINDOWS)
def test_split_plan_does_not_depend_on_batch(B, S):
    """Each lane's ranges are those of its scalar-t plan, whatever the
    other lanes hold; and a paged window of P pages of ``page`` slots
    splits as a ring of P * page slots does."""
    rng = np.random.default_rng(B * 1000 + S)
    t = torch.as_tensor(rng.integers(0, 2 * S + 3, B))
    batched = split_ranges(t, S)
    assert batched.shape == (B, split_plan(S), 2)
    for b in range(B):
        assert torch.equal(batched[b], split_ranges(int(t[b]), S))
        assert torch.equal(batched[b], split_ranges(t[b:b + 1], S)[0])
    for page in (8, 16, 32):
        if S % page == 0:
            assert split_plan((S // page) * page) == split_plan(S)


def _partial(q, k, v):
    """One split's (max, sum, accumulator) over its slots, f32: q (KV, G,
    hd), k/v (KV, n, hd); an empty split is (NEG_INF, 0, 0)."""
    KV, G, hd = q.shape
    if k.shape[1] == 0:
        return (torch.full((KV, G), NEG_INF), torch.zeros(KV, G),
                torch.zeros(KV, G, hd))
    s = torch.einsum("kgh,ksh->kgs", q, k) * hd ** -0.5
    m = s.max(-1).values
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("kgs,ksh->kgh", p, v)


def _fold(parts):
    """Partials folded in rank order: the common max, then each weighted
    by exp(its max - the common max)."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        e = torch.exp(m - mx)
        lsum = lsum + l * e
        acc = acc + a * e[..., None]
    return mx, lsum, acc


def _split_mirror(q, k, v, t):
    """K1 by its split plan: q (B, KV, G, hd), k/v (B, KV, S, hd), t (B,)."""
    S = k.shape[2]
    out = torch.empty_like(q)
    for b, ranges in enumerate(split_ranges(t, S).tolist()):
        parts = [_partial(q[b], k[b, :, lo:hi], v[b, :, lo:hi])
                 for lo, hi in ranges]
        _, lsum, acc = _fold(parts)
        out[b] = acc / lsum[..., None]
    return out


def test_empty_partial_folds_in_as_identity():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((2, 3, 16), (2, 9, 16), (2, 9, 16)))
    one = _partial(q, k, v)
    empty = _partial(q, k[:, :0], v[:, :0])
    for parts in ([one, empty], [empty, one], [empty, one, empty]):
        folded = _fold(parts)
        for got, want in zip(folded, one):
            assert torch.equal(got, want)


@pytest.mark.parametrize("S", WINDOWS)
def test_split_mirror_matches_jax_ref_and_pallas(S):
    """Per-lane fill levels on both sides of every split boundary (B =
    len of them) against the JAX ref; the scalar-t Pallas kernel in
    interpret mode on a few of them."""
    ts = _boundaries(S)
    B, KV, G, hd = len(ts), 2, 3, 16
    rng = np.random.default_rng(S)
    qn = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    vn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    t = np.asarray(ts, np.int32)
    got = _split_mirror(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                        torch.from_numpy(t)).numpy()
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    n = split_plan(S)
    per = -(-S // n)
    for b, tb in enumerate(ts):
        if tb not in (0, per - 1, per, S + 5):
            continue
        pallas = np.asarray(decode_attention_kernel(
            jnp.asarray(qn[b:b + 1]), jnp.asarray(kn[b:b + 1]),
            jnp.asarray(vn[b:b + 1]), tb, block_kv=min(128, S),
            interpret=True))
        np.testing.assert_allclose(got[b:b + 1], pallas, atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("G,hd,fits", [(3, 64, True), (16, 128, True),
                                       (2, 256, True), (8, 256, True),
                                       (16, 256, False)])
def test_block_shared_memory_fit_rule(G, hd, fits):
    """The wrapper's shared-memory rule for a K1/K2 block at the widest
    split and a 512-slot window of page 16 (32 table entries): the served
    groups (smollm-360m G 3 at hd 64, gemma3-4b-edge G 2 at hd 256) and
    up to 8 query heads a KV head at hd 256 fit; 16 at hd 256 (a lane
    holds two chunks of a row only up to a group of 8) is refused with a
    message before any launch."""
    if fits:
        assert decode_smem_bytes(G, hd, MAX_SPLITS, 32) <= MAX_SMEM_BYTES
        check_fits(G, hd, MAX_SPLITS, 32)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            check_fits(G, hd, MAX_SPLITS, 32)
