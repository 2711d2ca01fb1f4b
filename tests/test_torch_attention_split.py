"""K3's key split at head widths 128 and 256, held on the CPU.

The bf16 wgmma kernel (csrc/flash_attention.cu) cuts each query row's keys
into partials of ``KEY_CHUNK`` keys by absolute key index, walks each
chunk from a fresh (max, sum, accumulator) and folds the partials in
chunk order, whether one block walked them all or a thread-block cluster
of ``flash_launch_plan`` blocks walked one each.  Here:

* the plan (``key_chunks``) depends on absolute key indices only, and the
  split never hands a block more than one chunk;
* a plain float32 emulation of chunked partials with the fixed-order fold
  equals ``flash_attention_plain`` within 1e-6 of max|v| (the lse within
  1e-6 of max|lse|): an output row is a weighted mean of up to a
  thousand value rows, and its float32 rounding is absolute, on the
  scale of the values, not of the mean (the plain version's own distance
  from a float64 run is up to 1.4e-6 on these inputs, max|v| ~4.5); and
  the JAX
  package's attention (``repro.kernels.ref.flash_attention_ref`` at Sq ==
  Skv, the JAX model's ``flash_attention`` for extend and cross lengths)
  within 2e-5, the tolerance of tests/test_torch_kernels.py;
* through that emulation, extend rows equal cold-prefill rows bit for bit
  at hd 128 and 256 (each row's arithmetic reads its own position's
  chunks only);
* K1/K2's split plan is unchanged at those widths: K2's window is split
  as K1 splits a ring of the same length.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import split_plan, split_ranges
from repro_torch.kernels.flash_attention import (KEY_CHUNK, MAX_SPLITS,
                                                 flash_attention_plain,
                                                 flash_launch_plan, key_chunks)

#: (H, KV, hd): jamba-v0.1-52b's, llama-3.2-vision-90b's, gemma3-4b-edge's
#: heads, narrowed to a few heads a group for the CPU
WIDE = [(8, 2, 128), (16, 2, 128), (4, 2, 256)]


def _fold(parts):
    """Partials (m, l, acc) folded in chunk order: max, and the sums
    rescaled to it."""
    m, l, acc = parts[0]
    for mp, lp, ap in parts[1:]:
        mx = torch.maximum(m, mp)
        a, b = torch.exp(m - mx), torch.exp(mp - mx)
        m, l, acc = mx, l * a + lp * b, acc * a[..., None] + ap * b[..., None]
    return m, l, acc


def _chunked(q, k, v, *, causal=True, q_offset=0):
    """K3 by its key split in float32, model layout: q (B, Sq, H, hd),
    k/v (B, Skv, KV, hd) -> (o, lse).  Each row attends its keys (causal:
    positions <= its own) in the chunks of ``key_chunks``, a partial per
    chunk from its own keys only, folded in chunk order."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # (B, KV, Skv, hd)
    o = torch.empty(B, Sq, H, hd)
    lse = torch.empty(B, H, Sq)
    for i in range(Sq):
        end = q_offset + i + 1 if causal else Skv
        qi = q[:, i].reshape(B, KV, G, hd)
        parts = []
        for _, lo, hi in key_chunks(0, end):
            kc, vc = kh[:, :, lo:hi].contiguous(), vh[:, :, lo:hi].contiguous()
            s = torch.einsum("bkgd,bksd->bkgs", qi, kc) * hd ** -0.5
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("bkgs,bksd->bkgd", p,
                                                     vc)))
        m, l, acc = _fold(parts)
        o[:, i] = (acc / l[..., None]).reshape(B, H, hd)
        lse[:, :, i] = (m + torch.log(l)).reshape(B, H)
    return o, lse


def _close_scaled(got, want, scale):
    """|got - want| <= 1e-6 * scale everywhere."""
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(scale))


def _inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((B, Sq, H, hd), (B, Skv, KV, hd),
                            (B, Skv, KV, hd)))


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 256), (0, 257), (100, 900),
                                   (255, 256), (256, 1024), (511, 513)])
def test_key_chunks_follow_absolute_key_indices(lo, hi):
    """Every key of [lo, hi) lies in exactly one chunk, chunk key //
    KEY_CHUNK; the chunks are contiguous, in order, and a chunk's bounds
    do not depend on where the range starts or ends."""
    chunks = key_chunks(lo, hi)
    covered = [key for _, a, b in chunks for key in range(a, b)]
    assert covered == list(range(lo, hi))
    for c, a, b in chunks:
        assert all(key // KEY_CHUNK == c for key in range(a, b))
    whole = {c: (a, b) for c, a, b in key_chunks(0, 4096)}
    for c, a, b in chunks:
        assert whole[c][0] <= a < b <= whole[c][1]


@pytest.mark.parametrize("B,Sq,Skv,q_offset,causal", [
    (1, 512, 512, 0, True), (1, 32, 32, 0, True), (1, 1, 1024, 0, False),
    (1, 45, 1024, 0, False), (1, 16, 3000, 0, False), (1, 64, 700, 600, True),
    (2, 300, 300, 0, True), (1, 2100, 2100, 0, True),
    (1, 48, 2048, 2000, True), (4, 512, 512, 0, True)])
@pytest.mark.parametrize("H,KV,hd", [(8, 4, 256), (32, 8, 128), (64, 8, 128),
                                     (8, 8, 128)])
def test_split_gives_each_block_one_chunk_at_most(B, Sq, Skv, q_offset,
                                                  causal, H, KV, hd):
    """A split plan of n > 1 blocks covers the chunks of every row tile's
    keys with one chunk a block (the longest tile needs exactly n) and
    keeps the split grid within the card's 132 SMs (two 64-row blocks an
    SM at hd 128); otherwise (one chunk, more than MAX_SPLITS, or a grid
    that fills the card) the plan is 1 block.  hd 128 takes 128-row
    blocks once 64-row ones would outnumber the SMs."""
    rows, n = flash_launch_plan(B, Sq, Skv, H, KV, hd, q_offset, causal)
    G = H // KV
    assert rows == (128 if hd == 128 and -(-G * Sq // 64) * KV * B > 132
                    else 64)
    tiles = -(-G * Sq // rows)
    keys = [min(Skv, q_offset + (min((t + 1) * rows, G * Sq) - 1) // G + 1)
            if causal else Skv for t in range(tiles)]
    most = max(len(key_chunks(0, n_keys)) for n_keys in keys)
    per_sm = 2 if rows == 64 and hd == 128 else 1
    fits = tiles * KV * B * most <= per_sm * 132
    assert n == (most if 2 <= most <= MAX_SPLITS and fits else 1)


@pytest.mark.parametrize("S,causal", [(300, True), (600, False), (64, True),
                                      (520, True)])
@pytest.mark.parametrize("H,KV,hd", WIDE)
def test_chunked_emulation_matches_plain_and_jax(S, causal, H, KV, hd):
    """The chunked fold == the one-pass softmax (``flash_attention_plain``
    and its lse) within 1e-6 of max|v| in float32, and == the JAX
    package's ``flash_attention_ref`` within 2e-5, across chunk
    boundaries."""
    qn, kn, vn = _inputs(S + hd, 1, S, S, H, KV, hd)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    o, lse = _chunked(q, k, v, causal=causal)
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    _close_scaled(o, want, v.abs().max())
    _close_scaled(lse, want_lse, want_lse.abs().max())
    jax_o = jref.flash_attention_ref(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (qn, kn, vn)),
        causal=causal)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jax_o).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Sq,Skv,q_offset,causal", [
    (16, 340, 300, True), (45, 1024, 0, False), (1, 1024, 0, False),
    (100, 700, 550, True)])
@pytest.mark.parametrize("H,KV,hd", WIDE)
def test_chunked_emulation_matches_jax_at_extend_and_cross_lengths(
        Sq, Skv, q_offset, causal, H, KV, hd):
    """Extend (q_offset over a longer buffer) and cross (non-causal Sq
    over Skv) lengths: the chunked fold == ``flash_attention_plain``
    within 1e-6 of max|v| and == the JAX model's ``flash_attention``
    within 2e-5."""
    qn, kn, vn = _inputs(Sq + Skv + hd, 1, Sq, Skv, H, KV, hd)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    o, _ = _chunked(q, k, v, causal=causal, q_offset=q_offset)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    _close_scaled(o, want, v.abs().max())
    jax_o = jax_flash(*(jnp.asarray(x) for x in (qn, kn, vn)),
                      causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("prefix,suffix", [(48, 16), (250, 12), (256, 40),
                                           (300, 300)])
@pytest.mark.parametrize("H,KV,hd", WIDE)
def test_chunked_extend_rows_equal_cold_rows_bitwise(prefix, suffix, H, KV,
                                                     hd):
    """Through the chunked fold, the rows of an extend call (the suffix at
    q_offset = prefix over a padded key buffer) equal those rows of the
    cold prefill of prefix + suffix bit for bit, output and lse."""
    n = prefix + suffix
    qn, kn, vn = _inputs(n + hd, 1, n, n + 24, H, KV, hd)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    ext, ext_lse = _chunked(q[:, prefix:], k, v, q_offset=prefix)
    cold, cold_lse = _chunked(q, k[:, :n], v[:, :n])
    assert torch.equal(ext, cold[:, prefix:])
    assert torch.equal(ext_lse, cold_lse[:, :, prefix:])


@pytest.mark.parametrize("page,P", [(16, 32), (8, 64), (32, 4), (16, 9)])
def test_paged_window_splits_as_the_ring(page, P):
    """K2 (``paged_decode_attention_cuda``) splits a window of P * page
    slots with K1's plan for a ring of that length, at every fill level
    on both sides of the split edges, and a lane's ranges do not depend
    on the other lanes."""
    S = P * page
    levels = sorted({0, 1, 63, 64, 65, S - 1, S, S + 7}
                    | {r * -(-S // split_plan(S)) + d
                       for r in range(1, split_plan(S)) for d in (-1, 0, 1)})
    t = torch.tensor(levels)
    batch = split_ranges(t, S)
    for i, level in enumerate(levels):
        assert torch.equal(batch[i], split_ranges(torch.tensor([level]),
                                                  S)[0])
    assert batch.shape[1] == split_plan(S)
