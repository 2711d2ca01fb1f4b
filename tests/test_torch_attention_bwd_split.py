"""K3b's split walk at head widths 64, 128 and 256, and K3's body at
head width 64, held on the CPU.

The bf16 K3b kernel (csrc/flash_attention_bwd.cu) computes dK and dV of a
key tile (128 keys at hd 64 and 128, 64 at hd 256) by walking the (query head, query row) pairs that see the
tile.  It cuts that walk into partials by absolute query index (chunk c
= query rows [c * chunk, (c + 1) * chunk), ``chunk = query_chunk(Sq, G,
causal)``, a function of the model's shape alone),
walks each chunk from zero on its own block of a thread-block cluster and
adds the partials in chunk order.  dQ is one walk over the key tiles from
key 0 per 64 stacked rows.  Here:

* the plan (``flash_bwd_launch_plan``, ``flash_bwd_walk``): every (query
  head, query row) that can see a key tile is walked by exactly one rank,
  a rank walks rows of its own chunk only, a cluster never exceeds the
  portable size and fits the card, and a chunk's rows depend on absolute
  query indices only;
* a plain float32 emulation of the split walk, its fixed-order fold and
  the dQ walk equals ``flash_attention_bwd_plain`` within 1e-6 of
  max|grad| and ``jax.vjp`` of the JAX package's chunked flash attention
  (``repro.models.attention.flash_attention``, nested remat) within
  2e-5, at small causal, cross and hd-256 shapes;
* its bits do not depend on the split: the partials computed by the
  ranks in any order and added in chunk order equal one walker's running
  sum over the chunks bit for bit;
* K3's wgmma body at head width 64 is chosen by (hd, G) alone (G 1), its
  launch plan follows K3's rule, and its chunked fold equals the plain
  version and JAX's at musicgen-large's ungrouped heads, extend rows
  equal to cold rows bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels.flash_attention import (KEY_CHUNK,
                                                 flash_attention_plain,
                                                 flash_launch_plan,
                                                 wgmma_body)
from repro_torch.kernels.flash_attention_bwd import (
    CHUNK_STEPS, MAX_SPLITS, TILE, WGMMA_HEAD_DIMS, bwd_tile_keys,
    flash_attention_bwd_plain, flash_bwd_launch_plan, flash_bwd_walk,
    query_chunk)
from test_torch_attention_split import _chunked

#: (B, Sq, Skv, H, KV, hd, causal): the trained stacks' K3b shapes
#: (vision's cross-attention and self-attention, gemma3's hd 256,
#: musicgen's and smollm's hd 64) and ragged, short and long ones
PLAN_SHAPES = [(2, 512, 1024, 64, 8, 128, False), (2, 512, 512, 64, 8, 128,
                                                   True),
               (4, 512, 512, 8, 4, 256, True), (2, 45, 1000, 64, 8, 128,
                                                False),
               (2, 1000, 1000, 15, 5, 128, True), (1, 16, 16, 8, 4, 256, True),
               (2, 100, 64, 4, 2, 256, False), (1, 2100, 2100, 8, 4, 256,
                                                True),
               (1, 1025, 1025, 2, 1, 128, True), (3, 300, 300, 6, 3, 128,
                                                  True),
               (4, 512, 512, 32, 32, 64, True), (8, 512, 512, 15, 5, 64, True),
               (2, 1000, 1000, 15, 5, 64, True)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", PLAN_SHAPES)
def test_split_walks_every_visible_row_once(B, Sq, Skv, H, KV, hd, causal):
    """For every key tile, the ranks' walks cover each (query head, query
    row) that can see the tile (causal: rows at or after its first key)
    exactly once, each rank inside its own chunk and in the kernel's
    order (head by head, rows ascending); ranks below the tile's first
    chunk walk nothing, and the active blocks are those that walk."""
    plan = flash_bwd_launch_plan(B, Sq, Skv, H, KV, hd, causal)
    G, chunk, n, keys = H // KV, plan["chunk"], plan["split"], plan["keys"]
    assert chunk == query_chunk(Sq, G, causal) and n == -(-Sq // chunk)
    assert keys == (64 if hd == 256 else 128)
    assert plan["dkdv_grid"] == (n * KV, B, -(-Skv // keys))
    walking = 0
    for kt in range(plan["dkdv_grid"][2]):
        k0 = kt * keys
        seen = []
        for rank in range(n):
            steps = flash_bwd_walk(kt, rank, Sq, G, causal, keys)
            walking += bool(steps)
            assert steps == sorted(steps)
            rows = [(g, q0 + i) for g, q0 in steps for i in range(TILE)
                    if q0 + i < Sq]
            assert all(rank * chunk <= r < (rank + 1) * chunk
                       for _, r in rows)
            if causal and rank < k0 // chunk:
                assert steps == []
            seen += rows
        want = [(g, r) for g in range(G)
                for r in range(k0 if causal else 0, Sq)]
        assert sorted(seen) == want
    assert walking * KV * B == plan["dkdv_active"]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", PLAN_SHAPES)
def test_split_cluster_fits_the_card(B, Sq, Skv, H, KV, hd, causal):
    """A key tile's cluster has one block a chunk, at most MAX_SPLITS (the
    portable cluster size) whatever Sq, so it fits the card's 132 SMs at
    one pass-2 block an SM.  A chunk is a whole number of 64-row steps:
    about CHUNK_STEPS of the G heads when causal, four times that at full
    attention, widened only where Sq would take more than MAX_SPLITS.
    Pass 3 has one 64-row block per (KV head, batch row, stacked row
    tile), two an SM at hd 64 and 128."""
    plan = flash_bwd_launch_plan(B, Sq, Skv, H, KV, hd, causal)
    G = H // KV
    assert 1 <= plan["split"] <= MAX_SPLITS <= 132
    assert plan["chunk"] % TILE == 0
    steps = CHUNK_STEPS if causal else 4 * CHUNK_STEPS
    base = TILE * -(-steps // G)
    if Sq <= MAX_SPLITS * base:
        assert plan["chunk"] == base
    else:
        assert (plan["split"] - 1) * plan["chunk"] < Sq <= \
            plan["split"] * plan["chunk"]
    assert plan["dq_grid"] == (KV * B, -(-G * Sq // TILE))
    assert plan["dq_blocks_per_sm"] == (1 if hd == 256 else 2)
    assert hd in WGMMA_HEAD_DIMS
    with pytest.raises(ValueError, match="head widths"):
        flash_bwd_launch_plan(B, Sq, Skv, H, KV, 32, causal)


@pytest.mark.parametrize("Sq,G,causal,chunk,split", [
    (512, 8, True, 256, 2), (512, 8, False, 1024, 1), (512, 2, True, 1024, 1),
    (1000, 3, True, 704, 2), (2100, 8, True, 320, 7), (4096, 8, True, 512, 8),
    (512, 1, True, 2048, 1), (100, 8, True, 256, 1)])
def test_chunk_rule_at_the_trained_shapes(Sq, G, causal, chunk, split):
    """The chunk rule at the shapes the port trains and checks:
    llama-3.2-vision-90b's self-attention (G 8, causal) splits S 512 in
    two, its cross-attention (full) and gemma3-4b-edge (G 2) walk whole;
    a long Sq keeps at most MAX_SPLITS chunks."""
    assert query_chunk(Sq, G, causal) == chunk
    assert -(-Sq // chunk) == split


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_split_depends_on_absolute_query_chunks_only(causal, G):
    """A chunk's rows do not depend on Sq (up to MAX_SPLITS chunks): rank
    r's walk at a shorter Sq is its walk at a longer one cut to the
    shorter one's query tiles, and a key tile's walk does not depend on
    the batch, the KV heads or Skv (the walk's arguments are the key
    tile, the rank, Sq, G, causal and the tile's keys only)."""
    base = query_chunk(1, G, causal)
    for short, long_ in ((100, 1000), (300, 512), (129, 1024), (64, 65)):
        if long_ > MAX_SPLITS * base:
            continue
        assert query_chunk(short, G, causal) == \
            query_chunk(long_, G, causal) == base
        n_tiles = -(-short // TILE)
        for keys in (TILE, 2 * TILE):
            for kt in range(-(-short // keys)):
                for rank in range(-(-short // base)):
                    a = flash_bwd_walk(kt, rank, short, G, causal, keys)
                    b = [(g, q0) for g, q0 in flash_bwd_walk(
                        kt, rank, long_, G, causal, keys)
                         if q0 < n_tiles * TILE]
                    assert a == b


def _inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((B, Sq, H, hd), (B, Skv, KV, hd),
                            (B, Skv, KV, hd), (B, Sq, H, hd)))


def _chunk_partial(kt, rank, q, k, v, do, lse, D, causal):
    """One rank's pass-2 partial of key tile kt in float32: (dV, dK
    before the scale) of the tile's keys over its walk's steps, in the
    kernel's order; None for a rank that walks nothing."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    nk = bwd_tile_keys(hd)
    steps = flash_bwd_walk(kt, rank, Sq, G, causal, nk)
    if not steps:
        return None
    k0 = kt * nk
    keys = torch.arange(k0, k0 + nk)
    kt_ = torch.zeros(B, nk, KV, hd)
    vt_ = torch.zeros(B, nk, KV, hd)
    n = min(nk, Skv - k0)
    kt_[:, :n], vt_[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
    dv = torch.zeros(B, KV, nk, hd)
    dk = torch.zeros(B, KV, nk, hd)
    scale = hd ** -0.5
    for g, q0 in steps:
        rows = torch.arange(q0, q0 + TILE)
        live = rows < Sq
        m = min(TILE, Sq - q0)
        qs = torch.zeros(B, TILE, KV, hd)
        dos = torch.zeros(B, TILE, KV, hd)
        heads = torch.arange(KV) * G + g
        qs[:, :m] = q[:, q0:q0 + m][:, :, heads]
        dos[:, :m] = do[:, q0:q0 + m][:, :, heads]
        ls = torch.zeros(B, KV, TILE)
        ds_ = torch.zeros(B, KV, TILE)
        ls[..., :m] = lse[:, heads, q0:q0 + m]
        ds_[..., :m] = D[:, heads, q0:q0 + m]
        st = torch.einsum("bkhd,bqhd->bhkq", kt_, qs)        # S^T
        dpt = torch.einsum("bkhd,bqhd->bhkq", vt_, dos)      # dP^T
        p = torch.exp(st * scale - ls[:, :, None, :])
        ok = (keys[:, None] < Skv) & live[None, :]
        if causal:
            ok &= keys[:, None] <= rows[None, :]
        p = torch.where(ok, p, torch.zeros(()))
        dst = p * (dpt - ds_[:, :, None, :])
        dv += torch.einsum("bhkq,bqhd->bhkd", p, dos)
        dk += torch.einsum("bhkq,bqhd->bhkd", dst, qs)
    return dv, dk


def _split_bwd(q, k, v, o, do, lse, causal, order=None, walker=False):
    """K3b by its plan in float32, model layout -> (dq, dk, dv).  Pass 2:
    each key tile's partials, one a chunk, computed in the rank order
    ``order`` (a permutation of the ranks; None: ascending) and added in
    chunk order -- or, with ``walker``, by one walker that adds each
    chunk to its running sum as soon as it is done; pass 3: each query
    row's dQ over the key tiles from key 0 in order."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    D = (do * o).sum(-1).permute(0, 2, 1)                   # (B, H, Sq)
    n = -(-Sq // query_chunk(Sq, G, causal))
    dk = torch.zeros(B, Skv, KV, hd)
    dv = torch.zeros(B, Skv, KV, hd)
    nk = bwd_tile_keys(hd)
    for kt in range(-(-Skv // nk)):
        if walker:
            sv = sk = None
            for r in range(n):
                part = _chunk_partial(kt, r, q, k, v, do, lse, D, causal)
                if part is None:
                    continue
                sv, sk = part if sv is None else (sv + part[0],
                                                  sk + part[1])
        else:
            ranks = list(range(n)) if order is None else list(order)
            parts = {r: _chunk_partial(kt, r, q, k, v, do, lse, D, causal)
                     for r in ranks}
            live = [parts[r] for r in range(n) if parts[r] is not None]
            sv, sk = live[0]
            for pv, pk in live[1:]:
                sv, sk = sv + pv, sk + pk
        k0 = kt * nk
        m = min(nk, Skv - k0)
        dv[:, k0:k0 + m] = sv[:, :, :m].permute(0, 2, 1, 3)
        dk[:, k0:k0 + m] = (sk[:, :, :m] * scale).permute(0, 2, 1, 3)
    dq = torch.zeros(B, Sq, H, hd)
    for h in range(H):
        kh, vh = k[:, :, h // G], v[:, :, h // G]
        acc = torch.zeros(B, Sq, hd)
        for kt in range(-(-Skv // TILE)):
            k0 = kt * TILE
            kc, vc = kh[:, k0:k0 + TILE], vh[:, k0:k0 + TILE]
            s = torch.einsum("bqd,bkd->bqk", q[:, :, h], kc) * scale
            p = torch.exp(s - lse[:, h, :, None])
            if causal:
                keys = torch.arange(k0, k0 + kc.shape[1])
                p = torch.where(keys[None, :] <= torch.arange(Sq)[:, None],
                                p, torch.zeros(()))
            dp = torch.einsum("bqd,bkd->bqk", do[:, :, h], vc)
            ds = p * (dp - D[:, h, :, None])
            acc = acc + torch.einsum("bqk,bkd->bqd", ds, kc)
        dq[:, :, h] = acc * scale
    return dq, dk, dv


#: (B, Sq, Skv, H, KV, hd, causal): causal, cross (full, Sq != Skv, a
#: ragged Sq), hd 256 and hd 64, narrowed for the CPU; the first three
#: take 2 chunks
EMU_SHAPES = [(1, 300, 300, 8, 1, 128, True), (1, 1100, 130, 8, 1, 128, False),
              (1, 260, 260, 8, 1, 256, True), (2, 45, 200, 4, 2, 128, False),
              (1, 300, 300, 8, 1, 64, True), (2, 200, 200, 3, 1, 64, True)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", EMU_SHAPES)
def test_split_emulation_matches_plain_and_jax(B, Sq, Skv, H, KV, hd,
                                               causal):
    """The split walk with its chunk-order fold == the plain recurrence
    (``flash_attention_bwd_plain``) within 1e-6 of max|grad| in float32,
    and == ``jax.vjp`` of the JAX package's chunked flash attention
    within 2e-5."""
    qn, kn, vn, don = _inputs(Sq * 7 + Skv + hd, B, Sq, Skv, H, KV, hd)
    q, k, v, do = map(torch.from_numpy, (qn, kn, vn, don))
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = _split_bwd(q, k, v, o, do, lse, causal)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                               q_chunk=32, kv_chunk=64),
                     *map(jnp.asarray, (qn, kn, vn)))
    for a, w in zip(got, vjp(jnp.asarray(don))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", EMU_SHAPES[:3])
def test_split_emulation_bits_do_not_depend_on_the_split(B, Sq, Skv, H, KV,
                                                         hd, causal):
    """Whichever rank computes a partial, and when, the bits are the same:
    partials computed by the ranks in any order and added in chunk order
    equal one walker's running sum over the chunks, bit for bit (each
    partial starts from zero and the sums run in chunk order)."""
    qn, kn, vn, don = _inputs(Sq + Skv, B, Sq, Skv, H, KV, hd)
    q, k, v, do = map(torch.from_numpy, (qn, kn, vn, don))
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    n = flash_bwd_launch_plan(B, Sq, Skv, H, KV, hd, causal)["split"]
    assert n >= 2
    base = _split_bwd(q, k, v, o, do, lse, causal, walker=True)
    for order in itertools.islice(itertools.permutations(range(n)), 0, 4):
        for a, b in zip(base, _split_bwd(q, k, v, o, do, lse, causal,
                                         order)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("hd,G,want", [(64, 1, True), (64, 3, False),
                                       (64, 2, False), (128, 1, True),
                                       (128, 8, True), (256, 2, True),
                                       (32, 1, False), (16, 1, False)])
def test_k3_body_is_chosen_by_head_width_and_group(hd, G, want):
    """bf16 K3 takes the wgmma body at head widths 128 and 256 and at 64
    over ungrouped heads (G 1, musicgen-large); smollm's G 3 keeps its
    mma.sync body.  The rule's only arguments are (hd, G): no length, no
    batch, no q_offset can move a call from one body to the other."""
    assert wgmma_body(hd, G) is want
    assert k3.WGMMA_HEAD_DIMS == (128, 256)


@pytest.mark.parametrize("B,Sq,Skv,q_offset,causal,want", [
    (1, 512, 512, 0, True, (64, 1)), (1, 32, 32, 0, True, (64, 1)),
    (1, 45, 1024, 0, False, (64, 4)), (4, 512, 512, 0, True, (64, 1)),
    (1, 16, 600, 584, True, (64, 3)), (1, 2100, 2100, 0, True, (64, 1))])
def test_k3_hd64_plan_at_ungrouped_heads(B, Sq, Skv, q_offset, causal, want):
    """K3's plan at musicgen-large's heads (32 over 32, hd 64): 64-row
    blocks, two an SM, one consumer warpgroup; a row tile's keys split
    over a cluster of one block a KEY_CHUNK when they take 2..8 chunks
    and the split grid runs at once, else one block walks them all."""
    rows, n = flash_launch_plan(B, Sq, Skv, 32, 32, 64, q_offset, causal)
    assert (rows, n) == want
    blocks = -(-Sq // rows) * 32 * B
    chunks = -(-(q_offset + Sq if causal else Skv) // KEY_CHUNK)
    assert n == (chunks if 2 <= chunks <= 8 and blocks * chunks <= 2 * 132
                 else 1)


@pytest.mark.parametrize("S,causal", [(300, True), (520, False), (64, True)])
def test_k3_chunked_emulation_at_ungrouped_heads(S, causal):
    """K3's chunked fold at G 1, hd 64 == ``flash_attention_plain`` within
    1e-6 of max|v| (the lse within 1e-6 of max|lse|) and == the JAX
    model's ``flash_attention`` within 2e-5."""
    qn, kn, vn, _ = _inputs(S, 1, S, S, 4, 4, 64)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    o, lse = _chunked(q, k, v, causal=causal)
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(v.abs().max()))
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                               atol=1e-6 * float(want_lse.abs().max()))
    jax_o = jax_flash(*map(jnp.asarray, (qn, kn, vn)), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("prefix,suffix", [(48, 16), (250, 12), (300, 300)])
def test_k3_extend_equals_cold_at_ungrouped_heads(prefix, suffix):
    """Through the chunked fold at G 1, hd 64, the rows of an extend call
    equal those rows of the cold prefill bit for bit, output and lse."""
    n = prefix + suffix
    qn, kn, vn, _ = _inputs(n, 1, n, n + 24, 4, 4, 64)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    ext, ext_lse = _chunked(q[:, prefix:], k, v, q_offset=prefix)
    cold, cold_lse = _chunked(q, k[:, :n], v[:, :n])
    assert torch.equal(ext, cold[:, prefix:])
    assert torch.equal(ext_lse, cold_lse[:, :, prefix:])
