"""The fold at the end of K1/K2's decode body (csrc/decode_tile.cuh's
``block_fold``), held on the CPU.

The body folds its warps' (or warp pairs') partials into the block's,
then the blocks' partials of a cluster into the output.  Since the
wide-group redesign it takes the weights exp(m_p - max m) once per
(partial, head), skips the warp partials that held no slot, and spreads
the cluster's fold over the ranks by column: rank j folds columns
[j hd / n, (j + 1) hd / n) of every block's accumulator.  A float32
mirror of that order is held here bit for bit (``torch.equal``) to the
order before it -- every warp partial folded over whole rows, then rank 0
folding every block, ``_fold`` of tests/test_torch_decode_split.py -- on
the split plan's boundaries.  The card kernel keeps the same promise:
its output did not change by a bit.

The block's shared memory (``decode_smem_bytes``) is held to the
``Smem`` struct of the source and the arrays after it, and the wrapper's
refusals (``check_fits``) to those of the layout before the redesign.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels._build import CSRC
from repro_torch.kernels.decode_attention import (MAX_SMEM_BYTES,
                                                  SLOTS_PER_SPLIT, check_fits,
                                                  decode_smem_bytes,
                                                  split_plan, split_ranges)
from test_torch_decode_split import NEG_INF, _boundaries, _fold, _partial

#: (G, hd, partials a block, slots a partial takes a step, whether the
#: partials that held no slot are skipped): the tensor-core body's 4 warp
#: pairs of 16-slot tiles (gemma-2b's and llama4-maverick's groups), which
#: skips them, and the lane body's 8 warps of 4 slot rows (smollm-360m's
#: group at hd 64 in bf16), which folds all eight
BODIES = [(8, 256, 4, 16, True), (5, 128, 4, 16, True),
          (3, 64, 8, 4, False)]


def _warp_partials(q, k, v, lo, hi, nw, unit):
    """A block's partials over [lo, hi): steps of ``unit`` slots dealt
    round robin over its ``nw`` warps (pairs), and how many of them
    held a slot (the kernel's ``nw``: a prefix of the warps)."""
    slots = [[] for _ in range(nw)]
    for s in range(lo, hi):
        slots[(s - lo) // unit % nw].append(s)
    n_live = min(nw, -(-(hi - lo) // unit))
    assert all(slots[w] for w in range(n_live))
    assert not any(slots[w] for w in range(n_live, nw))
    parts = [_partial(q, k[:, idx], v[:, idx])
             for idx in (torch.tensor(s, dtype=torch.long) for s in slots)]
    return parts, n_live


def _weights(ms, like):
    """The common max and exp(m - max) of each partial, once per
    (partial, head); ``like`` is a (KV, G) tensor."""
    mx = torch.full_like(like, NEG_INF)
    for m in ms:
        mx = torch.maximum(mx, m)
    return mx, [torch.exp(m - mx) for m in ms]


def _lsum(ls, es, like):
    lsum = torch.zeros_like(like)
    for l, e in zip(ls, es):
        lsum = lsum + l * e
    return lsum


def _cols(accs, es, sl, like):
    """Columns ``sl`` of the partials' accumulators folded in order;
    ``like`` is a (KV, G, hd) tensor."""
    acc = torch.zeros_like(like[..., sl])
    for a, e in zip(accs, es):
        acc = acc + a[..., sl] * e[..., None]
    return acc


def _out(acc, lsum):
    return acc / torch.clamp(lsum, min=1e-30)[..., None]


def _lane_new(q, k, v, t, nw, unit, skip):
    """One lane in the new order: each block's warp weights once over its
    live warps (all of them unless ``skip``), each rank's columns of every
    block folded in rank order with the cluster weights taken once."""
    S, hd = k.shape[1], q.shape[-1]
    ranges = split_ranges(t, S).tolist()
    live = min(S, t + 1)
    ml = q[..., 0]
    blocks = []
    for lo, hi in ranges:
        parts, n_live = _warp_partials(q, k, v, lo, hi, nw, unit)
        parts = parts[:n_live] if skip else parts
        mx, es = _weights([p[0] for p in parts], ml)
        blocks.append((mx, _lsum([p[1] for p in parts], es, ml),
                       [p[2] for p in parts], es))
    if live <= SLOTS_PER_SPLIT:                     # rank 0 alone
        _, lsum, accs, es = blocks[0]
        return _out(_cols(accs, es, slice(None), q), lsum)
    n = len(ranges)
    cols = hd // n
    out = torch.empty_like(q)
    _, ce = _weights([b[0] for b in blocks], ml)
    lsum = _lsum([b[1] for b in blocks], ce, ml)
    for j in range(n):                              # rank j's columns
        sl = slice(j * cols, (j + 1) * cols)
        pushed = [_cols(accs, es, sl, q) for _, _, accs, es in blocks]
        out[..., sl] = _out(_cols(pushed, ce, slice(None), q[..., sl]),
                            lsum)
    return out


def _lane_old(q, k, v, t, nw, unit):
    """One lane in the order before: every warp partial (empty ones too)
    folded over whole rows, then rank 0 folding every block's."""
    S = k.shape[1]
    blocks = [_fold(_warp_partials(q, k, v, lo, hi, nw, unit)[0])
              for lo, hi in split_ranges(t, S).tolist()]
    if min(S, t + 1) <= SLOTS_PER_SPLIT:
        _, lsum, acc = blocks[0]
    else:
        _, lsum, acc = _fold(blocks)
    return _out(acc, lsum)


@pytest.mark.parametrize("S", [128, 512])
@pytest.mark.parametrize("G,hd,nw,unit,skip", BODIES)
def test_new_fold_order_equals_the_whole_row_fold_bitwise(G, hd, nw, unit,
                                                          skip, S):
    """Fill levels on both sides of every split boundary, the empty ring,
    wrapped rings: weights once per (partial, head), empty warp pairs
    skipped (the tensor-core body) and each rank's column slice give the
    whole-row fold's bits."""
    KV = 2
    rng = np.random.default_rng(G * 1000 + hd + S)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((KV, G, hd), (KV, S, hd), (KV, S, hd)))
    for t in _boundaries(S):
        new = _lane_new(q, k, v, t, nw, unit, skip)
        assert torch.equal(new, _lane_old(q, k, v, t, nw, unit)), t
        assert bool(torch.isfinite(new).all())


def _source_constants():
    src = (CSRC / "decode_tile.cuh").read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"struct Smem \{(.*?)\};", src, re.S).group(1)
    arrays = [re.findall(r"\[(\w+)\]", a)
              for decl in re.findall(r"float ([^;]*);", body)
              for a in decl.split(",")]
    return consts, arrays


def _smem_from_source(gm, hd, n_split, P):
    """``smem_bytes`` of the source: the ``Smem`` struct's float arrays
    at GM, then the warps' accumulators (kWarps x GM x hd), the columns a
    rank folds in a cluster (n_split x GM x hd / n_split) and K2's table
    row."""
    consts, arrays = _source_constants()
    dims = dict(consts, GM=gm)
    struct = sum(int(np.prod([dims[d] for d in a])) for a in arrays)
    accs = consts["kWarps"] * gm * hd + (gm * hd if n_split > 1 else 0)
    return 4 * (struct + accs) + 4 * P


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 8, 9, 16])
def test_smem_bytes_follow_the_source_layout(G, n_split):
    gm = G if G <= 4 else 8 if G <= 8 else 16
    for hd in (8, 64, 128, 256):
        for P in (0, 32):
            assert decode_smem_bytes(G, hd, n_split, P) == \
                _smem_from_source(gm, hd, n_split, P)


def _parent_smem_bytes(G, hd, n_split, P):
    """The layout before the redesign: (m, l) of kWarps warps and of
    kMaxSplits ranks, the warps' accumulators and n_split whole blocks'
    in rank 0."""
    gm = G if G <= 4 else 8 if G <= 8 else 16
    return 4 * (2 * 16 * gm + (8 + n_split) * gm * hd) + 4 * P


def test_check_fits_refuses_what_it_refused_before():
    """Every group the wrapper takes (1-16) at every head width, split
    and a K2 table of 0, 32 or 512 pages: refused now exactly where the
    layout before refused (more than 8 query heads past hd 128)."""
    for G in range(1, 17):
        for hd in range(8, 257, 8):
            for n_split in (1, 2, 4, 8):
                for P in (0, 32, 512):
                    before = (_parent_smem_bytes(G, hd, n_split, P)
                              > MAX_SMEM_BYTES or (hd > 128 and G > 8))
                    try:
                        check_fits(G, hd, n_split, P)
                        refused = False
                    except ValueError as e:
                        assert "shared memory" in str(e)
                        refused = True
                    assert refused == before, (G, hd, n_split, P)


@pytest.mark.parametrize("S", [16, 96, 128, 512, 1024])
def test_cluster_columns_split_every_head_width_evenly(S):
    """A rank folds hd / n columns: every head width the kernel takes (a
    multiple of 8) splits evenly over every cluster size, and at the
    tensor-core widths (128, 256) a rank's columns are a multiple of the
    4-column steps."""
    n = split_plan(S)
    assert n & (n - 1) == 0
    for hd in range(8, 257, 8):
        assert hd % n == 0
    for hd in (128, 256):
        assert (hd // n) % 4 == 0
