"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the serving path running through them.

Every test here needs an NVIDIA GPU: a CUDA kernel has no CPU mode.  They
carry the ``cuda`` marker and skip where no card is present (the check
runs inside the fixture, never at import).  This file imports only the
port, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in float32 and 2e-2 in bfloat16 between kernel and plain
version (the kernels accumulate in float32 in another order); GBDT
margins at 1e-4 and bitwise equal from run to run (no float atomics).
K2 against K1 on the same logical contents is exact: both run one body
(csrc/decode_tile.cuh) with one split plan, which depends on a lane's
fill level and the window only, so a lane also equals its own scalar-t
launch bit for bit; K3's extend rows equal the cold prefill's rows.  K5
(packed GBDT) is held to its plain version at 1e-5, and K4 and K5 to
each other and to ``tree_fold`` of the plain walks' leaf values bit for
bit: both split the trees by one plan from (T, K) and sum the leaves in
one fixed order, so a row also scores the same alone and in a batch.
K3b (attention backward) is held to its plain version within the same
1e-4 / 2e-2, scaled to max|plain| (gradients are not O(1)), and is
bitwise repeatable; K3's log-sum-exp within 1e-4 (f32) / 1e-3 (bf16) of
the plain logsumexp, its output unchanged bit for bit by asking for it.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.gbdt import GBDTModel, GBDTParams, train_gbdt
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import split_plan
from repro_torch.kernels.gbdt_infer import tree_fold
from repro_torch.serving.engine import (BatchedRealEngine, PagedBatchedEngine,
                                       RealEngine)

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
#: the serving paths' heads: (H, KV, hd) of smollm-360m, gemma3-4b-edge
#: and jamba-v0.1-52b
HEADS = [(15, 5, 64), (8, 4, 256), (32, 8, 128)]
#: the heads of the models served on the card whole or by one repeat:
#: gemma-2b's 8 over 1 KV head of width 256 (G 8; K1 in bf16 the
#: tensor-core body with all eight columns live, in float32 the widest
#: group the block's shared memory holds at that width) and
#: llama4-maverick's 40 over 8 at hd 128 (G 5); K2 also at qwen3-32b's 64
#: over 8 at hd 128 (its K1 and K3 are llama-3.2-vision-90b's instances);
#: dbrx-132b's 48 over 8 at hd 128 (G 6) for K1 and K3
SERVED_HEADS = [(8, 1, 256), (40, 8, 128), (48, 8, 128)]
PAGED_HEADS = [(8, 1, 256), (64, 8, 128)]
QWEN3_HEADS = (64, 8, 128)
#: every group width 1-8 at the tensor-core body's head widths (2 KV
#: heads): the fold's swizzled partial rows and column split hold at each
#: partial set of live head columns, G 5-7 included, which no served
#: model but llama4-maverick (G 5) and dbrx-132b (G 6) reaches
GROUP_HEADS = [(2 * G, 2, hd) for hd in (128, 256) for G in range(1, 9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,t", [(64, 0), (64, 40), (64, 100), (512, 300)])
@pytest.mark.parametrize("H,KV,hd", HEADS + SERVED_HEADS)
def test_decode_kernel_matches_plain(cuda, dtype, S, t, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(S + t)
    q = torch.randn(1, 1, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    tt = torch.tensor(t, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, tt)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention_ref(q.reshape(1, KV, H // KV, hd),
                                    k.transpose(1, 2), v.transpose(1, 2), tt)
    _close(got, want.reshape(got.shape), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 32, 48, 64, 96, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_kernel_matches_plain(cuda, dtype, S, causal, hd):
    """K3 at every serving bucket (ragged 48 and 96 too), B 4: bf16 on
    the tensor cores within 2e-2, float32 on the CUDA cores within
    1e-4."""
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q = torch.randn(4, S, 15, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(4, S, 5, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(1, 1024), (16, 1024), (45, 1024),
                                    (7, 40), (130, 64)])
@pytest.mark.parametrize("H,KV,hd", [(32, 32, 64), (64, 8, 128)])
def test_flash_kernel_noncausal_cross_lengths(cuda, dtype, Sq, Skv, H, KV,
                                              hd):
    """K3 non-causal with Sq != Skv, the cross-attention prefill (text
    rows over image rows), at one query head a KV head (musicgen's heads)
    and at eight (llama-3.2-vision-90b's)."""
    g = torch.Generator(device=cuda).manual_seed(Sq * 7 + Skv)
    q = torch.randn(1, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, Skv, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=False)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [40, 1024])
@pytest.mark.parametrize("H,KV,hd",
                         [(32, 32, 64), (64, 8, 128)] + SERVED_HEADS)
def test_decode_kernel_over_a_full_window(cuda, dtype, S, H, KV, hd):
    """K1 at t = S - 1 (every slot live), the cross-attention decode over
    the image cache, at G 1 and G 8, and at the served heads: equal to the
    non-causal attention of one query row."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn(2, 1, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    tt = torch.tensor(S - 1, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, tt)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=False)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.cuda
def test_gbdt_kernel_matches_plain_and_is_deterministic(cuda):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 600)
    X = rng.normal(0, 1, (600, 19)).astype(np.float32)
    X[:, 0] += y * 1.2
    model = train_gbdt(X, y, GBDTParams(num_rounds=20))
    args = [torch.as_tensor(X, device=cuda), *model.tensors(cuda)]
    got = ops.gbdt_margins(*args)
    want = ref.gbdt_margins_ref(*args)
    _close(got, want, torch.float32)
    assert torch.equal(got, ops.gbdt_margins(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_card_fused_equals_oracle(cuda, dtype):
    """A 2-layer GQA model served on the card goes through K3 and K1 and
    its fused decode equals the per-token oracle token for token."""
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              num_layers=2, num_heads=6, num_kv_heads=2,
                              dtype=dtype)
    eng = RealEngine(cfg, max_len=96, segment_len=8, device=cuda)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, 20)
    before = dict(ops.LAUNCHES)
    fused = eng.generate(ids, max_new_tokens=30)
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 2
    assert ops.LAUNCHES["decode_attention"] - before["decode_attention"] \
        == 2 * 29
    assert fused["tokens"] == eng.generate_reference(
        ids, max_new_tokens=30)["tokens"]


def _split_edges(S):
    """Fill levels on both sides of every split boundary of K1's plan
    (the live range [0, min(S, t + 1)) cut into split_plan(S) ranges of
    ceil(live / n) slots past 64 live slots, which rank 0 takes alone),
    the empty ring (every other split empty) and wrapped rings."""
    n = split_plan(S)
    ts = {0, 1, 2, 63, 64, 65, S - 2, S - 1, S, S + 3, 3 * S}
    for r in range(1, n):
        per = -(-S // n)
        ts |= {r * per - 1, r * per, r * per + 1}
    return sorted(t for t in ts if t >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 128, 512])
@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("H,KV,hd",
                         HEADS + SERVED_HEADS + [QWEN3_HEADS] + GROUP_HEADS)
def test_decode_kernel_per_lane_t_matches_plain(cuda, dtype, S, B, H, KV,
                                                hd):
    """K1 with (B,) fill levels on both sides of every split boundary,
    with empty splits and wrapped rings: each lane is the scalar-t
    launch for that lane bit for bit, and the batch matches the plain
    version.  One launch per call."""
    g = torch.Generator(device=cuda).manual_seed(4 + S + B)
    edges = _split_edges(S)
    levels = edges + edges[:(-len(edges)) % B]
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    for i in range(0, len(levels), B):
        t = torch.tensor(levels[i:i + B], dtype=torch.int32, device=cuda)
        before = ops.LAUNCHES["decode_attention"]
        got = ops.decode_attention(q, k, v, t)
        assert ops.LAUNCHES["decode_attention"] == before + 1
        _close(got, ops.decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                         t.cpu()), dtype)
        for b in range(B):
            solo = ops.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        t[b:b + 1])
            assert torch.equal(solo[0], got[b]), (levels[i + b], b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("levels", [(200, 511, 600), (1, 63, 64),
                                    (65, 127, 128), (255, 256, 449)])
@pytest.mark.parametrize("H,KV,hd", HEADS + PAGED_HEADS + GROUP_HEADS)
def test_paged_kernel_matches_plain_and_ring_kernel(cuda, dtype, page,
                                                    levels, H, KV, hd):
    """K2 through a shuffled block table (trash page poisoned, lane 0 on
    one page, fill levels on both sides of split boundaries, one past its
    window) == its plain version, and == K1 bit for bit on the same
    logical window."""
    g = torch.Generator(device=cuda).manual_seed(page + levels[0])
    B, P = 4, 512 // page
    n_pages = B * P + 1
    pk, pv = (torch.randn(n_pages, page, KV, hd, generator=g, device=cuda)
              .to(dtype) for _ in range(2))
    pk[0], pv[0] = 1e4, -1e4
    bt = (torch.randperm(n_pages - 1, generator=g, device=cuda)[:B * P] + 1) \
        .view(B, P).to(torch.int32)
    t = torch.tensor((3,) + levels, dtype=torch.int32, device=cuda)
    bt[0, 1:] = 0                              # lane 0: one page allocated
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dtype)
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_decode_attention(q, pk, pv, bt, t)
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    _close(got, ops.paged_decode_attention(q.cpu(), pk.cpu(), pv.cpu(),
                                           bt.cpu(), t.cpu()), dtype)
    ring_k = pk[bt.long()].reshape(B, P * page, KV, hd)
    ring_v = pv[bt.long()].reshape(B, P * page, KV, hd)
    assert torch.equal(got, ops.decode_attention(q, ring_k, ring_v, t))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prefix,suffix", [(64, 16), (48, 64), (128, 64),
                                           (48, 16), (64, 32), (256, 48)])
@pytest.mark.parametrize("H,KV,hd", HEADS + SERVED_HEADS)
def test_flash_kernel_extend_matches_plain(cuda, dtype, prefix, suffix, H,
                                           KV, hd):
    """K3 with q_offset over a longer key buffer == its plain version, and
    the suffix rows equal those rows of the cold prefill bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(prefix + suffix)
    extent = prefix + suffix + 32
    qf = torch.randn(1, prefix + suffix, H, hd, generator=g,
                     device=cuda).to(dtype)
    k, v = (torch.randn(1, extent, KV, hd, generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    q = qf[:, prefix:]
    got = ops.flash_attention(q, k, v, causal=True, q_offset=prefix)
    _close(got, ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                    q_offset=prefix), dtype)
    n = prefix + suffix
    cold = ops.flash_attention(qf, k[:, :n].contiguous(),
                               v[:, :n].contiguous(), causal=True)
    assert torch.equal(cold[:, prefix:], got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_lanes_equal_ring_lanes_on_card(cuda, dtype):
    """A 2-layer model's ring and paged lane engines on the card give the
    same greedy tokens; the paged decode launches K2 and no K1."""
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              num_layers=2, num_heads=6, num_kv_heads=2,
                              dtype=dtype)
    ring = BatchedRealEngine(cfg, max_len=96, segment_len=8, n_lanes=3,
                             device=cuda)
    paged = PagedBatchedEngine(cfg, state_dict=ring.lm.state_dict(),
                               max_len=96, segment_len=8, n_lanes=3,
                               page_size=16, device=cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 17, 30, 9)]
    want = [r["tokens"] for r in ring.generate_batch(prompts, 20)]
    before = dict(ops.LAUNCHES)
    got = [r["tokens"] for r in paged.generate_batch(prompts, 20)]
    assert got == want
    assert ops.LAUNCHES["paged_decode_attention"] > \
        before["paged_decode_attention"]
    assert ops.LAUNCHES["decode_attention"] == before["decode_attention"]


def _gbdt_model(base_score=0.0):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 600)
    X = rng.normal(0, 1, (600, 19)).astype(np.float32)
    X[:, 0] += y * 1.2
    model = train_gbdt(X, y, GBDTParams(num_rounds=20))
    model.base_score = base_score
    return model, X


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 64, 512])
def test_packed_gbdt_kernel_matches_plain_and_dense_kernel(cuda, B):
    """K5 == its plain version and == K4's margins (plus the base score)
    within 1e-5, and bitwise equal from run to run."""
    model, X = _gbdt_model(base_score=0.5)
    packed = model.packed()
    x = torch.as_tensor(X[:B], device=cuda)
    before = ops.LAUNCHES["gbdt_margins_packed"]
    got = ops.gbdt_margins_packed_from(packed, x)
    assert ops.LAUNCHES["gbdt_margins_packed"] == before + 1
    want = ops.gbdt_margins_packed_from(packed, x.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    dense = ops.gbdt_margins(x, *model.tensors(cuda)) + 0.5
    np.testing.assert_allclose(got.cpu().numpy(), dense.cpu().numpy(),
                               atol=1e-5)
    assert torch.equal(got, ops.gbdt_margins_packed_from(packed, x))


@pytest.mark.cuda
def test_single_row_admission_launches_k5_on_the_caller_stream(cuda):
    """One admission row and a burst both score through K5 (as the JAX
    model scores packed), on the caller's current stream; the dense
    oracle launches K4."""
    from repro_torch.core.predictor import Predictor
    model, X = _gbdt_model()
    pred = Predictor(model, device=cuda)
    seen = []
    orig = ops.gbdt_margins_packed_cuda

    def spy(*a, **kw):
        seen.append(torch.cuda.current_stream(cuda))
        return orig(*a, **kw)

    before = dict(ops.LAUNCHES)
    try:
        ops.gbdt_margins_packed_cuda = spy
        one = pred.proba_features(X[:1])
    finally:
        ops.gbdt_margins_packed_cuda = orig
    burst = pred.proba_features(X[:16])
    assert ops.LAUNCHES["gbdt_margins_packed"] == \
        before["gbdt_margins_packed"] + 2
    assert ops.LAUNCHES["gbdt_margins"] == before["gbdt_margins"]
    assert seen == [torch.cuda.current_stream(cuda)]
    np.testing.assert_allclose(one[0], burst[0], atol=1e-6)
    dense = model.predict_margin_dense(X[:16], cuda)
    assert ops.LAUNCHES["gbdt_margins"] == before["gbdt_margins"] + 1
    np.testing.assert_allclose(model.predict_margin(X[:16], cuda), dense,
                               atol=1e-5)


def _tiled(model, repeat, base_score=0.5):
    """``model``'s trees repeated ``repeat`` times along T (every tree keeps
    its class): a large ensemble without a long training."""
    return GBDTModel(*(np.tile(a, (repeat, 1)) for a in (
        model.feature, model.threshold, model.value)), model.n_classes,
        model.max_depth, base_score)


def _leaves(x, dense):
    """(T, B) leaf values of the plain dense walk (one class per tree)."""
    return ref.gbdt_margins_ref(x, *dense, n_classes=dense[0].shape[0]).T


def _both_kernels(model, x):
    """K4's margins + base score and K5's margins, one launch each."""
    before = dict(ops.LAUNCHES)
    k4 = ops.gbdt_margins(x, *model.tensors(x.device),
                          n_classes=model.n_classes) + model.base_score
    k5 = ops.gbdt_margins_packed_from(model.packed(), x)
    assert ops.LAUNCHES["gbdt_margins"] == before["gbdt_margins"] + 1
    assert ops.LAUNCHES["gbdt_margins_packed"] == \
        before["gbdt_margins_packed"] + 1
    return k4, k5


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 100, 512])
@pytest.mark.parametrize("repeat", [3, 6, 30])
def test_gbdt_kernels_fold_in_plan_order(cuda, repeat, B):
    """T 180 and T 360 (the launch CLIs' ensemble; each slice staged at
    once) and T 1800 (slices streamed through the two-buffer ring), at a
    sidecar admission (B 1), bursts of 16 and of 100 (``launch.serve``)
    and 512: K4 and K5 within 1e-5 of their plain
    versions (relative 1e-6 above that at T 1800, where margins reach
    ~40), K5 == K4 + base score and both == ``tree_fold`` of the plain
    walks' leaves bit for bit, and the same bits on every call."""
    base, X = _gbdt_model()
    model = _tiled(base, repeat)
    assert model.feature.shape[0] == 60 * repeat
    x = torch.as_tensor(np.tile(X, (2, 1))[:B], device=cuda)
    k4, k5 = _both_kernels(model, x)
    tol = dict(atol=1e-5, rtol=1e-6 if repeat > 3 else 0)
    xc, dense = x.cpu(), model.tensors("cpu")
    np.testing.assert_allclose(
        (k4 - model.base_score).cpu().numpy(),
        ref.gbdt_margins_ref(xc, *dense, n_classes=3).numpy(), **tol)
    np.testing.assert_allclose(
        k5.cpu().numpy(), ops.gbdt_margins_packed_from(model.packed(),
                                                       xc).numpy(), **tol)
    assert torch.equal(k5, k4)
    fold = tree_fold(_leaves(xc, dense), 3)
    assert torch.equal(k5.cpu(), fold + model.base_score)
    for _ in range(3):
        again4, again5 = _both_kernels(model, x)
        assert torch.equal(again4, k4) and torch.equal(again5, k5)


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", [3, 30])
def test_gbdt_row_alone_equals_row_in_batch(cuda, repeat):
    """A row's margins are the same bits scored alone (one admission) and
    in a burst of 16 or 512: the tree split depends on (T, K) only."""
    base, X = _gbdt_model()
    model = _tiled(base, repeat)
    x = torch.as_tensor(X[:512], device=cuda)
    k4, k5 = _both_kernels(model, x)
    k4_16, k5_16 = _both_kernels(model, x[:16])
    assert torch.equal(k4[:16], k4_16) and torch.equal(k5[:16], k5_16)
    for b in (0, 5, 15, 300, 511):
        a4, a5 = _both_kernels(model, x[b:b + 1].clone())
        assert torch.equal(a4[0], k4[b]) and torch.equal(a5[0], k5[b])


@pytest.mark.cuda
def test_gbdt_trees_too_large_to_stage_walk_from_global(cuda):
    """Depth-13 trees (16,383 nodes: more than half of shared memory a
    tree in either layout) are walked from global memory: K4 and K5
    still equal their plain versions within 1e-5 and each other bit for
    bit."""
    rng = np.random.default_rng(3)
    depth, T, F = 13, 3, 19
    N = 2 ** (depth + 1) - 1
    feature = rng.integers(0, F, (T, N)).astype(np.int32)
    feature[:, 2 ** depth - 1:] = -1                 # the bottom level
    feature[1, 5] = -1                               # an early leaf
    model = GBDTModel(feature, rng.normal(0, 1, (T, N)).astype(np.float32),
                      rng.normal(0, 0.1, (T, N)).astype(np.float32), 3,
                      depth, 0.25)
    x = torch.as_tensor(rng.normal(0, 1, (16, F)).astype(np.float32),
                        device=cuda)
    k4, k5 = _both_kernels(model, x)
    want = ref.gbdt_margins_ref(x.cpu(), *model.tensors("cpu"), n_classes=3)
    np.testing.assert_allclose((k4 - 0.25).cpu().numpy(), want.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(k5.cpu().numpy(), want.numpy() + 0.25,
                               atol=1e-5)
    assert torch.equal(k5, k4)


class _TwoClass:
    """Scores without a device: "long" prompts P(Long) = 1, others 0."""

    def proba_batch(self, prompts):
        return np.array([[0.0, 0.0, 1.0] if "long" in p else [1.0, 0.0, 0.0]
                         for p in prompts])


@pytest.mark.cuda
def test_full_width_preemption_resumes_to_the_uninterrupted_tokens(cuda):
    """smollm-360m at full width in float32 (TF32 off) under ``srpt``: the
    short (arriving 1e-6 s after the long) evicts the decoding long at a
    segment boundary, and the long's resumed tokens equal an
    uninterrupted decode's."""
    import dataclasses

    from repro_torch.serving.openai_api import CompletionRequest
    from repro_torch.serving.server import ClairvoyantServer
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config("smollm-360m"),
                                  dtype="float32")
        eng = RealEngine(cfg, max_len=96, segment_len=4, device=cuda)
        server = ClairvoyantServer(policy="srpt", predictor=_TwoClass(),
                                   engines=[eng])
        long_req = CompletionRequest(prompt="long story please")
        server.submit(long_req, arrival=0.0, true_output_tokens=600,
                      klass="long")
        server.submit(CompletionRequest(prompt="quick question"),
                      arrival=1e-6, true_output_tokens=30, klass="short")
        before = dict(ops.LAUNCHES)
        resp = server.drain(max_new_tokens=24)
        assert ops.LAUNCHES["decode_attention"] > before["decode_attention"]
        assert [r.status for r in resp] == ["ok", "ok"]
        assert resp[0].klass == "short"
        assert server.router.replicas[0].queue.stats["preemptions"] >= 1
        long_resp = next(r for r in resp
                         if r.request_id == long_req.request_id)
        ids = server._tokenizer.encode(long_req.prompt)
        want = eng.generate(ids, max_new_tokens=24)["tokens"]
        assert long_resp.tokens_generated == 24
        assert long_resp.token_ids == list(want)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.cuda
def test_launch_serve_scores_the_burst_with_one_k4_launch(cuda):
    """``python -m repro_torch.launch.serve`` on the card: the predictor
    scores the 100-request burst in one launch, of K5 since every batch
    takes the packed layout as in JAX (the name is from when a burst went
    to K4, which now launches no time), and SJF serves every request."""
    from repro_torch.launch import serve
    before = dict(ops.LAUNCHES)
    srv = serve.main(["--policy", "sjf", "--requests", "100"])
    assert ops.LAUNCHES["gbdt_margins_packed"] == \
        before["gbdt_margins_packed"] + 1
    assert ops.LAUNCHES["gbdt_margins"] == before["gbdt_margins"]
    assert srv.predictor.device.type == "cuda"
    assert len(srv.ok_responses) == 100


@pytest.mark.cuda
def test_cli_ensemble_kernels_match_plain(cuda):
    """The ensemble the launch CLIs train (``build_predictor``: 120
    rounds, T 360): K4 on ``launch.serve``'s 100-request burst within 1e-5
    of its plain version and == ``tree_fold`` of the plain walk's leaves;
    K5 on single admissions within 1e-5 of its plain version and == K4 +
    base score bit for bit."""
    from repro_torch.core.features import extract_batch
    from repro_torch.data.corpus import sample_dataset
    from repro_torch.launch import serve
    model = serve.build_predictor(device=cuda).model
    assert model.feature.shape[0] == 360
    prompts = sample_dataset("sharegpt", n=100, seed=1).prompts
    x = torch.as_tensor(extract_batch(prompts), device=cuda)
    dense = model.tensors(cuda)
    k4 = ops.gbdt_margins(x, *dense, n_classes=3)
    xc, dense_c = x.cpu(), model.tensors("cpu")
    np.testing.assert_allclose(
        k4.cpu().numpy(),
        ref.gbdt_margins_ref(xc, *dense_c, n_classes=3).numpy(), atol=1e-5)
    assert torch.equal(k4.cpu(), tree_fold(_leaves(xc, dense_c), 3))
    packed = model.packed()
    for b in (0, 37, 99):
        row = x[b:b + 1].clone()
        k5 = ops.gbdt_margins_packed_from(packed, row)
        np.testing.assert_allclose(
            k5.cpu().numpy(),
            ops.gbdt_margins_packed_from(packed, row.cpu()).numpy(),
            atol=1e-5)
        assert torch.equal(k5, ops.gbdt_margins(row, *dense, n_classes=3)
                           + model.base_score)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_des_on_card_equals_host_engine_bitwise(cuda, seed):
    """The grid DES in float64 on the card: start, finish, promoted and
    promotions equal the host engine's bit for bit (the first maximal
    index of ``argmax`` on CUDA is the FIFO head and the tie-break)."""
    from repro_torch.core.sim_fast import dispatch_key, simulate_grid
    from repro_torch.core.sim_torch import simulate_grid_torch
    rng = np.random.default_rng(seed)
    G, n = 12, 400
    arrival = np.sort(np.round(rng.uniform(0, 300, (G, n)), 1), axis=1)
    service = np.round(rng.uniform(0.5, 4, (G, n)), 1)   # ties in keys
    p_long = np.round(rng.random((G, n)), 1)
    policies = ["fcfs", "sjf", "sjf_oracle"] * 4
    taus = [None, 5.0, 0.0, None, 10.5, 2.0] * 2
    key = np.stack([dispatch_key(p, arrival[g], p_long[g], service[g])
                    for g, p in enumerate(policies)])
    got = simulate_grid_torch(arrival, service, key, taus, device=cuda)
    want = simulate_grid(arrival, service, key, taus)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _small_cfg(dtype):
    import dataclasses
    return dataclasses.replace(get_config("smollm-360m").reduced(),
                               num_layers=2, num_heads=6, num_kv_heads=2,
                               dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ring-scalar", "ring-lanes", "paged"])
def test_verify_forward_on_card_matches_plain(cuda, dtype, kind):
    """``LM.verify_step`` on the card (K1 per position over a ring, K2
    over the paged pool, W launches a layer) against the same forward on
    the CPU (the plain versions), windows crossing the ring's end
    included; the paged verify launches no K1."""
    from repro_torch.models.model import LM
    cfg = _small_cfg(str(dtype).split(".")[1])
    W, B = 5, 3
    lm = LM(cfg, device=cuda, seed=0)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    if kind == "paged":
        caches = [m.init_paged_cache(B, 64, 14, 16) for m in (lm, cpu)]
        bt = torch.tensor([[5, 2, 0, 0], [7, 1, 12, 3], [9, 4, 13, 0]],
                          dtype=torch.int32)
        t = torch.tensor([20, 61, 40], dtype=torch.int32)
    else:
        caches = [m.init_cache(B, 64) for m in (lm, cpu)]
        t = torch.tensor(60, dtype=torch.int32) if kind == "ring-scalar" \
            else torch.tensor([3, 61, 70], dtype=torch.int32)
    k = torch.randn(caches[1].k.shape, generator=g).to(caches[1].k.dtype)
    v = torch.randn(caches[1].v.shape, generator=g).to(caches[1].v.dtype)
    for c in caches:
        dev = c.k.device
        c.k.copy_(k.to(dev))
        c.v.copy_(v.to(dev))
        c.t = t.to(dev).clone()
        if kind == "paged":
            c.bt.copy_(bt.to(dev))
    toks = torch.randint(0, cfg.vocab_size, (B, W), generator=g)
    before = dict(ops.LAUNCHES)
    got = lm.verify_step(caches[0], toks.to(cuda))
    torch.cuda.synchronize()
    want = cpu.verify_step(caches[1], toks)
    name, other = ("paged_decode_attention", "decode_attention") \
        if kind == "paged" else ("decode_attention", "paged_decode_attention")
    assert ops.LAUNCHES[name] - before[name] == W * cfg.num_layers
    assert ops.LAUNCHES[other] == before[other]
    _close(got, want, dtype)
    if dtype == torch.float32:
        assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))


@pytest.mark.cuda
def test_speculative_tokens_on_card_equal_plain_decode(cuda):
    """Float32 (TF32 off): the serial speculative engine (agreeing and
    independent drafts) and speculative ring lanes give plain greedy
    decode's tokens on the card."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = _small_cfg("float32")
        ref = RealEngine(cfg, max_len=64, device=cuda)
        sd = ref.lm.state_dict()
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (4, 17, 9, 30)]
        maxes = [20, 12, 30, 8]
        want = [ref.generate(p, max_new_tokens=m)["tokens"]
                for p, m in zip(prompts, maxes)]
        for draft in ({"draft_state_dict": sd}, {"draft_seed": 5}):
            spec = RealEngine(cfg, state_dict=sd, max_len=64, device=cuda,
                              draft_cfg=cfg, draft_k=3, **draft)
            got = [spec.generate(p, max_new_tokens=m)["tokens"]
                   for p, m in zip(prompts, maxes)]
            assert got == want
        lanes = BatchedRealEngine(cfg, state_dict=sd, max_len=64,
                                  segment_len=8, n_lanes=3, device=cuda,
                                  draft_cfg=cfg, draft_state_dict=sd,
                                  draft_k=3)
        outs = lanes.generate_batch(prompts, maxes)
        assert [o["tokens"] for o in outs] == want
        assert lanes.accept_rate > 0.5
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _scaled_close(name, got, want, dtype):
    """max |kernel - plain| within the kernel tolerance scaled to the
    largest |plain| entry (gradients are not O(1))."""
    tol = TOL[dtype]["atol"] * max(float(want.float().abs().max()), 1.0)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{name}: {err} > {tol}"


def _bwd_inputs(cuda, dtype, B, S, H, KV, hd, seed, causal=True, Skv=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, S if Skv is None else Skv, KV, hd, generator=g,
                        device=cuda).to(dtype) for _ in range(2))
    do = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    o, lse = ops.flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    return q, k, v, o, do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 48, 64, 100, 512, 1000])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, S, hd, causal):
    """K3b against ``flash_attention_bwd_plain`` on the same q, k, v, o,
    dO and lse (S below one tile, 16 and 48, and ragged S 100 and 1000
    included), H 15 over KV 5: within 1e-4 (f32, TF32 off) and 2e-2
    (bf16: P, dS and the outputs rounded to bf16) of max|plain|; one
    launch counted per call."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args = _bwd_inputs(cuda, dtype, 2, S, 15, 5, hd, S + hd, causal)
        before = ops.LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd_cuda(*args, causal=causal)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
        want = flash_attention_bwd_plain(*args, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _scaled_close(name, a, b, dtype)


@pytest.mark.cuda
def test_flash_bwd_kernel_matches_plain_at_training_shape(cuda):
    """K3b at the train step's shape (bf16, causal, B 8, S 512, H 15 over
    KV 5, hd 64) within 2e-2 of max|plain|, against the f32 plain version
    and against the one that rounds P and dS to bf16 where the kernel
    does."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    args = _bwd_inputs(cuda, torch.bfloat16, 8, 512, 15, 5, 64, 11)
    got = flash_attention_bwd_cuda(*args)
    for round_dtype in (None, torch.bfloat16):
        want = flash_attention_bwd_plain(*args, round_dtype=round_dtype)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _scaled_close(name, a, b, torch.bfloat16)


@pytest.mark.cuda
def test_flash_bwd_bf16_kernels_do_not_spill(cuda, tmp_path, monkeypatch):
    """Every bf16 instance of K3b's passes (pass 1 at hd 16, 32, 64, 128
    and 256, the two mma.sync passes at hd 16 and 32, the two wgmma
    passes at hd 64, 128 and 256) compiles with no register spills, as
    ``_build.PTXAS_REPORT`` shows after a fresh build."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.build(["flash_attention_bwd"])
    entries = _build.PTXAS_REPORT["flash_attention_bwd"].split(
        "Compiling entry function '")[1:]
    bf16 = [e for e in entries if "nv_bfloat16" in e.split("'")[0]]
    assert len(bf16) == 15, [e.split("'")[0] for e in entries]
    for e in bf16:
        assert "0 bytes spill stores, 0 bytes spill loads" in e, e


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention",
                                  "flash_attention"])
def test_serving_kernels_do_not_spill(cuda, tmp_path, monkeypatch, name):
    """Every instance of K1, K2 and K3 that a group of up to 8 query
    heads a KV head reaches, the head-width-256 ones among them (K1/K2 at
    two 16-byte chunks a lane in float32, K3's wide bf16 block and its
    float32 rows over four threads), compiles with no register spills, as
    ``_build.PTXAS_REPORT`` shows after a fresh build.  K1/K2's bf16
    instance for groups of 9 to 16 (``Li16ELi1E``: q and the accumulator
    are 256 registers a lane) spills, as it did before hd 256; no
    reference config has such a group (ROADMAP Queue B)."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.build([name])
    entries = _build.PTXAS_REPORT[name].split(
        "Compiling entry function '")[1:]
    checked = [e for e in entries
               if "nv_bfloat16Li16ELi1E" not in e.split("'")[0]]
    assert checked and len(entries) - len(checked) <= 1
    for e in checked:
        assert "0 bytes spill stores, 0 bytes spill loads" in e, e


@pytest.mark.cuda
def test_hd256_refused_by_k3b_and_the_train_cli(cuda):
    """Head width 256 trains on the card: ``launch.train``'s card check
    lets gemma3-4b-edge through and K3b launches at hd 256; a head width
    K3b is not compiled for (96) still raises in K3b and stops the CLI
    before it builds any weight (no plain-backward fallback).  Then the
    CLI trains gemma3's hd-256 reduced copy on the card for 3 steps."""
    import dataclasses
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_cuda
    from repro_torch.launch import train as train_mod
    train_mod.check_attention_backward(get_config("gemma3-4b-edge"))
    args = _bwd_inputs(cuda, torch.bfloat16, 1, 32, 8, 4, 256, 1)
    before = ops.LAUNCHES["flash_attention_bwd"]
    flash_attention_bwd_cuda(*args)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_attention_bwd_cuda(*_bwd_inputs(cuda, torch.bfloat16, 1, 32, 8,
                                              4, 96, 1))
    wide = dataclasses.replace(get_config("gemma3-4b-edge"), head_dim=96)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with pytest.raises(SystemExit, match="K3b.*head_dim 96"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_mod, "get_config", lambda name: wide)
        train_mod.main(["--arch", "gemma3-4b-edge", "--steps", "1"])
    assert torch.cuda.max_memory_allocated() == base
    small = dataclasses.replace(get_config("gemma3-4b-edge").reduced(),
                                head_dim=256, dtype="bfloat16")
    before = ops.LAUNCHES["flash_attention_bwd"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_mod, "get_config", lambda name: small)
        try:
            losses = train_mod.main(["--arch", "gemma3-4b-edge", "--steps",
                                     "3", "--seq", "64", "--batch", "2"])
        finally:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert ops.LAUNCHES["flash_attention_bwd"] - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(7, 16), (16, 40), (37, 130), (100, 64),
                                    (512, 1024)])
@pytest.mark.parametrize("H,KV,hd", [(32, 32, 64), (64, 8, 128), (8, 4, 256),
                                     (4, 1, 32)])
def test_flash_bwd_kernel_at_cross_lengths(cuda, dtype, Sq, Skv, H, KV, hd):
    """K3b's full attention at Sq != Skv (the cross-attention layer's
    backward; musicgen's, vision's and gemma3's heads and a G 4 one)
    against the plain version within 1e-4 (f32, TF32 off) / 2e-2 (bf16)
    of max|plain|, bf16 also against the plain version that rounds P and
    dS; two calls give the same bits; causal at Sq != Skv raises."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args = _bwd_inputs(cuda, dtype, 2, Sq, H, KV, hd, Sq + Skv,
                           causal=False, Skv=Skv)
        got = flash_attention_bwd_cuda(*args, causal=False)
        again = flash_attention_bwd_cuda(*args, causal=False)
        torch.cuda.synchronize()
        wants = [flash_attention_bwd_plain(*args, causal=False)]
        if dtype == torch.bfloat16:
            wants.append(flash_attention_bwd_plain(
                *args, causal=False, round_dtype=torch.bfloat16))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for want in wants:
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == dtype and a.shape == b.shape
            _scaled_close(name, a, b, dtype)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention_bwd_cuda(*args, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic(cuda, dtype):
    """Two K3b calls on the same inputs give the same bits (no float
    atomics, a fixed walk)."""
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_cuda
    args = _bwd_inputs(cuda, dtype, 2, 200, 15, 5, 64, 7)
    a = flash_attention_bwd_cuda(*args)
    b = flash_attention_bwd_cuda(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 96, 512])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_lse_matches_plain(cuda, dtype, S, hd, causal):
    """K3's log-sum-exp against the plain logsumexp of the scaled masked
    scores (within 1e-4 in f32, 1e-3 in bf16: the scores are exact
    products of the same bf16 inputs, the sums run in another order), and
    K3's output with the lse requested equals its output without, bit for
    bit (a null lse changes nothing)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=cuda).manual_seed(S * hd)
    q = torch.randn(2, S, 15, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, S, 5, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    plain = flash_attention_cuda(q, k, v, causal=causal)
    _, want = ops.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=True)
    assert lse.shape == (2, 15, S) and lse.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                               atol=tol, rtol=tol)
    assert torch.equal(o, plain)


@pytest.mark.cuda
def test_flash_attention_train_reaches_k3_and_k3b(cuda):
    """``ops.flash_attention_train`` on the card: one K3 launch forward,
    one K3b launch backward, and gradients equal to K3b on K3's own o and
    lse."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_cuda
    q, k, v, _, do, _ = _bwd_inputs(cuda, torch.bfloat16, 2, 128, 15, 5,
                                    64, 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention_train(*leaves)
    out.backward(do)
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 1
    assert (ops.LAUNCHES["flash_attention_bwd"]
            - before["flash_attention_bwd"]) == 1
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    assert torch.equal(out.detach(), o)
    for leaf, want in zip(leaves, flash_attention_bwd_cuda(q, k, v, o, do,
                                                           lse)):
        assert torch.equal(leaf.grad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,H,KV,hd,causal", [
    (128, 128, 8, 4, 256, True), (64, 1024, 64, 8, 128, False),
    (40, 16, 4, 4, 256, False)])
def test_flash_attention_train_reaches_k3_and_k3b_at_new_shapes(
        cuda, Sq, Skv, H, KV, hd, causal):
    """``ops.flash_attention_train`` on the card at the shapes K3b gained:
    head width 256 (gemma3's heads, causal) and full attention at Sq !=
    Skv (vision's cross-attention heads over 1024 image rows, and hd
    256): one K3 launch forward, one K3b launch backward, gradients equal
    to K3b on K3's own o and lse; causal at Sq != Skv raises."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_cuda
    q, k, v, _, do, _ = _bwd_inputs(cuda, torch.bfloat16, 2, Sq, H, KV, hd,
                                    3, causal=causal, Skv=Skv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention_train(*leaves, causal=causal)
    out.backward(do)
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 1
    assert (ops.LAUNCHES["flash_attention_bwd"]
            - before["flash_attention_bwd"]) == 1
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out.detach(), o)
    for leaf, want in zip(leaves, flash_attention_bwd_cuda(
            q, k, v, o, do, lse, causal=causal)):
        assert torch.equal(leaf.grad, want)
    if Sq != Skv:
        with pytest.raises(ValueError, match="Sq == Skv"):
            ops.flash_attention_train(q, k, v, causal=True)


#: reduced stacks whose training reaches K3b's new shapes: (arch, config
#: overrides) -- gemma3 at head width 256, vision's cross-attention (full
#: attention over its image rows), musicgen on frames
TRAIN_ARCHS = {"gemma3-hd256": ("gemma3-4b-edge", {"head_dim": 256}),
               "vision": ("llama-3.2-vision-90b", {}),
               "musicgen": ("musicgen-large", {})}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRAIN_ARCHS))
def test_arch_train_step_on_card_matches_cpu(cuda, case):
    """The reduced gemma3 (hd 256), vision (``image_embeds``) and
    musicgen (``frames``) stacks in float32 with TF32 off: the loss
    gradients on the card (K3 forward and K3b backward in every
    attention layer, the cross-attention one non-causal at Sq != Skv)
    within 1e-4 of max|g| of the CPU's (the plain versions), K3 twice
    and K3b once a layer (remat), and one AdamW train step's loss (rtol
    1e-5) and params (atol 2 x lr) equal."""
    import dataclasses
    from repro_torch.models.model import LM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step
    arch, over = TRAIN_ARCHS[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    g = torch.Generator().manual_seed(9)
    batch = {"labels": torch.randint(0, cfg.vocab_size, (2, 48), generator=g)}
    if cfg.audio_frontend:
        batch["frames"] = torch.randn(2, 48, cfg.d_model, generator=g)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (2, 48),
                                        generator=g)
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.randn(2, cfg.num_image_tokens,
                                            cfg.d_model, generator=g)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        models = [LM(cfg, device=cuda, seed=0), LM(cfg, device="cpu")]
        models[1].load_state_dict({k: v.cpu() for k, v in
                                   models[0].state_dict().items()})
        grads = []
        for lm in models:
            lm.requires_grad_(True)
            before = dict(ops.LAUNCHES)
            lm.loss({k: v.to(lm.device) for k, v in batch.items()}).backward()
            if lm.device.type == "cuda":
                torch.cuda.synchronize()
                n_attn = sum(k in ("attn", "xattn")
                             for k in cfg.block_pattern) \
                    * cfg.num_layers // len(cfg.block_pattern)
                assert ops.LAUNCHES["flash_attention"] \
                    - before["flash_attention"] == 2 * n_attn
                assert ops.LAUNCHES["flash_attention_bwd"] \
                    - before["flash_attention_bwd"] == n_attn
            grads.append({n: p.grad.cpu() for n, p in lm.named_parameters()})
            lm.zero_grad(set_to_none=True)
        for n, want in grads[1].items():
            err = float((grads[0][n] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), n
        step = make_train_step(cfg, opt)
        out = [step(TrainState(lm, init_opt_state(
                   dict(lm.named_parameters()), opt)),
                    {k: v.to(lm.device) for k, v in batch.items()})
               for lm in models]
        (sc, mc), (sh, mh) = out
        np.testing.assert_allclose(float(mc["loss"]), float(mh["loss"]),
                                   rtol=1e-5)
        for (n, a), b in zip(sc.params.items(), sh.params.values()):
            np.testing.assert_allclose(a.detach().cpu().numpy(),
                                       b.detach().numpy(), atol=2 * opt.lr,
                                       rtol=0, err_msg=n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """A reduced float32 model (2 layers, H 6 over KV 2, TF32 off): its
    loss gradients on the card (K3 with lse forward, K3b backward, 2 x 2
    and 2 launches with remat) within 1e-4 of max|g| of the CPU's (the
    plain versions), and one AdamW train step's loss (rtol 1e-5), grad
    norm (rtol 1e-4) and params (atol 2 x lr: an element whose gradient
    is ~0 may take the other sign of Adam's first, sign-like step)."""
    from repro_torch.models.model import LM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = _small_cfg("float32")
        opt = OptConfig(lr=1e-3, warmup_steps=1)
        models = [LM(cfg, device=cuda, seed=0), LM(cfg, device="cpu")]
        models[1].load_state_dict({k: v.cpu() for k, v in
                                   models[0].state_dict().items()})
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, (4, 65))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        grads = []
        for lm in models:
            lm.requires_grad_(True)
            before = dict(ops.LAUNCHES)
            lm.loss({k: v.to(lm.device) for k, v in batch.items()}).backward()
            if lm.device.type == "cuda":
                torch.cuda.synchronize()
                assert ops.LAUNCHES["flash_attention"] \
                    - before["flash_attention"] == 2 * cfg.num_layers
                assert ops.LAUNCHES["flash_attention_bwd"] \
                    - before["flash_attention_bwd"] == cfg.num_layers
            grads.append({n: p.grad.cpu() for n, p in lm.named_parameters()})
            lm.zero_grad(set_to_none=True)
        for n, want in grads[1].items():
            err = float((grads[0][n] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), n
        step = make_train_step(cfg, opt)
        out = [step(TrainState(lm, init_opt_state(
                   dict(lm.named_parameters()), opt)),
                    {k: v.to(lm.device) for k, v in batch.items()})
               for lm in models]
        (sc, mc), (sh, mh) = out
        np.testing.assert_allclose(float(mc["loss"]), float(mh["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mc["grad_norm"]),
                                   float(mh["grad_norm"]), rtol=1e-4)
        for (n, a), b in zip(sc.params.items(), sh.params.values()):
            np.testing.assert_allclose(a.detach().cpu().numpy(),
                                       b.detach().numpy(), atol=2 * opt.lr,
                                       rtol=0, err_msg=n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 7, 23, 45, 129])
@pytest.mark.parametrize("B", [1, 3])
def test_flash_kernel_at_exact_lengths(cuda, dtype, S, B):
    """K3 at exact prompt lengths (a stack with Mamba or MoE blocks
    prefills unbucketed) at jamba's heads (H 32 over KV 8, hd 128),
    causal, against ``ref.flash_attention_ref`` (2e-2 bf16, 1e-4 f32).
    The keys and values are views of buffers whose rows past S hold NaN:
    the output is finite and equal bit for bit to the launch on clean
    copies, so the tail tile's masked keys contribute exact zeros."""
    g = torch.Generator(device=cuda).manual_seed(S + B)
    q = torch.randn(B, S, 32, 128, generator=g, device=cuda).to(dtype)
    kb, vb = (torch.full((B, S + 40, 8, 128), float("nan"), dtype=dtype,
                         device=cuda) for _ in range(2))
    kb[:, :S] = torch.randn(B, S, 8, 128, generator=g, device=cuda).to(dtype)
    vb[:, :S] = torch.randn(B, S, 8, 128, generator=g, device=cuda).to(dtype)
    k, v = kb[:, :S], vb[:, :S]
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ops.flash_attention(q, k.contiguous(),
                                                v.contiguous(), causal=True))
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "dbrx-132b"])
def test_hybrid_and_moe_engines_on_card_match_cpu(cuda, name):
    """Reduced jamba (Mamba + MoE + attention) and dbrx (MoE) in float32
    with TF32 off: greedy tokens of the serial and the lane engine on the
    card equal the same engines' on the CPU (plain attention), with K3
    and K1 launched once an attention layer a prefill and a step; fused
    decode equals the per-token oracle on the card."""
    cfg = get_config(name).reduced()
    n_attn = sum(k.startswith("attn") for k in cfg.block_pattern)
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((7, 7, 12, 5, 12))]
    maxes = [10, 6, 8, 12, 5]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    # one set of weights: a seeded generator draws other numbers on the card
    sd = RealEngine(cfg, max_len=64, device="cpu", seed=2).lm.state_dict()
    try:
        out = {}
        for dev in ("cpu", cuda):
            ser = RealEngine(cfg, state_dict=sd, max_len=64, segment_len=4,
                             device=dev)
            lanes = BatchedRealEngine(cfg, state_dict=sd, max_len=64,
                                      segment_len=4, n_lanes=3, device=dev)
            before = dict(ops.LAUNCHES)
            serial = [ser.generate(p, max_new_tokens=m)["tokens"]
                      for p, m in zip(prompts, maxes)]
            if dev == cuda:
                steps = sum(len(t) - 1 for t in serial)
                assert ops.LAUNCHES["flash_attention"] \
                    - before["flash_attention"] == 5 * n_attn
                assert ops.LAUNCHES["decode_attention"] \
                    - before["decode_attention"] == steps * n_attn
                assert ser.generate_reference(prompts[2], 8)["tokens"] == \
                    ser.generate(prompts[2], max_new_tokens=8)["tokens"]
            out[str(dev)] = (serial, [r["tokens"] for r in
                                      lanes.generate_batch(prompts, maxes)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out[str(cuda)] == out["cpu"]


@pytest.mark.cuda
def test_xlstm_engines_on_card_match_cpu(cuda):
    """Reduced xlstm-350m (sLSTM + mLSTM, no attention layer) in float32
    with TF32 off: serial and lane greedy tokens on the card equal the
    CPU's, and no attention kernel is launched."""
    cfg = get_config("xlstm-350m").reduced()
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((7, 7, 12, 5, 12))]
    maxes = [10, 6, 8, 12, 5]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = RealEngine(cfg, max_len=64, device="cpu", seed=2).lm.state_dict()
    try:
        out = {}
        for dev in ("cpu", cuda):
            ser = RealEngine(cfg, state_dict=sd, max_len=64, segment_len=4,
                             device=dev)
            lanes = BatchedRealEngine(cfg, state_dict=sd, max_len=64,
                                      segment_len=4, n_lanes=3, device=dev)
            before = dict(ops.LAUNCHES)
            out[str(dev)] = (
                [ser.generate(p, max_new_tokens=m)["tokens"]
                 for p, m in zip(prompts, maxes)],
                [r["tokens"] for r in lanes.generate_batch(prompts, maxes)])
            assert ops.LAUNCHES == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out[str(cuda)] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "musicgen-large"])
def test_cross_attention_and_audio_models_on_card_match_cpu(cuda, name):
    """Reduced vision (self- and cross-attention) and musicgen (frame
    embeddings) in float32 with TF32 off: prefill and 3 teacher-forced
    decode steps on the card within 1e-4 of the CPU; each prefill
    launches K3 once an attention layer (causal) and once a
    cross-attention layer (non-causal), each step K1 once a layer of
    either kind."""
    import dataclasses
    cfg = get_config(name).reduced()
    cfg = dataclasses.replace(cfg, num_layers=2 * len(cfg.block_pattern))
    g = torch.Generator().manual_seed(5)
    key = "frames" if cfg.audio_frontend else "tokens"
    seq = (torch.randn(2, 12, cfg.d_model, generator=g) if key == "frames"
           else torch.randint(0, cfg.vocab_size, (2, 12), generator=g))
    img = {"image_embeds": torch.randn(2, cfg.num_image_tokens,
                                       cfg.d_model, generator=g)} \
        if cfg.num_image_tokens else {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.models.model import LM
        cpu = LM(cfg, device="cpu", seed=3)
        gpu = LM(cfg, device=cuda)
        gpu.load_state_dict(cpu.state_dict())
        logits = {}
        before = dict(ops.LAUNCHES)
        for lm in (cpu, gpu):
            dev = lm.device
            out, cache = lm.prefill(pad_to=16, **{key: seq[:, :8].to(dev)},
                                    **{k: v.to(dev) for k, v in img.items()})
            outs = [out.cpu()]
            for t in range(8, 11):
                outs.append(lm.decode_step(
                    cache, **{key: seq[:, t:t + 1].to(dev)}).cpu())
            logits[dev.type] = torch.stack(outs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    layers = cfg.num_layers
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] \
        == layers
    assert ops.LAUNCHES["decode_attention"] - before["decode_attention"] \
        == 3 * layers
    _close(logits["cuda"], logits["cpu"], torch.float32)


@pytest.mark.cuda
def test_train_cli_refuses_a_state_the_card_cannot_hold(cuda):
    """jamba-v0.1-52b's bf16 weights, gradients and float32 AdamW moments
    (575 GiB) do not fit the card: ``launch.train`` stops with the sizes
    before it builds any weight."""
    from repro_torch.launch import train as train_mod
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with pytest.raises(SystemExit, match="AdamW moments need"):
        train_mod.main(["--arch", "jamba-v0.1-52b", "--steps", "1"])
    assert torch.cuda.max_memory_allocated() == base


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 257])
def test_packed_ensemble_and_p_long_score_through_k5(cuda, B):
    """``PackedEnsemble.predict_proba`` and ``GBDTModel.predict_p_long`` on
    the card launch K5 once a batch and K4 never, within 1e-5 of the
    CPU's plain version."""
    model, X = _gbdt_model(base_score=0.5)
    X = np.concatenate([X, X])[:B]
    packed = model.packed()
    before = dict(ops.LAUNCHES)
    proba = packed.predict_proba(X, cuda)
    p_long = model.predict_p_long(X, device=cuda)
    assert ops.LAUNCHES["gbdt_margins_packed"] == \
        before["gbdt_margins_packed"] + 2
    assert ops.LAUNCHES["gbdt_margins"] == before["gbdt_margins"]
    np.testing.assert_allclose(proba, packed.predict_proba(X, "cpu"),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_long, model.predict_p_long(X, device="cpu"),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(packed.predict_p_long(X, device=cuda), p_long,
                               atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_real_engine_generate_batch_on_card_equals_generate(cuda):
    """The serial engine's batch API on the card: each request's tokens
    equal its own ``generate`` call's, scalar and per-request budgets."""
    cfg = get_config("smollm-360m").reduced()
    eng = RealEngine(cfg, max_len=64, segment_len=4, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 11, 23, 7)]
    for maxes in (9, [10, 25, 6, 18]):
        per = [maxes] * 4 if np.isscalar(maxes) else maxes
        before = ops.LAUNCHES["flash_attention"]
        outs = eng.generate_batch(prompts, max_new_tokens=maxes)
        assert ops.LAUNCHES["flash_attention"] - before == \
            4 * cfg.num_layers
        for out, ids, m in zip(outs, prompts, per):
            assert out["tokens"] == \
                eng.generate(ids, max_new_tokens=m)["tokens"]


# ------------------------------------------- K1/K3 at head widths 128, 256
#: the wide heads: jamba-v0.1-52b's, llama-3.2-vision-90b's and
#: gemma3-4b-edge's (H, KV, hd)
WIDE_HEADS = [(32, 8, 128), (64, 8, 128), (8, 4, 256)]


def _attn_inputs(cuda, seed, B, Sq, Skv, H, KV, hd, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 32, 45, 300, 512])
@pytest.mark.parametrize("H,KV,hd", WIDE_HEADS)
def test_wgmma_flash_kernel_matches_plain_with_lse(cuda, S, H, KV, hd):
    """K3's wgmma kernel (bf16, hd 128 / 256) at the serving buckets, an
    exact length and a ragged multi-chunk length: output within 2e-2 of
    the plain version, lse within 1e-3, the output bitwise unchanged by
    asking for the lse and by a second launch."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q, k, v = _attn_inputs(cuda, S + hd, 1, S, S, H, KV, hd)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, return_lse=True)
    _close(o, want, torch.bfloat16)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)
    assert torch.equal(o, flash_attention_cuda(q, k, v))
    assert torch.equal(o, flash_attention_cuda(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(1, 1024), (45, 1024), (16, 1024),
                                    (7, 300), (130, 64)])
@pytest.mark.parametrize("H,KV,hd", [(64, 8, 128), (8, 4, 256)])
def test_wgmma_flash_kernel_cross_lengths(cuda, Sq, Skv, H, KV, hd):
    """K3's wgmma kernel non-causal at Sq != Skv (the vision
    cross-attention's Sq 1 / 16 / 45 over 1024 image rows, split over a
    cluster of 4 blocks), with its lse, against the plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q, k, v = _attn_inputs(cuda, Sq * 7 + Skv, 1, Sq, Skv, H, KV, hd)
    o, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, causal=False,
                                           return_lse=True)
    _close(o, want, torch.bfloat16)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix,suffix", [(48, 16), (64, 64), (200, 100),
                                           (256, 48), (500, 24), (700, 330)])
@pytest.mark.parametrize("H,KV,hd", WIDE_HEADS)
def test_wgmma_flash_extend_equals_cold_bitwise(cuda, prefix, suffix, H, KV,
                                                hd):
    """Extend rows (q_offset over a longer, padded key buffer) equal the
    cold prefill's rows bit for bit at hd 128 and 256, across chunk
    boundaries (256 keys) and whether the call was split over a cluster
    or not; and within 2e-2 of the plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    n = prefix + suffix
    qf, k, v = _attn_inputs(cuda, prefix + suffix, 1, n, n + 40, H, KV, hd)
    q = qf[:, prefix:]
    got = flash_attention_cuda(q, k, v, q_offset=prefix)
    _close(got, flash_attention_plain(q, k, v, q_offset=prefix),
           torch.bfloat16)
    cold = flash_attention_cuda(qf, k[:, :n].contiguous(),
                                v[:, :n].contiguous())
    assert torch.equal(cold[:, prefix:], got)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", WIDE_HEADS)
def test_wgmma_split_and_whole_walk_give_the_same_bits(cuda, H, KV, hd):
    """Rows 584..599 of a 2100-token causal prefill (9 chunks: one block
    walks every chunk of its row tile and folds them in its shared
    memory) equal the same rows as an extend over their 600 keys (3
    chunks on a small grid: split over a cluster of 3 blocks, rank 0
    folding the others' partials) bit for bit, output and lse; and a
    1600-row extend over the whole buffer equals the cold rows."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_launch_plan)
    q, k, v = _attn_inputs(cuda, H + hd, 1, 2100, 2100, H, KV, hd)
    assert flash_launch_plan(1, 2100, 2100, H, KV, hd)[1] == 1
    assert flash_launch_plan(1, 16, 600, H, KV, hd, q_offset=584)[1] == 3
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    part, part_lse = flash_attention_cuda(
        q[:, 584:600], k[:, :600].contiguous(), v[:, :600].contiguous(),
        q_offset=584, return_lse=True)
    assert torch.equal(part, o[:, 584:600])
    assert torch.equal(part_lse, lse[:, :, 584:600])
    ext = flash_attention_cuda(q[:, 500:], k, v, q_offset=500)
    assert torch.equal(ext, o[:, 500:])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 128, 512])
@pytest.mark.parametrize("H,KV,hd",
                         [(64, 8, 128), (8, 4, 256)] + GROUP_HEADS)
def test_tensor_core_decode_lanes_equal_scalar_t_and_paged(cuda, S, H, KV,
                                                           hd):
    """K1's tensor-core body (bf16, G <= 8, hd 128 / 256) with (B,) fill
    levels on both sides of every split boundary: each lane equals its
    scalar-t launch bit for bit, two launches are bitwise equal, the
    batch is within 2e-2 of plain, and K2 through a shuffled block table
    equals K1 on the same logical window bit for bit."""
    B, page = 4, 16
    g = torch.Generator(device=cuda).manual_seed(S + H + hd)
    edges = _split_edges(S)
    levels = edges + edges[:(-len(edges)) % B]
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    P = -(-S // page)
    for i in range(0, len(levels), B):
        t = torch.tensor(levels[i:i + B], dtype=torch.int32, device=cuda)
        got = ops.decode_attention(q, k, v, t)
        assert torch.equal(got, ops.decode_attention(q, k, v, t))
        _close(got, ops.decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                         t.cpu()), torch.bfloat16)
        for b in range(B):
            solo = ops.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        t[b:b + 1])
            assert torch.equal(solo[0], got[b]), (levels[i + b], b)
        if S % page:
            continue
        perm = torch.randperm(B * P, generator=g, device=cuda) + 1
        pk = torch.full((B * P + 1, page, KV, hd), 1e4, device=cuda).bfloat16()
        pv = torch.full_like(pk, -1e4)
        pk[perm] = k.reshape(B * P, page, KV, hd)
        pv[perm] = v.reshape(B * P, page, KV, hd)
        bt = perm.view(B, P).to(torch.int32)
        paged = ops.paged_decode_attention(q, pk, pv, bt, t)
        assert torch.equal(paged, got)


@pytest.mark.cuda
def test_wide_attention_kernels_do_not_spill(cuda, tmp_path, monkeypatch):
    """The bf16 instances at head widths 128 and 256 -- K3's wgmma kernel
    (hd 128 with one and with two consumer warpgroups, hd 256, and hd 64
    for ungrouped heads) and K1/K2's tensor-core body (hd 128 and 256) --
    are built and compile with no register spills, as
    ``_build.PTXAS_REPORT`` shows after a fresh build."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    names = ("flash_attention", "decode_attention", "paged_decode_attention")
    _build.build(names)
    for name, kernel, count in zip(
            names, ("flash_wgmma_kernel", "decode_tc_kernel",
                    "decode_tc_kernel"), (4, 2, 2)):
        entries = [e for e in _build.PTXAS_REPORT[name].split(
            "Compiling entry function '")[1:] if kernel in e.split("'")[0]]
        assert len(entries) == count, name
        for e in entries:
            assert "0 bytes spill stores, 0 bytes spill loads" in e, e


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 7, 16, 32, 45, 96, 512])
@pytest.mark.parametrize("H,KV,hd", SERVED_HEADS)
def test_flash_kernel_at_served_heads(cuda, dtype, S, H, KV, hd):
    """K3 causal at the serving buckets and at exact prompt lengths (a
    MoE stack prefills unbucketed): at G 8 over one KV head of width 256
    (the wgmma body in bf16) and at G 5, whose 64-row tiles cut a
    position's heads apart."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn(1, S, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    _close(got, want.transpose(1, 2), dtype)

