"""The block-paged KV engine in the port against the JAX package: K2's
plain version against ``paged_decode_attention_ref`` and the Pallas
kernel in interpret mode, the allocator and paged lane manager driven
through the same seeded op sequence, one paged decode step of the LM, and
``PagedBatchedEngine`` (greedy tokens equal to the JAX paged engine's, to
the port's ring lanes and to its serial oracle, with back-fill,
tight-pool growth preemption and prefix reuse within and across drains),
plus the server's paged drain order.

Float32 on the CPU in both packages (TF32 does not exist there).
Tolerances: kernels 2e-5 in float32 and 2e-2 in bfloat16 (as in
tests/test_paging.py); logits 1e-4 and pools 1e-5 (as in
tests/test_torch_model.py).  Tokens, page states and dispatch order are
compared exactly.  Inputs are drawn with numpy and handed to both.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.decode_attention import paged_decode_attention_kernel
from repro.kernels.ref import paged_decode_attention_ref as jpaged_ref
from repro.models.model import LM as JLM
from repro.serving import paging as jpaging
from repro.serving.engine import PagedBatchedEngine as JPaged
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.server import ClairvoyantServer as JServer
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops, ref
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM, PagedKVCache
from repro_torch.serving import paging
from repro_torch.serving.engine import BatchedRealEngine, PagedBatchedEngine
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("B,KV,G,hd,ps,P", [(3, 2, 4, 64, 16, 4),
                                            (2, 1, 8, 32, 8, 6),
                                            (4, 5, 3, 64, 16, 8),
                                            # gemma3-4b-edge's heads
                                            (4, 4, 2, 256, 16, 4)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_plain_matches_jax_ref_and_pallas(B, KV, G, hd, ps, P, dtype):
    """The port's plain K2 (kernel layout and the engine-layout ``ops``
    wrapper) == the JAX gather oracle == the Pallas kernel in interpret
    mode (on the serving heads of smollm-360m and gemma3-4b-edge;
    tests/test_paging.py holds it to the ref on its own shapes), with
    unallocated table slots on a poisoned trash page and one lane past
    its window."""
    rng = np.random.default_rng(B * 7 + ps)
    n_pages = B * P + 1
    qn = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kn = rng.normal(size=(n_pages, KV, ps, hd)).astype(np.float32)
    vn = rng.normal(size=(n_pages, KV, ps, hd)).astype(np.float32)
    kn[0], vn[0] = 1e4, -1e4                   # poison the trash page
    bt = rng.permutation(np.arange(1, n_pages))[:B * P] \
        .reshape(B, P).astype(np.int32)
    t = rng.integers(0, P * ps, size=B).astype(np.int32)
    t[-1] = P * ps + 5                         # a stopped lane, past it
    for b in range(B - 1):
        bt[b, [p for p in range(P) if p * ps > t[b]]] = 0
    jdt, tdt = DTYPES[dtype]
    qj, kj, vj = (jnp.asarray(x, jdt) for x in (qn, kn, vn))
    want = [jpaged_ref(qj, kj, vj, jnp.asarray(bt), jnp.asarray(t))]
    if KV in (4, 5):  # test_paging.py holds Pallas to ref on the others
        want.append(paged_decode_attention_kernel(qj, kj, vj, bt, t,
                                                  interpret=True))
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (qn, kn, vn))
    btt, tt = torch.from_numpy(bt), torch.from_numpy(t)
    got = ref.paged_decode_attention_ref(qt, kt, vt, btt, tt)
    # engine layout: pools (n_pages, page, KV, hd), q (B, 1, H, hd)
    got_ops = ops.paged_decode_attention(
        qt.reshape(B, 1, KV * G, hd), kt.transpose(1, 2).contiguous(),
        vt.transpose(1, 2).contiguous(), btt, tt)
    for g in (got, got_ops.reshape(B, KV, G, hd)):
        for w in want:
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       **_tol(dtype))


def test_paged_plain_equals_ring_plain_bitwise():
    """Same logical contents through the block table and through a ring:
    the paged plain version equals the ring plain version bit for bit
    (the CPU side of the paged == ring lanes contract)."""
    rng = np.random.default_rng(2)
    B, KV, G, hd, ps, P = 4, 5, 3, 16, 8, 8
    pool_k = torch.from_numpy(rng.normal(size=(B * P + 1, ps, KV, hd))
                              .astype(np.float32))
    pool_v = torch.from_numpy(rng.normal(size=(B * P + 1, ps, KV, hd))
                              .astype(np.float32))
    bt = torch.from_numpy(rng.permutation(np.arange(1, B * P + 1))
                          .reshape(B, P).astype(np.int32))
    t = torch.tensor([0, 9, 63, 70], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(B, 1, KV * G, hd))
                         .astype(np.float32))
    ring_k = pool_k[bt.long()].reshape(B, P * ps, KV, hd)
    ring_v = pool_v[bt.long()].reshape(B, P * ps, KV, hd)
    assert torch.equal(ops.paged_decode_attention(q, pool_k, pool_v, bt, t),
                       ops.decode_attention(q, ring_k, ring_v, t))


# ------------------------------------------------- allocator, lane manager
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_manager_fuzz_match_jax(seed):
    """The chaos fuzz of tests/test_paging.py driven through both
    packages' BlockAllocator/PagedLaneManager with the same ops: equal
    refcounts, free and LRU lists, prefix index, lane pages and stats
    after every op, and the invariants hold."""
    rng = np.random.default_rng(seed)
    N_PAGES, PS, LANES, CAP = 24, 4, 4, 32
    pairs = [(m.BlockAllocator(N_PAGES, PS), m) for m in (paging, jpaging)]
    mgrs = [m.PagedLaneManager(LANES, al, bytes_per_token=1, capacity=CAP)
            for al, m in pairs]
    ids_by_lane, rid = {}, 0

    def both(fn):
        outs = []
        for i, (al, _) in enumerate(pairs):
            try:
                outs.append(("ok", fn(al, mgrs[i])))
            except paging.PageError:
                outs.append(("PageError", None))
            except jpaging.PageError:
                outs.append(("PageError", None))
        assert outs[0][0] == outs[1][0]
        return outs[0]

    for _ in range(500):
        op = int(rng.integers(0, 8))
        free = [ln for ln in range(LANES) if mgrs[0].lanes[ln] is None]
        busy = mgrs[0].busy_lanes()
        assert busy == mgrs[1].busy_lanes()
        if op <= 2 and free:
            lane = int(rng.choice(free))
            n = int(rng.integers(1, CAP + 1))
            ids = rng.integers(0, 3, size=n).tolist()
            mx = int(rng.integers(1, 16))
            rid += 1
            assert mgrs[0].can_admit(n, mx, ids=ids) == \
                mgrs[1].can_admit(n, mx, ids=ids)
            status, _ = both(lambda al, m: m.admit(
                lane, req_id=rid, prompt_len=n, max_new=mx, ids=ids))
            if status == "ok":
                ids_by_lane[lane] = ids
        elif op == 3 and busy:
            lane = int(rng.choice(busy))
            reg = rng.random() < 0.7
            both(lambda al, m: (reg and m.register_prompt(
                lane, ids_by_lane[lane]), m.retire(lane)))
        elif op == 4 and busy:
            lane = int(rng.choice(busy))
            both(lambda al, m: m.evict(lane))
        elif op == 5 and busy:
            lane = int(rng.choice(busy))
            both(lambda al, m: m.preempt(lane))
        elif op == 6 and busy:
            lane = int(rng.choice(busy))
            need = len(mgrs[0].lanes[lane].pages) + int(rng.integers(1, 4))
            assert both(lambda al, m: m.grow(lane, need)) in \
                (("ok", True), ("ok", False))
        elif op == 7 and rng.random() < 0.3:
            drop = rng.random() < 0.5
            for i, (al, m) in enumerate(pairs):
                al.reset_transient()
                if drop:
                    al.drop_cache()
                mgrs[i] = m.PagedLaneManager(LANES, al, bytes_per_token=1,
                                             capacity=CAP)
            ids_by_lane.clear()
        (a, _), (b, _) = pairs
        a.check()
        assert a.refcount == b.refcount
        assert list(a._free) == list(b._free)
        assert list(a._lru.items()) == list(b._lru.items())
        assert a._table == b._table and a.stats == b.stats
        assert [s and s.pages for s in mgrs[0].lanes] == \
            [s and s.pages for s in mgrs[1].lanes]
        assert mgrs[0].stats == mgrs[1].stats


def test_pages_for_and_chain_hashes_match_jax():
    ids = list(range(37))
    for ps in (4, 8, 16):
        assert paging.chain_hashes(ids, ps) == jpaging.chain_hashes(ids, ps)
        for n in (0, 1, ps, ps + 1, 37):
            assert paging.pages_for(n, ps) == jpaging.pages_for(n, ps)


# ------------------------------------------------------- paged decode step
def test_paged_decode_step_matches_jax():
    """One decode step over a filled paged cache (a lane past its window
    included): logits, both pools and the fill levels as in the JAX LM."""
    cfg = get_config("smollm-360m").reduced()
    jlm = JLM(cfg)
    params = jlm.init(jax.random.key(5))
    tcfg = port_config("smollm-360m").reduced()
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg))
    rng = np.random.default_rng(1)
    B, max_len, ps = 3, 64, 8
    P, n_pages = max_len // ps, 3 * (max_len // ps) + 1
    shape = (tcfg.num_layers, n_pages, ps, tcfg.num_kv_heads, tcfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P) \
        .astype(np.int32)
    t = np.array([5, 40, max_len + 3], np.int32)
    toks = rng.integers(0, 512, (B, 1))
    jc = ({"k": jnp.asarray(k), "v": jnp.asarray(v),
           "t": jnp.asarray(t)[None], "bt": jnp.asarray(bt)[None]},)
    jl, jc = jax.jit(jlm.decode_step)(
        params, jc, {"tokens": jnp.asarray(toks, jnp.int32)})
    tc = PagedKVCache(k=torch.from_numpy(k.copy()),
                      v=torch.from_numpy(v.copy()),
                      bt=torch.from_numpy(bt), t=torch.from_numpy(t.copy()))
    tl = lm.decode_step(tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc[0]["k"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc[0]["v"]),
                               atol=1e-5, rtol=1e-5)
    assert tc.t.tolist() == np.asarray(jc[0]["t"])[0].tolist()
    # the past-window lane wrote the trash page, nothing else
    moved = np.nonzero(np.any(tc.k.numpy() != k, axis=(0, 2, 3, 4)))[0]
    assert sorted(moved) == sorted({0, int(bt[0, 0]), int(bt[1, 5])})


# ------------------------------------------------------ PagedBatchedEngine
@pytest.fixture(scope="module")
def engines():
    """The JAX ring and paged lane engines of tests/test_paging.py
    (max_len 64, segment 4, 3 lanes, page 8) and the port's twins on the
    same weights."""
    cfg = get_config("smollm-360m").reduced()
    jpaged = JPaged(cfg, max_len=64, segment_len=4, n_lanes=3, seed=0,
                    page_size=8)
    tcfg = port_config("smollm-360m").reduced()
    sd = params_from_jax(jax.tree.map(np.asarray, jpaged.params), tcfg)
    ring = BatchedRealEngine(tcfg, state_dict=sd, max_len=64, segment_len=4,
                             n_lanes=3, device="cpu")
    paged = PagedBatchedEngine(tcfg, state_dict=sd, max_len=64,
                               segment_len=4, n_lanes=3, page_size=8,
                               device="cpu")
    return jpaged, ring, paged, sd


def _prompts(rng, sizes):
    return [rng.integers(1, 512, size=n).astype(np.int64) for n in sizes]


PROMPT_SIZES, MAXES = (5, 17, 9, 23, 3, 12), [20, 8, 30, 12, 25, 16]


@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_paged_backfill_equals_ring_serial_and_jax(engines, page_size):
    """Roomy pool, 6 requests through 3 lanes: every sequence equals the
    port's ring lanes, its serial oracle and (page 8) the JAX paged
    engine; the pool drains clean."""
    jpaged, ring, paged, sd = engines
    if page_size != 8:
        paged = PagedBatchedEngine(ring.cfg, state_dict=sd, max_len=64,
                                   segment_len=4, n_lanes=3,
                                   page_size=page_size, device="cpu")
    prompts = _prompts(np.random.default_rng(0), PROMPT_SIZES)
    want = [ring.generate_reference(p, m)["tokens"]
            for p, m in zip(prompts, MAXES)]
    res = paged.generate_batch(prompts, MAXES)
    assert [r["tokens"] for r in res] == want
    assert [r["tokens"] for r in ring.generate_batch(prompts, MAXES)] == want
    if page_size == 8:
        assert [r["tokens"] for r in jpaged.generate_batch(
            prompts, MAXES)] == want
    paged.allocator.reset_transient()
    assert paged.allocator.used_pages == 0
    paged.allocator.check()


def test_tight_pool_preemption_matches_jax(engines):
    """A 10-page pool: growth preemption fires, resumed requests keep
    their tokens, and the preemption count, page stats and dead steps
    equal the JAX engine's."""
    jpaged, ring, _, sd = engines
    bpt = ring._bytes_per_token
    tight = PagedBatchedEngine(ring.cfg, state_dict=sd, max_len=64,
                               segment_len=4, n_lanes=3, page_size=8,
                               budget_bytes=10 * 8 * bpt, device="cpu")
    jtight = JPaged(jpaged.cfg, params=jpaged.params, max_len=64,
                    segment_len=4, n_lanes=3, seed=0, page_size=8,
                    budget_bytes=10 * 8 * bpt)
    assert tight.n_pages == jtight.n_pages == 10
    prompts = _prompts(np.random.default_rng(0), PROMPT_SIZES)
    want = [r["tokens"] for r in jtight.generate_batch(prompts, MAXES)]
    res = tight.generate_batch(prompts, MAXES)
    assert [r["tokens"] for r in res] == want
    assert want == [ring.generate_reference(p, m)["tokens"]
                    for p, m in zip(prompts, MAXES)]
    st = tight.lane_manager.stats
    assert st["preemptions"] >= 1
    assert st == jtight.lane_manager.stats
    assert tight.allocator.stats == jtight.allocator.stats
    terminals = st["retired"] + st["evictions"] + st["preemptions"]
    assert 0 <= tight.dead_steps <= terminals * (tight.segment_len - 1)
    tight.allocator.reset_transient()
    assert tight.allocator.used_pages == 0
    tight.allocator.check()


def test_prefix_reuse_within_and_across_drains_matches_jax(engines):
    """Four prompts share a 24-token system prompt: warm admissions take
    the extend prefill (K3 with q_offset) within a drain and, from the
    LRU cache, across drains; tokens equal the cold serial oracle and the
    JAX engine, and the prefix-hit counts equal the JAX allocator's."""
    jpaged, ring, paged, _ = engines
    rng = np.random.default_rng(7)
    sys_p = rng.integers(1, 512, size=24).astype(np.int64)
    share = [np.concatenate([sys_p, rng.integers(1, 512, size=k)])
             for k in (4, 6, 3, 5)]
    want = [ring.generate_reference(p, 10)["tokens"] for p in share]
    hits = []
    for _ in range(2):
        s0, j0 = dict(paged.allocator.stats), dict(jpaged.allocator.stats)
        assert [r["tokens"] for r in paged.generate_batch(share, 10)] == want
        assert [r["tokens"] for r in jpaged.generate_batch(share, 10)] == \
            want
        hits.append(paged.allocator.stats["prefix_hit_pages"]
                    - s0["prefix_hit_pages"])
        assert hits[-1] == jpaged.allocator.stats["prefix_hit_pages"] \
            - j0["prefix_hit_pages"]
    assert 0 < hits[0] < hits[1]
    assert paged.engine_stats()["prefix_hits"] > 0
    paged.allocator.check()


def test_prefix_plus_tight_pool_loses_nothing(engines):
    """Shared-prefix prompts under a 9-page pool: preempt/resume cycles
    with deferred heads, no lost request, tokens equal to the serial
    oracle and the JAX engine."""
    jpaged, ring, _, sd = engines
    rng = np.random.default_rng(5)
    bpt = ring._bytes_per_token
    eng = PagedBatchedEngine(ring.cfg, state_dict=sd, max_len=64,
                             segment_len=4, n_lanes=4, page_size=8,
                             budget_bytes=9 * 8 * bpt, device="cpu")
    jeng = JPaged(jpaged.cfg, params=jpaged.params, max_len=64,
                  segment_len=4, n_lanes=4, seed=0, page_size=8,
                  budget_bytes=9 * 8 * bpt)
    prefix = rng.integers(1, 512, size=24).astype(np.int64)
    maxes = [32, 32, 6, 6, 6, 6, 32, 6]
    prompts = [np.concatenate([prefix, rng.integers(1, 512, size=8)])
               for _ in maxes]
    res = eng.generate_batch(prompts, maxes)
    want = [ring.generate_reference(p, m)["tokens"]
            for p, m in zip(prompts, maxes)]
    assert [r["tokens"] for r in res] == want
    assert [r["tokens"] for r in jeng.generate_batch(prompts, maxes)] == want
    assert eng.lane_manager.stats == jeng.lane_manager.stats
    eng.allocator.reset_transient()
    assert eng.allocator.used_pages == 0
    eng.allocator.check()


def test_paged_server_drain_order_matches_jax(engines):
    """sjf_oracle over a head-of-line backlog with one paged lane: the
    port's server dispatches in the JAX server's order, [2, 4, 3, 1]."""
    jpaged, _, _, sd = engines
    toks = [40, 4, 30, 6]
    orders = []
    for srv_cls, req_cls, eng in (
            (JServer, JCompletion,
             JPaged(jpaged.cfg, params=jpaged.params, max_len=64,
                    segment_len=4, n_lanes=1, seed=0, page_size=8)),
            (ClairvoyantServer, CompletionRequest,
             PagedBatchedEngine(port_config("smollm-360m").reduced(),
                                state_dict=sd, max_len=64, segment_len=4,
                                n_lanes=1, page_size=8, device="cpu"))):
        server = srv_cls(policy="sjf_oracle", tau=None, engines=[eng])
        server.submit_many([req_cls(prompt="p %d" % i) for i in range(4)],
                           true_output_tokens=toks,
                           klasses=["long", "short", "long", "short"])
        resp = server.drain(max_new_tokens=40)
        assert all(r.status == "ok" for r in resp)
        orders.append(([r.request_id for r in resp],
                       [r.tokens_generated for r in resp]))
    assert orders[0] == orders[1]
    assert orders[1][0] == [2, 4, 3, 1]
