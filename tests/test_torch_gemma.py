"""gemma3-4b-edge, the paper's own backend, through the port's engines
against the JAX package's: greedy tokens from the serial ``RealEngine``,
the ring lanes (``BatchedRealEngine``) and the block-paged lanes
(``PagedBatchedEngine``) on the JAX engines' weights, on the prompts and
budgets of tests/test_generate.py, tests/test_batching.py and
tests/test_paging.py.

Two configs: ``gemma3-4b-edge.reduced()`` (GeGLU, RoPE theta 1e6, head
width 16) and a copy with the full config's head width 256.  Float32 on
the CPU; tokens are compared exactly (logits are held at 1e-5 by
tests/test_torch_model.py)."""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import PagedBatchedEngine as JPaged
from repro.serving.engine import RealEngine as JEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import (BatchedRealEngine, PagedBatchedEngine,
                                       RealEngine)

CONFIGS = {"gemma3": {}, "gemma3-hd256": {"head_dim": 256}}


def _cfgs(name):
    over = CONFIGS[name]
    return (dataclasses.replace(get_config("gemma3-4b-edge").reduced(),
                                **over),
            dataclasses.replace(port_config("gemma3-4b-edge").reduced(),
                                **over))


def _sd(jeng, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jeng.params), tcfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serial_engine_tokens_match_jax(name):
    """tests/test_generate.py's engine (max_len 96, segment 8) and
    prompt lengths: the port's fused tokens == the JAX engine's == the
    port's per-token oracle."""
    jcfg, tcfg = _cfgs(name)
    jeng = JEngine(jcfg, max_len=96, segment_len=8)
    eng = RealEngine(tcfg, state_dict=_sd(jeng, tcfg), max_len=96,
                     segment_len=8, device="cpu")
    for plen in (1, 8, 33, 64):
        ids = np.random.default_rng(plen).integers(0, 512, plen)
        want = jeng.generate(ids, max_new_tokens=24)["tokens"]
        got = eng.generate(ids, max_new_tokens=24)["tokens"]
        assert got == want, plen
        assert got == eng.generate_reference(ids, 24)["tokens"], plen


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ring_lanes_tokens_match_jax(name):
    """tests/test_batching.py's lane engine (max_len 64, segment 4, 3
    lanes) and back-fill workload: every sequence == the JAX lane
    engine's."""
    jcfg, tcfg = _cfgs(name)
    jeng = JBatched(jcfg, max_len=64, segment_len=4, n_lanes=3, seed=0)
    eng = BatchedRealEngine(tcfg, state_dict=_sd(jeng, tcfg), max_len=64,
                            segment_len=4, n_lanes=3, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (5, 11, 23, 7, 3, 15, 9)]
    maxes = [10, 25, 6, 18, 4, 12, 9]
    want = [r["tokens"] for r in jeng.generate_batch(prompts, maxes)]
    assert [r["tokens"] for r in eng.generate_batch(prompts, maxes)] == want
    assert eng.lane_manager.stats["backfills"] == 4


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_lanes_tokens_match_jax(name):
    """tests/test_paging.py's paged engine (max_len 64, segment 4, 3
    lanes, page 8) and workload: every sequence == the JAX paged
    engine's, and the pool drains clean."""
    jcfg, tcfg = _cfgs(name)
    jeng = JPaged(jcfg, max_len=64, segment_len=4, n_lanes=3, seed=0,
                  page_size=8)
    eng = PagedBatchedEngine(tcfg, state_dict=_sd(jeng, tcfg), max_len=64,
                             segment_len=4, n_lanes=3, page_size=8,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, size=n).astype(np.int64)
               for n in (5, 17, 9, 23, 3, 12)]
    maxes = [20, 8, 30, 12, 25, 16]
    want = [r["tokens"] for r in jeng.generate_batch(prompts, maxes)]
    assert [r["tokens"] for r in eng.generate_batch(prompts, maxes)] == want
    eng.allocator.reset_transient()
    assert eng.allocator.used_pages == 0
    eng.allocator.check()
