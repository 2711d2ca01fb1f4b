"""LM training data pipeline: deterministic synthetic token streams with
sharded, prefetching batch iteration.

A copy of ``repro.data.lm_data`` (numpy only): the port imports nothing of
the JAX package, and ``batch(step)`` gives the same arrays bit for bit.

The stream is an order-k Markov chain over the vocabulary seeded per shard —
learnable structure (a real LM's loss visibly decreases) without any corpus
on disk.  The loader yields host-local shards of the global batch given
(host_index, host_count), the same contract a 1000-node data pipeline needs:
every host computes its slice of the same deterministic stream, no
coordination traffic.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    branching: int = 8      # candidate successors per state (lower = easier)


class SyntheticLMStream:
    """Deterministic markov token stream, shardable by (host, n_hosts)."""

    def __init__(self, cfg: LMDataConfig, host_index: int = 0,
                 host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        rng = np.random.default_rng(cfg.seed)
        # successor table: state -> branching candidate next tokens
        self._succ = rng.integers(
            0, cfg.vocab_size, (cfg.vocab_size, cfg.branching), dtype=np.int32)

    def batch(self, step: int) -> dict:
        """The host-local slice of global batch ``step`` (pure function of
        (seed, step, host) — restart/elastic-resume safe)."""
        cfg = self.cfg
        rows = np.arange(self.local_batch) + self.host_index * self.local_batch
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) % (2 ** 63))
        starts = rng.integers(0, cfg.vocab_size, cfg.global_batch)
        picks = rng.integers(0, cfg.branching,
                             (cfg.global_batch, cfg.seq_len + 1))
        toks = np.zeros((self.local_batch, cfg.seq_len + 1), np.int32)
        cur = starts[rows].astype(np.int32)
        for t in range(cfg.seq_len + 1):
            toks[:, t] = cur
            cur = self._succ[cur, picks[rows, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PrefetchLoader:
    """Background-thread prefetch (compute/IO overlap on the host side)."""

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 depth: int = 2):
        self.stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self.stream.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
