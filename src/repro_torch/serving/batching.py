"""KV-budgeted continuous micro-batching: bounded-concurrency decode lanes
(a copy of ``repro.serving.batching``; the port imports nothing of the JAX
package).

* :class:`KVBudget` -- a bytes accountant.  The worst-case KV footprint of
  a request is ``tokens x bytes_per_token(cfg)`` where ``tokens`` is the
  ring-buffer capacity the request can actually fill
  (``min(max_len, prompt_len + max_new)``) and ``bytes_per_token`` is the
  per-position cache cost across the whole stack (K+V x layers x
  kv_heads x head_dim x dtype).  Admission *reserves* the worst case up
  front; retirement releases it.
* :class:`LaneManager` -- lane occupancy + admission.  The policy-ordered
  queue head is admitted into a free lane only when its worst-case
  footprint fits the remaining budget; a head that does not fit **blocks
  admission** (strict policy order -- no smaller request may bypass it).
  Per-lane state tracks the request, its prompt length, tokens produced,
  tenant, and eviction count; retired lanes release their reservation and
  are back-filled by the engine via a fresh prefill into the vacant cache
  slot.

The real-decode side lives in ``serving.generate.LaneDecoder`` (the
stacked-cache segment loop) and ``serving.engine.BatchedRealEngine`` (the
admission/retire/back-fill orchestration).  The code below the imports is
the JAX package's, line for line.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.configs.base import ATTN, ATTN_MOE

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def kv_bytes_per_token(cfg) -> int:
    """Worst-case KV-cache bytes one sequence position costs across the
    stack: K+V entries for every attention layer.  Recurrent blocks
    (SSM/xLSTM) hold O(1) state per lane and contribute nothing per
    token; their fixed cost rides in the per-lane base term."""
    dt = _DTYPE_BYTES.get(cfg.dtype, 4)
    n_attn = sum(k in (ATTN, ATTN_MOE) for k in cfg.block_pattern)
    return 2 * n_attn * cfg.pattern_repeats * cfg.num_kv_heads \
        * cfg.head_dim * dt


class KVBudget:
    """Byte accountant for concurrent KV caches.

    ``total_bytes`` is the box's KV-memory budget; :meth:`reserve` admits
    a worst-case footprint, :meth:`release` returns it.  ``peak_bytes``
    records the high-water mark for reporting.
    """

    def __init__(self, total_bytes: int):
        if total_bytes <= 0:
            raise ValueError(f"budget must be positive, got {total_bytes}")
        self.total_bytes = int(total_bytes)
        self.used_bytes = 0
        self.peak_bytes = 0

    @classmethod
    def from_config(cls, cfg, capacity: int, n_lanes: int) -> "KVBudget":
        """The budget that exactly fits ``n_lanes`` full ring buffers of
        ``capacity`` slots — the default when the caller gives a lane
        count instead of a byte budget."""
        return cls(max(1, n_lanes * capacity * kv_bytes_per_token(cfg)))

    @property
    def available_bytes(self) -> int:
        return self.total_bytes - self.used_bytes

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.available_bytes

    def reserve(self, nbytes: int) -> None:
        if not self.fits(nbytes):
            raise ValueError(
                f"KV budget exceeded: want {nbytes}, "
                f"available {self.available_bytes} of {self.total_bytes}")
        self.used_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def release(self, nbytes: int) -> None:
        self.used_bytes = max(0, self.used_bytes - int(nbytes))


@dataclass
class LaneState:
    """One decode lane's live request."""

    lane: int
    req_id: int = -1
    prompt_len: int = 0
    max_new: int = 0
    produced: int = 0              # tokens emitted incl. the prefill token
    tenant: str = "default"
    footprint_bytes: int = 0       # budget reservation held by this lane
    evictions: int = 0             # times this lane's request was evicted
    admit_t: float = 0.0           # wall/virtual admission time
    ttft_s: float = 0.0
    tokens: List[int] = field(default_factory=list)
    meta: dict = field(default_factory=dict)
    # block-paged mode (serving/paging.py): physical pages owned by this
    # lane, and how many leading prompt tokens were satisfied from the
    # prefix cache (0 under worst-case ring accounting)
    pages: List[int] = field(default_factory=list)
    prefix_len: int = 0
    # speculative decoding (serving/generate.py): draft positions proposed
    # for this lane and how many of them the target verified and accepted
    drafted: int = 0
    accepted: int = 0

    @property
    def accept_rate(self) -> Optional[float]:
        """Observed draft acceptance rate, None before any draft ran."""
        return self.accepted / self.drafted if self.drafted else None


class LaneManager:
    """Occupancy + memory-aware admission over ``n_lanes`` decode lanes.

    The manager owns *bookkeeping only* — which lane holds which request
    and how many bytes each reservation pinned; the engine owns the
    caches and the segment loop.  That split keeps the admission rule
    testable without a model.
    """

    def __init__(self, n_lanes: int, budget: KVBudget,
                 bytes_per_token: int, capacity: int):
        if n_lanes < 1:
            raise ValueError(f"need >= 1 lane, got {n_lanes}")
        self.n_lanes = n_lanes
        self.budget = budget
        self.bytes_per_token = int(bytes_per_token)
        self.capacity = int(capacity)
        self.lanes: List[Optional[LaneState]] = [None] * n_lanes
        self.stats = {"admitted": 0, "retired": 0, "backfills": 0,
                      "evictions": 0, "blocked_on_budget": 0}

    # ------------------------------------------------------------- occupancy
    def free_lanes(self) -> List[int]:
        return [i for i, s in enumerate(self.lanes) if s is None]

    def busy_lanes(self) -> List[int]:
        return [i for i, s in enumerate(self.lanes) if s is not None]

    def lane_of(self, req_id: int) -> Optional[int]:
        for i, s in enumerate(self.lanes):
            if s is not None and s.req_id == req_id:
                return i
        return None

    # -------------------------------------------------------------- admission
    def footprint(self, prompt_len: int, max_new: int) -> int:
        """Worst-case KV bytes: the ring slots this request can fill."""
        tokens = min(self.capacity, int(prompt_len) + int(max_new))
        return tokens * self.bytes_per_token

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Fits the remaining budget?  The degenerate case — an idle
        manager whose head exceeds even the EMPTY budget — admits anyway:
        the request must run eventually and a serial backend would have
        run it, so memory pressure may serialize but never deadlock."""
        need = self.footprint(prompt_len, max_new)
        if self.budget.fits(need):
            return True
        return self.budget.used_bytes == 0

    def admit(self, lane: int, *, req_id: int, prompt_len: int,
              max_new: int, tenant: str = "default", admit_t: float = 0.0,
              meta: Optional[dict] = None, backfill: bool = False
              ) -> LaneState:
        if self.lanes[lane] is not None:
            raise ValueError(f"lane {lane} is occupied")
        need = self.footprint(prompt_len, max_new)
        if not self.budget.fits(need):
            if self.budget.used_bytes:
                raise ValueError(
                    f"admit over budget: want {need}, "
                    f"available {self.budget.available_bytes}")
            need = self.budget.available_bytes   # oversized head, idle box
        self.budget.reserve(need)
        st = LaneState(lane=lane, req_id=req_id, prompt_len=int(prompt_len),
                       max_new=int(max_new), tenant=tenant,
                       footprint_bytes=need, admit_t=admit_t,
                       meta=dict(meta or {}))
        self.lanes[lane] = st
        self.stats["admitted"] += 1
        if backfill:
            self.stats["backfills"] += 1
        return st

    def retire(self, lane: int) -> LaneState:
        st = self.lanes[lane]
        if st is None:
            raise ValueError(f"lane {lane} is already free")
        self.lanes[lane] = None
        self.budget.release(st.footprint_bytes)
        self.stats["retired"] += 1
        return st

    def evict(self, lane: int) -> LaneState:
        """Take a running request off its lane mid-flight (disconnect or
        preemption at a segment boundary).  The returned state carries
        the generated prefix so the caller can resume it later by
        re-prefilling prompt + prefix (the PR-4 resume machinery)."""
        st = self.retire(lane)
        st.evictions += 1
        self.stats["evictions"] += 1
        self.stats["retired"] -= 1       # an eviction is not a completion
        return st
