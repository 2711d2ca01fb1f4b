"""One-shot sweep grids over the queueing simulation (paper §5.4/§5.5);
a copy of ``repro.core.sweep`` (imports renamed), whose ``backend="jax"``
branch becomes ``backend="torch"``.

Every end-to-end number in the paper is a grid — policy x tau for Table 9,
policy x rho x seed for Fig. 3, policy x workload x run for Table 8.  The
seed benchmarks walked those grids cell by cell through the per-object
simulator; this module runs a whole grid through the vectorized engine
(``core.sim_fast``) in ONE call:

    from repro_torch.core.sweep import sweep_poisson
    res = sweep_poisson(
        conditions=[("fcfs", None), ("sjf", 10.5), ("sjf", None)],
        rhos=(0.5, 0.74), seeds=range(5), n=2000, short=S, long=L)
    res.metric("short_p50")          # (C, R, S) ndarray
    res.metric("short_p50").mean(-1) # seed-averaged (C, R)

Workloads are generated once per (rho, seed) cell — vectorized, no Request
objects — and shared across all conditions (paired comparison, as the seed
benchmarks did via deepcopy).  Backends: ``auto`` (compiled C engine,
stdlib-heapq fallback) and ``torch`` (every cell advancing together as
(G, n) tensors, ``core.sim_torch``) for running the per-cell axis on the
card; ``device`` is read by ``torch`` only (default: the card).

Conditions are policy specs: registry names ("fcfs", "srpt", ...) or
``core.policy.Policy`` instances for custom parameters.  Preemptive
policies (srpt / mlfq) are routed row-wise to the preemptive host engine
(``sim_fast.simulate_grid_preempt``); key-based rows run on the requested
backend, so one grid can mix both.

``sweep_lanes`` / ``sweep_lane_batches`` add the batch-degree axis:
policy x decode-lane count x KV-memory budget through the c-server
engine (``sim_fast.simulate_grid_servers``) with a calibrated per-lane
slowdown — the grid that decomposes how much of the scheduling
win bounded-concurrency batching recovers by itself.

``run_grid`` is the non-DES counterpart used by the accuracy-table
benchmarks (model x feature-group, model x baseline): one call evaluates
a cartesian grid of cells and returns the keyed results.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import Policy, get_policy
from repro_torch.core.sim_fast import (RequestBatch, simulate_grid,
                                 simulate_grid_preempt,
                                 simulate_grid_servers)

#: A sweep condition: (policy spec, tau).  The policy spec is a registry
#: name ("fcfs", "sjf", "srpt", ...) or a Policy instance (for custom
#: parameters, e.g. ``QuantileSJF(z=2.0)``); SweepResult indexes
#: conditions by the resolved policy name.
Condition = Tuple[object, Optional[float]]       # (policy spec, tau)

METRICS = ("short_p50", "short_p95", "short_p99", "long_p50", "long_p95",
           "long_p99", "mean_sojourn", "mean_wait", "promotions", "makespan")


@dataclass
class SweepResult:
    """Metric arrays over a conditions x rhos x seeds grid."""

    conditions: Tuple[Condition, ...]
    rhos: Tuple[float, ...]
    seeds: Tuple[int, ...]
    metrics: Dict[str, np.ndarray]               # each (C, R, S)

    def metric(self, name: str) -> np.ndarray:
        return self.metrics[name]

    def condition_index(self, policy: str, tau: Optional[float]) -> int:
        return self.conditions.index((policy, tau))


def _percentile_metrics(start: np.ndarray, finish: np.ndarray,
                        promotions: int, arrival: np.ndarray,
                        short_mask: np.ndarray,
                        long_mask: np.ndarray) -> Tuple[float, ...]:
    sojourn = finish - arrival
    wait = start - arrival
    s, l = sojourn[short_mask], sojourn[long_mask]

    def pct(v, q):
        return float(np.percentile(v, q)) if v.size else float("nan")

    return (pct(s, 50), pct(s, 95), pct(s, 99),
            pct(l, 50), pct(l, 95), pct(l, 99),
            float(sojourn.mean()), float(wait.mean()),
            float(promotions), float(finish.max()))


def sweep_batches(batches: Sequence[RequestBatch],
                  conditions: Sequence[Condition],
                  backend: str = "auto", return_arrays: bool = False,
                  device=None):
    """Simulate every (condition, batch) cell in one engine call.

    Returns ``{metric: (C, B) ndarray}``.  All batches must have equal
    length (stacked into one (C*B, n) grid).  With ``return_arrays``,
    additionally returns ``(arrival, klass, start, finish, promoted)`` as
    (C*B, n) arrays (row ``c * B + g``, each row in its batch's
    arrival-sorted order) for callers that pool raw sojourns across cells.
    """
    C, B = len(conditions), len(batches)
    n = len(batches[0])
    assert all(len(b) == n for b in batches), "batches must be same length"
    policies = [get_policy(p) for p, _ in conditions]

    # sort each batch once; reuse the sorted arrays for every condition
    sorted_cols = []
    for b in batches:
        perm = np.lexsort((b.req_id, b.arrival))
        sorted_cols.append((b.arrival[perm], b.true_service[perm],
                            b.p_long[perm], b.klass[perm], b.tenant[perm],
                            b.tenants))

    arrival = np.empty((C * B, n))
    service = np.empty((C * B, n))
    key = np.empty((C * B, n))
    quanta = np.full((C * B, n), np.inf)
    taus: List[Optional[float]] = []
    modes = np.zeros(C * B, np.int8)
    for c, ((_, tau), pol) in enumerate(zip(conditions, policies)):
        for g, (arr, svc, pl, _, tc, tn) in enumerate(sorted_cols):
            row = c * B + g
            arrival[row] = arr
            service[row] = svc
            key[row] = pol.key_array(arr, pl, svc, tenant=tc, tenants=tn)
            taus.append(pol.aging.effective_tau(tau))
            modes[row] = pol.mode
            if pol.preemptive:
                q = pol.quantum_array(arr, pl, svc)
                if q is not None:
                    quanta[row] = q

    # preemptive rows run on the host preemptive engine; key-based rows on
    # the requested backend (the torch grid engine is non-preemptive)
    pre = modes != 0
    start = np.empty((C * B, n))
    finish = np.empty((C * B, n))
    promoted = np.zeros((C * B, n), bool)
    promotions = np.zeros(C * B, np.int64)
    if (~pre).any():
        rows = np.flatnonzero(~pre)
        taus_np = [taus[r] for r in rows]
        if backend == "torch":
            from repro_torch.core.sim_torch import simulate_grid_torch
            s, f, pr, pm = simulate_grid_torch(
                arrival[rows], service[rows], key[rows], taus_np,
                device=device)
        else:
            s, f, pr, pm = simulate_grid(
                arrival[rows], service[rows], key[rows], taus_np,
                engine=backend)
        start[rows], finish[rows], promoted[rows] = s, f, pr
        promotions[rows] = pm
    if pre.any():
        rows = np.flatnonzero(pre)
        s, f, pr, pm, _ = simulate_grid_preempt(
            arrival[rows], service[rows], key[rows],
            [taus[r] for r in rows], modes[rows], quanta[rows],
            engine="auto" if backend == "torch" else backend)
        start[rows], finish[rows], promoted[rows] = s, f, pr
        promotions[rows] = pm

    from repro_torch.core.sim_fast import _KLASS_CODE
    out = {m: np.empty((C, B)) for m in METRICS}
    for c in range(C):
        for g in range(B):
            row = c * B + g
            klass = sorted_cols[g][3]
            vals = _percentile_metrics(
                start[row], finish[row], int(promotions[row]),
                arrival[row], klass == _KLASS_CODE["short"],
                klass == _KLASS_CODE["long"])
            for m, v in zip(METRICS, vals):
                out[m][c, g] = v
    if return_arrays:
        klass = np.tile(np.stack([cols[3] for cols in sorted_cols]),
                        (C, 1))
        return out, (arrival, klass, start, finish, promoted)
    return out


def sweep_poisson(conditions: Sequence[Condition], rhos: Sequence[float],
                  seeds: Sequence[int], n: int, short, long,
                  mix_long: float = 0.5,
                  backend: str = "auto", device=None) -> SweepResult:
    """The paper's steady-state grid: conditions x rhos x seeds, one call.

    ``rho = lam * E[S]`` fixes the arrival rate per rho; one workload per
    (rho, seed) is shared across all conditions.
    """
    specs = tuple((p, t) for p, t in conditions)
    conditions = tuple((get_policy(p).name, t) for p, t in specs)
    rhos = tuple(float(r) for r in rhos)
    seeds = tuple(int(s) for s in seeds)
    es = mix_long * long.mean + (1.0 - mix_long) * short.mean
    batches = []
    for rho in rhos:
        lam = rho / es
        for seed in seeds:
            rng = np.random.default_rng(seed)
            batches.append(RequestBatch.poisson(rng, n, lam, short, long,
                                                mix_long=mix_long))
    flat = sweep_batches(batches, specs, backend=backend, device=device)
    C, R, S = len(conditions), len(rhos), len(seeds)
    return SweepResult(conditions=conditions, rhos=rhos, seeds=seeds,
                       metrics={m: v.reshape(C, R, S)
                                for m, v in flat.items()})


def sweep_burst(conditions: Sequence[Condition], seeds: Sequence[int],
                n_short: int, n_long: int, short, long,
                window: float = 0.05,
                backend: str = "auto", device=None) -> SweepResult:
    """The §5.5 burst grid: all requests arrive within ``window``."""
    specs = tuple((p, t) for p, t in conditions)
    conditions = tuple((get_policy(p).name, t) for p, t in specs)
    seeds = tuple(int(s) for s in seeds)
    batches = [RequestBatch.burst(np.random.default_rng(s), n_short, n_long,
                                  short, long, window=window)
               for s in seeds]
    flat = sweep_batches(batches, specs, backend=backend, device=device)
    C, S = len(conditions), len(seeds)
    return SweepResult(conditions=conditions, rhos=(float("nan"),),
                       seeds=seeds,
                       metrics={m: v.reshape(C, 1, S)
                                for m, v in flat.items()})


#: Named per-request acceptance-rate generators for ``sweep_speculative``:
#: name -> fn(rng, n) returning (n,) draft-acceptance rates in [0, 1).
ACCEPT_DISTS = {
    "high": lambda rng, n: np.full(n, 0.9),
    "low": lambda rng, n: np.full(n, 0.2),
    "uniform": lambda rng, n: rng.uniform(0.05, 0.95, n),
    "bimodal": lambda rng, n: np.where(rng.random(n) < 0.5, 0.9, 0.1),
}


@dataclass
class SpeculativeSweepResult:
    """Metric arrays over a conditions x draft-K x acceptance x seeds grid."""

    conditions: Tuple[Condition, ...]
    draft_ks: Tuple[int, ...]
    accept_dists: Tuple[str, ...]
    seeds: Tuple[int, ...]
    metrics: Dict[str, np.ndarray]               # each (C, K, A, S)

    def metric(self, name: str) -> np.ndarray:
        return self.metrics[name]

    def condition_index(self, policy: str, tau: Optional[float]) -> int:
        return self.conditions.index((policy, tau))


def sweep_speculative(conditions: Sequence[Condition],
                      draft_ks: Sequence[int],
                      accept_dists: Sequence,
                      seeds: Sequence[int], n: int, short, long,
                      mix_long: float = 0.5, rho: float = 0.85,
                      draft_cost: float = 0.15,
                      backend: str = "auto",
                      device=None) -> SpeculativeSweepResult:
    """The speculative-decoding grid: policy x draft-K x acceptance x seed.

    Mirrors draft-verify decode in the DES as a per-request service-rate
    modifier (``sim_fast.speculative_service``): one Poisson workload per
    seed (rho fixes the arrival rate against the *serial* mean service)
    is shared across every (policy, K, acceptance) cell; each cell scales
    services by ``1 / expected_speedup(accept_rate, K)`` with acceptance
    rates drawn from the named generator (:data:`ACCEPT_DISTS`, or pass
    ``(name, fn)`` pairs).  Acceptance-aware policies (``sjf_effective``)
    receive the per-request rates through ``key_array``; plain policies
    key as usual — the grid that shows when acceptance-aware admission
    beats token-count SJF (heterogeneous acceptance) and when it
    degenerates to it (uniform acceptance).  ``draft_k = 0`` cells are
    the unmodified serial grid.  Key-based policies only.
    """
    from repro_torch.core.sim_fast import _KLASS_CODE, speculative_service
    specs = tuple((p, t) for p, t in conditions)
    policies = [get_policy(p) for p, _ in specs]
    for pol in policies:
        if pol.preemptive:
            raise ValueError(
                f"sweep_speculative supports key-based policies only, "
                f"got preemptive {pol.name!r}")
    conds = tuple((pol.name, t) for pol, (_, t) in zip(policies, specs))
    draft_ks = tuple(int(k) for k in draft_ks)
    dists = [(d, ACCEPT_DISTS[d]) if isinstance(d, str) else (d[0], d[1])
             for d in accept_dists]
    names = tuple(name for name, _ in dists)
    seeds = tuple(int(s) for s in seeds)
    C, K, A, S = len(conds), len(draft_ks), len(dists), len(seeds)

    es = mix_long * long.mean + (1.0 - mix_long) * short.mean
    lam = rho / es
    base = []                        # per seed: arrival-sorted columns
    for seed in seeds:
        rng = np.random.default_rng(seed)
        b = RequestBatch.poisson(rng, n, lam, short, long,
                                 mix_long=mix_long)
        perm = np.lexsort((b.req_id, b.arrival))
        base.append((b.arrival[perm], b.true_service[perm], b.p_long[perm],
                     b.klass[perm], b.tenant[perm], b.tenants))
    accept = {}                      # (ai, si) -> (n,) acceptance rates
    for ai, (_, fn) in enumerate(dists):
        for si, seed in enumerate(seeds):
            accept[ai, si] = np.clip(
                np.asarray(fn(np.random.default_rng((seed, 7919 + ai)), n),
                           np.float64), 0.0, 1.0)

    R = C * K * A * S
    arrival = np.empty((R, n))
    service = np.empty((R, n))
    key = np.empty((R, n))
    taus: List[Optional[float]] = []
    from dataclasses import replace as _replace

    from repro_torch.core.policy import EffectiveSJF
    for c, (pol, (_, tau)) in enumerate(zip(policies, specs)):
        for ki, k in enumerate(draft_ks):
            # acceptance-aware policies must key against the cell's
            # actual draft depth/cost, not their registry defaults (at
            # K=0 the key degenerates to plain predicted service)
            pol_k = _replace(pol, draft_k=k, draft_cost=draft_cost) \
                if isinstance(pol, EffectiveSJF) else pol
            for ai in range(A):
                for si in range(S):
                    row = ((c * K + ki) * A + ai) * S + si
                    arr, svc, pl, _, tc, tn = base[si]
                    a = accept[ai, si]
                    eff = speculative_service(svc, a, k, draft_cost)
                    arrival[row] = arr
                    service[row] = eff
                    try:
                        key[row] = pol_k.key_array(
                            arr, pl, eff, tenant=tc, tenants=tn,
                            accept_rate=a)
                    except TypeError:      # acceptance-unaware policy
                        key[row] = pol_k.key_array(arr, pl, eff,
                                                   tenant=tc, tenants=tn)
                    taus.append(pol.aging.effective_tau(tau))

    if backend == "torch":
        from repro_torch.core.sim_torch import simulate_grid_torch
        start, finish, _, promotions = simulate_grid_torch(
            arrival, service, key, taus, device=device)
    else:
        start, finish, _, promotions = simulate_grid(
            arrival, service, key, taus, engine=backend)

    out = {m: np.empty((C, K, A, S)) for m in METRICS}
    for c in range(C):
        for ki in range(K):
            for ai in range(A):
                for si in range(S):
                    row = ((c * K + ki) * A + ai) * S + si
                    klass = base[si][3]
                    vals = _percentile_metrics(
                        start[row], finish[row], int(promotions[row]),
                        arrival[row], klass == _KLASS_CODE["short"],
                        klass == _KLASS_CODE["long"])
                    for m, v in zip(METRICS, vals):
                        out[m][c, ki, ai, si] = v
    return SpeculativeSweepResult(conditions=conds, draft_ks=draft_ks,
                                  accept_dists=names, seeds=seeds,
                                  metrics=out)


@dataclass
class LaneSweepResult:
    """Metric arrays over a conditions x lanes x budgets x seeds grid."""

    conditions: Tuple[Condition, ...]
    lanes: Tuple[int, ...]
    budgets: Tuple[Optional[float], ...]
    seeds: Tuple[int, ...]
    metrics: Dict[str, np.ndarray]               # each (C, L, B, S)

    def metric(self, name: str) -> np.ndarray:
        return self.metrics[name]


def sweep_lanes(conditions: Sequence[Condition], lanes: Sequence[int],
                seeds: Sequence[int], n: int, rho: float, short, long,
                mix_long: float = 0.5, slowdown=None,
                budgets: Sequence[Optional[float]] = (None,),
                mem_tokens_per_s: float = 60.0) -> LaneSweepResult:
    """The batch-degree grid: policy x lane-count x KV-budget x seed,
    answering "how much of the scheduling win does batching recover, and
    what does predictive admission still add on top" in one call.

    * ``lanes``: decode-lane counts c (c=1 rows are bitwise-equal to the
      serial engine for key policies, so the existing sweeps anchor the
      grid);
    * ``slowdown``: per-lane service stretch ``s[k-1]`` at k busy lanes,
      covering at least ``max(lanes)`` entries (calibrate from the real
      engine — ``benchmarks/batching_bench.py`` measures it); default
      ideal scaling;
    * ``budgets``: KV-memory budgets in *memory tokens* (None =
      lane-limited only).  A request's demand is its KV residency proxy
      ``true_service x mem_tokens_per_s`` (service seconds x decode
      rate ~ output tokens pinned in cache).

    One workload per seed at the given ``rho`` is shared across every
    (condition, c, budget) cell — paired comparisons, like
    :func:`sweep_poisson`.  Conditions may mix key-based policies and
    srpt; quantum policies (mlfq) are rejected by the c-server engine.
    """
    specs = tuple((p, t) for p, t in conditions)
    named = tuple((get_policy(p).name, t) for p, t in specs)
    lanes = tuple(int(c) for c in lanes)
    budgets = tuple(budgets)
    seeds = tuple(int(s) for s in seeds)
    es = mix_long * long.mean + (1.0 - mix_long) * short.mean
    lam = rho / es
    batches = [RequestBatch.poisson(np.random.default_rng(s), n, lam,
                                    short, long, mix_long=mix_long)
               for s in seeds]
    out = sweep_lane_batches(batches, specs, lanes, budgets=budgets,
                             slowdown=slowdown,
                             mem_tokens_per_s=mem_tokens_per_s)
    return LaneSweepResult(conditions=named, lanes=lanes, budgets=budgets,
                           seeds=seeds, metrics=out)


def sweep_lane_batches(batches: Sequence[RequestBatch],
                       conditions: Sequence[Condition],
                       lanes: Sequence[int],
                       budgets: Sequence[Optional[float]] = (None,),
                       slowdown=None,
                       mem_tokens_per_s: float = 60.0) -> Dict[str, np.ndarray]:
    """Batch-level core of :func:`sweep_lanes` (the analogue of
    :func:`sweep_batches`): callers that prepare their own workloads —
    e.g. to inject noisy predictor scores — pass them directly.

    Returns ``{metric: (C, L, B, G) ndarray}`` over conditions x lanes x
    budgets x batches.
    """
    policies = [get_policy(p) for p, _ in conditions]
    lanes = tuple(int(c) for c in lanes)
    budgets = tuple(budgets)
    if slowdown is None:
        slowdown = (1.0,) * max(lanes)
    slowdown = tuple(float(x) for x in slowdown)
    C, G = len(conditions), len(batches)
    n = len(batches[0])
    assert all(len(b) == n for b in batches), "batches must be same length"

    sorted_cols = []
    for b in batches:
        perm = np.lexsort((b.req_id, b.arrival))
        sorted_cols.append((b.arrival[perm], b.true_service[perm],
                            b.p_long[perm], b.klass[perm], b.tenant[perm],
                            b.tenants))

    arrival = np.empty((C * G, n))
    service = np.empty((C * G, n))
    key = np.empty((C * G, n))
    mem = np.empty((C * G, n))
    taus: List[Optional[float]] = []
    modes = np.zeros(C * G, np.int8)
    for c_i, ((_, tau), pol) in enumerate(zip(conditions, policies)):
        for g, (arr, svc, pl, _, tc, tn) in enumerate(sorted_cols):
            row = c_i * G + g
            arrival[row] = arr
            service[row] = svc
            key[row] = pol.key_array(arr, pl, svc, tenant=tc, tenants=tn)
            mem[row] = svc * mem_tokens_per_s
            taus.append(pol.aging.effective_tau(tau))
            modes[row] = pol.mode

    from repro_torch.core.sim_fast import _KLASS_CODE
    out = {m: np.empty((C, len(lanes), len(budgets), G)) for m in METRICS}
    for li, c in enumerate(lanes):
        for bi, budget in enumerate(budgets):
            start, finish, _, promotions, _ = simulate_grid_servers(
                arrival, service, key, taus, c, slowdown=slowdown[:c],
                mem=None if budget is None else mem,
                mem_budget=budget, mode=modes)
            for c_i in range(C):
                for g in range(G):
                    row = c_i * G + g
                    klass = sorted_cols[g][3]
                    vals = _percentile_metrics(
                        start[row], finish[row], int(promotions[row]),
                        arrival[row], klass == _KLASS_CODE["short"],
                        klass == _KLASS_CODE["long"])
                    for m, v in zip(METRICS, vals):
                        out[m][c_i, li, bi, g] = v
    return out


@dataclass
class PagingSweepResult:
    """Metric arrays over conditions x page-size x budget x share x seed."""

    conditions: Tuple[Condition, ...]
    page_sizes: Tuple[int, ...]
    budgets: Tuple[float, ...]                   # memory tokens
    share_ratios: Tuple[float, ...]
    seeds: Tuple[int, ...]
    metrics: Dict[str, np.ndarray]               # each (C, P, B, R, S)

    def metric(self, name: str) -> np.ndarray:
        return self.metrics[name]


PAGING_METRICS = METRICS + ("preemptions", "prefix_hits", "peak_pages")


def sweep_paging(conditions: Sequence[Condition],
                 page_sizes: Sequence[int], budgets: Sequence[float],
                 share_ratios: Sequence[float], seeds: Sequence[int],
                 n: int, rho: float, short, long, mix_long: float = 0.5,
                 n_servers: int = 4, slowdown=None,
                 mem_tokens_per_s: float = 60.0, prompt_frac: float = 0.35,
                 shared_tokens: Optional[float] = None,
                 prefill_s_per_token: float = 5e-4) -> PagingSweepResult:
    """The block-paged memory grid: policy x page-size x byte-budget x
    prefix-share-ratio through the paged c-server engine
    (``sim_fast.simulate_grid_paged``), answering how much sojourn the
    page-granular accounting recovers at a FIXED budget, and how page
    size and prefix sharing move it.

    * ``page_sizes`` x ``budgets``: the pool is ``budget // page_size``
      pages — the same memory-token budget sliced at different
      granularities (big pages waste more of the last partial page;
      the DES's linear-growth model shows the admission-level effect);
    * ``share_ratios``: each request independently shares a fixed
      ``shared_tokens``-token system prefix with probability r.  Warm
      admissions skip those pages and ``shared_tokens x
      prefill_s_per_token`` seconds of prefill;
    * request memory: total residency ``true_service x
      mem_tokens_per_s`` tokens, of which ``prompt_frac`` is prompt
      (admission-time) and the rest decode growth.  ``shared_tokens``
      defaults to half the mean prompt.

    One workload per seed is shared across every cell (paired).
    Returns metric arrays ``(C, P, B, R, S)``; beyond the standard
    sojourn metrics: ``preemptions`` (pool-exhaustion pageouts),
    ``prefix_hits`` (warm admissions) and ``peak_pages``.
    """
    from repro_torch.core.sim_fast import _KLASS_CODE, simulate_grid_paged
    specs = tuple((p, t) for p, t in conditions)
    named = tuple((get_policy(p).name, t) for p, t in specs)
    policies = [get_policy(p) for p, _ in specs]
    page_sizes = tuple(int(p) for p in page_sizes)
    budgets = tuple(float(b) for b in budgets)
    share_ratios = tuple(float(r) for r in share_ratios)
    seeds = tuple(int(s) for s in seeds)
    if slowdown is None:
        slowdown = (1.0,) * int(n_servers)
    es = mix_long * long.mean + (1.0 - mix_long) * short.mean
    lam = rho / es
    if shared_tokens is None:
        shared_tokens = 0.5 * prompt_frac * es * mem_tokens_per_s
    C, G = len(specs), len(seeds)

    arrival = np.empty((C * G, n))
    service = np.empty((C * G, n))
    key = np.empty((C * G, n))
    total_tok = np.empty((C * G, n))
    prompt_tok = np.empty((C * G, n))
    taus: List[Optional[float]] = []
    modes = np.zeros(C * G, np.int8)
    klasses = []
    shared_mask = {}                 # seed index -> per-ratio request mask
    for g, s in enumerate(seeds):
        rng = np.random.default_rng(s)
        b = RequestBatch.poisson(rng, n, lam, short, long,
                                 mix_long=mix_long)
        perm = np.lexsort((b.req_id, b.arrival))
        arr, svc = b.arrival[perm], b.true_service[perm]
        pl, tc, tn = b.p_long[perm], b.tenant[perm], b.tenants
        klasses.append(b.klass[perm])
        # one uniform draw per request, thresholded per ratio: raising r
        # only ADDS shared requests (nested masks, cleaner trends)
        u = rng.random(n)
        shared_mask[g] = {r: u < r for r in share_ratios}
        tot = svc * mem_tokens_per_s
        for c_i, ((_, tau), pol) in enumerate(zip(specs, policies)):
            row = c_i * G + g
            arrival[row] = arr
            service[row] = svc
            key[row] = pol.key_array(arr, pl, svc, tenant=tc, tenants=tn)
            total_tok[row] = tot
            prompt_tok[row] = prompt_frac * tot
            taus.append(pol.aging.effective_tau(tau))
            modes[row] = pol.mode

    shape = (C, len(page_sizes), len(budgets), len(share_ratios), G)
    out = {m: np.empty(shape) for m in PAGING_METRICS}
    for ri, ratio in enumerate(share_ratios):
        grp = np.full((C * G, n), -1, np.int64)
        shared = np.zeros((C * G, n))
        saved = np.zeros((C * G, n))
        ptok = prompt_tok.copy()
        ttok = total_tok.copy()
        for g in range(G):
            m = shared_mask[g][ratio]
            for c_i in range(C):
                row = c_i * G + g
                grp[row, m] = 0                      # one system prefix
                shared[row, m] = shared_tokens
                saved[row, m] = shared_tokens * prefill_s_per_token
                ptok[row, m] += shared_tokens        # prefix + private
                ttok[row, m] += shared_tokens
        for pi, ps in enumerate(page_sizes):
            for bi, budget in enumerate(budgets):
                n_pages = max(1, int(budget // ps))
                (start, finish, _, promotions, preempts, hits,
                 peak) = simulate_grid_paged(
                    arrival, service, key, taus, n_servers,
                    -(-ptok // ps), -(-ttok // ps), n_pages,
                    slowdown=slowdown, mode=modes, share_group=grp,
                    shared_pages=shared // ps,
                    prefill_saved=saved)
                for c_i in range(C):
                    for g in range(G):
                        row = c_i * G + g
                        klass = klasses[g]
                        vals = _percentile_metrics(
                            start[row], finish[row], int(promotions[row]),
                            arrival[row],
                            klass == _KLASS_CODE["short"],
                            klass == _KLASS_CODE["long"])
                        cell = (c_i, pi, bi, ri, g)
                        for m, v in zip(METRICS, vals):
                            out[m][cell] = v
                        out["preemptions"][cell] = float(preempts[row])
                        out["prefix_hits"][cell] = float(hits[row])
                        out["peak_pages"][cell] = float(peak[row])
    return PagingSweepResult(conditions=named, page_sizes=page_sizes,
                             budgets=budgets, share_ratios=share_ratios,
                             seeds=seeds, metrics=out)


def run_grid(axes: Dict[str, Sequence], fn: Callable) -> Dict[tuple, object]:
    """Evaluate ``fn(**point)`` over the cartesian product of ``axes``.

    The non-DES grid helper: the accuracy tables (model x feature-group,
    model x baseline) run their whole grid through one call and get back
    ``{(v1, v2, ...): fn_result}`` keyed in axis order.
    """
    names = list(axes)
    return {combo: fn(**dict(zip(names, combo)))
            for combo in itertools.product(*(axes[k] for k in names))}


# ---------------------------------------------------------------------------
# Fault-injection grid: conditions x crash-MTBF x repair x seeds.
# ---------------------------------------------------------------------------

FAULT_METRICS = METRICS + ("goodput", "shed_rate", "timeout_rate",
                           "requeues")


@dataclass
class FaultSweepResult:
    """Metric arrays over a conditions x mtbfs x repairs x seeds grid.

    ``mtbf = inf`` rows are the no-fault baseline (and are bitwise
    trace-equal to the clean engines).  Latency metrics aggregate served
    requests only; ``goodput`` is served requests per unit makespan,
    ``shed_rate`` the pre-dispatch shed fraction, ``timeout_rate`` the
    in-service deadline-expiry fraction (always 0 unless the sweep ran
    with ``in_service_timeout=True``), ``requeues`` crash-requeue count.
    """

    conditions: Tuple[Condition, ...]
    mtbfs: Tuple[float, ...]
    repairs: Tuple[float, ...]
    seeds: Tuple[int, ...]
    metrics: Dict[str, np.ndarray]               # each (C, F, R, S)

    def metric(self, name: str) -> np.ndarray:
        return self.metrics[name]

    def condition_index(self, policy: str, tau) -> int:
        return self.conditions.index((policy, tau))


def sweep_faults(conditions: Sequence[Condition], mtbfs: Sequence[float],
                 repairs: Sequence[float], seeds: Sequence[int],
                 n: int, short, long, rho: float = 0.7,
                 mix_long: float = 0.5, deadline: Optional[float] = None,
                 in_service_timeout: bool = False,
                 stall_mtbf: float = 0.0, stall_s: float = 10.0,
                 stall_factor: float = 2.0,
                 batches: Optional[Sequence[RequestBatch]] = None
                 ) -> FaultSweepResult:
    """The robustness grid: does the scheduling win survive faults?

    One Poisson workload per seed is shared across every condition and
    every fault cell; one fault timeline per (mtbf, repair, seed) cell is
    shared across all conditions — fully paired comparisons on both axes.
    ``mtbf = inf`` (or 0) disables crashes for that column, giving the
    in-grid no-fault baseline.  Key-based conditions only (the fault
    engine is non-preemptive).  ``batches`` (one per seed) overrides the
    internal Poisson generation — use for noisy-predictor workloads.
    """
    from repro_torch.core.sim_fast import ServerFaults, simulate_grid_faults
    specs = tuple((p, t) for p, t in conditions)
    policies = [get_policy(p) for p, _ in specs]
    if any(p.preemptive for p in policies):
        raise ValueError("sweep_faults supports key-based policies only")
    conditions = tuple((p.name, t) for p, (_, t) in zip(policies, specs))
    mtbfs = tuple(float(m) for m in mtbfs)
    repairs = tuple(float(r) for r in repairs)
    seeds = tuple(int(s) for s in seeds)
    C, F, R, S = len(conditions), len(mtbfs), len(repairs), len(seeds)

    es = mix_long * long.mean + (1.0 - mix_long) * short.mean
    lam = rho / es
    if batches is not None and len(batches) != S:
        raise ValueError(f"need one batch per seed ({S})")
    cols = []
    for si, seed in enumerate(seeds):
        if batches is not None:
            b = batches[si]
        else:
            rng = np.random.default_rng(seed)
            b = RequestBatch.poisson(rng, n, lam, short, long,
                                     mix_long=mix_long)
        perm = np.lexsort((b.req_id, b.arrival))
        cols.append((b.arrival[perm], b.true_service[perm],
                     b.p_long[perm], b.klass[perm], b.tenant[perm],
                     b.tenants))

    # one timeline per (mtbf, repair, seed) — horizon covers the busy
    # period with slack for repair-time queue growth
    timelines = {}
    for fi, mtbf in enumerate(mtbfs):
        for ri, rep in enumerate(repairs):
            for si, seed in enumerate(seeds):
                horizon = float(cols[si][0][-1]) + 20.0 * es
                rng = np.random.default_rng((seed, fi, ri, 7))
                eff = 0.0 if not np.isfinite(mtbf) else mtbf
                timelines[fi, ri, si] = ServerFaults.random(
                    rng, horizon, mtbf=eff, mttr=rep,
                    stall_mtbf=stall_mtbf, stall_s=stall_s,
                    stall_factor=stall_factor)

    G = C * F * R * S
    n = cols[0][0].shape[0]           # batches may override the target n
    arrival = np.empty((G, n))
    service = np.empty((G, n))
    key = np.empty((G, n))
    taus: List[Optional[float]] = []
    faults = []
    for c, ((_, tau), pol) in enumerate(zip(specs, policies)):
        for fi in range(F):
            for ri in range(R):
                for si in range(S):
                    row = ((c * F + fi) * R + ri) * S + si
                    arr, svc, pl, _, tc, tn = cols[si]
                    arrival[row] = arr
                    service[row] = svc
                    key[row] = pol.key_array(arr, pl, svc, tenant=tc,
                                             tenants=tn)
                    taus.append(pol.aging.effective_tau(tau))
                    faults.append(timelines[fi, ri, si])
    start, finish, promoted, promotions, shed, timeout, requeues = \
        simulate_grid_faults(arrival, service, key, taus, faults,
                             deadline=deadline,
                             in_service_timeout=in_service_timeout)

    from repro_torch.core.sim_fast import _KLASS_CODE
    out = {m: np.empty((C, F, R, S)) for m in FAULT_METRICS}
    for c in range(C):
        for fi in range(F):
            for ri in range(R):
                for si in range(S):
                    row = ((c * F + fi) * R + ri) * S + si
                    klass = cols[si][3]
                    ok = ~shed[row] & ~timeout[row]
                    vals = _percentile_metrics(
                        start[row][ok], finish[row][ok],
                        int(promotions[row]), arrival[row][ok],
                        (klass == _KLASS_CODE["short"])[ok],
                        (klass == _KLASS_CODE["long"])[ok])
                    mk = float(finish[row][ok].max()) if ok.any() else 0.0
                    vals = vals[:-1] + (mk,)
                    for m, v in zip(METRICS, vals):
                        out[m][c, fi, ri, si] = v
                    out["goodput"][c, fi, ri, si] = \
                        (ok.sum() / mk) if mk > 0 else 0.0
                    out["shed_rate"][c, fi, ri, si] = shed[row].mean()
                    out["timeout_rate"][c, fi, ri, si] = \
                        timeout[row].mean()
                    out["requeues"][c, fi, ri, si] = requeues[row]
    return FaultSweepResult(conditions=conditions, mtbfs=mtbfs,
                            repairs=repairs, seeds=seeds, metrics=out)
