"""The port's sweep grids (``core.sweep``) and its grid DES on the device
(``core.sim_torch``) against the JAX package.

* Every ``sweep_*`` and ``run_grid`` of the port gives the JAX module's
  metrics on the same seeds with the host engines (``backend="auto"``):
  both are numpy copies over bit-equal DES engines, so arrays are
  compared exactly (NaN where a class is empty, in both).
* ``simulate_grid_torch`` on the CPU: in float64 its start, finish,
  promoted and promotions equal the port's host engine bit for bit; in
  float32 its dispatch order and promotions equal ``simulate_grid_jax``'s
  (JAX's default mode) and the per-request reference simulator's, with
  times within float32 tolerance (rtol 1e-5, atol 1e-4, as
  tests/test_simulation.py holds the JAX engine).
* ``backend="torch"`` (here with ``device="cpu"``) equals
  ``backend="auto"`` bit for bit, preemptive rows going to the host
  preemptive engine and only key-based rows to the grid DES.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import numpy as np
import pytest
import torch

from repro.core import sweep as jsweep
from repro.core.sim_jax import simulate_grid_jax
from repro.core.simulation import ServiceDist as JDist
from repro_torch.core import sim_torch, sweep
from repro_torch.core.scheduler import Request
from repro_torch.core.sim_fast import (RequestBatch, dispatch_key,
                                       simulate_grid)
from repro_torch.core.simulation import ServiceDist, simulate_reference
from repro_torch.core.sim_torch import simulate_grid_torch

S, L = ServiceDist(3.5, 0.8), ServiceDist(8.9, 2.0)
JS, JL = JDist(3.5, 0.8), JDist(8.9, 2.0)


def _assert_metrics_equal(got, want):
    assert sorted(got) == sorted(want)
    for m in want:
        np.testing.assert_array_equal(np.asarray(got[m]),
                                      np.asarray(want[m]), err_msg=m)


def _batches(seeds, n=120, lam=0.2):
    return [RequestBatch.poisson(np.random.default_rng(s), n, lam, S, L)
            for s in seeds]


def _jbatches(seeds, n=120, lam=0.2):
    from repro.core.sim_fast import RequestBatch as JBatch
    return [JBatch.poisson(np.random.default_rng(s), n, lam, JS, JL)
            for s in seeds]


CONDS = [("fcfs", None), ("sjf", 10.5), ("sjf", None), ("srpt", None),
         ("sjf_oracle", 5.0)]

# (name, port call, JAX call) -> a metrics dict; each a few hundred cells
SWEEPS = {
    "poisson": lambda m, d, l: m.sweep_poisson(
        CONDS, rhos=(0.5, 0.85), seeds=range(3), n=150, short=d, long=l),
    "burst": lambda m, d, l: m.sweep_burst(
        [("fcfs", None), ("sjf", None), ("sjf_oracle", None)], seeds=range(3),
        n_short=30, n_long=30, short=d, long=l),
    "speculative": lambda m, d, l: m.sweep_speculative(
        [("sjf", None), ("sjf_effective", None)], draft_ks=(0, 4),
        accept_dists=("uniform", "bimodal"), seeds=range(2), n=120,
        short=d, long=l, rho=0.8),
    "lanes": lambda m, d, l: m.sweep_lanes(
        [("fcfs", None), ("sjf", None), ("srpt", None)], lanes=(1, 2, 4),
        seeds=range(2), n=120, rho=0.85, short=d, long=l,
        budgets=(None, 2000.0)),
    "paging": lambda m, d, l: m.sweep_paging(
        [("fcfs", None), ("sjf", None)], page_sizes=(16, 64),
        budgets=(4000.0,), share_ratios=(0.0, 0.5), seeds=range(2), n=100,
        rho=0.85, short=d, long=l),
    "faults": lambda m, d, l: m.sweep_faults(
        [("fcfs", None), ("sjf", 10.0)], mtbfs=(float("inf"), 60.0),
        repairs=(5.0,), seeds=range(2), n=120, short=d, long=l,
        deadline=60.0),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_jax(name):
    got = SWEEPS[name](sweep, S, L)
    want = SWEEPS[name](jsweep, JS, JL)
    _assert_metrics_equal(got.metrics, want.metrics)
    for field in ("conditions", "seeds"):
        assert getattr(got, field) == getattr(want, field)


def test_sweep_batches_and_lane_batches_match_jax():
    got = sweep.sweep_batches(_batches(range(3)), CONDS)
    want = jsweep.sweep_batches(_jbatches(range(3)), CONDS)
    _assert_metrics_equal(got, want)
    got, arrs = sweep.sweep_batches(_batches(range(2)), CONDS[:2],
                                    return_arrays=True)
    _, jarrs = jsweep.sweep_batches(_jbatches(range(2)), CONDS[:2],
                                    return_arrays=True)
    for a, b in zip(arrs, jarrs):
        np.testing.assert_array_equal(a, b)
    got = sweep.sweep_lane_batches(_batches(range(2)), CONDS[:4],
                                   lanes=(1, 3), budgets=(None, 1500.0))
    want = jsweep.sweep_lane_batches(_jbatches(range(2)), CONDS[:4],
                                     lanes=(1, 3), budgets=(None, 1500.0))
    _assert_metrics_equal(got, want)


def test_run_grid_matches_jax():
    axes = {"a": (1, 2, 3), "b": ("x", "y")}
    fn = lambda a, b: f"{b}{a * a}"             # noqa: E731
    assert sweep.run_grid(axes, fn) == jsweep.run_grid(axes, fn)
    assert list(sweep.run_grid(axes, fn)) == [(1, "x"), (1, "y"), (2, "x"),
                                              (2, "y"), (3, "x"), (3, "y")]


def _grid(seed, G=8, n=90):
    rng = np.random.default_rng(seed)
    arrival = np.sort(np.round(rng.uniform(0, 25, (G, n)), 2), axis=1)
    service = np.round(rng.uniform(0.5, 4, (G, n)), 2)
    p_long = np.round(rng.random((G, n)), 2)
    taus = [None, 0.0, 3.0, None, 8.0, 1.0, 20.0, None][:G]
    policies = ["fcfs", "sjf", "sjf", "sjf_oracle", "sjf", "sjf",
                "sjf_oracle", "fcfs"][:G]
    key = np.stack([dispatch_key(p, arrival[g], p_long[g], service[g])
                    for g, p in enumerate(policies)])
    return arrival, service, p_long, key, taus, policies


@pytest.mark.parametrize("seed", range(3))
def test_grid_des_float64_equals_host_engine_bitwise(seed):
    arrival, service, _, key, taus, _ = _grid(seed)
    got = simulate_grid_torch(arrival, service, key, taus, device="cpu")
    want = simulate_grid(arrival, service, key, taus)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].sum() > 0                     # the guard promoted


def test_grid_des_float32_matches_jax_dispatch_order():
    """Port of tests/test_simulation.py::
    test_jax_engine_matches_dispatch_order, with the JAX engine itself
    beside the reference."""
    arrival, service, p_long, key, taus, policies = _grid(5, G=6, n=80)
    start, finish, promoted, promos = simulate_grid_torch(
        arrival, service, key, taus, device="cpu", dtype=torch.float32)
    jstart, _, jpromoted, jpromos = simulate_grid_jax(arrival, service, key,
                                                      taus)
    np.testing.assert_array_equal(promos, jpromos)
    np.testing.assert_array_equal(promoted, jpromoted)
    for g in range(len(taus)):
        assert np.array_equal(np.argsort(start[g], kind="stable"),
                              np.argsort(jstart[g], kind="stable")), g
        np.testing.assert_allclose(start[g], jstart[g], rtol=1e-5, atol=1e-4)
        reqs = [Request(req_id=i, arrival=float(arrival[g, i]),
                        true_service=float(service[g, i]),
                        p_long=float(p_long[g, i]))
                for i in range(arrival.shape[1])]
        ref = simulate_reference(reqs, policy=policies[g], tau=taus[g])
        ref_start = np.array([r.start for r in sorted(
            ref.requests, key=lambda r: r.req_id)])
        np.testing.assert_allclose(start[g], ref_start, rtol=1e-5, atol=1e-4)
        assert np.array_equal(np.argsort(start[g], kind="stable"),
                              np.argsort(ref_start, kind="stable")), g
        assert int(promos[g]) == ref.promotions, g
    np.testing.assert_allclose(finish, start + service, rtol=1e-5, atol=1e-4)


def test_sweep_batches_torch_backend_routes_preemptive_rows_to_host(
        monkeypatch):
    """``backend="torch"`` equals ``"auto"`` bit for bit; the grid DES
    sees only the key-based rows (fcfs, sjf x2, sjf_oracle: 4 of 5
    conditions), the srpt rows go to the host preemptive engine."""
    rows = []
    real = sim_torch.simulate_grid_torch

    def spy(arrival, *a, **kw):
        rows.append(arrival.shape[0])
        assert kw["device"] == "cpu"
        return real(arrival, *a, **kw)

    monkeypatch.setattr(sim_torch, "simulate_grid_torch", spy)
    batches = _batches(range(3))
    want = sweep.sweep_batches(batches, CONDS)
    got = sweep.sweep_batches(batches, CONDS, backend="torch", device="cpu")
    _assert_metrics_equal(got, want)
    assert rows == [4 * 3]
    assert want["promotions"][3].sum() == 0     # srpt: no aging guard


@pytest.mark.parametrize("name", ["poisson", "burst", "speculative"])
def test_sweeps_torch_backend_equal_auto(name):
    call = {
        "poisson": lambda **kw: sweep.sweep_poisson(
            CONDS, rhos=(0.74,), seeds=range(2), n=150, short=S, long=L,
            **kw),
        "burst": lambda **kw: sweep.sweep_burst(
            [("fcfs", None), ("sjf", 10.5), ("srpt", None)], seeds=range(2),
            n_short=25, n_long=25, short=S, long=L, **kw),
        "speculative": lambda **kw: sweep.sweep_speculative(
            [("sjf", None), ("sjf_effective", 10.0)], draft_ks=(0, 3),
            accept_dists=("high", "uniform"), seeds=range(2), n=100,
            short=S, long=L, **kw),
    }[name]
    want = call()
    got = call(backend="torch", device="cpu")
    _assert_metrics_equal(got.metrics, want.metrics)
