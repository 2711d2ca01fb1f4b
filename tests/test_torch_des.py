"""The port's discrete-event simulator against the JAX package's.

``repro_torch.core.{simulation,sim_fast,_native,calibration}`` are copies
of the JAX package's numpy/C modules, and ``serving.service_time`` is
completed from its JAX original with the card's peaks in ``from_arch``.
The same seeded workloads go through both packages; every DES engine
(serial, preemptive, c-server, paged, faulty), the workload generators,
the length draws and ``calibrate_tau`` must agree bit for bit (float64
arrays compared with ``np.array_equal``, NaN == NaN where a request was
shed).  The port's compiled loops must equal its heapq fallbacks.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import copy

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import calibration as jcal
from repro.core import sim_fast as jsf
from repro.core import simulation as jsim
from repro.core.policy import MODE_QUANTUM as J_MODE_QUANTUM
from repro.core.policy import MODE_SRPT as J_MODE_SRPT
from repro.serving import service_time as jst
from repro_torch.configs import get_config
from repro_torch.core import _native
from repro_torch.core import calibration as cal
from repro_torch.core import sim_fast as sf
from repro_torch.core import simulation as sim
from repro_torch.core.policy import MODE_QUANTUM, MODE_SRPT
from repro_torch.serving import service_time as st

SHORT, LONG = (2.0, 0.6), (20.0, 6.0)
POLICIES = ["fcfs", "sjf", "sjf_oracle", "sjf_quantile", "fair_share",
            "srpt", "mlfq"]
TAUS = [None, 0.0, 4.0, 60.0]


def _same(a, b) -> bool:
    """Bitwise equality of (possibly nested) DES outputs."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


def _dists(mod):
    return mod.ServiceDist(*SHORT), mod.ServiceDist(*LONG)


def _trace(res):
    """Per-request (id, start, finish, promoted); NaN (a shed request's
    times) as None, so that two traces compare equal with ``==``."""
    def f(x):
        return None if x is None or np.isnan(x) else x
    return [(r.req_id, f(r.start), f(r.finish), r.promoted)
            for r in sorted(res.requests, key=lambda r: r.req_id)]


def _workload(mod, seed, n=120, rho=0.74):
    s, l = _dists(mod)
    lam = rho / (0.5 * SHORT[0] + 0.5 * LONG[0])
    reqs = mod.poisson_workload(np.random.default_rng(seed), n, lam, s, l)
    noise = np.random.default_rng(seed + 100).uniform(-0.3, 0.3, n)
    for r, d in zip(reqs, noise):           # an imperfect predictor
        r.p_long = float(np.clip(r.p_long + d, 0.0, 1.0))
    return reqs


def _arrays(seed, n=90):
    rng = np.random.default_rng(seed)
    arrival = np.sort(np.round(rng.exponential(1.5, n).cumsum(), 3))
    service = np.round(rng.uniform(0.05, 9.0, n), 3)
    key = np.round(rng.uniform(0.5, 12.0, n), 2)
    quanta = np.round(rng.uniform(0.2, 14.0, n), 2)
    return arrival, service, key, quanta


# -------------------------------------------------------------- generators
def test_workload_generators_match_jax():
    for mod_pair in ((jsim, sim),):
        j, t = mod_pair
        for seed in (0, 5):
            a = _workload(j, seed)
            b = _workload(t, seed)
            assert [(r.req_id, r.arrival, r.true_service, r.klass,
                     r.p_long) for r in a] == \
                [(r.req_id, r.arrival, r.true_service, r.klass, r.p_long)
                 for r in b]
            ja = j.burst_workload(np.random.default_rng(seed), 30, 20,
                                  *_dists(j))
            ta = t.burst_workload(np.random.default_rng(seed), 30, 20,
                                  *_dists(t))
            assert [(r.req_id, r.arrival, r.true_service, r.klass)
                    for r in ja] == [(r.req_id, r.arrival, r.true_service,
                                      r.klass) for r in ta]
    jb = jsf.RequestBatch.poisson(np.random.default_rng(3), n=200,
                                  lam=0.1, short=jsim.ServiceDist(*SHORT),
                                  long=jsim.ServiceDist(*LONG))
    tb = sf.RequestBatch.poisson(np.random.default_rng(3), n=200, lam=0.1,
                                 short=sim.ServiceDist(*SHORT),
                                 long=sim.ServiceDist(*LONG))
    for name in ("arrival", "true_service", "p_long", "klass"):
        assert _same(getattr(jb, name), getattr(tb, name)), name


# ---------------------------------------------------------------- simulate
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_matches_jax(policy):
    """The ``simulate`` front end (non-preemptive and preemptive engines,
    native and fallback) writes back the same start/finish/promotion per
    request as the JAX package's."""
    for seed, tau in zip((0, 1, 2, 3), TAUS):
        for engine in ("auto", "python"):
            a = jsim.simulate(_workload(jsim, seed), policy=policy, tau=tau,
                              engine=engine)
            b = sim.simulate(_workload(sim, seed), policy=policy, tau=tau,
                             engine=engine)
            assert _trace(a) == _trace(b), (policy, tau, engine)
            assert a.promotions == b.promotions
            assert a.makespan == b.makespan


def test_simulate_reference_matches_jax():
    for seed, policy in ((0, "fcfs"), (1, "sjf"), (2, "sjf_oracle")):
        a = jsim.simulate_reference(_workload(jsim, seed, n=60),
                                    policy=policy, tau=4.0)
        b = sim.simulate_reference(_workload(sim, seed, n=60),
                                   policy=policy, tau=4.0)
        assert _trace(a) == _trace(b)


# ----------------------------------------------------------- grid engines
@pytest.mark.parametrize("engine", ["python", "native"])
def test_simulate_grid_matches_jax(engine):
    if engine == "native" and _native.native_des() is None:
        pytest.skip("no C compiler on this machine")
    rows = [_arrays(s) for s in range(4)]
    arrival = np.stack([r[0] for r in rows])
    service = np.stack([r[1] for r in rows])
    key = np.stack([r[2] for r in rows])
    taus = (None, 0.0, 4.0, 60.0)
    want = jsf.simulate_grid(arrival, service, key, taus, engine="python")
    got = sf.simulate_grid(arrival, service, key, taus, engine=engine)
    assert _same(want, got)


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("mode", ["srpt", "quantum"])
def test_simulate_grid_preempt_matches_jax(engine, mode):
    if engine == "native" and _native.native_des_preempt() is None:
        pytest.skip("no C compiler on this machine")
    jmode, tmode = (J_MODE_SRPT, MODE_SRPT) if mode == "srpt" \
        else (J_MODE_QUANTUM, MODE_QUANTUM)
    assert jmode == tmode
    for trial, tau in enumerate(TAUS):
        arrival, service, key, quanta = _arrays(10 + trial)
        want = jsf.simulate_grid_preempt(
            arrival[None], service[None], key[None], (tau,), (jmode,),
            quanta[None], engine="python")
        got = sf.simulate_grid_preempt(
            arrival[None], service[None], key[None], (tau,), (tmode,),
            quanta[None], engine=engine)
        assert _same(want, got), (mode, tau)


def test_native_des_equals_fallback():
    """The port's compiled loops == its own heapq fallbacks."""
    if sf._native.native_des() is None:
        pytest.skip("no C compiler on this machine")
    assert _native.des_engine() == "native"
    for trial in range(6):
        arrival, service, key, quanta = _arrays(40 + trial)
        tau = TAUS[trial % 4]
        a = sf.simulate_grid(arrival[None], service[None], key[None],
                             (tau,), engine="python")
        b = sf.simulate_grid(arrival[None], service[None], key[None],
                             (tau,), engine="native")
        assert _same(a, b)
        mode = (MODE_SRPT, MODE_QUANTUM)[trial % 2]
        a = sf.simulate_grid_preempt(arrival[None], service[None],
                                     key[None], (tau,), (mode,),
                                     quanta[None], engine="python")
        b = sf.simulate_grid_preempt(arrival[None], service[None],
                                     key[None], (tau,), (mode,),
                                     quanta[None], engine="native")
        assert _same(a, b)


@pytest.mark.parametrize("mode", [None, "srpt"])
def test_simulate_grid_servers_matches_jax(mode):
    arrival, service, key, _ = _arrays(21)
    mem = np.round(np.random.default_rng(2).uniform(50, 400, len(arrival)))
    kw = dict(n_servers=3, slowdown=(1.0, 1.2, 1.45), mem=mem[None],
              mem_budget=700.0)
    want = jsf.simulate_grid_servers(
        arrival[None], service[None], key[None], (4.0,),
        mode=None if mode is None else (J_MODE_SRPT,), **kw)
    got = sf.simulate_grid_servers(
        arrival[None], service[None], key[None], (4.0,),
        mode=None if mode is None else (MODE_SRPT,), **kw)
    assert _same(want, got)


def _paged_inputs(mod, seed):
    reqs = _workload(mod, seed, n=80)
    rng = np.random.default_rng(seed + 7)
    ptok = rng.integers(8, 64, len(reqs)).astype(np.float64)
    ttok = ptok + rng.integers(4, 200, len(reqs))
    grp = np.where(np.arange(len(reqs)) % 2 == 0, 0, -1)
    return reqs, ptok, ttok, grp


@pytest.mark.parametrize("policy", ["fcfs", "sjf", "srpt"])
def test_simulate_paged_and_servers_match_jax(policy):
    out = []
    for mod in (jsim, sim):
        reqs, ptok, ttok, grp = _paged_inputs(mod, 3)
        p = mod.simulate_paged(
            copy.deepcopy(reqs), policy=policy, tau=10.0, n_servers=4,
            slowdown=(1.0, 1.1, 1.25, 1.4), prompt_tokens=ptok + 32,
            total_tokens=ttok + 32, page_size=16, n_pages=14,
            share_group=grp, shared_tokens=np.where(grp == 0, 32.0, 0.0),
            prefill_saved=np.where(grp == 0, 0.05, 0.0))
        c = mod.simulate_servers(copy.deepcopy(reqs), policy=policy,
                                 tau=10.0, n_servers=2,
                                 mem_tokens=ttok, mem_budget=300.0)
        out.append((_trace(p), p.preemptions, p.prefix_hits, p.peak_pages,
                    _trace(c), c.promotions))
    assert out[0] == out[1]
    assert out[1][1] > 0                        # the pool did bind


@pytest.mark.parametrize("in_service_timeout", [False, True])
def test_simulate_faulty_matches_jax(in_service_timeout):
    out = []
    for mod, smod in ((jsim, jsf), (sim, sf)):
        faults = smod.ServerFaults.random(
            np.random.default_rng(4), 400.0, mtbf=60.0, mttr=8.0,
            stall_mtbf=90.0, stall_s=12.0)
        res = mod.simulate_faulty(_workload(mod, 6), policy="sjf", tau=20.0,
                                  faults=faults, deadline=45.0,
                                  in_service_timeout=in_service_timeout)
        out.append((_trace(res), res.shed, res.requeues, res.timeouts,
                    [bool(r.meta.get("shed")) for r in res.requests]))
    assert out[0] == out[1]
    assert out[1][1] + out[1][3] > 0            # the deadline did bind


def test_simulate_grid_faults_matches_jax():
    arrival, service, key, _ = _arrays(31)
    jf = jsf.ServerFaults(downs=((5.0, 9.0), (40.0, 52.0)),
                          slowdowns=((12.0, 30.0, 2.5),))
    tf = sf.ServerFaults(downs=((5.0, 9.0), (40.0, 52.0)),
                         slowdowns=((12.0, 30.0, 2.5),))
    for tau, dl in ((None, None), (4.0, 30.0)):
        want = jsf.simulate_grid_faults(arrival[None], service[None],
                                        key[None], (tau,), (jf,),
                                        deadline=dl, in_service_timeout=True)
        got = sf.simulate_grid_faults(arrival[None], service[None],
                                      key[None], (tau,), (tf,),
                                      deadline=dl, in_service_timeout=True)
        assert _same(want, got)


def test_simulate_speculative_matches_jax():
    a = jsim.simulate_speculative(_workload(jsim, 8), policy="sjf_effective",
                                  tau=10.0, draft_k=4)
    b = sim.simulate_speculative(_workload(sim, 8), policy="sjf_effective",
                                 tau=10.0, draft_k=4)
    assert _trace(a) == _trace(b)


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("kw", [{}, {"policy": "fcfs", "seed": 3},
                                {"effective_rate": 1.7},
                                {"n_short": 20, "n_long": 80}])
def test_calibrate_tau_matches_jax(kw):
    want = jcal.calibrate_tau(jsim.ServiceDist(*SHORT),
                              jsim.ServiceDist(*LONG), **kw)
    got = cal.calibrate_tau(sim.ServiceDist(*SHORT),
                            sim.ServiceDist(*LONG), **kw)
    assert want == got
    assert cal.TAU_MULTIPLIER == jcal.TAU_MULTIPLIER


def test_calibrate_tau_on_the_cli_service_model():
    """``launch.serve``'s calibration (gemma3-4b-edge priced on the card's
    peaks) equals the JAX calibration fed the same model."""
    from repro_torch.launch.serve import tau_for
    m = st.ServiceTimeModel.from_arch(get_config("gemma3-4b-edge"))
    jm = jst.ServiceTimeModel(m.prefill_tok_per_s, m.decode_tok_per_s)
    js = jsim.ServiceDist(jm.service(64, 60), 0.3 * jm.service(64, 60))
    jl = jsim.ServiceDist(jm.service(64, 1400), 0.3 * jm.service(64, 1400))
    assert tau_for(m, 3.0) == jcal.calibrate_tau(js, jl, multiplier=3.0)


# ----------------------------------------------------------- service time
def test_service_time_model_matches_jax():
    kw = dict(prefill_tok_per_s=9000.0, decode_tok_per_s=55.0,
              overhead_s=0.02, effective_rate=1.6)
    a, b = jst.ServiceTimeModel(**kw), st.ServiceTimeModel(**kw)
    p = np.array([1, 64, 900, 4000])
    o = np.array([1, 60, 1400, 8000])
    assert _same(a.service_batch(p, o), b.service_batch(p, o))
    assert [a.service(x, y) for x, y in zip(p, o)] == \
        [b.service(x, y) for x, y in zip(p, o)]
    for name in ("PAPER_4090_SHORT", "PAPER_4090_LONG", "PAPER_M1_SHORT",
                 "PAPER_M1_LONG"):
        ja, ta = getattr(jst, name), getattr(st, name)
        assert (ja.mean, ja.std, ja.floor) == (ta.mean, ta.std, ta.floor)


def test_output_length_draws_match_jax():
    klasses = ["short", "medium", "long", "short", ""] * 40
    ja = [jst.sample_output_tokens(np.random.default_rng(9), k)
          for k in klasses]
    ta = [st.sample_output_tokens(np.random.default_rng(9), k)
          for k in klasses]
    assert ja == ta
    assert _same(jst.sample_output_tokens_batch(np.random.default_rng(2),
                                                klasses),
                 st.sample_output_tokens_batch(np.random.default_rng(2),
                                               klasses))


def test_from_arch_uses_the_card_peaks():
    """The roofline arithmetic is JAX's; only the peaks differ (H100 SXM
    data sheet instead of the TPU's), so the port's rates are JAX's scaled
    by the peak ratios."""
    from repro.launch.roofline import HBM_BW, PEAK_FLOPS
    peaks = st.H100_SXM_PEAKS
    for name in ("gemma3-4b-edge", "smollm-360m"):
        j = jst.ServiceTimeModel.from_arch(jax_config(name))
        t = st.ServiceTimeModel.from_arch(get_config(name))
        np.testing.assert_allclose(
            t.prefill_tok_per_s / j.prefill_tok_per_s,
            peaks["bf16_flops"] / PEAK_FLOPS, rtol=1e-12)
        np.testing.assert_allclose(
            t.decode_tok_per_s / j.decode_tok_per_s,
            peaks["hbm_bytes_per_s"] / HBM_BW, rtol=1e-12)
    m = st.ServiceTimeModel.from_arch(get_config("gemma3-4b-edge"))
    assert 50_000 < m.prefill_tok_per_s < 52_000
    assert 285 < m.decode_tok_per_s < 295


def test_service_time_model_monotone():
    cfg = get_config("gemma3-4b-edge")
    m = st.ServiceTimeModel.from_arch(cfg, chips=1)
    assert m.service(64, 800) > m.service(64, 100) > m.service(64, 10)
    assert m.service(1024, 100) > m.service(64, 100)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name,count", [("smollm-360m", 361_821_120),
                                        ("gemma3-4b-edge", 3_879_907_840)])
def test_config_counts_match_jax(name, count):
    cfg, jcfg = get_config(name), jax_config(name)
    assert cfg.param_count() == cfg.active_param_count() == count
    assert jcfg.param_count() == jcfg.active_param_count() == count
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta",
              "tie_embeddings", "mlp_activation"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_lm_refuses_an_unported_activation():
    """The reduced gemma3-4b-edge (GeGLU: ``jax.nn.gelu``'s tanh form)
    builds, and on the JAX package's weights its prefill logits equal the
    JAX LM's within 1e-5 (float32); an activation that neither package's
    gated MLP names is refused."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from repro.models.model import LM as JLM
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.models.model import LM
    cfg = get_config("gemma3-4b-edge").reduced()
    jlm = JLM(jax_config("gemma3-4b-edge").reduced())
    params = jlm.init(jax.random.key(5))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    toks = np.zeros((1, 16), np.int32)
    toks[0, :9] = np.random.default_rng(2).integers(0, cfg.vocab_size, 9)
    jl, _ = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, pad_to=32,
                        prompt_len=jnp.asarray(9, jnp.int32))
    tl, _ = lm.prefill(torch.from_numpy(toks.astype(np.int64)), pad_to=32,
                       prompt_len=9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(NotImplementedError, match="relu"):
        LM(dataclasses.replace(cfg, mlp_activation="relu"), device="cpu")
