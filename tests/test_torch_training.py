"""The port's training substrate against the JAX package's: optimizer
updates (AdamW, Adafactor, clipping) on the same params and grads, five
train steps from a JAX ``TrainState`` carried across (microbatches 1 and
4), the straggler monitor, and the CLI's loss dropping.

Float32 on the CPU.  Tolerances: optimizer updates atol 1e-6 (elementwise
float32 arithmetic in the same order; the gradient norm sums in another
order); with bf16 moments, params atol 1e-4 and moments rtol 1e-2 (a last
float32 bit of the clip scale can round a moment to the neighbouring
bf16 value, 2^-8 relative, which moves that element's update by up to
lr x 2^-7); train losses rtol 1e-4 and params atol 5e-4, rtol 5e-3 (the JAX
package's own microbatch-equivalence tolerance, tests/test_training.py).
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.lm_data import LMDataConfig as JDataConfig
from repro.data.lm_data import SyntheticLMStream as JStream
from repro.training import optimizer as jopt
from repro.training import straggler as jstraggler
from repro.training.train_loop import init_train_state as jinit
from repro.training.train_loop import make_train_step as jmake_step
from repro_torch.configs import get_config as port_config
from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
from repro_torch.models.bridge import (opt_state_from_jax, params_from_jax,
                                       params_to_jax)
from repro_torch.models.model import LM
from repro_torch.training import optimizer as topt
from repro_torch.training.straggler import HostMonitor, StepTimer
from repro_torch.training.train_loop import (TrainState, init_train_state,
                                             make_train_step)

OVER = {"num_layers": 3, "num_kv_heads": 2}
UPDATE_TOL = dict(atol=1e-6, rtol=0)


def _cfgs():
    return (dataclasses.replace(get_config("smollm-360m").reduced(), **OVER),
            dataclasses.replace(port_config("smollm-360m").reduced(), **OVER))


def _params_and_grads(seed, grad_scale):
    jcfg, tcfg = _cfgs()
    from repro.models.model import LM as JLM
    params = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * grad_scale)
        .astype(np.float32), params)
    return tcfg, params, grads


@pytest.mark.parametrize("kind,grad_scale,moment_dtype", [
    ("adamw", 1e-3, "float32"),     # norm below the clip
    ("adamw", 1.0, "float32"),      # clipped
    ("adamw", 1.0, "bfloat16"),
    ("adafactor", 1e-3, "float32"),
    ("adafactor", 1.0, "float32"),
])
def test_apply_updates_matches_jax(kind, grad_scale, moment_dtype):
    """Three steps on the same params and grads: params, moments, grad
    norm and lr."""
    p_tol, m_tol = (UPDATE_TOL, UPDATE_TOL) if moment_dtype == "float32" \
        else (dict(atol=1e-4, rtol=0), dict(atol=0, rtol=1e-2))
    tcfg, params, grads = _params_and_grads(1, grad_scale)
    cfg = dict(lr=1e-2, kind=kind, warmup_steps=2, moment_dtype=moment_dtype)
    jcfg, pcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init_opt_state(jp, jcfg)
    tp = {k: v.clone() for k, v in params_from_jax(params, tcfg).items()}
    tstate = topt.init_opt_state(tp, pcfg)
    tgrads = params_from_jax(grads, tcfg)
    upd = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jcfg))
    for _ in range(3):
        jp, jstate, jm = upd(jp, jax.tree.map(jnp.asarray, grads), jstate)
        tp, tstate, tm = topt.apply_updates(tp, tgrads, tstate, pcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["lr"]) == float(jm["lr"])
    for a, b in zip(jax.tree.leaves(params_to_jax(tp, tcfg)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), **p_tol)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    assert int(tstate.step) == int(want.step) == 3
    for mine, theirs in ((tstate.m, want.m), (tstate.v, want.v)):
        assert sorted(mine) == sorted(theirs)
        for name in mine:
            assert mine[name].dtype == theirs[name].dtype
            np.testing.assert_allclose(mine[name].float().numpy(),
                                       theirs[name].float().numpy(),
                                       **m_tol, err_msg=name)


def test_grad_norm_is_reported_before_clipping():
    params = {"w": torch.zeros(3)}
    cfg = topt.OptConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0,
                         warmup_steps=1)
    state = topt.init_opt_state(params, cfg)
    _, _, metrics = topt.apply_updates(params, {"w": torch.full((3,), 100.)},
                                       state, cfg)
    assert float(metrics["grad_norm"]) > 100.0


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = topt.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    state = topt.init_opt_state(params, cfg)
    for _ in range(120):
        params, state, _ = topt.apply_updates(params, {"w": 2 * params["w"]},
                                              state, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_adafactor_reduces_quadratic_loss():
    params = {"w": torch.ones(4, 6) * 3.0}
    cfg = topt.OptConfig(lr=0.5, kind="adafactor", weight_decay=0.0,
                         warmup_steps=1)
    state = topt.init_opt_state(params, cfg)
    for _ in range(100):
        params, state, _ = topt.apply_updates(params, {"w": 2 * params["w"]},
                                              state, cfg)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 4])
def test_five_train_steps_match_jax(kind, microbatches):
    """A JAX TrainState carried across whole (params and optimizer state
    after one JAX step, so the moments are not zero), then five steps in
    each package on the same Markov batches."""
    jcfg, tcfg = _cfgs()
    cfg = dict(lr=3e-3, kind=kind, warmup_steps=2)
    jo, to = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    data = JStream(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                               global_batch=8))
    jstep = jax.jit(jmake_step(jcfg, jo, microbatches=microbatches))
    jstate = jinit(jcfg, jo, jax.random.key(2))
    jb = lambda i: {k: jnp.asarray(v)                   # noqa: E731
                    for k, v in data.batch(i).items()}
    jstate, _ = jstep(jstate, jb(0))
    np_state = jax.tree.map(np.asarray, jstate)
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(params_from_jax(np_state.params, tcfg))
    state = TrainState(lm, opt_state_from_jax(np_state.opt, tcfg))
    step = make_train_step(tcfg, to, microbatches=microbatches)
    for i in range(1, 6):
        jstate, jm = jstep(jstate, jb(i))
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch(i).items()}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    got = params_to_jax(state.model.state_dict(), tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3)


def test_microbatch_accumulation_matches_full_batch():
    _, tcfg = _cfgs()
    opt = topt.OptConfig(lr=1e-3, warmup_steps=1)
    data = SyntheticLMStream(LMDataConfig(vocab_size=tcfg.vocab_size,
                                          seq_len=32, global_batch=8))
    batch = {k: torch.from_numpy(v).long()
             for k, v in data.batch(0).items()}
    s1 = init_train_state(tcfg, opt, device="cpu")
    s2 = init_train_state(tcfg, opt, device="cpu")
    s1, m1 = make_train_step(tcfg, opt, microbatches=1)(s1, batch)
    s2, m2 = make_train_step(tcfg, opt, microbatches=4)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for (n, a), b in zip(s1.params.items(), s2.params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-4, rtol=5e-3, err_msg=n)


def test_train_state_turns_gradients_on_and_serving_still_works():
    _, tcfg = _cfgs()
    state = init_train_state(tcfg, topt.OptConfig(), device="cpu", seed=3)
    assert all(p.requires_grad for p in state.model.parameters())
    logits, cache = state.model.prefill(torch.tensor([[1, 2, 3]]))
    assert not logits.requires_grad and int(cache.t) == 3


def test_straggler_detection_matches_jax():
    mine, theirs = StepTimer(warmup=3), jstraggler.StepTimer(warmup=3)
    times = [1.0 + 0.01 * i for i in range(10)] + [10.0, 1.1, 0.9, 5.0]
    assert [mine.observe(i, t) for i, t in enumerate(times)] == \
        [theirs.observe(i, t) for i, t in enumerate(times)]
    assert mine.flagged == theirs.flagged and 10 in mine.flagged
    assert (mine.mean, mine.var) == (theirs.mean, theirs.var)


def test_host_monitor_matches_jax():
    mine, theirs = HostMonitor(), jstraggler.HostMonitor()
    for i in range(10):
        for m in (mine, theirs):
            m.observe("h0", 1.0)
            m.observe("h1", 1.05 + 0.01 * i)
            m.observe("h2", 2.5)
    assert mine.stragglers() == theirs.stragglers() == ["h2"]


def test_cli_loss_decreases_over_short_run():
    from repro_torch.launch import train as train_mod
    losses = train_mod.main(["--arch", "smollm-360m", "--reduced",
                             "--steps", "30", "--batch", "8", "--seq", "64",
                             "--lr", "1e-2", "--device", "cpu"])
    assert len(losses) == 30
    assert losses[-1] < losses[0] - 0.4, (losses[0], losses[-1])


def test_cli_refuses_an_unported_arch():
    """The reduced gemma3-4b-edge (GeGLU blocks) trains on the CPU with a
    falling loss, as the JAX CLI trains it; an arch the registry does not
    hold is refused."""
    from repro_torch.launch import train as train_mod
    losses = train_mod.main(["--arch", "gemma3-4b-edge", "--reduced",
                             "--steps", "30", "--batch", "8", "--seq", "64",
                             "--lr", "1e-2", "--device", "cpu"])
    assert len(losses) == 30 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0] - 0.4, (losses[0], losses[-1])
    with pytest.raises(SystemExit, match="unknown arch"):
        train_mod.main(["--arch", "no-such-arch", "--device", "cpu"])
