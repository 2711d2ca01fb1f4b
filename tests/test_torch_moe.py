"""The port's MoE block against ``repro.models.moe.apply_moe`` (one
dispatch group: no mesh), on the same weights and inputs, float32.

Capacity drops are forced with ``moe_capacity_factor`` 0.5 (and checked
to happen), and exercised without drops at factor E.  Output and the
Switch auxiliary loss within 1e-5 (the products and the float32 combine
sum in the same order; the matmuls round differently in the last bits);
the gradients of the block's parameters and of its input within 1e-4.

``torch.topk`` and ``jax.lax.top_k`` could order exact ties
differently; the router is float32 over random weights, its
probabilities agree between the packages to ~1e-7 and no two of a
token's are that close, so no tie decides a route here.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.moe import apply_moe, init_moe
from repro_torch.configs import get_config
from repro_torch.models.moe import MoE

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["jamba-v0.1-52b", "dbrx-132b", "llama4-maverick-400b-a17b"]


def _pair(name, cf, seed=0, act=None):
    over = dict(moe_capacity_factor=cf)
    if act:
        over["mlp_activation"] = act
    jcfg = dataclasses.replace(jax_config(name).reduced(), **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    p, _ = init_moe(jcfg, jax.random.key(seed))
    p = jax.tree.map(np.asarray, p)
    moe = MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    moe.load_state_dict({
        "norm": torch.from_numpy(p["norm"]),
        "router": torch.from_numpy(p["router"]),
        **{f"experts.{k}": torch.from_numpy(v)
           for k, v in p["experts"].items()}})
    return jcfg, p, moe


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _drops(cfg, x, router):
    """Pairs the capacity drops (from the routing alone)."""
    T = x.shape[0] * x.shape[1]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(1, math.ceil(T * K / E * cfg.moe_capacity_factor))
    h = x.reshape(T, -1)
    h = h / np.sqrt((h * h).mean(-1, keepdims=True) + cfg.norm_eps)
    top = np.argsort(-(h @ router), axis=-1)[:, :K]
    counts = np.bincount(top.reshape(-1), minlength=E)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("shape", [(2, 16), (1, 1), (4, 1), (1, 37)])
@pytest.mark.parametrize("cf", [0.5, 1.25, None])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_matches_apply_moe(name, cf, shape):
    """Output and aux equal to the JAX block; ``cf`` None is E (no
    drop), 0.5 forces drops on every multi-token shape."""
    cf = float(get_config(name).reduced().num_experts) if cf is None else cf
    jcfg, p, moe = _pair(name, cf, seed=len(shape) + shape[1])
    x = _x((*shape, jcfg.d_model), shape[1])
    want, waux = apply_moe(jcfg, jax.tree.map(jnp.asarray, p),
                           jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    if cf == 0.5 and shape[0] * shape[1] > 4:
        assert _drops(jcfg, x, p["router"]) > 0


def test_moe_geglu_matches_apply_moe():
    """The experts' activation follows ``mlp_activation`` (GeGLU: the
    tanh gelu of ``jax.nn.gelu``)."""
    jcfg, p, moe = _pair("dbrx-132b", 1.25, act="gelu")
    x = _x((2, 9, jcfg.d_model), 3)
    want, _ = apply_moe(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    with torch.no_grad():
        got, _ = moe(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "dbrx-132b"])
def test_moe_gradients_match_jax(name, cf):
    """d(sum(out * w) + aux) by every parameter and by the input, within
    1e-4."""
    jcfg, p, moe = _pair(name, cf, seed=4)
    x = _x((2, 12, jcfg.d_model), 9)
    wt = _x((2, 12, jcfg.d_model), 10)

    def f(params, xx):
        out, aux = apply_moe(jcfg, params, xx)
        return jnp.sum(out * wt) + aux
    gp, gx = jax.grad(f, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    moe.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe(xt)
    ((out * torch.from_numpy(wt)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(moe.router.grad.numpy(),
                               np.asarray(gp["router"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(moe.norm.grad.numpy(), np.asarray(gp["norm"]),
                               atol=1e-4, rtol=1e-4)
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(moe.experts, k).grad.numpy(),
                                   np.asarray(gp["experts"][k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_capacity_is_shared_by_the_tokens_of_a_call():
    """A token's output depends on the other tokens of the call once
    capacity binds (the reason MoE lanes are held to lanes, not to the
    serial engine): the same row alone and in a batch of 8 differ at cf
    0.5, and agree at cf E."""
    for cf, same in ((0.5, False), (4.0, True)):
        _, _, moe = _pair("jamba-v0.1-52b", cf, seed=2)
        x = torch.from_numpy(_x((8, 1, 64), 11))
        with torch.no_grad():
            batch, _ = moe(x)
            alone = torch.cat([moe(x[i:i + 1])[0] for i in range(8)])
        assert torch.allclose(batch, alone, atol=1e-6) == same
