"""The port's sharding rules against the JAX package's.

Every leaf of every registered arch at full size (eleven configs): the
parameters, the AdamW and Adafactor train states
(``abstract_train_state``) and the decode cache (``cache_axes``) resolve
to the same spec in both packages on the production meshes (16, 16) and
(2, 16, 16) and on a (4, 1) data-parallel mesh.  JAX works on
``eval_shape`` structs, the port on ``meta`` tensors: nothing is
allocated.  The port's block leaves are one layer's (the JAX leaves are
stacked over the pattern's repeats with a leading None axis), so a port
spec is compared with the JAX spec of the stacked leaf after that None
is put back.  Then the JAX sharding tests' cases, and
``placements_for`` on a world-1 gloo ``DeviceMesh``.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.models.model import LM as JLM
from repro.sharding.rules import spec_for as jax_spec_for
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.train_loop import abstract_train_state as jax_abstract
from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.models.model import LM
from repro_torch.sharding import constrain, use_mesh
from repro_torch.sharding.rules import (DEFAULT_RULES, MeshShape,
                                        PartitionSpec, is_axes_leaf,
                                        placements_for, spec_for)
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import abstract_train_state


def _fake(shape, names):
    class FakeMesh:
        axis_names = names
        devices = np.empty(shape)
    return FakeMesh


MESHES = [_fake((16, 16), ("data", "model")),
          _fake((2, 16, 16), ("pod", "data", "model")),
          _fake((4, 1), ("data", "model"))]

#: port cache fields by the JAX cache leaf of each block kind
CACHE_FIELDS = {"attn": {"k": "k", "v": "v", "t": "t"},
                "attn_moe": {"k": "k", "v": "v", "t": "t"},
                "mamba": {"conv": "conv", "ssm": "ssm"},
                "mamba_moe": {"conv": "conv", "ssm": "ssm"},
                "mlstm": {"mlstm_C": "C", "mlstm_n": "n", "mlstm_m": "m"},
                "slstm": {"slstm_c": "c", "slstm_n": "n", "slstm_h": "h",
                          "slstm_m": "m"},
                "xattn": {"xk": "k", "xv": "v"}}


def _stacked(spec) -> tuple:
    """A port block leaf's spec with the JAX stack's leading None."""
    parts = [None, *spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _nested(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return tree


def _jax_leaf(jtree, port_name, period, stacked_groups=False):
    """The JAX (shape or axes) leaf of a port parameter name (or, with
    ``stacked_groups``, of an Adafactor group key)."""
    if not port_name.startswith("blocks."):
        return jtree[port_name]
    rest = port_name[len("blocks."):]
    if stacked_groups:
        pos = 0
        if rest.startswith("pos"):
            head, rest = rest.split(".", 1)
            pos = int(head[3:])
        return _nested(jtree["blocks"][pos], rest)
    layer, rest = rest.split(".", 1)
    return _nested(jtree["blocks"][int(layer) % period], rest)


def _check_params(jshapes, jaxes, shapes, axes, period, mesh, what,
                  stacked_groups=False):
    if stacked_groups:                       # one group per JAX leaf
        assert len(shapes) == len(jax.tree.leaves(jshapes)), what
    for name, t in shapes.items():
        js = _jax_leaf(jshapes, name, period, stacked_groups)
        ja = _jax_leaf(jaxes, name, period, stacked_groups)
        want = tuple(jax_spec_for(js.shape, ja, mesh))
        got = spec_for(tuple(t.shape), axes[name], mesh)
        if name.startswith("blocks.") and not stacked_groups:
            assert tuple(js.shape[1:]) == tuple(t.shape), (what, name)
            assert ja[1:] == axes[name], (what, name)
            got = _stacked(got)
        else:
            assert tuple(js.shape) == tuple(t.shape), (what, name)
        assert tuple(got) == want, (what, name, got, want)


@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_specs_equal_jax_for_every_leaf_at_full_size(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    period = len(cfg.block_pattern)
    for kind in ("adamw", "adafactor"):
        js, ja = jax_abstract(jcfg, JOptConfig(kind=kind))
        state, axes = abstract_train_state(cfg, OptConfig(kind=kind))
        params = dict(state.model.named_parameters())
        assert all(p.is_meta for p in params.values())
        n_jax = sum(np.prod(x.shape) for x in jax.tree.leaves(js.params))
        assert n_jax == sum(p.numel() for p in params.values())
        for mesh in MESHES:
            _check_params(js.params, ja.params, params, axes.model, period,
                          mesh, f"{kind} params")
            if kind == "adamw":
                for f in ("m", "v"):
                    _check_params(getattr(js.opt, f), getattr(ja.opt, f),
                                  getattr(state.opt, f), getattr(axes.opt, f),
                                  period, mesh, f"adamw {f}")
            else:
                for f in ("m", "v"):
                    _check_params(getattr(js.opt, f), getattr(ja.opt, f),
                                  getattr(state.opt, f), getattr(axes.opt, f),
                                  period, mesh, f"adafactor {f}",
                                  stacked_groups=True)
            assert tuple(spec_for((), axes.opt.step, mesh)) == \
                tuple(jax_spec_for((), ja.opt.step, mesh)) == ()

    # the decode cache
    B, S = 128, 32768
    jlm = JLM(jcfg)
    jcache = jax.eval_shape(lambda: jlm.init_cache(B, S))
    jcax = jlm.cache_axes()
    lm = LM(cfg, device="meta")
    cache, cax = lm.init_cache(B, S), lm.cache_axes()
    assert set(cax) == {"k", "v", "t"} | {n for n, _ in cache.states()}
    seen = set()
    for pos, kind in enumerate(cfg.block_pattern):
        for field, leaf in CACHE_FIELDS[kind].items():
            seen.add(field)
            t = getattr(cache, field)
            js, ja = jcache[pos][leaf], jcax[pos][leaf]
            assert tuple(t.shape[1:]) == tuple(js.shape[1:]), (field, pos)
            for mesh in MESHES:
                assert tuple(spec_for(tuple(t.shape), cax[field], mesh)) == \
                    tuple(jax_spec_for(js.shape, ja, mesh)), (field, mesh)
    assert seen | {"k", "v", "t"} >= set(cax)


def test_param_axes_cover_the_parameters_of_every_reduced_arch():
    """Every parameter has an axes annotation of matching rank."""
    for name in ALL_ARCH_NAMES:
        lm = LM(get_config(name).reduced(), device="meta")
        axes = lm.param_axes()
        assert list(axes) == [n for n, _ in lm.named_parameters()]
        for n, p in lm.named_parameters():
            assert p.dim() == len(axes[n]), (name, n, axes[n])


def test_spec_divisible():
    spec = spec_for((32, 64), ("batch", "mlp"), MeshShape(("data", "model"),
                                                           (1, 1)))
    assert isinstance(spec, PartitionSpec) and spec == PartitionSpec()


def test_divisibility_fallback_drops_axis():
    mesh = MeshShape(("data", "model"), (16, 16))
    assert spec_for((15, 64), ("heads", "head_dim"), mesh) == P()
    assert spec_for((15, 64), ("heads", "head_dim"), mesh) == \
        jax_spec_for((15, 64), ("heads", "head_dim"), MESHES[0])


def test_composite_batch_axes():
    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert spec_for((256, 4096), ("batch", "seq"), mesh) == \
        P(("pod", "data"))
    # batch=1 (long_500k decode): everything falls back
    assert spec_for((1, 4096), ("batch", "seq"), mesh) == P()
    # 16 rows divide by data (16) but not by pod x data (32)
    assert spec_for((16, 8), ("batch", "seq"), mesh) == P("pod") == \
        jax_spec_for((16, 8), ("batch", "seq"), MESHES[1])


def test_axis_used_once_per_tensor():
    mesh = MeshShape(("data", "model"), (16, 16))
    # both logical axes map to "model": first wins, second falls back
    assert spec_for((64, 64), ("heads", "mlp"), mesh) == P("model")


def test_kv_cache_spec_seq_sharded():
    mesh = MeshShape(("data", "model"), (16, 16))
    spec = spec_for((4, 128, 32768, 8, 128),
                    (None, "batch", "kv_seq", "kv_heads", "head_dim"), mesh)
    assert spec == P(None, "data", "model")


def test_constrain_is_identity_off_mesh_on_one_device_and_for_plain():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", "embed") is x
    with use_mesh(MeshShape(("data", "model"), (1, 1))):
        assert constrain(x, "batch", "embed") is x
    with use_mesh(MeshShape(("data", "model"), (16, 16))):
        assert constrain(x, "batch", "embed") is x    # not a DTensor


def test_is_axes_leaf():
    assert is_axes_leaf(("embed_w", "qkv"))
    assert is_axes_leaf((None, "batch"))
    assert is_axes_leaf(())
    assert not is_axes_leaf(({"a": 1},))
    assert not is_axes_leaf([1, 2])


def test_default_rules_are_jax_rules():
    from repro.sharding.rules import DEFAULT_RULES as J, SERVING_RULES as JS
    from repro_torch.sharding.rules import SERVING_RULES
    assert DEFAULT_RULES == J and SERVING_RULES == JS


def test_placements_on_a_world_one_gloo_mesh_and_a_mesh_shape():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh("cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert placements_for(P(), mesh) == (Replicate(), Replicate())
    # specs name mesh axes whatever their size: a (1, 1) mesh resolves
    # none, a spec written for a larger mesh still maps onto its axes
    assert placements_for(PartitionSpec("data", "model"), mesh) == \
        (Shard(0), Shard(1))
    assert placements_for(PartitionSpec(None, "data"), mesh) == \
        (Shard(1), Replicate())
    pod = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert placements_for(PartitionSpec(("pod", "data"), "model"), pod) == \
        (Shard(0), Shard(0), Shard(1))
    # over a parameter dict: the (16, 256) embedding shards its width over
    # data (FSDP) and its rows over model; the norm is replicated
    from repro_torch.sharding.partition import replicated, tree_placements
    shapes = {"embed": torch.empty(256, 16, device="meta"),
              "final_norm": torch.empty(16, device="meta")}
    axes = {"embed": ("vocab", "embed_w"), "final_norm": ("embed",)}
    assert tree_placements(shapes, axes, pod) == {
        "embed": (Replicate(), Shard(1), Shard(0)),
        "final_norm": replicated(pod)}
    assert replicated(mesh) == (Replicate(), Replicate())
    # a DTensor on the world-1 mesh: constrain lays it out (replicated)
    from torch.distributed.tensor import distribute_tensor
    dt = distribute_tensor(torch.arange(8.).view(2, 4), mesh,
                           (Replicate(), Replicate()))
    with use_mesh(mesh):
        assert constrain(dt, "batch", "embed") is dt   # one device
    np.testing.assert_array_equal(dt.full_tensor().numpy(),
                                  np.arange(8.).reshape(2, 4))
