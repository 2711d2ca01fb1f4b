"""The port's roofline and dry run against the JAX package's, and the
train CLI's card check.

``model_flops`` and ``analytic_bytes`` are copies: equal to JAX's for
every arch x shape x chip count.  The dry run builds every cell on the
``meta`` device: reduced configs of all eleven archs at one small shape
of each kind, and one full cell, smollm-360m ``train_4k`` on the 16 x 16
mesh, whose per-device state bytes equal the sum JAX's specs give and
whose FLOPs, counted on meta tensors, lie within 5% of remat's count:
8 N D (forward, the recomputed forward and a backward of twice the
forward, over every parameter including the tied head) plus four times
the plain attention's forward (4 B S^2 attn_dim a layer: the full S x S
products, no causal skip) — 2.19 times ``model_flops``'s 6 N D.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import json
import math

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro.models.frontends import input_specs as jax_input_specs
from repro.sharding.rules import spec_for as jax_spec_for
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.train_loop import abstract_train_state as jax_abstract
from repro_torch.configs import ALL_ARCH_NAMES, SHAPE_NAMES, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.sharding.rules import MeshShape

SMALL = (ShapeConfig("train_small", 8, 2, "train"),
         ShapeConfig("prefill_small", 8, 2, "prefill"),
         ShapeConfig("decode_small", 16, 2, "decode"))


def test_model_flops_and_analytic_bytes_equal_jax():
    for arch in ALL_ARCH_NAMES:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for name in SHAPE_NAMES:
            for chips in (1, 4, 256, 512):
                assert rl.model_flops(cfg, SHAPES[name]) == \
                    jrl.model_flops(jcfg, JSHAPES[name])
                for mb in (1, 8):
                    assert rl.analytic_bytes(cfg, SHAPES[name], chips, mb) \
                        == jrl.analytic_bytes(jcfg, JSHAPES[name], chips, mb)


@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_dry_run_builds_every_kind_of_cell_for_reduced_archs(arch, tmp_path):
    cfg = get_config(arch).reduced()
    for shape in SMALL:
        d = dryrun.run_cell(arch, shape.name, False, tmp_path, cfg=cfg,
                            shape=shape)
        assert d["flops_counted"] > 0 and d["bytes_per_device"]["args"] > 0
        assert d["bytes_per_device"]["temp"] is None and "temp" in d["note"]
        for k in ("compute_s", "memory_s", "collective_s"):
            assert math.isfinite(d[k]) and d[k] >= 0
        assert d["bottleneck"] in ("compute", "memory", "collective")
        written = json.loads((tmp_path / f"{arch}__{shape.name}__pod16x16"
                              ".json").read_text())
        assert written["model_flops"] == d["model_flops"]


def _jax_bytes_per_device(leaves, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0.0
    for shape, dtype, axes in leaves:
        spec = jax_spec_for(shape, axes, mesh)
        split = math.prod(sizes[a] for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        total += math.prod(shape) * np.dtype(dtype).itemsize / split
    return total


def test_full_smollm_train_cell_bytes_and_flops(tmp_path):
    import jax

    class FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((16, 16))
    d = dryrun.run_cell("smollm-360m", "train_4k", False, tmp_path)
    jcfg, cfg = jax_config("smollm-360m"), get_config("smollm-360m")
    js, ja = jax_abstract(jcfg, JOptConfig())
    leaves = [(s.shape, s.dtype, a) for s, a in zip(
        jax.tree.leaves(js), jax.tree.leaves(
            ja, is_leaf=lambda x: isinstance(x, tuple) and all(
                e is None or isinstance(e, str) for e in x)))]
    assert d["bytes_per_device"]["args_state"] == \
        _jax_bytes_per_device(leaves, FakeMesh)
    # the batch: JAX's int32 tokens and labels, the port's int64
    from repro.models.frontends import batch_axes as jax_batch_axes
    jb = jax_input_specs(jcfg, JSHAPES["train_4k"])
    jba = jax_batch_axes(jcfg, JSHAPES["train_4k"])
    assert d["bytes_per_device"]["args_batch"] == 2 * _jax_bytes_per_device(
        [(s.shape, s.dtype, jba[k]) for k, s in jb.items()], FakeMesh)
    shape = SHAPES["train_4k"]
    n, tokens = cfg.active_param_count(), shape.tokens
    attn = 4 * shape.global_batch * shape.seq_len ** 2 * cfg.attn_dim \
        * cfg.num_layers
    remat = 8 * n * tokens + 4 * attn
    assert 0.95 <= d["flops_counted"] / remat <= 1.05
    assert 2.0 <= d["flops_counted"] / d["model_flops"] <= 2.4
    # one pod: FSDP over data (16) and the matrices' other axis over model
    assert d["coll_bytes"]["all-to-all"] == 0.0
    assert d["coll_bytes"]["all-gather"] > 0
    # the activations over model (16 ranks), the stream between blocks
    # split by positions (seq_sp): 6 all-gathers and 5 reduce-scatters a
    # layer of 16 x 4096 tokens x 960 in bf16 and one of each for the
    # vocab-parallel embedding and for the head, beside the loss's
    # all-reduces, outweigh the FLOPs at 450 GB/s: collective-bound
    act = 16 * 4096 * cfg.d_model * 2
    L = cfg.num_layers
    assert d["coll_bytes"]["all-gather"] >= (6 * L + 2) * act * 15 / 16
    assert d["coll_bytes"]["reduce-scatter"] >= (5 * L + 2) * act * 15 / 16
    assert d["coll_bytes"]["all-reduce"] >= \
        (2 * 3 * 16 * 4096 * 4 + 4) * 2 * 15 / 16
    assert d["bottleneck"] == "collective"


def test_collective_count_of_a_data_parallel_mesh():
    """On (n, 1) meshes: a leaf sharded over data is gathered ((n-1)/n of
    its bytes) and its float32 gradient reduce-scattered; a replicated
    leaf's float32 gradient is all-reduced (2(n-1)/n); nothing at n 1."""
    from repro_torch.models.model import LM
    from repro_torch.sharding.partition import tree_specs
    cfg = get_config("smollm-360m").reduced()
    lm = LM(cfg, device="meta")
    params = dict(lm.named_parameters())
    for n in (1, 2, 4):
        mesh = MeshShape(("data", "model"), (n, 1))
        specs = tree_specs(params, lm.param_axes(), mesh)
        got = rl.collective_bytes(params, specs, mesh, "train")
        sharded = [p for k, p in params.items() if specs[k]]
        whole = [p for k, p in params.items() if not specs[k]]
        assert whole and (sharded or n == 1)
        f = (n - 1) / n
        assert got["all-gather"] == pytest.approx(
            f * sum(p.numel() * p.element_size() for p in sharded))
        assert got["reduce-scatter"] == pytest.approx(
            f * sum(4 * p.numel() for p in sharded))
        assert got["all-reduce"] == pytest.approx(
            2 * f * sum(4 * p.numel() for p in whole))
        assert got["all-to-all"] == 0.0
        inf = rl.collective_bytes(params, specs, mesh, "decode")
        assert inf["reduce-scatter"] == inf["all-reduce"] == 0.0


def test_dry_run_cli_and_summary(tmp_path, capsys):
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh",
                 "multi", "--out", str(tmp_path)])
    d = json.loads((tmp_path / "xlstm-350m__decode_32k__pod2x16x16.json")
                   .read_text())
    assert d["chips"] == 512 and d["knobs"]["microbatches"] == 1
    dryrun.main(["--summarize", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| xlstm-350m | decode_32k | pod2x16x16 |" in out


def test_card_check_lets_a_stack_without_attention_through():
    """``launch.train``'s card check: xlstm-350m (head width 256, no
    attention layer) and gemma3-4b-edge (256, attention: K3b takes it)
    pass; a stack at a head width K3b is not compiled for (96) is
    refused; every other text arch's attention takes K3b."""
    import dataclasses
    from repro_torch.launch.train import check_attention_backward
    check_attention_backward(get_config("xlstm-350m"))
    check_attention_backward(get_config("gemma3-4b-edge"))
    with pytest.raises(ValueError, match="head_dim 96"):
        check_attention_backward(dataclasses.replace(
            get_config("gemma3-4b-edge"), head_dim=96))
    for arch in ("smollm-360m", "jamba-v0.1-52b", "qwen3-32b",
                 "llama-3.2-vision-90b"):
        check_attention_backward(get_config(arch))
