"""The port's residual stream split by positions over ``model``
(``seq_sp``: Megatron's sequence parallelism) where it falls back to a
whole stream, and the Mamba channels and xLSTM heads that fall across
ranks, on the CPU over gloo against the JAX package's jitted step on
meshes of the same shape over forced host devices.

Every process runs at once, under one time limit: two port ranks on a
(1, 2) ("data", "model") mesh and four on (1, 4)
(``tests/torch_tp_worker.py``'s ``seq`` suite), and one JAX process per
mesh shape.  Each runs the cases of ``SEQ_CASES`` that name its mesh,
three AdamW steps each, from the same JAX-initialised weights: reduced
smollm-360m at (1, 2) under rules with ``seq_sp: ()`` in both packages
and at S 31, which does not divide (both a whole stream); reduced
jamba-v0.1-52b with d_model 3 (``d_inner`` 6 over model 4 while
``in_proj``'s 12 columns split; Mamba and attention) and reduced
xlstm-350m with 2 heads (8 ``qkv`` columns a rank, half a head) at
(1, 4), both with the stream split by positions.  The (1, 2) ranks then
count what one forward of the loss saves for the backward, under both
rules.

Tolerances are ``tests/test_torch_tensor_parallel.py``'s: losses and
gradient norms rtol 1e-4, parameters atol 5e-4, rtol 5e-3.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import json
import math
import pickle
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.bridge import params_to_jax
from repro_torch.sharding.rules import spec_axes

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_worker as W  # noqa: E402
from test_torch_tensor_parallel import (LIMIT_S, TOL, _assembled,  # noqa: E402
                                        _coords, _init, _specs, _start,
                                        layout_runs)

SUITE = "seq"
SEQ_MESHES = ("1x2", "1x4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_seq")
    for case in W.SEQ_CASES:
        _init(case, out / case)
    procs = [_start(["port", r, math.prod(W.mesh_shape(m)),
                     out / f"store{m}", out, m, SUITE])
             for m in SEQ_MESHES for r in range(math.prod(W.mesh_shape(m)))]
    procs += [_start(["jax", out, m, SUITE], devices=4) for m in SEQ_MESHES]
    deadline = time.monotonic() + LIMIT_S
    try:
        for p in procs:
            log, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


CASE_MESH = [(c, m) for c in W.SEQ_CASES for m in W.case_meshes(c)]
#: the weights each case splits over ``model``
SPLIT = {"smollm_whole": "attn.wq", "smollm_odd": "mlp.w_gate",
         "mamba_apart": "mamba.in_proj", "xlstm_apart": "w_gates"}


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_step_matches_jax_at_the_same_mesh(runs, case, shape):
    """Three steps: losses and gradient norms within rtol 1e-4 of JAX's
    jitted step on a mesh of the same shape (under the same rules),
    every parameter (put together from the ranks' blocks) within atol
    5e-4, rtol 5e-3; the case's weights are split over model."""
    port = json.loads((runs / case / f"port_{shape}.json").read_text())
    jres = pickle.loads((runs / case / f"jax_{shape}.pkl").read_bytes())
    np.testing.assert_allclose(port["loss"], jres["loss"], rtol=1e-4)
    np.testing.assert_allclose(port["grad_norm"], jres["grad_norm"],
                               rtol=1e-4)
    specs = _specs(case, shape)
    assert any("model" in spec_axes(e) for p, s in specs.items()
               if p.endswith(SPLIT[case]) for e in s)
    whole = _assembled(runs, case, shape)
    got = params_to_jax({p[len("model/"):]: t for p, t in whole.items()
                         if p.startswith("model/")}, W.config(case))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jres["params"])):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_whole_leaves_stay_equal_across_model_ranks(runs, case, shape):
    """After three steps every leaf not split over ``model`` (the norms,
    a Mamba's conv and scan weights whose channels do not divide, the
    xLSTM gates' whole weights, the optimizer step, a whole leaf's
    moments) is bit-identical on every model rank; the split leaves
    differ."""
    specs = _specs(case, shape)
    coords = _coords(shape)
    ranks = [torch.load(runs / case / f"port_{shape}_rank{r}.pt")
             for r in range(len(coords))]
    whole = [p for p, s in specs.items()
             if not any("model" in spec_axes(e) for e in s)]
    assert any(p.endswith("norm") for p in whole)
    for p in whole:
        for r in range(1, len(coords)):
            assert torch.equal(torch.as_tensor(ranks[r][p]),
                               torch.as_tensor(ranks[0][p])), (p, r)
    split = [p for p in specs if p not in whole]
    assert split and all(not torch.equal(ranks[0][p], ranks[1][p])
                         for p in split)


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_roofline_counts_the_collectives_the_step_issues(runs, case, shape):
    """``roofline.tensor_parallel_bytes`` (under the case's rules) equals,
    kind by kind, the collectives over ``model`` that each step handed
    over (calls and bytes); a whole stream reduce-scatters nothing, a
    split one does, and the gathered projections are all-gathered."""
    port = json.loads((runs / case / f"port_{shape}.json").read_text())
    roof = port["roofline"]
    assert roof["all-reduce"]["calls"] > 0
    assert (roof["reduce-scatter"]["calls"] > 0) == case.endswith("apart")
    assert roof["all-gather"]["calls"] > 0 or case.startswith("smollm")
    for counted in port["counted"]:
        assert counted == roof


@pytest.mark.parametrize("layout", ["split", "whole"])
def test_each_block_saves_its_block_of_the_positions(runs, layout):
    """One forward of reduced smollm-360m's loss (3 layers) at (1, 2):
    autograd saves each block's input for the backward (remat), and that
    input holds S / 2 = 16 positions with the stream split by positions
    (the default rules), all 32 under ``seq_sp: ()``; the split forward
    saves fewer bytes."""
    got = json.loads((runs / "saved.json").read_text())
    rows = {"split": W.SEQ // 2, "whole": W.SEQ}[layout]
    assert got[layout]["rows"] == [rows] * W.SAVED_LAYERS
    assert all(got[layout]["saved"])
    assert got["split"]["bytes"] < got["whole"]["bytes"]


@pytest.mark.parametrize("model", [8, 16])
def test_xlstm_heads_apart_at_model_8_and_16(model):
    """Full xlstm-350m (4 heads of 256) at model 8 and 16: ``qkv`` splits
    into 128 or 64 columns a rank, part of a head.  ``make_train_step``
    builds the step, the roofline counts the stream split by positions
    (``layout_runs``), and on the whole stream each of the 12 mLSTM
    layers gathers ``wq``/``wk``/``wv`` and each of the 12 sLSTM layers
    ``w_gates`` and ``b_gates``, their gradients reduce-scattered: 60
    reduce-scatters, with no all-to-all."""
    whole = layout_runs(get_config("xlstm-350m"), (1, model))
    assert whole["reduce-scatter"]["calls"] == 12 * 3 + 12 * 2
    assert whole["all-to-all"]["calls"] == 0
