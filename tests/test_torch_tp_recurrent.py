"""The port's tensor parallelism over ``model`` for the Mamba and xLSTM
stacks on the CPU, over gloo, against the JAX package's jitted step on
meshes of the same shape over forced host devices (Auto axes: GSPMD
splits ``ssm_inner``, ``qkv``, ``heads`` and ``mlp`` over ``model``).

Every process runs at once, under one time limit: two port ranks on a
(1, 2) ("data", "model") mesh, four on (2, 2), four on (1, 4)
(``tests/torch_tp_worker.py``'s ``recurrent`` suite) and one JAX process
per mesh shape.  Each runs the cases of ``RECURRENT_CASES`` that name
its mesh, three AdamW steps each, from the same JAX-initialised weights:
reduced jamba-v0.1-52b (all 8 block kinds of its pattern: Mamba,
Mamba + MoE, attention; 4 experts) at (1, 2) and (2, 2); a Mamba and
attention stack at (1, 4), where a rank's ``in_proj`` block is half of
x or half of z and the exchange into its channels takes per-rank sizes;
reduced xlstm-350m (sLSTM and mLSTM, 4 heads) at (1, 2), (2, 2) and
(1, 4), where a rank's ``w_gates`` block is one gate of every head.
Where the sequence divides over ``model`` the default rules split the
residual stream between blocks by positions (``seq_sp``).

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

SUITE = "recurrent"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_recurrent")
    for case in W.RECURRENT_CASES:
        _init(case, out / case)
    procs = [_start(["port", r, math.prod(W.mesh_shape(m)),
                     out / f"store{m}", out, m, SUITE])
             for m in W.MESHES for r in range(math.prod(W.mesh_shape(m)))]
    procs += [_start(["jax", out, m, SUITE], devices=4) for m in W.MESHES]
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


CASE_MESH = [(c, m) for c in W.RECURRENT_CASES for m in W.case_meshes(c)]


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_step_matches_jax_at_the_same_mesh(runs, case, shape):
    """Three steps: losses and gradient norms within rtol 1e-4 of JAX's
    jitted step on a mesh of the same shape, every parameter (put
    together from the ranks' blocks) within atol 5e-4, rtol 5e-3; the
    Mamba or xLSTM weights are split over model."""
    port = json.loads((runs / case / f"port_{shape}.json").read_text())
    jres = pickle.loads((runs / case / f"jax_{shape}.pkl").read_bytes())
    np.testing.assert_allclose(port["loss"], jres["loss"], rtol=1e-4)
    np.testing.assert_allclose(port["grad_norm"], jres["grad_norm"],
                               rtol=1e-4)
    specs = _specs(case, shape)
    mixers = ("mamba.in_proj", "mamba.conv_w", "w_gates", "r_gates", "wi")
    assert any("model" in spec_axes(e) for p, s in specs.items()
               if p.endswith(mixers) for e in s)
    whole = _assembled(runs, case, shape)
    got = params_to_jax({p[len("model/"):]: t for p, t in whole.items()
                         if p.startswith("model/")}, W.config(case))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jres["params"])):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_whole_leaves_stay_equal_across_model_ranks(runs, case, shape):
    """After three steps every leaf not split over ``model`` (the norms,
    the optimizer step, a whole leaf's moments) is bit-identical on the
    ranks that differ only in their model coordinate; the split leaves
    differ."""
    specs = _specs(case, shape)
    coords = _coords(shape)
    ranks = [torch.load(runs / case / f"port_{shape}_rank{r}.pt")
             for r in range(len(coords))]
    whole = [p for p, s in specs.items()
             if not any("model" in spec_axes(e) for e in s)]
    assert any(p.endswith("norm") for p in whole)
    for p in whole:
        for r, (dc, mc) in enumerate(coords):
            peer = coords.index((dc, 0))
            assert torch.equal(torch.as_tensor(ranks[r][p]),
                               torch.as_tensor(ranks[peer][p])), (p, r)
    split = [p for p in specs if p not in whole]
    assert split and all(not torch.equal(ranks[0][p], ranks[1][p])
                         for p in split)


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_roofline_counts_the_collectives_the_step_issues(runs, case, shape):
    """``roofline.tensor_parallel_bytes`` equals, kind by kind, the
    collectives over ``model`` that each step handed over (calls and
    bytes); the Mamba and sLSTM exchanges are all-to-alls."""
    port = json.loads((runs / case / f"port_{shape}.json").read_text())
    assert port["roofline"]["all-reduce"]["calls"] > 0
    assert port["roofline"]["all-to-all"]["calls"] > 0
    for counted in port["counted"]:
        assert counted == port["roofline"]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
@pytest.mark.parametrize("model", [2, 4])
def test_full_and_reduced_recurrent_stacks_pass_check_layout(arch, model):
    """Full and reduced jamba-v0.1-52b and xlstm-350m at model 2 and 4:
    ``make_train_step`` builds the step and the roofline counts the
    stream split by positions (``layout_runs``)."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        layout_runs(cfg, (1, model))
