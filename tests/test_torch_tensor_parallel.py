"""The port's tensor parallelism over the mesh's ``model`` axis on the CPU,
over gloo, against the JAX package's jitted step on meshes of the same
shape over forced host devices.

Every process of the comparison runs at once, under one time limit:
two port ranks on a (1, 2) ("data", "model") mesh, four on a (2, 2) one
(``tests/torch_tp_worker.py``; gloo through a ``file://`` store under
the test's temporary directory), and one JAX process per mesh shape
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and Auto
axes, on which GSPMD splits heads, MLP columns and the vocabulary over
``model`` by the JAX model's ``constrain`` hints.  Each runs every case
of ``torch_tp_worker.CASES`` from the same JAX-initialised weights:
reduced smollm-360m, gemma3-4b-edge and qwen3-32b cut to 2 KV heads
(QK-norm, grouped queries) with AdamW, and smollm with Adafactor, three
steps each.  At S 32 the default rules split the residual stream
between blocks by positions over ``model`` (``seq_sp``), in both
packages.

Tolerances are ``tests/test_torch_dist.py``'s: losses and gradient norms
rtol 1e-4, parameters atol 5e-4, rtol 5e-3.  A mesh of one rank is the
single-device step bit for bit; checkpoints reshard exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.model import LM as JLM
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_jax, params_to_jax
from repro_torch.models.model import LM
from repro_torch.sharding.rules import (DEFAULT_RULES, MeshShape,
                                        mesh_axis_sizes, spec_axes)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_loop import (TrainState, init_train_state,
                                             make_train_step, state_specs)

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(Path(__file__).parent / "torch_tp_worker.py")
LIMIT_S = 300              # the processes' common limit (~35 s alone)
TOL = dict(atol=5e-4, rtol=5e-3)


def _env(devices=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def _start(args, devices=None):
    return subprocess.Popen([sys.executable, WORKER, *map(str, args)],
                            env=_env(devices), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _init(case, d: Path):
    """JAX init params (numpy) for the JAX process, and the same weights
    with zero optimizer state as the port's step-0 checkpoint."""
    d.mkdir(parents=True)
    jcfg, cfg = W.config(case, jax_side=True), W.config(case)
    params = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(2)))
    (d / "init.pkl").write_bytes(pickle.dumps(params))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(params, cfg))
    lm.requires_grad_(True)
    opt = OptConfig(**W.OPT, kind=W.ALL_CASES[case][2])
    ckpt.save(TrainState(lm, init_opt_state(dict(lm.named_parameters()), opt,
                                            len(cfg.block_pattern))),
              d / "ckpt0", 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    for case in W.CASES:
        _init(case, out / case)
    procs = [_start(["port", r, math.prod(W.mesh_shape(m)),
                     out / f"store{m}", out, m])
             for m in W.MESHES for r in range(math.prod(W.mesh_shape(m)))]
    procs += [_start(["jax", out, m], devices=4) for m in W.MESHES]
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


def _specs(case, shape):
    cfg = W.config(case)
    opt = OptConfig(**W.OPT, kind=W.ALL_CASES[case][2])
    return state_specs(cfg, opt, MeshShape(("data", "model"),
                                           W.mesh_shape(shape)))


def _coords(shape):
    """Each rank's (data, model) coordinate: a DeviceMesh is row-major."""
    dims = W.mesh_shape(shape)
    return [divmod(r, dims[1]) for r in range(math.prod(dims))]


def _block(full_shape, spec, sizes, coord):
    """The index of the block of a tensor of ``full_shape`` laid out by
    ``spec`` that the rank at ``coord`` ({axis: index}) holds."""
    idx = []
    for d, n_full in enumerate(full_shape):
        names = spec_axes(spec[d]) if d < len(spec) else ()
        n, i = 1, 0
        for a in names:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        idx.append(slice(i * n_full // n, (i + 1) * n_full // n))
    return tuple(idx)


def _assembled(out, case, shape) -> dict:
    """{path: full tensor} of the port's final state on ``shape``, put
    together from every rank's blocks."""
    specs = _specs(case, shape)
    sizes = dict(zip(("data", "model"), W.mesh_shape(shape)))
    full0 = dict(ckpt.flatten(ckpt.restore(
        init_train_state(W.config(case), OptConfig(
            **W.OPT, kind=W.ALL_CASES[case][2]), device="cpu"),
        out / case / "ckpt0")))
    ranks = [torch.load(out / case / f"port_{shape}_rank{r}.pt")
             for r in range(len(_coords(shape)))]
    whole = {}
    for p, t0 in full0.items():
        if not isinstance(t0, torch.Tensor):
            continue
        t = torch.empty_like(t0)
        for r, (dc, mc) in enumerate(_coords(shape)):
            t[_block(t0.shape, specs[p], sizes,
                     {"data": dc, "model": mc})] = ranks[r][p]
        whole[p] = t
    return whole


CASE_MESH = [(c, m) for c in W.CASES for m in W.case_meshes(c)]


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_step_matches_jax_at_the_same_mesh(runs, case, shape):
    """Three steps on (1, 2) and (2, 2): losses and gradient norms within
    rtol 1e-4 of JAX's jitted step on a mesh of the same shape, every
    parameter (put together from the ranks' blocks) within atol 5e-4,
    rtol 5e-3; something is split over model."""
    port = json.loads((runs / case / f"port_{shape}.json").read_text())
    jres = pickle.loads((runs / case / f"jax_{shape}.pkl").read_bytes())
    np.testing.assert_allclose(port["loss"], jres["loss"], rtol=1e-4)
    np.testing.assert_allclose(port["grad_norm"], jres["grad_norm"],
                               rtol=1e-4)
    specs = _specs(case, shape)
    assert any("model" in spec_axes(e) for s in specs.values() for e in s)
    whole = _assembled(runs, case, shape)
    cfg = W.config(case)
    got = params_to_jax({p[len("model/"):]: t for p, t in whole.items()
                         if p.startswith("model/")}, cfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jres["params"])):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("case,shape", CASE_MESH)
def test_whole_leaves_stay_equal_across_model_ranks(runs, case, shape):
    """After three steps, every leaf not split over ``model`` (the norms,
    QK-norm weights, the optimizer step and such leaves' statistics) is
    bit-identical on the ranks that differ only in their model
    coordinate; the split leaves differ."""
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
    bytes, recorded by ``tensor_parallel``'s counter)."""
    port = json.loads((runs / case / f"port_{shape}.json").read_text())
    assert port["roofline"]["all-reduce"]["calls"] > 0
    for counted in port["counted"]:
        assert counted == port["roofline"]


def test_collective_count_in_the_roofline_of_a_tp_mesh():
    """On a shape-only (1, 2) mesh the train cell's all-reduce term adds
    the step's tensor-parallel buffers at 2(n-1)/n; at model 1 nothing."""
    from repro_torch.launch import roofline as rl
    from repro_torch.sharding.partition import tree_specs
    cfg = get_config("smollm-360m").reduced()
    lm = LM(cfg, device="meta")
    params = dict(lm.named_parameters())
    for dims, want in (((1, 2), True), ((2, 1), False)):
        mesh = MeshShape(("data", "model"), dims)
        specs = tree_specs(params, lm.param_axes(), mesh)
        tp = rl.tensor_parallel_bytes(cfg, specs, mesh, 8 // dims[0], 32)
        assert (tp["all-reduce"]["bytes"] > 0) == want
        base = rl.collective_bytes(params, specs, mesh, "train")
        got = rl.collective_bytes(params, specs, mesh, "train", tp)
        n = dims[1]
        assert got["all-reduce"] == pytest.approx(
            base["all-reduce"] + tp["all-reduce"]["bytes"] * 2 * (n - 1) / n)


def test_moe_collectives_in_the_roofline_of_a_tp_mesh():
    """Reduced dbrx on a shape-only (1, 2) mesh: six all-to-alls of the
    (E, C, d_model) buffer a MoE layer (dispatch and combine, forward,
    recomputed and backward), the router gathered twice and its gradient
    reduce-scattered once beside the split stream's reduce-scatters; each
    kind enters the train cell's term at its
    ring factor (all-reduce 2(n-1)/n, the others (n-1)/n)."""
    import math as m
    from repro_torch.launch import roofline as rl
    from repro_torch.sharding.partition import tree_specs
    from repro_torch.sharding.tensor_parallel import KINDS
    cfg = get_config("dbrx-132b").reduced()
    lm = LM(cfg, device="meta")
    params = dict(lm.named_parameters())
    mesh = MeshShape(("data", "model"), (1, 2))
    specs = tree_specs(params, lm.param_axes(), mesh)
    tp = rl.tensor_parallel_bytes(cfg, specs, mesh, 8, 32)
    E, K, L = cfg.num_experts, cfg.experts_per_token, cfg.num_layers
    C = m.ceil(8 * 32 // 2 * K / E * cfg.moe_capacity_factor)
    assert tp["all-to-all"] == {"calls": 6 * L,
                                "bytes": 6 * L * E * C * cfg.d_model * 4}
    router = cfg.d_model * E * 4
    # beside the router's gradient, the stream split by positions: each
    # layer's attention input gradient and output (forward, recomputed)
    # and the MoE's input gradient and output, then the embedding's sum
    # and the head input's gradient
    act = 8 * 32 * cfg.d_model * 4
    assert tp["reduce-scatter"]["calls"] == L + 5 * L + 2
    assert tp["reduce-scatter"]["bytes"] == L * router + (5 * L + 2) * act
    base = rl.collective_bytes(params, specs, mesh, "train")
    got = rl.collective_bytes(params, specs, mesh, "train", tp)
    for k in KINDS:
        ring = 2 * 0.5 if k == "all-reduce" else 0.5
        assert got[k] == pytest.approx(base[k] + tp[k]["bytes"] * ring)
    assert rl.collective_bytes(params, specs, mesh, "decode")[
        "all-to-all"] == 0.0


def test_checkpoint_at_2x2_restores_at_1x1_4x1_and_1x2(runs):
    """The smollm case's checkpoint saved by the (2, 2) ranks after two
    steps (gathered, written by rank 0): restored onto (1, 1) it equals
    the restore with no mesh, and onto (4, 1) and (1, 2) each rank holds
    exactly its block of it (``restore(mesh=, axes=)`` is the reshard;
    ``test_plan_remesh_resumes_the_2x2_run_at_1x2`` trains on from it)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.train_loop import abstract_train_state
    cfg, opt = W.config("smollm"), OptConfig(**W.OPT)
    root = runs / "smollm" / "ckpt22"
    assert ckpt.latest_step(root) == W.RESUME_AT
    full = dict(ckpt.flatten(ckpt.restore(
        init_train_state(cfg, opt, device="cpu", seed=1), root)))
    _, axes = abstract_train_state(cfg, opt)
    one = dict(ckpt.flatten(ckpt.restore(
        init_train_state(cfg, opt, device="cpu", seed=1), root,
        mesh=make_local_mesh("cpu"), axes=axes)))
    for p, t in full.items():
        assert torch.equal(torch.as_tensor(one[p]), torch.as_tensor(t)), p
    for dims in ((4, 1), (1, 2)):
        mesh = MeshShape(("data", "model"), dims)
        specs = state_specs(cfg, opt, mesh)
        sizes = mesh_axis_sizes(mesh)
        assert any(specs[p] for p in full)
        for r in range(math.prod(dims)):
            dc, mc = divmod(r, dims[1])
            view = type("RankView", (), {
                "mesh_dim_names": ("data", "model"),
                "mesh": torch.empty(*dims),
                "get_coordinate": lambda self, c=(dc, mc): list(c)})()
            got = dict(ckpt.flatten(ckpt.restore(
                init_train_state(cfg, opt, device="cpu", seed=1), root,
                mesh=view, axes=axes)))
            for p, t in full.items():
                if isinstance(t, torch.Tensor):
                    want = t[_block(t.shape, specs[p], sizes,
                                    {"data": dc, "model": mc})]
                    assert torch.equal(got[p], want), (dims, r, p)


def test_plan_remesh_resumes_the_2x2_run_at_1x2(runs):
    """``plan_remesh(2, model_parallel=2, old_data_parallel=2)`` gives the
    (1, 2) mesh and two microbatches; the step resumed there from the
    (2, 2) checkpoint has the (2, 2) run's and JAX's third loss and
    gradient norm (rtol 1e-4)."""
    got = json.loads((runs / "smollm" / "resumed.json").read_text())
    assert got["mesh"] == [1, 2] and got["microbatches"] == 2
    port = json.loads((runs / "smollm" / "port_2x2.json").read_text())
    jres = pickle.loads((runs / "smollm" / "jax_2x2.pkl").read_bytes())
    for ref in (port, jres):
        np.testing.assert_allclose(got["loss"], ref["loss"][W.RESUME_AT],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"],
                                   ref["grad_norm"][W.RESUME_AT], rtol=1e-4)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_one_rank_mesh_is_the_single_device_step_bit_for_bit(kind):
    """At (1, 1) (``make_local_mesh``'s one-rank gloo group) two steps of
    reduced gemma3 (tied head) give the losses, norms and every leaf of
    the state bit for bit as the step with no mesh."""
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_config("gemma3-4b-edge").reduced()
    opt = OptConfig(**W.OPT, kind=kind)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=W.SEQ,
                                          global_batch=W.BATCH))
    runs = []
    for mesh in (None, make_local_mesh("cpu")):
        state = init_train_state(cfg, opt, device="cpu", seed=4)
        step = make_train_step(cfg, opt, mesh=mesh)
        metrics = []
        for i in range(2):
            state, m = step(state, {k: torch.from_numpy(v).long()
                                    for k, v in data.batch(i).items()})
            metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
        runs.append((metrics, dict(ckpt.flatten(state))))
    (m0, s0), (m1, s1) = runs
    for (a, b), (c, d) in zip(m0, m1):
        assert torch.equal(a, c) and torch.equal(b, d)
    for p, t in s0.items():
        assert torch.equal(torch.as_tensor(t), torch.as_tensor(s1[p])), p


#: rules under which the residual stream stays whole on every rank
WHOLE_STREAM = {**DEFAULT_RULES, "seq_sp": ()}


class RankView:
    """Rank 0's view of a ("data", "model") mesh of ``dims``: what
    ``make_train_step`` reads of a ``DeviceMesh`` before its first step
    (no process group exists)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, dims):
        self.mesh = torch.empty(*dims)

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, axis):
        return None


def layout_runs(cfg, dims):
    """``make_train_step`` builds ``cfg``'s step over the (data, model)
    mesh ``dims``, and the roofline of a B 1 x S 4096 step there splits
    the stream between blocks by positions (``seq_sp``): against the
    whole stream's count (``seq_sp: ()``) at least 5 more all-gathers and
    5 more reduce-scatters of the stream (S x d_model) a layer, as every
    block gathers its normed input (forward, recomputed) and its output's
    gradient and reduce-scatters its input's gradient and its output
    (the mixer's recomputed); at S 4095, which does not divide, the
    whole stream's count.  Returns the whole stream's count at S 4096."""
    from repro_torch.launch.roofline import tensor_parallel_bytes
    from repro_torch.sharding.partition import tree_specs
    assert callable(make_train_step(cfg, OptConfig(), mesh=RankView(dims)))
    mesh = MeshShape(("data", "model"), dims)
    lm = LM(cfg, device="meta")
    specs = tree_specs(dict(lm.named_parameters()), lm.param_axes(), mesh)
    split = tensor_parallel_bytes(cfg, specs, mesh, 1, 4096)
    whole = tensor_parallel_bytes(cfg, specs, mesh, 1, 4096,
                                  rules=WHOLE_STREAM)
    act = 4096 * cfg.d_model * {"float32": 4, "bfloat16": 2}[cfg.dtype]
    for kind in ("all-gather", "reduce-scatter"):
        assert split[kind]["bytes"] - whole[kind]["bytes"] >= \
            5 * cfg.num_layers * act, kind
    assert tensor_parallel_bytes(cfg, specs, mesh, 1, 4095) == \
        tensor_parallel_bytes(cfg, specs, mesh, 1, 4095, rules=WHOLE_STREAM)
    return whole


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "gemma-2b", "smollm-360m",
                                  "jamba-v0.1-52b", "xlstm-350m"])
def test_moe_and_cut_heads_are_not_refused(arch):
    """Full dbrx, llama4, gemma-2b (one KV head), smollm-360m (15 query
    over 5 KV heads), jamba-v0.1-52b (Mamba, Mamba + MoE) and xlstm-350m
    (sLSTM, mLSTM) over (1, 2): ``make_train_step`` builds the step and
    the roofline counts the stream split by positions
    (:func:`layout_runs`)."""
    layout_runs(get_config(arch), (1, 2))


def test_mamba_moe_blocks_are_not_refused():
    """A stack of ``attn_moe`` and ``mamba_moe`` blocks over (1, 2): the
    step builds and the roofline counts the split stream
    (:func:`layout_runs`)."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              block_pattern=("attn_moe", "mamba_moe"))
    layout_runs(cfg, (1, 2))


def test_remat_recomputes_under_the_callers_mesh():
    """``layers.remat``'s recomputation sees the mesh that was active in
    the forward even when the backward runs on another thread (on the
    card autograd runs it on its device thread, where the caller's
    thread-local ``use_mesh`` is not set)."""
    import threading
    from repro_torch.models.layers import remat
    from repro_torch.sharding import current_mesh, use_mesh
    mesh, seen = MeshShape(("data", "model"), (1, 2)), []

    def fn(x):
        seen.append(current_mesh())
        return (x * x).sum()
    x = torch.ones(3, requires_grad=True)
    with use_mesh(mesh):
        y = remat(fn, x)
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == [mesh, mesh] and torch.equal(x.grad, 2 * torch.ones(3))
