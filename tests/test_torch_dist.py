"""The port's multi-process training pieces on the CPU, over gloo, against
the JAX package on forced host devices.

Each port rank is a process of its own (``tests/torch_dist_worker.py``)
that joins its group through a ``file://`` store under the test's
``tmp_path`` (no TCP port is fixed); the JAX side runs in a process with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` set before JAX
loads.  Both sides of a comparison run at the same time; every process
has its own time limit.

Tolerances: the compressed mean is within one phase-2 quantization step
of JAX's (XLA contracts the JAX sum's multiply and add into a fused
multiply-add; the port rounds each dequantized chunk before adding it,
so the partial sums differ in their last bit for about a third of the
elements, which can move a phase-2 rounding by one step; the phase-1
int8 payloads and scales are equal bit for bit); the data-parallel train
steps use ``tests/test_torch_training.py``'s (losses and gradient norms
rtol 1e-4, parameters atol 5e-4, rtol 5e-3); elastic restores are exact.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import json
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

from repro.configs import get_config as jax_config
from repro.models.model import LM as JLM
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_jax, params_to_jax
from repro_torch.models.model import LM
from repro_torch.sharding.partition import shard_tree
from repro_torch.sharding.rules import MeshShape
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.grad_compress import (apply_error_feedback,
                                                compressed_psum_mean,
                                                init_error_state)
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_loop import (TrainState, init_train_state,
                                             make_train_step, state_specs)

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(Path(__file__).parent / "torch_dist_worker.py")
LIMIT_S = 120              # each process's limit (each test runs ~10-25 s)
TRAIN_TOL = dict(atol=5e-4, rtol=5e-3)


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


def _wait(procs):
    deadline = time.monotonic() + LIMIT_S
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _ranks(case, world, tmp_path, *extra):
    init = tmp_path / "store"
    return [_start([case, r, world, init, tmp_path, *extra])
            for r in range(world)]


# ----------------------------------------------------------- compressed mean
def test_compressed_mean_at_world_four_matches_jax(tmp_path):
    """Four ranks, a different gradient on each: every rank's result is
    within one phase-2 quantization step of JAX's ``compressed_psum_mean``
    under ``shard_map`` over four forced host devices, the same on every
    rank, and within two steps of the exact mean."""
    procs = _ranks("psum", 4, tmp_path) + [
        _start(["jax-psum", 4, tmp_path], devices=4)]
    _wait(procs)
    want = np.load(tmp_path / "psum_jax.npz")
    grads = [W.psum_grads(r) for r in range(4)]
    for r in range(4):
        got = np.load(tmp_path / f"psum_rank{r}.npz")
        for k in W.PSUM_SHAPES:
            step = np.abs(want[k][r]).max() / 127 * (1 + 1e-6)
            assert np.abs(got[k] - want[k][r]).max() <= step, k
            np.testing.assert_array_equal(
                got[k], np.load(tmp_path / "psum_rank0.npz")[k])
            exact = np.mean([g[k] for g in grads], axis=0)
            assert np.abs(got[k] - exact).max() <= 2 * step, k
        # int8 payloads: phase 1 (padded elements) + phase 2 (a chunk),
        # and three float32 scales; against 8 B/elem for a float32 ring
        n = {k: int(np.prod(s)) for k, s in W.PSUM_SHAPES.items()}
        padded = sum(-(-v // 4) * 4 for v in n.values())
        assert int(got["exchanged"]) == padded + padded // 4 + 4 * 2 * 3


def test_error_feedback_residual_is_exact_and_world_one_is_identity():
    """``tests/test_training.py``'s error-feedback and single-device
    identity cases, on a world-1 gloo group."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.grad_compress import make_compressed_allreduce
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(0, 1, 64)
                               .astype(np.float32))}
    err = init_error_state(g)
    deq, new_err = apply_error_feedback(g, err)
    np.testing.assert_allclose((deq["w"] + new_err["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)
    # a second round carries the residual in
    deq2, err2 = apply_error_feedback(g, new_err)
    np.testing.assert_allclose((deq2["w"] + err2["w"]).numpy(),
                               (g["w"] + new_err["w"]).numpy(), atol=1e-6)
    mesh = make_local_mesh("cpu")
    fn = make_compressed_allreduce(mesh)
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(0, 1, (8, 16))
                               .astype(np.float32))}
    out = fn(g)
    # int8 quantization error only (scale = max/127)
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(),
                               atol=float(g["w"].abs().max()) / 100)
    # world 1: the dequantized phase-2 value of the input itself
    np.testing.assert_array_equal(
        compressed_psum_mean(g["w"], mesh.get_group("data")).numpy(),
        apply_error_feedback(
            {"w": g["w"]}, init_error_state(g))[0]["w"].numpy())


# ------------------------------------------------------- data-parallel steps
def _jax_init(arch, tmp_path, seed=2, kind="adamw"):
    """JAX init params (numpy) pickled for the JAX process, and the same
    weights with zero optimizer state as a port checkpoint at step 0."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    params = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(seed)))
    (tmp_path / "init.pkl").write_bytes(pickle.dumps(params))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(params, cfg))
    lm.requires_grad_(True)
    opt = OptConfig(**W.OPT, kind=kind)
    state = TrainState(lm, init_opt_state(dict(lm.named_parameters()), opt,
                                          len(cfg.block_pattern)))
    ckpt.save(state, tmp_path / "ckpt0", 0)
    return cfg, opt, state


def _rank_view(rank, world):
    """Rank ``rank``'s view of a (world, 1) ("data", "model") mesh."""
    return type("RankView", (), {"mesh_dim_names": ("data", "model"),
                                 "mesh": torch.empty(world, 1),
                                 "get_coordinate": lambda self: [rank, 0]})()


def _run_dp(arch, tmp_path):
    cfg, opt, state0 = _jax_init(arch, tmp_path)
    _wait(_ranks("train", 2, tmp_path, arch) +
          [_start(["jax-train", 2, tmp_path, arch], devices=2)])
    specs = state_specs(cfg, opt, MeshShape(("data", "model"), (2, 1)))
    full0 = dict(ckpt.flatten(state0))
    # the restore onto a (2, 1) mesh laid every leaf out by its spec
    for r in range(2):
        got = torch.load(tmp_path / f"restored_rank{r}.pt")
        assert got.keys() == full0.keys()
        want = shard_tree(full0, specs, _rank_view(r, 2))
        for p, t in want.items():
            assert torch.equal(got[p], t), p
    assert any(specs[p] for p in full0)         # something was sharded
    jres = pickle.loads((tmp_path / "jax_train.pkl").read_bytes())
    port = json.loads((tmp_path / "port_losses.json").read_text())
    np.testing.assert_allclose(port["loss"], jres["loss"], rtol=1e-4)
    np.testing.assert_allclose(port["grad_norm"], jres["grad_norm"],
                               rtol=1e-4)
    # elastic: the world-2 checkpoint resumes at world 1 with every leaf
    # equal to the ranks' shards put together
    resumed = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=7),
                           tmp_path / "ckpt_w2")
    shards = [torch.load(tmp_path / f"final_rank{r}.pt") for r in range(2)]
    for p, t in ckpt.flatten(resumed):
        if not isinstance(t, torch.Tensor):
            continue
        parts = [s[p] for s in shards]
        d = next((i for i, e in enumerate(specs[p]) if e), None)
        whole = parts[0] if d is None else torch.cat(parts, dim=d)
        assert torch.equal(t, whole), p
    got = params_to_jax(resumed.model.state_dict(), cfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jres["params"])):
        np.testing.assert_allclose(a, b, **TRAIN_TOL)
    return cfg, opt, resumed, port


def _world_one(cfg, opt, tmp_path, port, resumed):
    """The port's single-device step from the same step-0 checkpoint on
    the same global batches: losses and every leaf of the state against
    the world-2 run's (resumed at world 1)."""
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    one = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=5),
                       tmp_path / "ckpt0")
    step = make_train_step(cfg, opt)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=W.SEQ, global_batch=W.BATCH))
    losses = []
    for i in range(W.STEPS):
        one, m = step(one, {k: torch.from_numpy(v).long()
                            for k, v in data.batch(i).items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(port["loss"], losses, rtol=1e-4)
    for (p, a), (q, b) in zip(ckpt.flatten(one), ckpt.flatten(resumed)):
        assert p == q
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), err_msg=p,
                                   **TRAIN_TOL)


def test_data_parallel_smollm_at_world_two_matches_jax_and_world_one(
        tmp_path):
    """Reduced smollm-360m, three AdamW steps on two ranks: losses, norms
    and parameters equal JAX's jitted step on a (2, 1) mesh of two forced
    host devices, and the port's own single-device step on the same
    global batches."""
    cfg, opt, resumed, port = _run_dp("smollm-360m", tmp_path)
    _world_one(cfg, opt, tmp_path, port, resumed)


def test_data_parallel_adafactor_at_world_two_equals_world_one(tmp_path):
    """Adafactor on two ranks: its factored statistics taken on the
    gathered gradient and kept as shards where their specs shard them;
    the losses and every leaf (parameters and statistics, resumed at
    world 1) equal the single-device run's."""
    cfg, opt, _ = _jax_init("smollm-360m", tmp_path, kind="adafactor")
    _wait(_ranks("train", 2, tmp_path, "smollm-360m", "adafactor"))
    specs = state_specs(cfg, opt, MeshShape(("data", "model"), (2, 1)))
    assert any(specs[p] for p in specs if p.startswith("opt/m/"))
    port = json.loads((tmp_path / "port_losses.json").read_text())
    resumed = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=7),
                           tmp_path / "ckpt_w2")
    _world_one(cfg, opt, tmp_path, port, resumed)


def test_data_parallel_jamba_at_world_two_matches_jax(tmp_path):
    """Reduced jamba (Mamba, MoE, attention): each rank routes its own
    rows as one dispatch group, as each device of JAX's (2, 1) mesh does;
    held to JAX only (its routing differs from one device's by design).
    One process under a shape-only (2, 1) mesh routes the same two groups
    itself: its first loss is JAX's too."""
    from repro_torch.sharding import use_mesh
    cfg, opt, _, port = _run_dp("jamba-v0.1-52b", tmp_path)
    jres = pickle.loads((tmp_path / "jax_train.pkl").read_bytes())
    state = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=4),
                         tmp_path / "ckpt0")
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
        LMDataConfig(vocab_size=cfg.vocab_size, seq_len=W.SEQ,
                     global_batch=W.BATCH)).batch(0).items()}
    with torch.no_grad(), use_mesh(MeshShape(("data", "model"), (2, 1))):
        loss = float(state.model.loss(batch))
    np.testing.assert_allclose(loss, jres["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(loss, port["loss"][0], rtol=1e-5)


# ---------------------------------------------------------------- elastic
def test_plan_remesh_mirrors_jax():
    from repro_torch.training.elastic import plan_remesh
    plan = plan_remesh(device_count=1, model_parallel=1, old_data_parallel=4,
                       device="cpu")
    assert plan.microbatch_scale == 4 and plan.data_parallel == 1
    assert plan.mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError):
        # model axis cannot exceed the surviving device count
        plan_remesh(device_count=1, model_parallel=2, old_data_parallel=4,
                    device="cpu")
    with pytest.raises(ValueError, match="relaunch"):
        plan_remesh(device_count=2, model_parallel=1, old_data_parallel=4,
                    device="cpu")


def test_resume_on_a_world_one_mesh_equals_restore(tmp_path):
    """``tests/test_checkpoint.py``'s restore onto another layout: a
    checkpoint resumed onto a (1, 1) mesh through ``resume_on_mesh`` is
    ``restore`` leaf for leaf."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.elastic import resume_on_mesh
    from repro_torch.training.train_loop import abstract_train_state
    cfg = get_config("smollm-360m").reduced()
    opt = OptConfig()
    ckpt.save(init_train_state(cfg, opt, device="cpu", seed=3), tmp_path, 1)
    _, axes = abstract_train_state(cfg, opt)
    a = resume_on_mesh(init_train_state(cfg, opt, device="cpu"), axes,
                       make_local_mesh("cpu"), tmp_path)
    b = ckpt.restore(init_train_state(cfg, opt, device="cpu"), tmp_path)
    for (pa, x), (pb, y) in zip(ckpt.flatten(a), ckpt.flatten(b)):
        assert pa == pb and torch.equal(torch.as_tensor(x),
                                        torch.as_tensor(y)), pa


# -------------------------------------------------------------------- CLI
def test_train_cli_under_two_ranks_equals_world_one(tmp_path):
    """``torchrun --standalone`` (its rendezvous takes a free port) runs
    ``launch.train`` on two CPU ranks: rank 0 prints the losses, equal to
    the single-process run on the same global batches within rtol 1e-4;
    its checkpoint resumes in a single process."""
    from repro_torch.launch import train as train_mod
    args = ["--arch", "smollm-360m", "--reduced", "--batch", "4", "--seq",
            "32", "--lr", "1e-3", "--device", "cpu", "--log-every", "1"]
    ck = tmp_path / "ck"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
         "--steps", "3", "--ckpt", str(ck), "--ckpt-every", "100"],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=LIMIT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    import re
    two = [float(x) for x in re.findall(r"step \d+: loss=([\d.]+)",
                                        out.stdout)]
    assert len(two) == 3                    # rank 0 alone prints
    straight = train_mod.main(args + ["--steps", "6"])
    np.testing.assert_allclose(two, straight[:3], rtol=1e-4)
    assert ckpt.latest_step(ck) == 3
    resumed = train_mod.main(args + ["--steps", "3", "--ckpt", str(ck),
                                     "--ckpt-every", "100"])
    np.testing.assert_allclose(resumed, straight[3:], rtol=1e-4)
