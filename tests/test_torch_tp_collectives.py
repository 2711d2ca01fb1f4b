"""The collectives of ``sharding.tensor_parallel`` added for the cut heads,
the MoE's expert parallelism and the Mamba and xLSTM blocks (the
all-to-all at per-rank sizes, the exchange into a rank's channels, the
sum whose gradient is summed too), on a two-rank gloo group over the CPU
(``tests/torch_tp_worker.py units``), each held to what it must compute
forward and backward; and the MoE block over a (1, 2) ("data", "model")
mesh held to the same block under a shape-only (1, 2) mesh in one
process, which routes the same two dispatch groups with every expert.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.sharding import use_mesh
from repro_torch.sharding.rules import MeshShape

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(Path(__file__).parent / "torch_tp_worker.py")
LIMIT_S = 120


def _close(got, want) -> bool:
    """float32 agreement: max |got - want| within 1e-6 of max(1, max
    |want|), the same sums taken in another order (a rank's partials
    summed by the collective, one process's in place)."""
    scale = max(1.0, float(want.abs().max()))
    return got.shape == want.shape and \
        float((got - want).abs().max()) <= 1e-6 * scale


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("units")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "units", str(r), str(out / "store"),
         str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for p in procs:
            log, _ = p.communicate(timeout=LIMIT_S)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(out / f"units_rank{r}.pt") for r in range(2)]


def test_gather_sum_grad_gathers_and_sums_the_gradient(ranks):
    """Forward: both ranks' blocks side by side along the dimension.
    Backward: each rank's block of the sum over ranks of the incoming
    gradients (a reduce-scatter), since each rank's readers are partial."""
    a, b = (r["gather_sum_grad"] for r in ranks)
    whole = torch.cat([a["x"], b["x"]], dim=1)
    assert torch.equal(a["y"], whole) and torch.equal(b["y"], whole)
    total = a["w"] + b["w"]
    assert torch.allclose(a["grad"], total[:, :2], atol=1e-6)
    assert torch.allclose(b["grad"], total[:, 2:], atol=1e-6)


def test_gather_own_grad_takes_its_own_block_of_the_gradient(ranks):
    """Forward as above along rows; backward each rank's own rows of its
    own incoming gradient, with nothing summed."""
    a, b = (r["gather_own_grad"] for r in ranks)
    whole = torch.cat([a["x"], b["x"]], dim=0)
    assert torch.equal(a["y"], whole) and torch.equal(b["y"], whole)
    assert torch.equal(a["grad"], a["w"][:3])
    assert torch.equal(b["grad"], b["w"][3:])


def test_all_to_all_backward_is_the_reverse_exchange(ranks):
    """Forward: block j of rank r's result is block r of rank j's input.
    Backward: block j of rank r's input gradient is block r of rank j's
    incoming gradient."""
    xs = [r["all_to_all_model"] for r in ranks]
    for r in range(2):
        for j in range(2):
            rows = slice(2 * j, 2 * j + 2)
            own = slice(2 * r, 2 * r + 2)
            assert torch.equal(xs[r]["y"][rows], xs[j]["x"][own])
            assert torch.equal(xs[r]["grad"][rows], xs[j]["w"][own])


def test_all_to_all_at_per_rank_sizes(ranks):
    """Rank 0 sends 1 row to itself and 3 to rank 1, rank 1 sends 2 to
    rank 0 and 1 to itself: each result is what the ranks sent it, in
    rank order, and each input's gradient is the reverse exchange."""
    xs = [r["all_to_all_uneven"] for r in ranks]
    for r in range(2):
        y, grad, at = xs[r]["y"], xs[r]["grad"], 0
        for j in range(2):
            n = W.A2A_SPLITS[j][r]
            lo = sum(W.A2A_SPLITS[j][:r])
            assert torch.equal(y[at:at + n], xs[j]["x"][lo:lo + n])
            assert torch.equal(xs[j]["grad"][lo:lo + n],
                               xs[r]["w"][at:at + n])
            at += n
        assert at == y.shape[0] and grad.shape == xs[r]["x"].shape


@pytest.mark.parametrize("groups", W.OWN_GROUPS)
def test_own_channels_gives_each_rank_its_channels(ranks, groups):
    """From each rank's block of the columns of ``groups`` groups of 4
    channels (at 2 groups a block is one whole group, at 4 two whole
    groups), each rank gets its 2 channels of every group; its block's
    gradient is the incoming gradients put back where they came from."""
    full = W.own_channels_input(groups).view(5, groups, 4)
    grad = torch.zeros_like(full)
    for r, got in enumerate(ranks):
        g = got[f"own_channels{groups}"]
        assert torch.equal(g["y"], full[..., 2 * r:2 * r + 2])
        grad[..., 2 * r:2 * r + 2] = g["w"]
    grad = grad.reshape(5, -1)
    width = grad.shape[1] // 2
    for r, got in enumerate(ranks):
        assert torch.equal(got[f"own_channels{groups}"]["grad"],
                           grad[:, r * width:(r + 1) * width])


def test_reduce_sum_grad_is_the_one_process_gradient(ranks):
    """out = tanh((a @ w) @ c) @ d with a row-split first product (a's
    columns, w's rows) summed by ``reduce_sum_grad`` and read whole by
    split work (c's columns, d's rows) summed by ``reduce_from_model``:
    each rank's output and the gradients of its blocks equal one
    process's autograd within 1e-6 of the largest magnitude; the backward
    sums the product's gradient (one all-reduce) as the forward summed
    the product."""
    ops = [m.requires_grad_(True) for m in W.row_split_operands()]
    a, w, c, d = ops
    out = torch.tanh((a @ w) @ c) @ d
    out.square().sum().backward()
    cuts = ((1, 3), (0, 3), (1, 2), (0, 2))
    for r, got in enumerate(ranks):
        g = got["reduce_sum_grad"]
        assert _close(g["out"], out.detach())
        for m, mine, (dim, n) in zip(ops, g["grads"], cuts):
            assert _close(mine, m.grad.narrow(dim, r * n, n))
        assert g["backward"]["all-reduce"]["calls"] == 1


@pytest.mark.parametrize("experts", W.MOE_EXPERTS)
def test_moe_block_over_model_matches_one_process(ranks, experts):
    """Reduced dbrx's MoE block, float32, at (1, 2): each rank's output
    and auxiliary loss equal the block under a shape-only (1, 2) mesh in
    one process (two dispatch groups, every expert) within 1e-6 of their
    largest magnitude (:func:`_close`), as do the input's gradient and
    every parameter's gradient block, and the auxiliary loss is the same
    bits on both ranks.  With 4 experts they are split (the all-to-all);
    with 3 they stay whole."""
    from repro_torch.sharding.partition import local_shard
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import state_specs
    moe, x = W.moe_block(experts)
    mesh = MeshShape(("data", "model"), (1, 2))
    with use_mesh(mesh):
        y, aux = moe(x)
    (y.square().sum() + aux).backward()
    specs = state_specs(moe.cfg, OptConfig(), mesh)
    split = experts % 2 == 0
    for r, got in enumerate(ranks):
        g = got[f"moe{experts}"]
        assert _close(g["y"], y.detach())
        assert torch.equal(g["aux"], ranks[0][f"moe{experts}"]["aux"])
        assert _close(g["aux"], aux.detach())
        assert _close(g["x_grad"], x.grad)
        view = type("RankView", (), {
            "mesh_dim_names": ("data", "model"), "mesh": torch.empty(1, 2),
            "get_coordinate": lambda self, c=(0, r): list(c)})()
        for n, p in moe.named_parameters():
            want = local_shard(p.grad, specs[f"model/blocks.0.moe.{n}"],
                               view)
            assert _close(g["grads"][n], want), n
        # dispatch and combine, forward and backward (no remat here)
        assert g["counted"]["all-to-all"]["calls"] == (4 if split else 0)
