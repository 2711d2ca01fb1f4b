"""Processes for ``tests/test_torch_dist.py``: one rank of a gloo group
running the port, or a JAX process over forced host devices running the
reference.  Not a test module (pytest collects ``test_*.py`` only).

    python tests/torch_dist_worker.py psum RANK WORLD INIT_FILE OUT
    python tests/torch_dist_worker.py train RANK WORLD INIT_FILE OUT ARCH [KIND]
    python tests/torch_dist_worker.py jax-psum WORLD OUT
    python tests/torch_dist_worker.py jax-train WORLD OUT ARCH

A port rank joins its group through ``file://INIT_FILE``; the JAX cases
need ``XLA_FLAGS=--xla_force_host_platform_device_count=WORLD`` set
before JAX loads (the test sets it).  Results go under OUT.
"""

import json
import pathlib
import pickle
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: the gradients of the compressed-mean case: odd sizes pad the exchange
PSUM_SHAPES = {"w": (37, 5), "b": (64,), "s": (3,)}
STEPS, SEQ, BATCH = 3, 32, 8
#: AdamW at the card's ``[train]`` rate.  Its first update is +-lr on
#: every element, so float noise in near-zero gradients can flip signs:
#: at lr 3e-3 the port and JAX on ONE device already differ by 1.1e-4 in
#: reduced jamba's second loss (3e-4: 6e-7)
OPT = dict(lr=3e-4, warmup_steps=2)


def psum_grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {k: (rng.standard_normal(s) * (1 + rank)).astype(np.float32)
            for k, s in PSUM_SHAPES.items()}


def _join(rank, world, init_file):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    return make_local_mesh("cpu")


def port_psum(rank, world, init_file, out):
    import torch
    from repro_torch.training.grad_compress import (EXCHANGED,
                                                    make_compressed_allreduce)
    mesh = _join(rank, world, init_file)
    fn = make_compressed_allreduce(mesh)
    got = fn({k: torch.from_numpy(v) for k, v in psum_grads(rank).items()})
    np.savez(out / f"psum_rank{rank}.npz",
             **{k: v.numpy() for k, v in got.items()},
             exchanged=np.int64(EXCHANGED["bytes"]))


def port_train(rank, world, init_file, out, arch, kind="adamw"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (abstract_train_state,
                                                 init_train_state,
                                                 make_train_step,
                                                 state_specs)
    mesh = _join(rank, world, init_file)
    cfg = get_config(arch).reduced()
    opt = OptConfig(**OPT, kind=kind)
    _, axes = abstract_train_state(cfg, opt)
    state = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=9),
                         out / "ckpt0", mesh=mesh, axes=axes)
    torch.save(dict(ckpt.flatten(state)), out / f"restored_rank{rank}.pt")
    step = make_train_step(cfg, opt, mesh=mesh)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
    losses, norms = [], []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.save(dict(ckpt.flatten(state)), out / f"final_rank{rank}.pt")
    ckpt.save(state, out / "ckpt_w2", STEPS, mesh=mesh,
              specs=state_specs(cfg, opt, mesh))
    if rank == 0:
        (out / "port_losses.json").write_text(json.dumps(
            {"loss": losses, "grad_norm": norms}))


def jax_psum(world, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.sharding.compat import shard_map_unchecked
    from repro.training.grad_compress import compressed_psum_mean
    mesh = jax.make_mesh((world,), ("data",))
    res = {}
    for k in PSUM_SHAPES:
        stacked = jnp.stack([psum_grads(r)[k] for r in range(world)])
        fn = shard_map_unchecked(
            lambda g: compressed_psum_mean(g[0], "data")[None], mesh,
            P("data"), P("data"))
        res[k] = np.asarray(jax.jit(fn)(stacked))
    np.savez(out / "psum_jax.npz", **res)


def jax_train(world, out, arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data.lm_data import LMDataConfig, SyntheticLMStream
    from jax.sharding import AxisType
    from repro.sharding import use_mesh
    from repro.sharding.partition import tree_shardings
    from repro.training.optimizer import OptConfig, init_opt_state
    from repro.training.train_loop import (TrainState, abstract_train_state,
                                           make_train_step)
    assert jax.device_count() == world
    cfg = get_config(arch).reduced()
    opt = OptConfig(**OPT)
    params = jax.tree.map(jnp.asarray,
                          pickle.loads((out / "init.pkl").read_bytes()))
    # launch.mesh.make_local_mesh's (world, 1) mesh, with the Auto axes
    # its constrain hints need on this jax (make_mesh defaults to Explicit)
    mesh = jax.make_mesh((world, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    s_shapes, s_axes = abstract_train_state(cfg, opt)
    s_sh = tree_shardings(s_shapes, s_axes, mesh)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
    losses, norms = [], []
    with use_mesh(mesh):
        state = jax.device_put(
            TrainState(params, init_opt_state(params, opt)), s_sh)
        step = jax.jit(make_train_step(cfg, opt), in_shardings=(s_sh, None),
                       out_shardings=(s_sh, None))
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    (out / "jax_train.pkl").write_bytes(pickle.dumps(
        {"loss": losses, "grad_norm": norms,
         "params": jax.tree.map(np.asarray, state.params)}))


def main(argv):
    case = argv[0]
    if case == "psum":
        port_psum(int(argv[1]), int(argv[2]), argv[3], pathlib.Path(argv[4]))
    elif case == "train":
        port_train(int(argv[1]), int(argv[2]), argv[3], pathlib.Path(argv[4]),
                   *argv[5:7])
    elif case == "jax-psum":
        jax_psum(int(argv[1]), pathlib.Path(argv[2]))
    elif case == "jax-train":
        jax_train(int(argv[1]), pathlib.Path(argv[2]), argv[3])
    else:
        raise SystemExit(f"unknown case {case!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
