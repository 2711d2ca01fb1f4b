"""Processes for ``tests/test_torch_tensor_parallel.py``: one rank of a
gloo group running the port's train step on a ("data", "model") mesh, or
a JAX process over forced host devices running the reference's jitted
step on a mesh of the same shape.  Not a test module (pytest collects
``test_*.py`` only).

    python tests/torch_tp_worker.py port RANK WORLD INIT_FILE OUT DxM
    python tests/torch_tp_worker.py jax OUT DxM

Every case of ``CASES`` runs in turn, each from the weights under
``OUT/<case>/`` (``init.pkl`` for JAX, the step-0 checkpoint ``ckpt0``
for the port, both written by the test).  A port rank joins its group
through ``file://INIT_FILE``; the JAX process needs
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX
loads (the test sets it).  Results go under OUT.
"""

import dataclasses
import json
import pathlib
import pickle
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STEPS, SEQ, BATCH = 3, 32, 8
#: AdamW at the card's rate (see ``tests/torch_dist_worker.py``)
OPT = dict(lr=3e-4, warmup_steps=2)
#: case -> (arch, num_kv_heads override or None, optimizer)
CASES = {
    "smollm": ("smollm-360m", None, "adamw"),
    "gemma3": ("gemma3-4b-edge", None, "adamw"),
    "gqa": ("qwen3-32b", 2, "adamw"),          # QK-norm, 4 heads over 2
    "adafactor": ("smollm-360m", None, "adafactor"),
}
#: the (2, 2) run checkpoints the smollm case after this many steps; the
#: (1, 2) ranks resume it through ``plan_remesh`` for the last step
RESUME_AT = 2
RESUME_WAIT_S = 150


def config(case, jax_side=False):
    arch, kv, _ = CASES[case]
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg


def mesh_shape(text):
    return tuple(int(x) for x in text.split("x"))


def port(rank, world, init_file, out, shape):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.launch.roofline import tensor_parallel_bytes
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (abstract_train_state,
                                                 init_train_state,
                                                 make_train_step,
                                                 state_specs)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    dims = mesh_shape(shape)
    mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
    for case, (_, _, kind) in CASES.items():
        cfg, opt = config(case), OptConfig(**OPT, kind=kind)
        d = out / case
        _, axes = abstract_train_state(cfg, opt)
        state = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=9),
                             d / "ckpt0", mesh=mesh, axes=axes)
        specs = state_specs(cfg, opt, mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        data = SyntheticLMStream(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH))
        losses, norms, counted = [], [], []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in data.batch(i).items()}
            tp.reset_collectives()
            state, m = step(state, batch)
            counted.append(dict(tp.COLLECTIVES))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if case == "smollm" and dims == (2, 2) and i + 1 == RESUME_AT:
                ckpt.save(state, d / "ckpt22", RESUME_AT, mesh=mesh,
                          specs=specs)
        torch.save(dict(ckpt.flatten(state)),
                   d / f"port_{shape}_rank{rank}.pt")
        if rank == 0:
            pspecs = {k[len("model/"):]: s for k, s in specs.items()
                      if k.startswith("model/")}
            (d / f"port_{shape}.json").write_text(json.dumps(
                {"loss": losses, "grad_norm": norms, "counted": counted,
                 "roofline": tensor_parallel_bytes(
                     cfg, pspecs, BATCH // dims[0], SEQ)}))
    if dims == (1, 2):
        resume(rank, out)


def resume(rank, out):
    """The smollm case's (2, 2) checkpoint resumed on two ranks through
    ``plan_remesh(2, model_parallel=2, old_data_parallel=2)``: its last
    step at (1, 2), the global batch kept by two microbatches."""
    import torch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.training.elastic import plan_remesh, resume_on_mesh
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (abstract_train_state,
                                                 init_train_state,
                                                 make_train_step)
    d = out / "smollm"
    deadline = time.monotonic() + RESUME_WAIT_S
    while not (d / "ckpt22" / f"step_{RESUME_AT:06d}").is_dir():
        if time.monotonic() > deadline:
            raise SystemExit("the (2, 2) checkpoint never appeared")
        time.sleep(0.2)
    cfg, opt = config("smollm"), OptConfig(**OPT)
    plan = plan_remesh(2, model_parallel=2, old_data_parallel=2,
                       device="cpu")
    _, axes = abstract_train_state(cfg, opt)
    state = resume_on_mesh(init_train_state(cfg, opt, device="cpu", seed=5),
                           axes, plan.mesh, d / "ckpt22")
    step = make_train_step(cfg, opt, mesh=plan.mesh,
                           microbatches=plan.microbatch_scale)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
    batch = {k: torch.from_numpy(v).long()
             for k, v in data.batch(RESUME_AT).items()}
    state, m = step(state, batch)
    if rank == 0:
        (d / "resumed.json").write_text(json.dumps(
            {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "mesh": list(plan.mesh.mesh.shape),
             "microbatches": plan.microbatch_scale}))


def jax_run(out, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro.sharding import use_mesh
    from repro.sharding.partition import tree_shardings
    from repro.training.optimizer import OptConfig, init_opt_state
    from repro.training.train_loop import (TrainState, abstract_train_state,
                                           make_train_step)
    dims = mesh_shape(shape)
    mesh = jax.make_mesh(dims, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:dims[0] * dims[1]])
    for case, (_, _, kind) in CASES.items():
        cfg, opt = config(case, jax_side=True), OptConfig(**OPT, kind=kind)
        d = out / case
        params = jax.tree.map(jnp.asarray,
                              pickle.loads((d / "init.pkl").read_bytes()))
        s_shapes, s_axes = abstract_train_state(cfg, opt)
        s_sh = tree_shardings(s_shapes, s_axes, mesh)
        data = SyntheticLMStream(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH))
        losses, norms = [], []
        with use_mesh(mesh):
            state = jax.device_put(
                TrainState(params, init_opt_state(params, opt)), s_sh)
            step = jax.jit(make_train_step(cfg, opt),
                           in_shardings=(s_sh, None),
                           out_shardings=(s_sh, None))
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        (d / f"jax_{shape}.pkl").write_bytes(pickle.dumps(
            {"loss": losses, "grad_norm": norms,
             "params": jax.tree.map(np.asarray, state.params)}))


def main(argv):
    if argv[0] == "port":
        port(int(argv[1]), int(argv[2]), argv[3], pathlib.Path(argv[4]),
             argv[5])
    elif argv[0] == "jax":
        jax_run(pathlib.Path(argv[1]), argv[2])
    else:
        raise SystemExit(f"unknown case {argv[0]!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
