"""Processes for ``tests/test_torch_tensor_parallel.py``: one rank of a
gloo group running the port's train step on a ("data", "model") mesh, or
a JAX process over forced host devices running the reference's jitted
step on a mesh of the same shape.  Not a test module (pytest collects
``test_*.py`` only).

    python tests/torch_tp_worker.py port RANK WORLD INIT_FILE OUT DxM [SUITE]
    python tests/torch_tp_worker.py jax OUT DxM [SUITE]
    python tests/torch_tp_worker.py units RANK INIT_FILE OUT

(``units``: one of two ranks of ``tests/test_torch_tp_collectives.py``.)

``SUITE`` is ``attn`` (the default: ``CASES``, for
``tests/test_torch_tensor_parallel.py``), ``recurrent``
(``RECURRENT_CASES``, for ``tests/test_torch_tp_recurrent.py``),
``xattn`` (``XATTN_CASES``, for ``tests/test_torch_tp_xattn.py``) or
``seq`` (``SEQ_CASES``, for ``tests/test_torch_tp_seq.py``).  Under the
default rules every case whose sequence divides over ``model`` runs with
the residual stream split by positions (``seq_sp``); ``CASE_RULES``
names the cases run under other rules, in both packages.  Every case of
the suite runs in turn on the meshes it names, each from the
weights under
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
#: case -> (arch, overrides of its reduced config, optimizer)
CASES = {
    "smollm": ("smollm-360m", {}, "adamw"),
    "gemma3": ("gemma3-4b-edge", {}, "adamw"),
    "gqa": ("qwen3-32b", {"num_kv_heads": 2}, "adamw"),  # QK-norm, 4 over 2
    "adafactor": ("smollm-360m", {}, "adafactor"),
    # 3 query heads over 1 KV head: qkv 48 -> 24 a rank cuts head 1
    "heads_cut": ("smollm-360m", {"num_heads": 3, "num_kv_heads": 1},
                  "adamw"),
    # 4 query heads over a single KV head: wk 16 -> 8 a rank
    "mqa": ("gemma-2b", {}, "adamw"),
    # 2 query heads over 1 KV head of width 6 at model 4: wq 12 -> 3 a
    # rank, wk (6) stays whole.  RoPE's half split needs an even head
    # width, and at model 2 an even width always splits wk too.
    "split_apart": ("smollm-360m", {"num_heads": 2, "num_kv_heads": 1,
                                    "head_dim": 6}, "adamw"),
    "moe": ("dbrx-132b", {}, "adamw"),                   # 4 experts, top-2
    "moe_mixed": ("llama4-maverick-400b-a17b", {},      # (attn, attn_moe),
                  "adafactor"),                          # 4 experts, top-1
}
#: the Mamba and xLSTM cases: reduced jamba (all 8 block kinds of its
#: pattern, 4 experts), a Mamba-only stack at model 4 (a rank's in_proj
#: block is half of x or half of z), reduced xlstm (sLSTM and mLSTM, 4
#: heads; at model 4 a rank's w_gates block is one gate)
RECURRENT_CASES = {
    "jamba": ("jamba-v0.1-52b", {}, "adamw"),
    "mamba_only": ("jamba-v0.1-52b", {"block_pattern": ("mamba", "attn"),
                                      "num_layers": 2}, "adamw"),
    "xlstm": ("xlstm-350m", {}, "adamw"),
}
#: cross-attention, the audio frontend and a MoE batch routed in fewer
#: dispatch groups than ranks: reduced llama-3.2-vision-90b (4 attention
#: and 1 cross-attention layer, 16 image rows; Adafactor, as the card
#: trains it), the same with 2 KV heads at model 4 (wk 32 -> 8 a rank
#: cuts a head of 16), reduced musicgen-large (frames in, the 512-way
#: head split) and reduced dbrx-132b at B 1 x S 31 over (1, 2) and B 2
#: x S 31 over (2, 2): 31 and 62 tokens route in 1 and 2 groups
XATTN_CASES = {
    "vision": ("llama-3.2-vision-90b", {}, "adafactor"),
    "vision_cut": ("llama-3.2-vision-90b", {"num_kv_heads": 2},
                   "adafactor"),
    "musicgen": ("musicgen-large", {}, "adamw"),
    "moe_few": ("dbrx-132b", {}, "adamw"),
}
#: the residual stream whole on every rank, and the layouts that fall
#: across ranks: reduced smollm-360m under rules with ``seq_sp: ()`` and
#: at S 31 (not dividing over model 2); reduced jamba-v0.1-52b with
#: d_model 3 (d_inner 6 over model 4 while in_proj's 12 columns split;
#: Mamba and attention) and reduced xlstm-350m with 2 heads (qkv 32 -> 8
#: columns a rank at model 4, half a head)
SEQ_CASES = {
    "smollm_whole": ("smollm-360m", {}, "adamw"),
    "smollm_odd": ("smollm-360m", {}, "adamw"),
    "mamba_apart": ("jamba-v0.1-52b", {"d_model": 3,
                                       "block_pattern": ("mamba", "attn"),
                                       "num_layers": 2}, "adamw"),
    "xlstm_apart": ("xlstm-350m", {"num_heads": 2, "num_kv_heads": 2},
                    "adamw"),
}
ALL_CASES = {**CASES, **RECURRENT_CASES, **XATTN_CASES, **SEQ_CASES}
SUITES = {"attn": CASES, "recurrent": RECURRENT_CASES, "xattn": XATTN_CASES,
          "seq": SEQ_CASES}
MESHES = ("1x2", "2x2", "1x4")
#: the cases that run on other meshes than (1, 2) and (2, 2)
CASE_MESHES = {"split_apart": ("1x4",), "mamba_only": ("1x4",),
               "xlstm": MESHES, "vision_cut": ("1x4",),
               "smollm_whole": ("1x2",), "smollm_odd": ("1x2",),
               "mamba_apart": ("1x4",), "xlstm_apart": ("1x4",)}
#: (global batch, sequence) of a case on a mesh, where not (BATCH, SEQ)
CASE_SHAPES = {("moe_few", "1x2"): (1, 31), ("moe_few", "2x2"): (2, 31),
               ("smollm_odd", "1x2"): (BATCH, 31)}
#: the cases run under rules of their own: the default ones with these
#: logical axes' mappings replaced
CASE_RULES = {"smollm_whole": {"seq_sp": ()}}


def case_rules(case, jax_side=False):
    """The rules ``case`` runs under, in JAX's package or the port's."""
    if jax_side:
        from repro.sharding.rules import DEFAULT_RULES
    else:
        from repro_torch.sharding.rules import DEFAULT_RULES
    return {**DEFAULT_RULES, **CASE_RULES.get(case, {})}


def case_meshes(case):
    """The mesh shapes ``case`` runs on."""
    return CASE_MESHES.get(case, ("1x2", "2x2"))


#: the (2, 2) run checkpoints the smollm case after this many steps; the
#: (1, 2) ranks resume it through ``plan_remesh`` for the last step
RESUME_AT = 2
RESUME_WAIT_S = 150


def case_shape(case, shape):
    """(global batch, sequence) of ``case`` on the mesh ``shape``."""
    return CASE_SHAPES.get((case, shape), (BATCH, SEQ))


def batches(case, shape, cfg, jax_side=False):
    """``batch(step)``: the numpy inputs of ``case`` on ``shape`` at a
    step, the same in JAX's process and the port's: the Markov stream's
    tokens and labels (each package's own stream), and for a stack with
    the audio frontend seeded frame embeddings in place of the tokens,
    for one with cross-attention seeded image embeddings (float32)."""
    if jax_side:
        from repro.data.lm_data import LMDataConfig, SyntheticLMStream
    else:
        from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    B, S = case_shape(case, shape)
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=B))

    def batch(step):
        out = dict(data.batch(step))
        rng = np.random.default_rng(1000 + step)
        if cfg.audio_frontend:
            out["frames"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
            del out["tokens"]
        if cfg.num_image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        return out
    return batch


def config(case, jax_side=False):
    arch, overrides, _ = ALL_CASES[case]
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), **overrides)


def mesh_shape(text):
    return tuple(int(x) for x in text.split("x"))


def port(rank, world, init_file, out, shape, suite="attn"):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.roofline import tensor_parallel_bytes
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding import use_mesh
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
    for case, (_, _, kind) in SUITES[suite].items():
        if shape not in case_meshes(case):
            continue
        cfg, opt = config(case), OptConfig(**OPT, kind=kind)
        rules = case_rules(case)
        d = out / case
        _, axes = abstract_train_state(cfg, opt)
        state = ckpt.restore(init_train_state(cfg, opt, device="cpu", seed=9),
                             d / "ckpt0", mesh=mesh, axes=axes)
        specs = state_specs(cfg, opt, mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        data = batches(case, shape, cfg)
        losses, norms, counted = [], [], []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v) if v.dtype == np.float32
                     else torch.from_numpy(v).long()
                     for k, v in data(i).items()}
            tp.reset_collectives()
            with use_mesh(mesh, rules):
                state, m = step(state, batch)
            counted.append(tp.snapshot())
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
                     cfg, pspecs, mesh, case_shape(case, shape)[0] // dims[0],
                     case_shape(case, shape)[1], optimizer=kind,
                     rules=rules)}))
    if dims == (1, 2) and suite == "attn":
        resume(rank, out)
    if dims == (1, 2) and suite == "seq":
        saved_inputs(rank, out, mesh)


#: layers of ``saved_inputs``' reduced smollm-360m
SAVED_LAYERS = 3


def saved_inputs(rank, out, mesh):
    """One forward of reduced smollm-360m's loss (``SAVED_LAYERS`` layers,
    each rank's blocks of the weights) at B ``BATCH`` x S ``SEQ`` over
    (1, 2), under the default rules and under ``seq_sp: ()``: the
    sequence length of each block's input, whether autograd saved it for
    the backward (``saved_tensors_hooks``; remat saves a block's inputs)
    and the bytes of every activation saved (the parameters aside).  Rank
    0 writes them to ``OUT/saved.json``."""
    import torch
    from repro_torch.models.model import LM
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.partition import local_shard
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import state_specs
    cfg = dataclasses.replace(config("smollm_whole"), num_layers=SAVED_LAYERS)
    lm = LM(cfg, device="cpu", seed=9)
    specs = state_specs(cfg, OptConfig(), mesh)
    for n, p in lm.named_parameters():
        p.data = local_shard(p.data, specs[f"model/{n}"], mesh)
    lm.requires_grad_(True)
    weights = {p.data_ptr() for p in lm.parameters()}
    batch = {k: torch.from_numpy(v).long()
             for k, v in batches("smollm_whole", "1x2", cfg)(0).items()}
    got = {}
    for name, case in (("split", "smollm"), ("whole", "smollm_whole")):
        rules = case_rules(case)
        inputs, saved = [], []
        hooks = [b.register_forward_pre_hook(
            lambda mod, args: inputs.append(args[0])) for b in lm.blocks]
        with use_mesh(mesh, rules), torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            lm.loss(batch)
        for h in hooks:
            h.remove()
        kept = {(t.data_ptr(), tuple(t.shape)) for t in saved}
        got[name] = {
            "rows": [x.shape[1] for x in inputs],
            "saved": [(x.data_ptr(), tuple(x.shape)) in kept for x in inputs],
            "bytes": sum(t.numel() * t.element_size() for t in saved
                         if t.data_ptr() not in weights)}
    if rank == 0:
        (out / "saved.json").write_text(json.dumps(got))


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


def jax_run(out, shape, suite="attn"):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.sharding import use_mesh
    from repro.sharding.partition import tree_shardings
    from repro.training.optimizer import OptConfig, init_opt_state
    from repro.training.train_loop import (TrainState, abstract_train_state,
                                           make_train_step)
    dims = mesh_shape(shape)
    mesh = jax.make_mesh(dims, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:dims[0] * dims[1]])
    for case, (_, _, kind) in SUITES[suite].items():
        if shape not in case_meshes(case):
            continue
        cfg, opt = config(case, jax_side=True), OptConfig(**OPT, kind=kind)
        rules = case_rules(case, jax_side=True)
        d = out / case
        params = jax.tree.map(jnp.asarray,
                              pickle.loads((d / "init.pkl").read_bytes()))
        s_shapes, s_axes = abstract_train_state(cfg, opt)
        s_sh = tree_shardings(s_shapes, s_axes, mesh)
        data = batches(case, shape, cfg, jax_side=True)
        losses, norms = [], []
        with use_mesh(mesh, rules):
            state = jax.device_put(
                TrainState(params, init_opt_state(params, opt)), s_sh)
            step = jax.jit(make_train_step(cfg, opt),
                           in_shardings=(s_sh, None),
                           out_shardings=(s_sh, None))
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in data(i).items()}
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        (d / f"jax_{shape}.pkl").write_bytes(pickle.dumps(
            {"loss": losses, "grad_norm": norms,
             "params": jax.tree.map(np.asarray, state.params)}))


#: the MoE block of ``units``: reduced dbrx with 4 experts (split over
#: model 2) and with 3 (whole), on a batch of MOE_B x MOE_S tokens
MOE_EXPERTS, MOE_B, MOE_S = (4, 3), 2, 8


def moe_block(experts):
    """(reduced dbrx's MoE block with ``experts`` experts, float32, from a
    fixed seed, and its input x (MOE_B, MOE_S, d_model), requiring
    grad); the same in every process."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(),
                              num_experts=experts)
    gen = torch.Generator().manual_seed(3)
    moe = MoE(cfg, gen, "cpu")
    moe.requires_grad_(True)
    x = torch.randn(MOE_B, MOE_S, cfg.d_model, generator=gen)
    return moe, x.requires_grad_(True)


#: rows each rank sends to rank 0 and rank 1 in ``units``' uneven
#: all-to-all
A2A_SPLITS = ((1, 3), (2, 1))
#: the groups of ``units``' channel exchange (Mamba's 2, the sLSTM's 4)
OWN_GROUPS = (2, 4)


def own_channels_input(groups):
    """A (5, groups x 4) tensor, the same in every process: ``groups``
    groups of 4 channels side by side."""
    import torch
    return torch.randn(5, groups * 4,
                       generator=torch.Generator().manual_seed(groups))


def row_split_operands():
    """(a (4, 6), w (6, 5), c (5, 4), d (4, 3)), the same in every
    process: out = tanh((a @ w) @ c) @ d, with a's columns and w's rows
    split (a row-split product), c's columns and d's rows split (the
    split work that reads the product whole)."""
    import torch
    gen = torch.Generator().manual_seed(7)
    return tuple(torch.randn(*s, generator=gen)
                 for s in ((4, 6), (6, 5), (5, 4), (4, 3)))


def units(rank, init_file, out):
    """Each new Function of ``sharding.tensor_parallel`` forward and
    backward on a two-rank gloo group, and the MoE block over a (1, 2)
    mesh; every input and result saved to ``OUT/units_rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.partition import local_shard
    from repro_torch.training.train_loop import state_specs
    from repro_torch.training.optimizer import OptConfig
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    group = mesh.get_group("model")
    got = {}
    gen = torch.Generator().manual_seed(rank)
    for name, fn, shape in (
            ("gather_sum_grad", lambda x: tp.gather_sum_grad(x, group, 1),
             (3, 2)),
            ("gather_own_grad", lambda x: tp.gather_own_grad(x, group, 0),
             (3, 2)),
            ("all_to_all_model", lambda x: tp.all_to_all_model(x, group),
             (4, 3))):
        x = torch.randn(shape, generator=gen).requires_grad_(True)
        y = fn(x)
        w = torch.randn(y.shape, generator=gen)
        (y * w).sum().backward()
        got[name] = {"x": x.detach(), "y": y.detach(), "w": w,
                     "grad": x.grad}
    # an all-to-all of per-rank sizes: rank 0 sends 1 row to itself and
    # 3 to rank 1, rank 1 sends 2 to rank 0 and 1 to itself
    send = A2A_SPLITS[rank]
    recv = [A2A_SPLITS[j][rank] for j in range(2)]
    x = torch.randn(sum(send), 3, generator=gen).requires_grad_(True)
    y = tp.all_to_all_model(x, group, send, recv)
    w = torch.randn(y.shape, generator=gen)
    (y * w).sum().backward()
    got["all_to_all_uneven"] = {"x": x.detach(), "y": y.detach(), "w": w,
                                "grad": x.grad}
    # this rank's channels of 2 and 4 groups from its block of columns
    for groups in OWN_GROUPS:
        full = own_channels_input(groups)
        width = full.shape[1] // 2
        x = full[:, rank * width:(rank + 1) * width].clone()
        x.requires_grad_(True)
        y = tp.own_channels(x, groups, group)
        w = torch.randn(y.shape, generator=gen)
        (y * w).sum().backward()
        got[f"own_channels{groups}"] = {"y": y.detach(), "w": w,
                                        "grad": x.grad}
    # a row-split product read whole by split work (Mamba's x_proj)
    a, wt, c, d = row_split_operands()
    blk = [m.clone() for m in (a[:, rank * 3:(rank + 1) * 3],
                               wt[rank * 3:(rank + 1) * 3],
                               c[:, rank * 2:(rank + 1) * 2],
                               d[rank * 2:(rank + 1) * 2])]
    for m in blk:
        m.requires_grad_(True)
    pr = tp.reduce_sum_grad(blk[0] @ blk[1], group)
    res = tp.reduce_from_model(torch.tanh(pr @ blk[2]) @ blk[3], group)
    tp.reset_collectives()
    res.square().sum().backward()
    got["reduce_sum_grad"] = {"out": res.detach(), "backward": tp.snapshot(),
                              "grads": [m.grad for m in blk]}
    for e in MOE_EXPERTS:
        moe, x = moe_block(e)
        specs = state_specs(moe.cfg, OptConfig(), mesh)
        for n, p in moe.named_parameters():
            spec = specs[f"model/blocks.0.moe.{n}"]
            p.data = local_shard(p.data, spec, mesh)
        tp.reset_collectives()
        with use_mesh(mesh):
            y, aux = moe(x)
        (y.square().sum() + aux).backward()
        got[f"moe{e}"] = {"y": y.detach(), "aux": aux.detach(),
                          "x_grad": x.grad, "counted": tp.snapshot(),
                          "grads": {n: p.grad for n, p in
                                    moe.named_parameters()}}
    torch.save(got, out / f"units_rank{rank}.pt")
    dist.destroy_process_group()


def main(argv):
    if argv[0] == "units":
        units(int(argv[1]), argv[2], pathlib.Path(argv[3]))
    elif argv[0] == "port":
        port(int(argv[1]), int(argv[2]), argv[3], pathlib.Path(argv[4]),
             *argv[5:7])
    elif argv[0] == "jax":
        jax_run(pathlib.Path(argv[1]), *argv[2:4])
    else:
        raise SystemExit(f"unknown case {argv[0]!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
