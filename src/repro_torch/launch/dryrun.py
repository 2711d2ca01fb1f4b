"""Multi-pod dry run on the ``meta`` device (port of
``repro.launch.dryrun``).

For every (architecture x input shape) cell of the assignment matrix on
the production meshes, (16, 16) single-pod and (2, 16, 16) multi-pod
(``launch.mesh.make_production_mesh``: shapes only), this builds the
cell's arguments on the ``meta`` device with the JAX dry run's per-arch
knobs (``TRAIN_KNOBS``): the AdamW train state and the batch (train),
the parameters and the prompt (prefill), or the parameters, a
``seq_len`` cache and one token (decode).  Nothing is allocated and no
card is needed: it is a shape computation.  Per cell it reports

* the per-device argument bytes: every leaf's bytes over the shard
  factor of the spec its logical axes resolve to on the mesh
  (``sharding.rules.spec_for``), by part (state or params, cache, batch);
* the FLOPs of the port's own step on meta tensors, counted by
  ``torch.utils.flop_counter.FlopCounterMode``: forward and backward with
  per-block remat (so one forward is recomputed) for a train cell, the
  prefill or the decode step otherwise; divided by the chips;
* ``roofline.analytic_bytes``, ``roofline.model_flops`` and the port's
  collective count (``roofline.collective_bytes``, a train cell's
  all-reduces over ``model`` among them), and the three
  roofline terms at the H100's rates.

Nothing is compiled, so there is no temporary-buffer ("temp") term, nor
an output term: ``bytes_per_device`` holds the arguments only, and each
report says so.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --summarize
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, SHAPE_NAMES, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.frontends import batch_axes, input_specs
from repro_torch.models.model import LM
from repro_torch.sharding import use_mesh
from repro_torch.sharding.partition import tree_specs
from repro_torch.sharding.rules import (is_axes_leaf, mesh_axis_sizes,
                                        shard_factor)
from repro_torch.training.checkpoint import flatten
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import abstract_train_state

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"

#: per-arch training knobs (the JAX dry run's)
TRAIN_KNOBS = {
    "llama4-maverick-400b-a17b": dict(microbatches=8, moment_dtype="bfloat16",
                                      accum_dtype="bfloat16"),
    "dbrx-132b": dict(microbatches=8, moment_dtype="bfloat16",
                      accum_dtype="bfloat16"),
    "llama-3.2-vision-90b": dict(microbatches=8, moment_dtype="bfloat16",
                                 accum_dtype="bfloat16"),
    "qwen3-32b": dict(microbatches=4),
    "jamba-v0.1-52b": dict(microbatches=8, accum_dtype="bfloat16"),
    "granite-8b": dict(microbatches=2),
}

NOTE = ("nothing is compiled: no temporary-buffer or output term; "
        "bytes_per_device counts the arguments")


def _knobs(arch: str) -> dict:
    base = dict(microbatches=1, moment_dtype="float32",
                accum_dtype="float32")
    base.update(TRAIN_KNOBS.get(arch, {}))
    return base


def build_cell(cfg, shape, knobs: dict):
    """(args {part: {path: meta tensor}}, axes {part: {path: axes}}, run):
    the cell's arguments on the meta device and a function running its
    step on them."""
    batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
             for k, s in input_specs(cfg, shape).items()}
    parts_axes = {"batch": batch_axes(cfg, shape)}
    if shape.kind == "train":
        state, axes = abstract_train_state(
            cfg, OptConfig(moment_dtype=knobs["moment_dtype"]))
        args = {"state": dict(flatten(state)), "batch": batch}
        parts_axes["state"] = dict(flatten(axes, is_leaf=is_axes_leaf))

        def run():
            state.model.loss(batch, remat=True).backward()
        return args, parts_axes, run

    lm = LM(cfg, device="meta")
    args = {"params": dict(lm.named_parameters()), "batch": batch}
    parts_axes["params"] = lm.param_axes()
    extra = {k: batch[k] for k in ("frames", "image_embeds") if k in batch}
    if shape.kind == "prefill":
        def run():
            lm.prefill(batch.get("tokens"), **extra)
        return args, parts_axes, run

    # decode: one new token against a seq_len cache
    cache = lm.init_cache(shape.global_batch, shape.seq_len)
    fields = lm.cache_axes()
    args["cache"] = {k: getattr(cache, k) for k in fields}
    parts_axes["cache"] = fields

    def run():
        lm.decode_step(cache, batch.get("tokens"),
                       frames=batch.get("frames"))
    return args, parts_axes, run


def count_flops(run) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return float(counter.get_total_flops())


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, cfg=None, shape=None) -> dict:
    """One cell's report, written to ``out_dir``.  ``cfg`` and ``shape``
    replace the registry's (a reduced config, a smaller shape)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    knobs = _knobs(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.time()
    with use_mesh(mesh):
        args, axes, run = build_cell(cfg, shape, knobs)
        specs = {part: tree_specs(leaves, axes[part], mesh)
                 for part, leaves in args.items()}
        by_part = {part: float(sum(
            t.numel() * t.element_size() / shard_factor(specs[part][k], mesh)
            for k, t in leaves.items())) for part, leaves in args.items()}
        flops = count_flops(run)
    params = {k[len("model/"):]: t for k, t in args.get(
        "state", {}).items() if k.startswith("model/")} or args["params"]
    pspecs = {k: specs["state"][f"model/{k}"] for k in params} \
        if "state" in args else specs["params"]
    tp = None
    if shape.kind == "train":
        sizes = mesh_axis_sizes(mesh)
        rows = shape.global_batch // math.prod(
            sizes.get(a, 1) for a in rl.BATCH_AXES)
        tp = rl.tensor_parallel_bytes(cfg, pspecs, mesh, rows,
                                      shape.seq_len, knobs["microbatches"])
    coll = rl.collective_bytes(params, pspecs, mesh, shape.kind, tp)
    analytic = rl.analytic_bytes(cfg, shape, chips, knobs["microbatches"])
    report = rl.RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        model_flops=rl.model_flops(cfg, shape), hlo_flops=flops / chips,
        hlo_bytes=analytic, coll_bytes=coll,
        bytes_per_device={"args": sum(by_part.values()), "temp": None,
                          "out": None, **{f"args_{p}": b
                                          for p, b in by_part.items()}},
        analytic_bytes_dev=analytic)
    d = report.to_dict()
    d["flops_counted"] = flops
    d["build_s"] = time.time() - t0
    d["knobs"] = knobs
    d["note"] = NOTE
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__{shape.name}__{mesh_name}.json").write_text(
        json.dumps(d, indent=2))
    print(f"[{arch} {shape.name} {mesh_name}] args "
          f"{d['bytes_per_device']['args'] / 2 ** 30:.2f} GiB per device; "
          f"compute={report.compute_s * 1e3:.2f}ms "
          f"memory={report.memory_s * 1e3:.2f}ms "
          f"collective={report.collective_s * 1e3:.2f}ms "
          f"bottleneck={report.bottleneck} "
          f"fraction={report.roofline_fraction:.3f} ({NOTE})")
    return d


def summarize(out_dir: pathlib.Path) -> str:
    rows = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    lines = ["| arch | shape | mesh | compute(ms) | memory(ms) | coll(ms) | "
             "bottleneck | useful | roofline-frac | args GiB/dev |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        gib = r["bytes_per_device"]["args"] / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_s']*1e3:.2f} | {r['memory_s']*1e3:.2f} | "
            f"{r['collective_s']*1e3:.2f} | {r['bottleneck']} | "
            f"{r['usefulness']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{gib:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--summarize", action="store_true")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.summarize:
        print(summarize(out_dir))
        return

    archs = ARCH_NAMES if args.arch == "all" else (args.arch,)
    shapes = SHAPE_NAMES if args.shape == "all" else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not cfg.supports_shape(shape_name):
                print(f"[{arch} {shape_name}] SKIP (long_500k needs "
                      "sub-quadratic attention)")
                continue
            for multi_pod in meshes:
                try:
                    run_cell(arch, shape_name, multi_pod, out_dir)
                except Exception:
                    failures.append((arch, shape_name, multi_pod))
                    traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry run complete: every cell built and counted on meta tensors")


if __name__ == "__main__":
    main()
