"""Resolve logical-axis annotations for whole states, and move tensors
between their full form and this rank's shard (port of
``repro.sharding.partition``).

The port's trees are flat dicts keyed by path (``training.checkpoint.
flatten``: ``"model/blocks.0.attn.wq"``, ``"opt/m/embed"``), their axes
dicts of the same keys.  ``shard_tree`` cuts each full tensor to this
rank's block of its spec (every rank holds the full tensor: it was drawn
from the same seed or read from the same checkpoint, so no bytes move);
``gather_tree`` is the inverse, one all-gather over each sharding mesh
axis.  A spec entry of several mesh axes, ("pod", "data"), orders the
blocks major axis first, as a JAX ``NamedSharding`` does.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.sharding.rules import (PartitionSpec, mesh_axis_sizes,
                                        placements_for, spec_axes, spec_for)


def tree_specs(shapes: Dict[str, object], axes: Dict[str, tuple], mesh,
               rules=None) -> Dict[str, PartitionSpec]:
    """{key: PartitionSpec}: ``shapes`` values have ``.shape`` (tensors,
    meta tensors), ``axes`` the logical axes of the same keys."""
    return {k: spec_for(tuple(s.shape), axes[k], mesh, rules)
            for k, s in shapes.items()}


def tree_placements(shapes, axes, mesh, rules=None) -> Dict[str, tuple]:
    """{key: DTensor placements} of :func:`tree_specs`."""
    return {k: placements_for(s, mesh)
            for k, s in tree_specs(shapes, axes, mesh, rules).items()}


def replicated(mesh) -> tuple:
    """The placements of a tensor every rank holds whole."""
    return placements_for(PartitionSpec(), mesh)


def _coordinate(mesh) -> dict:
    """{axis name: this rank's index along it} on a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_shard(t: torch.Tensor, spec: PartitionSpec, mesh,
                axes=None) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` laid out by ``spec``
    (a contiguous copy when anything is cut, else ``t`` itself).
    ``axes``: cut over these mesh axes only, ``t`` being the block of the
    others (the reverse of :func:`gather_shard` with ``axes``)."""
    sizes, coord = mesh_axis_sizes(mesh), None
    out = t
    for d, entry in enumerate(spec):
        names = _cut_axes(entry, axes, "local_shard")
        if not names:
            continue
        coord = coord or _coordinate(mesh)
        n, idx = 1, 0
        for a in names:                        # major axis first
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        step = t.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out.contiguous().clone() if out is not t else t


def _cut_axes(entry, axes, who: str) -> tuple:
    """The mesh axes of a spec entry to cut or gather over: all of them,
    or with ``axes`` those of them in ``axes``, which must be the
    entry's minor ones."""
    names = spec_axes(entry)
    if axes is None:
        return names
    kept = [a for a in names if a not in axes]
    if names[:len(kept)] != tuple(kept):
        raise ValueError(f"{who}: cannot take {axes} out of {entry} and "
                         "keep the rest")
    return names[len(kept):]


def gather_shard(t: torch.Tensor, spec: PartitionSpec, mesh,
                 axes=None) -> torch.Tensor:
    """The full tensor from every rank's block ``t`` laid out by ``spec``
    (collective: every rank of the mesh calls it with its own block).
    ``axes``: gather over these mesh axes only and keep the others'
    blocks (the train step gathers over ``data`` and keeps ``model``'s);
    in an entry of several axes those gathered must be its minor ones."""
    from repro_torch.sharding.compat import all_gather_single
    out = t
    for d, entry in enumerate(spec):
        names = _cut_axes(entry, axes, "gather_shard")
        for a in reversed(names):              # minor axis first
            blocks = all_gather_single(out, group=mesh.get_group(a))
            out = torch.cat(blocks.unbind(0), dim=d)
    return out


def shard_tree(tree: Dict[str, torch.Tensor], specs, mesh):
    """{key: this rank's shard} of full tensors."""
    return {k: local_shard(t, specs[k], mesh) for k, t in tree.items()}


def gather_tree(tree: Dict[str, torch.Tensor], specs, mesh):
    """{key: full tensor} of this rank's shards (collective)."""
    return {k: gather_shard(t, specs[k], mesh) for k, t in tree.items()}
