"""Logical-axis sharding rules with divisibility fallback (a copy of
``repro.sharding.rules``).

Tensors are annotated with *logical* axis names ("batch", "heads", "mlp",
...).  A rules table maps each logical axis to a tuple of mesh axes.
``spec_for`` resolves an annotation to a concrete :class:`PartitionSpec`
given the actual dimension sizes, degrading gracefully:

* a logical axis whose dimension does not divide by the mapped mesh axes
  is left unsharded (15-head smollm and batch-1 decode on a 16x16 mesh);
* a composite mapping like ("pod", "data") drops trailing mesh axes until
  the product divides the dimension;
* a mesh axis is consumed at most once per tensor: the first annotation
  wins, later ones fall back to None.

A *mesh* is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``mesh.shape``), a shape-only :class:`MeshShape` for meshes that have no
processes (the production meshes of the dry run), or an object with
``axis_names`` and ``devices.shape`` (the JAX tests' ``FakeMesh``).
:func:`placements_for` turns a spec into DTensor placements.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

# logical axis -> preferred mesh axes (in priority order; composite tuples
# shard one dimension over several mesh axes)
DEFAULT_RULES: dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                 # replicated by default (activations)
    # sequence parallelism for the inter-block residual stream over "model"
    "seq_sp": ("model",),
    "kv_seq": ("model",),      # decode-time KV cache sequence dim (SP)
    "embed": (),               # activation d_model stays replicated across TP
    # weight d_model dim: FSDP-sharded over the data axis; with the "model"
    # split of the other dim this is 2D (FSDP x TP) weight sharding
    "embed_w": ("data",),
    "heads": ("model",),
    "kv_heads": (),            # usually too few to shard 16-way; see kv_seq
    "head_dim": (),
    "qkv": ("model",),         # flattened heads*head_dim projection dim
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    # MoE dispatch groups: local to a device; the group->expert reshard is
    # the MoE all-to-all
    "moe_groups": ("pod", "data", "model"),
    "expert_mlp": (),          # per-expert ff dim: experts already claim model
    "cap": (),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    "image_seq": (),
}

# Serving rule-set: small models replicate weights across the data axis
# (no per-token FSDP regather on the decode path); the model axis keeps TP.
SERVING_RULES = dict(DEFAULT_RULES)
SERVING_RULES["embed_w"] = ()


class PartitionSpec(tuple):
    """One entry per tensor dimension, trailing Nones trimmed: None
    (unsharded), a mesh axis name, or a tuple of names (one dimension over
    several mesh axes, major first).  Equal to ``jax.sharding.
    PartitionSpec`` of the same entries when both are compared as
    tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no processes behind it."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of any mesh this module takes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def is_axes_leaf(x) -> bool:
    """True for a tuple of logical-axis names (str/None): an annotation
    leaf, as opposed to a structural tuple of subtrees."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def resolve_axis(
    logical: Optional[str],
    dim: int,
    mesh,
    rules: Mapping[str, Tuple[str, ...]],
    used: set,
) -> Optional[Tuple[str, ...]]:
    """Resolve one logical axis to mesh axes (or None), respecting
    divisibility."""
    if logical is None:
        return None
    mapped = rules.get(logical, ())
    sizes = mesh_axis_sizes(mesh)
    # keep only axes present in this mesh and not already used in this spec
    avail = [a for a in mapped if a in sizes and a not in used]
    # drop trailing axes until the product divides the dimension
    while avail:
        prod = 1
        for a in avail:
            prod *= sizes[a]
        if prod > 0 and dim % prod == 0 and prod > 1:
            for a in avail:
                used.add(a)
            return tuple(avail)
        avail.pop()
    return None


def spec_for(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh,
    rules: Optional[Mapping[str, Tuple[str, ...]]] = None,
) -> PartitionSpec:
    rules = DEFAULT_RULES if rules is None else rules
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    parts = []
    for dim, logical in zip(shape, axes):
        resolved = resolve_axis(logical, dim, mesh, rules, used)
        if resolved is None:
            parts.append(None)
        elif len(resolved) == 1:
            parts.append(resolved[0])
        else:
            parts.append(resolved)
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factor(spec: PartitionSpec, mesh) -> int:
    """How many pieces a tensor laid out by ``spec`` is cut into."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for e in spec for a in spec_axes(e))


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` when the spec shards tensor dimension d over it (a
    composite entry such as ("pod", "data") shards d on both), else
    ``Replicate()``."""
    from repro_torch.sharding.compat import dtensor
    Shard, Replicate = dtensor().Shard, dtensor().Replicate
    dim_of = {a: d for d, e in enumerate(spec) for a in spec_axes(e)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh_axis_sizes(mesh))
