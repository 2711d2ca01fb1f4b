"""Elastic scaling: survive node loss by re-meshing and resuming (port of
``repro.training.elastic``).

Flow on failure (the launcher's):
  1. detect the reduced device count (heartbeat timeout / restart with
     fewer hosts: ``torchrun`` relaunches the survivors)
  2. ``make_elastic_mesh(n_remaining)``: keep the model axis intact, shrink
     the data axis
  3. ``restore`` the latest checkpoint laid out by the specs resolved on
     the new mesh (``checkpoint.restore(mesh=, axes=)`` IS the reshard)
  4. rescale the per-rank batch or raise the microbatch count so the
     GLOBAL batch is kept, and continue from the recorded data step (the
     synthetic stream is a pure function of (seed, step): no replay log)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.training import checkpoint as ckpt


@dataclass
class ElasticPlan:
    mesh: Any
    data_parallel: int
    microbatch_scale: int   # multiply microbatches by this to keep global batch


def plan_remesh(device_count: int, model_parallel: int,
                old_data_parallel: int, device=None) -> ElasticPlan:
    mesh = make_elastic_mesh(device_count, model_parallel, device=device)
    new_dp = device_count // model_parallel
    if old_data_parallel % new_dp:
        raise ValueError(
            f"cannot keep global batch: old dp {old_data_parallel} not a "
            f"multiple of new dp {new_dp}")
    return ElasticPlan(mesh=mesh, data_parallel=new_dp,
                       microbatch_scale=old_data_parallel // new_dp)


def resume_on_mesh(state_template: Any, state_axes: Any, mesh,
                   ckpt_root, step: Optional[int] = None) -> Any:
    """Restore the latest checkpoint resharded onto ``mesh``: each leaf
    this rank's shard of its spec (``state_axes``: the axes tree of
    ``training.train_loop.abstract_train_state``)."""
    return ckpt.restore(state_template, ckpt_root, step=step, mesh=mesh,
                        axes=state_axes)
