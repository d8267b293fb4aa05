"""Elastic re-meshing (``repro/runtime/elastic.py``): plan a new mesh after
host loss or scale-up and restore the latest checkpoint onto it.

``plan_mesh`` is the host-side decision. ``elastic_restore`` recomputes the
train state's placements for the new mesh (``launch/specs.py``
``state_shardings``) and restores the checkpoint onto them: each leaf goes
to its placement's device and keeps its placement (one process holds
every shard), its values bitwise the checkpoint's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import Mesh


@dataclasses.dataclass
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    reason: str

    def build(self, device=None) -> Mesh:
        return Mesh(self.axes, self.shape, device)


def plan_mesh(total_chips: int, *, chips_per_host: int = 4,
              model_parallel: int = 16) -> MeshPlan:
    """Largest (data, model) mesh that fits the surviving chips.

    Keeps model-parallel fixed (weight placements stay valid) and shrinks
    the data axis: the batch redistributes, and the weights' placements
    along data shrink with it."""
    usable = (total_chips // model_parallel) * model_parallel
    data = usable // model_parallel
    if data < 1:
        raise ValueError(f"not enough chips ({total_chips}) for "
                         f"TP={model_parallel}")
    return MeshPlan((data, model_parallel), ("data", "model"),
                    reason=f"elastic: {total_chips} chips -> "
                           f"{data}x{model_parallel}")


def elastic_restore(ckpt, cfg, abstract_state, new_mesh):
    """The latest checkpoint of ``ckpt`` (a ``CheckpointManager``) in the
    structure of ``abstract_state``, placed for ``new_mesh``."""
    from repro_torch.launch.specs import state_shardings

    sh = state_shardings(cfg, new_mesh)
    return ckpt.restore(None, like=abstract_state, shardings=sh)
