"""Production meshes.

Counterpart of the reference's ``repro.launch.mesh``.  Single pod:
(16, 16) = 256 ranks, axes (data, model).  Multi-pod: (2, 16, 16) = 512
ranks, axes (pod, data, model); the pod axis extends data parallelism.

``make_production_mesh`` is a function (never a module-level constant),
so importing this module touches no process group.  It needs a
``torch.distributed`` group of exactly 256 (or 512) ranks and raises
:class:`MeshSizeError` otherwise.  ``make_rules`` is pure: it reads a
``DeviceMesh`` or an ``{axis: size}`` mapping (``SINGLE_POD`` and
``MULTI_POD`` give theirs), so the production rules can be computed on
one machine.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.sharding import MeshRules, axis_sizes

__all__ = ["make_production_mesh", "make_rules", "SINGLE_POD", "MULTI_POD",
           "MeshSizeError", "axis_map"]

SINGLE_POD = dict(shape=(16, 16), axes=("data", "model"))
MULTI_POD = dict(shape=(2, 16, 16), axes=("pod", "data", "model"))


class MeshSizeError(ValueError):
    """The process group does not have the ranks a production mesh needs."""


def axis_map(layout: dict) -> dict:
    """``{axis: size}`` of ``SINGLE_POD`` or ``MULTI_POD``."""
    return dict(zip(layout["axes"], layout["shape"]))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    layout = MULTI_POD if multi_pod else SINGLE_POD
    need = math.prod(layout["shape"])
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise MeshSizeError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh "
            f"{layout['shape']} needs a process group of {need} ranks, "
            f"this one has {have}")
    return init_device_mesh(device_type, layout["shape"],
                            mesh_dim_names=layout["axes"])


def make_rules(mesh) -> MeshRules:
    """MeshRules for either production mesh (the pod axis folds into
    data)."""
    if "pod" in axis_sizes(mesh):
        return MeshRules(mesh=mesh, data_axes=("pod", "data"))
    return MeshRules(mesh=mesh, data_axes=("data",))
