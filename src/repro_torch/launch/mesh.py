"""Device meshes of the port: ``torch.distributed`` device meshes with the
JAX package's axis names and shapes.

Functions, not module-level constants, so importing never touches the
process group.  A mesh covers the ranks of the process group the caller has
initialised (``torch.distributed.init_process_group``: NCCL, one rank a card,
or gloo on the CPU); ``make_test_mesh`` and ``make_production_mesh`` build
``init_device_mesh`` over it.  ``AbstractMesh`` is a mesh of axis names and
sizes alone, for spec work without ranks (the dry-run's 16x16 and 2x16x16
shapes on one process); ``ChipMesh`` is one of a data axis over a list of
devices (the elastic fleet's job meshes).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist


class AbstractMesh:
    """Axis name -> size, with no ranks behind it: what the sharding rules
    read of a mesh (``shape[axis]``, ``axis_names``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} for axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class ChipMesh(AbstractMesh):
    """A one-axis ``("data",)`` mesh over a list of devices in chip order,
    with no process group: the elastic fleet's counterpart of the JAX
    package's ``Mesh(devices, ("data",))``.  Several chips may name one
    device (logical chips of one card)."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        super().__init__((len(self.devices),), ("data",))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` (or anything whose ``shape``
    is such a dict) or of a ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _init_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, "
                         f"the process group has {world}")
    if _device_type() == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Two pods: 2x16x16 = 512 ranks ("pod", "data", "model").
    Raises unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(shape, axes)


def make_test_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the process group's ranks: ``cuda`` with
    NCCL, ``cpu`` with gloo."""
    return _init_mesh((data, model), ("data", "model"))
