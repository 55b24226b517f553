"""Production mesh construction.

Defined as functions (never module-level constants) so importing this
module initialises nothing: no process group, no device.

Every mesh is a ``torch.distributed`` ``DeviceMesh`` built by
``init_device_mesh`` over the process group the CALLER owns, as the
reference's caller owns ``--xla_force_host_platform_device_count``:
a real group on the card (NCCL), gloo for CPU tests, and the fake group
(``fake_world``) for shape-only work, where one process stands for
every rank of a 256- or 512-chip mesh.  A mesh whose size differs from
the group's world size raises.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _make(shape: Sequence[int], axes: Sequence[str],
          device_type: str) -> DeviceMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: the caller initialises one "
                           "(NCCL on the card, gloo on the CPU, or "
                           "launch.mesh.fake_world for shapes only)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: 16x16 = 256 chips (data, model).
    Multi-pod: 2x16x16 = 512 chips (pod, data, model); the ``pod`` axis
    crosses the data-centre network."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    return _make(shape, axes, device_type)


def host_device_mesh(n: int = 1, axis: str = "data",
                     device_type: str = "cuda") -> DeviceMesh:
    """A one-axis mesh of ``n`` ranks (tests: gloo on the CPU)."""
    return _make((n,), (axis,), device_type)


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks in this one process
    (rank 0), destroyed on exit: meshes of any size for work that reads
    only their shapes (shardings, placements).  No collective runs.  The
    fake backend is an internal module of torch
    (``torch.testing._internal.distributed.fake_pg``); a test pins it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
