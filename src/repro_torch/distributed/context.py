"""Ambient mesh context for layers that need an explicit local map.

``with mesh_context(mesh): ...`` makes the mesh visible to model code
(the EP MoE path) without threading it through every call signature.
The mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

_STATE = threading.local()


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev
