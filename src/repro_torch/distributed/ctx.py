"""Meshes and the mesh context.

Port of ``repro.distributed.ctx``. A ``Mesh`` is a grid of
``torch.device``s with named axes, ("pod",) "data", "model" (see
``launch/mesh.py``); a device may repeat (``["cuda:0"] * 4`` is four
shards of one card, ``["cpu"] * 4`` the CPU's counterpart of
``--xla_force_host_platform_device_count=4``). A mesh built with no
devices holds only its shape and names: the sharding rules need no more,
so they serve the production meshes on a machine that has not their 256
cards.

The reference's ``shard_act`` is a GSPMD sharding constraint on an
activation. The port runs each shard's work eagerly on its own device, so
there is nothing to constrain, and it has no counterpart.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()


class Mesh:
    """``axis_names`` over a grid of ``shape``; ``devices`` (any that
    ``torch.device`` takes, in row-major order, or None for a mesh of
    shape and names only). ``.shape`` maps each name to its size, as
    ``jax.sharding.Mesh.shape`` does; ``.devices`` is a numpy object
    array of ``torch.device`` of that shape, or None."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not name its axes "
                             f"{self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape))
        self.devices = None
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if len(devices) != self.size:
                raise ValueError(f"a {shape} mesh takes {self.size} devices, "
                                 f"got {len(devices)}")
            arr = np.empty(self.size, dtype=object)
            arr[:] = devices
            self.devices = arr.reshape(shape)

    def __repr__(self) -> str:
        where = ("no devices" if self.devices is None
                 else ", ".join(str(d) for d in self.devices.flat))
        return f"Mesh({dict(self.shape)}; {where})"


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _resolve(*names):
    """Drop mesh axes that do not exist (single-pod vs multi-pod meshes)."""
    mesh = current_mesh()
    out = []
    for n in names:
        if n is None or isinstance(n, (list, tuple)):
            out.append(n)
        elif mesh is not None and n not in mesh.axis_names:
            out.append(None)
        else:
            out.append(n)
    return tuple(out)


def batch_axes():
    """The data-parallel axes present in the current mesh."""
    mesh = current_mesh()
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod", "data")
    return "data"
