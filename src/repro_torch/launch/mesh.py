"""Meshes for the LM scaffold.

Port of ``repro.launch.mesh``. Single pod: 16x16 = 256 chips, axes
("data", "model"). Multi-pod: 2x16x16 = 512 chips, axes ("pod", "data",
"model"); the "pod" axis is pure data parallelism. The production meshes
hold shape and names only (no machine here has their cards): the
sharding rules need no more. ``make_host_mesh`` spreads the devices it is
given, which may repeat.
"""
from __future__ import annotations

from ..device import resolve_devices
from ..distributed.ctx import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1, devices=None) -> Mesh:
    """A ``(n // model, model)`` mesh, axes ("data", "model"), over
    ``resolve_devices(devices)``: every card unless given (a list that
    may repeat, ``["cpu"] * 4`` on the CPU). Raises ``ValueError`` when
    ``model`` does not divide n."""
    devs = resolve_devices(devices)
    n = len(devs)
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide "
                         f"{n} devices")
    return Mesh((n // model, model), ("data", "model"), devs)
