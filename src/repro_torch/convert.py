"""Carry Programs and machine states across from the reference package.

For this system the "weights" are the compiled Program and the machine
state. The reference package (``repro``) and the port hold them in
different classes and array libraries; these functions move them as plain
numpy arrays and dicts, so both packages can be fed the same program and
the same state without the port importing anything of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from .core.bsp import MachineState, from_words, to_words
from .core.compile import Program
from .core.isa import HardwareConfig


def program_to_arrays(program) -> Dict[str, Any]:
    """Every field of a ``Program`` dataclass (either package's) as numpy
    arrays and plain Python values; ``hw`` becomes a dict."""
    out = {f.name: getattr(program, f.name)
           for f in dataclasses.fields(program)}
    out["hw"] = dataclasses.asdict(program.hw)
    return out


def program_from_arrays(fields: Dict[str, Any]) -> Program:
    """The port's ``Program`` from ``program_to_arrays`` output: arrays are
    copied, ``hw`` may be a dict or a ``HardwareConfig``-like object."""
    f = dict(fields)
    hw = f.pop("hw")
    if not isinstance(hw, dict):
        hw = dataclasses.asdict(hw)
    for k, v in f.items():
        if isinstance(v, np.ndarray):
            f[k] = v.copy()
    f["outputs"] = {nm: (int(core), [int(r) for r in mregs])
                    for nm, (core, mregs) in f["outputs"].items()}
    f["state_regs"] = {nm: [[(int(c), int(r)) for c, r in locs]
                            for locs in words]
                       for nm, words in f["state_regs"].items()}
    f["stats"] = dict(f.get("stats") or {})
    return Program(hw=HardwareConfig(**hw), **f)


def state_from_numpy(leaves: Sequence[np.ndarray], device="cpu"
                     ) -> MachineState:
    """A ``MachineState`` (single ``[C, ...]`` or batched ``[B, C, ...]``)
    from the reference's six leaves as numpy arrays, in its order
    (regs, spads, gmem, flags, cache_tags, counters)."""
    regs, spads, gmem, flags, tags, counters = leaves
    return MachineState(
        regs=to_words(regs, device), spads=to_words(spads, device),
        gmem=to_words(gmem, device), flags=to_words(flags, device),
        cache_tags=torch.from_numpy(np.array(tags, np.int32)).to(device),
        counters=to_words(counters, device))


def state_to_numpy(state: MachineState):
    """The reference's leaf dtypes: uint32 words, int32 cache tags."""
    return (from_words(state.regs), from_words(state.spads),
            from_words(state.gmem), from_words(state.flags),
            state.cache_tags.detach().cpu().numpy().astype(np.int32),
            from_words(state.counters))
