"""Carry Programs, machine states and LM parameters across from the
reference package.

For the simulator the "weights" are the compiled Program and the machine
state; for the LM scaffold they are the parameter pytree. The reference
package (``repro``) and the port hold them in different classes and array
libraries; these functions move them as plain numpy arrays and dicts, so
both packages can be fed the same program, state and parameters without
the port importing anything of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from .core.bsp import MachineState, from_words, to_words
from .core.compile import Program
from .core.isa import HardwareConfig
from .device import resolve_device
from .optim.adamw import AdamWState


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


def state_from_numpy(leaves: Sequence[np.ndarray], device=None
                     ) -> MachineState:
    """A ``MachineState`` (single ``[C, ...]`` or batched ``[B, C, ...]``)
    from the reference's six leaves as numpy arrays, in its order
    (regs, spads, gmem, flags, cache_tags, counters), on ``device`` (None:
    the card, see ``device.resolve_device``)."""
    device = resolve_device(device)
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


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy holds bf16 as ml_dtypes.bfloat16, which torch cannot read:
        # carry the bit patterns through int16
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's LM parameters from the reference's parameter pytree with
    numpy leaves (``jax.tree.map(np.asarray, params)``): the same nested
    dict, name for name, stacked ``[L, ...]`` leaves kept, on ``device``
    (None: the card, see ``device.resolve_device``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: numpy leaves, bf16 as
    numpy's ``bfloat16``, the type that ``ml_dtypes`` registers when the
    reference package (JAX) is loaded; this module imports neither, so
    without it a bf16 leaf raises ``TypeError``."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def opt_state_from_jax(state, device=None) -> AdamWState:
    """The port's ``AdamWState`` from the reference's with numpy leaves
    (``jax.tree.map(np.asarray, opt)``): ``step`` an int32 scalar, ``m``,
    ``v`` (and ``ef`` when set) nested dicts like the parameters, on
    ``device`` (None: the card, see ``device.resolve_device``)."""
    device = resolve_device(device)
    ef = None if state.ef is None else params_from_jax(state.ef, device)
    return AdamWState(
        step=_leaf_from_numpy(np.asarray(state.step, np.int32), device),
        m=params_from_jax(state.m, device),
        v=params_from_jax(state.v, device), ef=ef)


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The inverse of ``opt_state_from_jax``: the same four fields with
    numpy leaves, which the reference's ``AdamWState(*...)`` takes."""
    return AdamWState(
        step=state.step.detach().cpu().numpy(),
        m=params_to_numpy(state.m), v=params_to_numpy(state.v),
        ef=None if state.ef is None else params_to_numpy(state.ef))
