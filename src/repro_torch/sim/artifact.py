# Copy of src/repro/sim/artifact.py (commit aa57dc1); imports may differ.
"""Persistent ``Program`` artifacts: one ``.npz`` file, versioned.

A compiled Program is the whole point of Manticore's economics — the
middle-end/partition/schedule/regalloc cost is paid once and the resulting
static binary simulates at hardware speed forever after. This module makes
that artifact durable: ``save_program``/``load_program`` serialize every
dense array (code, LUTs, init images, exchange tables, slot-op masks) in
native dtype inside a single NumPy ``.npz`` container, with the scalar and
structured metadata (hardware config, ``outputs``/``state_regs`` maps,
``stats``) as one embedded JSON document. The round trip is bit-exact:
arrays keep shape and dtype, JSON floats round-trip via shortest-repr, and
tuple-shaped metadata is restored to the exact in-memory form
``core.compile`` produces.

``FORMAT_VERSION`` gates compatibility: a loader refuses artifacts written
by an incompatible schema instead of mis-reading them. Bump it whenever a
field changes meaning; the on-disk compile cache (:mod:`repro.sim.cache`)
keys on it too, so stale cache entries simply miss.
"""
from __future__ import annotations

import io
import json
import os
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, Union
from uuid import uuid4

import numpy as np

from ..core.compile import Program
from ..core.isa import HardwareConfig

FORMAT_VERSION = 1

# Every dense array field of Program, saved in native dtype.
_ARRAY_FIELDS = (
    "code", "luts", "reg_init", "spad_init", "gmem_init",
    "xchg_src_core", "xchg_src_slot", "xchg_dst_core", "xchg_dst_reg",
)


def _jsonable(obj: Any) -> Any:
    """Strip numpy scalar/array types so ``stats`` always serializes;
    tuples become lists (restored by the typed loaders below)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_jsonable(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def _restore_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Re-impose the tuple shapes ``core.compile`` uses inside stats."""
    out = dict(stats)
    if "mem_layout" in out:
        out["mem_layout"] = {
            name: (int(v[0]), int(v[1]), int(v[2]), bool(v[3]))
            for name, v in out["mem_layout"].items()}
    return out


def save_program(prog: Program, path: Union[str, Path]) -> Path:
    """Write ``prog`` to ``path`` (a single ``.npz`` container). Returns
    the path written. The file is self-contained: ``load_program`` needs
    nothing but the file."""
    path = Path(path)
    meta = {
        "format_version": FORMAT_VERSION,
        "name": prog.name,
        "hw": asdict(prog.hw),
        "t_compute": int(prog.t_compute),
        "vcpl": int(prog.vcpl),
        "used_cores": int(prog.used_cores),
        "pipe_prologue": int(prog.pipe_prologue),
        "outputs": {nm: [int(core), [int(r) for r in mregs]]
                    for nm, (core, mregs) in prog.outputs.items()},
        "state_regs": {
            nm: [[[int(c), int(r)] for (c, r) in locs] for locs in words]
            for nm, words in prog.state_regs.items()},
        "stats": _jsonable(prog.stats),
    }
    arrays = {f: getattr(prog, f) for f in _ARRAY_FIELDS}
    arrays["slot_op_mask"] = prog._op_masks()
    buf = io.BytesIO()
    np.savez_compressed(
        buf, __meta__=np.frombuffer(json.dumps(meta).encode("utf-8"),
                                    dtype=np.uint8), **arrays)
    path.parent.mkdir(parents=True, exist_ok=True)
    # unique tmp name + rename: concurrent writers of the same artifact
    # (two processes cold-compiling one cache key) each publish a complete
    # file, never a torn one
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{uuid4().hex}.tmp")
    try:
        tmp.write_bytes(buf.getvalue())
        tmp.replace(path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def load_program(path: Union[str, Path]) -> Program:
    """Read a Program artifact written by :func:`save_program`."""
    path = Path(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        version = meta.get("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: artifact format {version!r} is not supported by "
                f"this build (expected {FORMAT_VERSION})")
        arrays = {f: np.array(z[f]) for f in _ARRAY_FIELDS}
        slot_op_mask = np.array(z["slot_op_mask"])
    return Program(
        name=meta["name"],
        hw=HardwareConfig(**meta["hw"]),
        t_compute=int(meta["t_compute"]),
        vcpl=int(meta["vcpl"]),
        used_cores=int(meta["used_cores"]),
        pipe_prologue=int(meta.get("pipe_prologue", 0)),
        outputs={nm: (core, list(mregs))
                 for nm, (core, mregs) in meta["outputs"].items()},
        state_regs={nm: [[(c, r) for c, r in locs] for locs in words]
                    for nm, words in meta["state_regs"].items()},
        stats=_restore_stats(meta["stats"]),
        slot_op_mask=slot_op_mask,
        **arrays,
    )
