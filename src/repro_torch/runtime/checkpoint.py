"""Atomic, asynchronous checkpoints of the LM's training state.

Port of ``repro.runtime.checkpoint`` with its on-disk layout:

    <dir>/step_<N>/
        manifest.json        tree keys, shapes, dtypes, step
        host0.npz            the leaves under flat keys
    <dir>/step_<N>.COMMIT    written last; a checkpoint without it is
                             ignored (atomicity)

The flat keys are the reference's: a dict key is its name, a NamedTuple
field (``AdamWState``) is ``.`` and its name, a list or tuple entry its
index, joined by ``/``; a ``None`` holds no leaf. So
``{"params": ..., "opt": AdamWState(...)}`` gives ``params/embed/out``,
``opt/.step`` and ``opt/.m/embed/tok``, and a checkpoint written by either
package restores in the other. bfloat16 leaves travel as their uint16
bits, with ``"bfloat16"`` in the manifest; the bits move through torch
(``view(torch.int16)``), so this module needs no ``ml_dtypes``.

``save`` copies every leaf to host memory before it returns, and a
background thread writes the files (one save in flight at a time). A
checkpoint holds full logical arrays: a ``ShardedTensor`` leaf is
gathered first. ``restore_tree(template, step, device, shardings)``
puts each leaf on ``device`` (None: the template leaf's device), or,
given ``shardings`` (a tree of ``distributed.sharding.Sharding`` shaped
like ``template``), places it as a ``ShardedTensor`` on the mesh of its
sharding, which may differ from the mesh that saved it (the elastic
restart); a stored leaf whose shape or dtype differs from the template
leaf's raises. There is one host, so the multi-host commit has no
counterpart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import ShardedTensor, shard_tree


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(flat key, leaf) pairs in the reference's order and naming."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in sorted(tree.items())]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [kv for key, sub in items for kv in _flatten(sub, prefix + (key,))]


def _unflatten(template, leaves: Dict[str, Any], prefix=()):
    """``template`` with each leaf replaced by ``leaves[key]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(getattr(template, f), leaves, prefix + (f".{f}",))
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaves["/".join(prefix)]


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array written to the npz, and its dtype name."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- save ----
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write asynchronously."""
        host_arrays: Dict[str, np.ndarray] = {}
        manifest = {"step": int(step), "leaves": {}}
        for key, leaf in _flatten(tree):
            if isinstance(leaf, ShardedTensor):
                leaf = leaf.gather(torch.device("cpu"))
            arr, dtype = _encode(torch.as_tensor(leaf))
            host_arrays[key] = np.array(arr)     # a copy the step cannot touch
            manifest["leaves"][key] = {"shape": list(arr.shape),
                                       "dtype": dtype}
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(int(step), host_arrays, manifest),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               manifest: Dict) -> None:
        d = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_0"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "host0.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if d.exists():
            shutil.rmtree(d)
        os.replace(tmp, d)
        (self.dir / f"step_{step:08d}.COMMIT").touch()
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        commits = sorted(self.dir.glob("step_*.COMMIT"))
        for c in commits[:-self.keep]:
            step_dir = self.dir / c.name.replace(".COMMIT", "")
            c.unlink(missing_ok=True)
            if step_dir.exists():
                shutil.rmtree(step_dir)

    # -------------------------------------------------------- restore ----
    def latest_step(self) -> Optional[int]:
        commits = sorted(self.dir.glob("step_*.COMMIT"))
        if not commits:
            return None
        return int(commits[-1].name[len("step_"):-len(".COMMIT")])

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """Returns (step, flat {key: CPU tensor})."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]
        with np.load(d / "host0.npz") as z:
            arrays = {k: _decode(z[k], manifest[k]["dtype"]) for k in z.files}
        return step, arrays

    def restore_tree(self, template: Any, step: Optional[int] = None,
                     device=None, shardings: Any = None) -> Tuple[int, Any]:
        """Rebuild a tree shaped like ``template`` (dicts, NamedTuples,
        tensors) on ``device`` (None: the template leaf's device), or
        with ``shardings`` as ``ShardedTensor``s on their mesh. A stored
        leaf must have the template leaf's shape and dtype: a checkpoint
        of another configuration raises here."""
        if device is not None and shardings is not None:
            raise TypeError("restore_tree: pass a device or shardings, "
                            "not both")
        step, arrays = self.restore(step)
        leaves = {}
        for key, leaf in _flatten(template):
            t = arrays[key]
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint step {step} in {self.dir}: leaf {key} is "
                    f"{t.dtype}{list(t.shape)}, the template's is "
                    f"{leaf.dtype}{list(leaf.shape)}")
            if shardings is None:
                t = t.to(leaf.device if device is None else device)
            leaves[key] = t
        tree = _unflatten(template, leaves)
        if shardings is not None:
            tree = shard_tree(tree, shardings)
        return step, tree
