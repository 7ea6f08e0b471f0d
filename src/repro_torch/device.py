"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import List

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    when there is none (the CPU is used only when asked for)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "kernels' plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _on_cpu(default) -> bool:
    return default is not None and torch.device(default).type == "cpu"


def default_device_count(default=None) -> int:
    """How many devices ``resolve_devices(None, default)`` gives, without
    raising: 1 for the CPU, else the number of cards (0 without one)."""
    return 1 if _on_cpu(default) else torch.cuda.device_count()


def resolve_devices(devices=None, default=None) -> List[torch.device]:
    """The devices of a multi-device engine, in order; a device may
    repeat (``["cuda:0"] * 4`` runs four shards on one card). None means
    one CPU device when ``default`` is the CPU, else every card, and
    raises when there is none. A CUDA device without an index is the
    current card."""
    if devices is None:
        if _on_cpu(default):
            return [torch.device("cpu")]
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a multi-device engine needs at least one device")
    return out
