# Copy of src/repro/launch/shapes.py (commit 42fa311); imports may differ.
"""Assigned input-shape sets and arch x shape cell enumeration."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    mode: str      # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention / O(1) state:
#   zamba2-7b  — Mamba2 state + 4096-window shared attention
#   mixtral-8x7b — SWA window 4096 bounds the KV cache
#   xlstm-125m — recurrent state
# Pure full-attention archs skip it (DESIGN.md §Arch-applicability).
LONG_OK = {"zamba2-7b", "mixtral-8x7b", "xlstm-125m"}

ALL_ARCHS = [
    "qwen2-vl-72b", "qwen3-1.7b", "qwen1.5-110b", "starcoder2-3b",
    "qwen3-0.6b", "zamba2-7b", "mixtral-8x7b", "deepseek-moe-16b",
    "whisper-medium", "xlstm-125m",
]


def cells() -> List[Tuple[str, Shape]]:
    out = []
    for arch in ALL_ARCHS:
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and arch not in LONG_OK:
                continue
            out.append((arch, shape))
    return out
