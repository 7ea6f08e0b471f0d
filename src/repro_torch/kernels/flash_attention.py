"""Fused (flash) softmax attention: the CUDA kernel for Hopper and its wrapper.

``flash_attention`` launches ``csrc/flash_attention.cu``, which replaces
the TPU kernel ``repro/kernels/flash_attention.py:33 _flash_kernel``
(wrapper ``flash_attention`` :74). The prefill of every dense decoder runs
its self-attention through it (``models/layers.py``). On CPU tensors the
wrapper runs the plain version ``kernels/ref.py::flash_ref`` instead; on
CUDA tensors it launches the kernel or raises.

The kernel is built at first use with the port's other kernels
(``kernels/build.py``).
"""
from __future__ import annotations

import math

import torch

from .build import check, load
from .ref import flash_ref

# launches of the CUDA kernel since the last reset (the CPU path and the
# plain version never count)
COUNTS = {"flash_attention": 0}
MAX_HEAD_DIM = 128


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _validate(q, k, v) -> None:
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or k.shape[1:] != q.shape[1:] or k.shape[0] < 1
            or q.shape[0] % k.shape[0]):
        raise ValueError("flash_attention takes q [BH, S, dh] and k, v "
                         "[BHkv, S, dh] with BHkv dividing BH; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention dtypes differ: q {q.dtype}, "
                         f"k {k.dtype}, v {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention tensors on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention with scale ``1/sqrt(dh)``, causal or not.

    q: ``[BH, S, dh]``; k, v: ``[BHkv, S, dh]`` with ``G = BH / BHkv``:
    query row-set i reads key/value row-set ``i // G``, so batch-major
    ``[B * H]`` query heads over ``[B * Hkv]`` KV heads is grouped-query
    attention with head h reading KV head ``h // G`` and no copy of K/V.
    Returns ``[BH, S, dh]`` in q's dtype. On the card: float32 or bfloat16,
    ``dh <= 128``, any S."""
    _validate(q, k, v)
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    BH, S, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("flash_attention's kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if dh > MAX_HEAD_DIM or BH > 65535:
        raise ValueError(f"flash_attention's kernel takes dh <= "
                         f"{MAX_HEAD_DIM} and BH <= 65535, got dh={dh}, "
                         f"BH={BH}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = load().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH,
            k.shape[0], S, dh, int(causal), int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(dh), stream)
        check("flash_attention", err)
    COUNTS["flash_attention"] += 1
    return o
