"""Fused (flash) softmax attention: four CUDA kernels for Hopper and their
wrappers, with the gradient.

The two forward kernels replace the TPU kernel
``repro/kernels/flash_attention.py:33 _flash_kernel`` (wrapper
``flash_attention`` :74), each for its own part of the inputs:

* ``flash_attention_sm90`` launches ``csrc/flash_attention_sm90.cu``:
  bfloat16 with ``dh`` 64 or 128, on the tensor cores (wgmma, K/V tiles
  by TMA into a ring of shared memory). Every served dense config has
  ``dh = 128``.
* ``flash_attention_simt`` launches ``csrc/flash_attention.cu``: float32,
  and bfloat16 with any other ``dh <= 128``. The name is the route's, kept
  so that launch counts stay comparable: the kernel runs on the tensor
  cores in 3xTF32 (``csrc/tf32x3.cuh``: three TF32 ``mma.sync`` products
  per fp32 product, float32-class accuracy; bf16 inputs are exact in TF32
  and skip the products of their zero small parts), with K/V tiles by
  ``cp.async`` into a ring of shared memory.

Both forward kernels write each row's log-sum-exp on request
(``return_lse``). ``flash_attention`` picks one of them by ``route(dtype,
dh)``; what no kernel takes raises. Under grad (grad mode on and an input
that requires grad) it goes through ``FlashAttention``, which saves that
lse, and whose backward is one of two kernels, which replace no TPU kernel
(the reference takes the gradient of its jnp attention by XLA and ships
none):

* ``flash_attention_bwd_sm90`` launches ``csrc/flash_attention_bwd_sm90.cu``
  where the forward ran on ``flash_attention_sm90`` (bfloat16, ``dh`` 64
  or 128): wgmma and TMA.
* ``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu``
  otherwise: float32, and bfloat16 with any other ``dh <= 128``, on the
  tensor cores in 3xTF32 with ``cp.async``, as the forward. Given no lse it
  computes it first.

Both take the forward's lse and use no atomics. The self-attention of
every dense decoder runs through ``flash_attention`` (``models/layers.py``).
On CPU tensors every wrapper runs its plain version instead
(``kernels/ref.py``: ``flash_ref``, ``flash_bwd_ref``); on CUDA tensors it
launches its kernel or raises.

The kernels are built at first use with the port's other kernels
(``kernels/build.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .build import check, load
from .ref import flash_bwd_ref, flash_ref

# launches of each CUDA kernel since the last reset (the CPU path and the
# plain version never count)
COUNTS = {"flash_attention_sm90": 0, "flash_attention_simt": 0,
          "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0}
MAX_HEAD_DIM = 128
SM90_HEAD_DIMS = (64, 128)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel that runs attention of ``dtype`` and head dimension
    ``dh``: ``"flash_attention_sm90"`` for bfloat16 with ``dh`` in
    ``SM90_HEAD_DIMS``, ``"flash_attention_simt"`` for float32 and for
    bfloat16 with any other ``dh <= MAX_HEAD_DIM``. Raises ``ValueError``
    for anything else."""
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention's kernels take dh <= "
                         f"{MAX_HEAD_DIM}, got dh={dh}")
    if dtype == torch.bfloat16 and dh in SM90_HEAD_DIMS:
        return "flash_attention_sm90"
    if dtype in (torch.float32, torch.bfloat16):
        return "flash_attention_simt"
    raise ValueError("flash_attention's kernels take float32 or bfloat16, "
                     f"got {dtype}")


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
    Returns ``[BH, S, dh]`` in q's dtype, for any S. The kernel is
    ``route(q.dtype, dh)``'s: bfloat16 with dh 64 or 128 on
    ``flash_attention_sm90``, float32 and bfloat16 with any other
    ``dh <= 128`` on ``flash_attention_simt``; anything else raises.
    With grad mode on and an input that requires grad, it runs through
    ``FlashAttention``, whose backward is ``flash_attention_bwd_sm90`` or
    ``flash_attention_bwd``."""
    _validate(q, k, v)
    kernel = _KERNELS[route(q.dtype, q.shape[-1])]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return kernel(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward on the kernel
    ``route`` picks, saving q, k, v, the output and each row's
    log-sum-exp (``[BH, S]`` fp32); the backward on
    ``flash_attention_bwd_sm90`` where the forward ran on
    ``flash_attention_sm90``, else on ``flash_attention_bwd``, each given
    that lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.kernel = route(q.dtype, q.shape[-1])
        o, lse = _KERNELS[ctx.kernel](q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.kernel == "flash_attention_sm90":
            grads = flash_attention_bwd_sm90(q, k, v, o, do, lse,
                                             ctx.causal)
        else:
            grads = flash_attention_bwd(q, k, v, o, do, ctx.causal, lse=lse)
        return (*grads, None)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when it does not start on a 16-byte boundary (TMA and
    16-byte ``cp.async`` read only from such)."""
    return t.clone() if t.data_ptr() % 16 else t


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False):
    """``flash_attention`` on ``csrc/flash_attention_sm90.cu``: bfloat16,
    ``dh`` 64 or 128, any S (``ceil(S / 128) <= 65535``). With
    ``return_lse`` it returns (output, lse): lse ``[BH, S]`` fp32, each
    row's natural log-sum-exp of ``q k^T / sqrt(dh)`` (masked), which
    ``flash_attention_bwd_sm90`` takes."""
    _validate(q, k, v)
    if q.dtype != torch.bfloat16 or q.shape[-1] not in SM90_HEAD_DIMS:
        raise ValueError("flash_attention_sm90 takes bfloat16 with dh in "
                         f"{SM90_HEAD_DIMS}, got {q.dtype} with "
                         f"dh={q.shape[-1]}")
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_sm90: no kernel for {q.device}")
    BH, S, dh = q.shape
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = (torch.empty((BH, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = load().flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, k.shape[0], S, dh,
            int(causal), 1.0 / math.sqrt(dh), _stream(q))
        check("flash_attention_sm90", err)
    COUNTS["flash_attention_sm90"] += 1
    return (o, lse) if return_lse else o


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False):
    """``flash_attention`` on ``csrc/flash_attention.cu`` (3xTF32 on the
    tensor cores): float32 or bfloat16, ``dh <= 128``, any S.
    ``flash_attention`` sends it float32 and the bfloat16 head dims
    ``flash_attention_sm90`` does not take. With ``return_lse`` it returns
    (output, lse): lse ``[BH, S]`` fp32, each row's natural log-sum-exp of
    ``q k^T / sqrt(dh)`` (masked), which ``flash_attention_bwd`` takes."""
    _validate(q, k, v)
    route(q.dtype, q.shape[-1])     # raises for what no kernel takes
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_simt: no kernel for {q.device}")
    BH, S, dh = q.shape
    if BH > 65535:
        raise ValueError(f"flash_attention_simt takes BH <= 65535, got "
                         f"BH={BH}")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = (torch.empty((BH, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = load().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, k.shape[0], S, dh,
            int(causal), int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
            _stream(q))
        check("flash_attention_simt", err)
    COUNTS["flash_attention_simt"] += 1
    return (o, lse) if return_lse else o


def _check_lse(name: str, lse: torch.Tensor, q: torch.Tensor) -> None:
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"{name} takes lse [BH, S] float32 "
                         f"{tuple(q.shape[:2])}; got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if lse.device != q.device:
        raise ValueError(f"{name} tensors on different devices")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        causal: bool = True,
                        lse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention`` on ``csrc/flash_attention_bwd.cu``
    (3xTF32 on the tensor cores): q, o, do ``[BH, S, dh]`` and k, v
    ``[BHkv, S, dh]`` (o the forward's output, do its incoming gradient),
    float32 or bfloat16, ``dh <= 128``, any S; ``lse`` ``[BH, S]`` fp32 as
    ``flash_attention_simt(..., return_lse=True)`` gives it, or None: then
    the kernel computes it first. Returns (dq, dk, dv) in the inputs'
    dtype; dk and dv sum the G = BH / BHkv query row-sets that read each
    key/value row-set. The kernel uses no atomics, so the result does not
    change from run to run."""
    _validate(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or not (
            o.dtype == do.dtype == q.dtype):
        raise ValueError("flash_attention_bwd takes o and do shaped and "
                         f"typed as q {tuple(q.shape)} {q.dtype}; got o "
                         f"{tuple(o.shape)} {o.dtype}, do {tuple(do.shape)} "
                         f"{do.dtype}")
    if not o.device == do.device == q.device:
        raise ValueError("flash_attention_bwd tensors on different devices")
    if lse is not None:
        _check_lse("flash_attention_bwd", lse, q)
    route(q.dtype, q.shape[-1])     # raises for what no kernel takes
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, do, causal, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    BH, S, dh = q.shape
    if BH > 65535:
        raise ValueError(f"flash_attention_bwd takes BH <= 65535, got "
                         f"BH={BH}")
    q, k, v, o, do = (_aligned(t.contiguous()) for t in (q, k, v, o, do))
    if lse is not None:
        lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # lse when not given, then rowsum(dO * O)
    scratch = torch.empty((2, BH, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = load().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), None if lse is None else lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            BH, k.shape[0], S, dh, int(causal),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), _stream(q))
        check("flash_attention_bwd", err)
    COUNTS["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd_sm90(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of ``flash_attention`` on
    ``csrc/flash_attention_bwd_sm90.cu`` (tensor cores): q, o, do
    ``[BH, S, dh]`` and k, v ``[BHkv, S, dh]`` in bfloat16 with ``dh`` 64
    or 128, any S, and ``lse`` ``[BH, S]`` fp32 as
    ``flash_attention_sm90(..., return_lse=True)`` gives it. Returns (dq,
    dk, dv) in bfloat16; dk and dv sum the G = BH / BHkv query row-sets
    that read each key/value row-set. No atomics: a relaunch gives the
    same bits."""
    _validate(q, k, v)
    if q.dtype != torch.bfloat16 or q.shape[-1] not in SM90_HEAD_DIMS:
        raise ValueError("flash_attention_bwd_sm90 takes bfloat16 with dh "
                         f"in {SM90_HEAD_DIMS}, got {q.dtype} with "
                         f"dh={q.shape[-1]}")
    if o.shape != q.shape or do.shape != q.shape or not (
            o.dtype == do.dtype == q.dtype):
        raise ValueError("flash_attention_bwd_sm90 takes o and do shaped "
                         f"and typed as q {tuple(q.shape)} {q.dtype}; got o "
                         f"{tuple(o.shape)} {o.dtype}, do {tuple(do.shape)} "
                         f"{do.dtype}")
    _check_lse("flash_attention_bwd_sm90", lse, q)
    if not o.device == do.device == q.device:
        raise ValueError("flash_attention_bwd_sm90 tensors on different "
                         "devices")
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, do, causal, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_sm90: no kernel for "
                         f"{q.device}")
    BH, S, dh = q.shape
    q, k, v, o, do = (_aligned(t.contiguous()) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # {lse * log2(e), rowsum(dO * O)} a row, rows padded to 128
    scratch = torch.empty((BH, -(-S // 128) * 128, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = load().flash_attention_bwd_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), BH, k.shape[0], S, dh,
            int(causal), 1.0 / math.sqrt(dh), _stream(q))
        check("flash_attention_bwd_sm90", err)
    COUNTS["flash_attention_bwd_sm90"] += 1
    return dq, dk, dv


_KERNELS = {"flash_attention_sm90": flash_attention_sm90,
            "flash_attention_simt": flash_attention_simt}
