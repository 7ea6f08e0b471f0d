"""The model code's arithmetic in float64: a yardstick for float32 runs.

The models compute their norms, scans, gates and softmaxes in float32
whatever the config's dtype (``Tensor.float()``, buffers made
``dtype=torch.float32``), and the attention kernels take float32 or
bfloat16 only. Inside ``in_float64()`` the same code computes in float64
throughout: ``Tensor.float`` casts to float64, ``torch.float32`` and the
default dtype name float64, and ``layers.flash_attention`` is its plain
version (``kernels/ref.flash_ref``, float64 for float64 inputs), so no
kernel launches. Give it a config of dtype ``"float64"``, float64
parameters and float64 float inputs.

Where a deep stack amplifies float32's rounding past a test's tolerance
(zamba2's and xLSTM's scans at full width), two float32 runs that sum in
different orders are each held against this, and the float64 runs of both
against each other at the tolerance itself. Not for the main path: it
swaps module attributes for the whole process while it is open.
"""
from __future__ import annotations

import contextlib

import torch

from ..kernels.ref import flash_ref
from . import layers as L


@contextlib.contextmanager
def in_float64():
    """The model code computes in float64 while the context is open (see
    the module docstring); everything is put back on the way out."""
    saved = (torch.Tensor.float, torch.float32, L.flash_attention,
             torch.get_default_dtype())
    torch.Tensor.float = lambda self: self.to(torch.float64)
    torch.float32 = torch.float64
    L.flash_attention = flash_ref
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        (torch.Tensor.float, torch.float32, L.flash_attention,
         default) = saved
        torch.set_default_dtype(default)
