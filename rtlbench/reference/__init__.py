"""The plain reference: each design's RTL semantics in NumPy or PyTorch.

``reference/<design>.py`` steps every stimulus of a suite at once from the
initial state the generator drew, with 32-bit words held in int64 arrays
(``numpy.ndarray`` or ``torch.Tensor``: the code uses operators only).
It imports nothing of the program. ``Exact`` is the design's arithmetic;
``NoCarry`` is the control's: each 32-bit add, subtract and multiply done
in the machine's 16-bit halves with the carry between them dropped.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
M16 = 0xFFFF


class Exact:
    @staticmethod
    def add(a, b):
        return (a + b) & M32

    @staticmethod
    def sub(a, b):
        return (a - b) & M32

    @staticmethod
    def mul(a, b):
        return (a * b) & M32


class NoCarry:
    @staticmethod
    def _halves(f, a, b):
        return ((f(a >> 16, b >> 16) & M16) << 16) | (f(a & M16, b & M16)
                                                      & M16)

    @staticmethod
    def add(a, b):
        return NoCarry._halves(lambda u, v: u + v, a, b)

    @staticmethod
    def sub(a, b):
        return NoCarry._halves(lambda u, v: u - v, a, b)

    @staticmethod
    def mul(a, b):
        # b is at most 16 bits in these designs: each half times b
        return (((a >> 16) * b & M16) << 16) | ((a & M16) * b & M16)


def lanes(a, device=None):
    """``a`` as int64 where the reference runs: NumPy for ``device=None``,
    else a torch tensor on ``device``."""
    if device is None:
        return np.asarray(a, np.int64)
    import torch
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def host(a) -> np.ndarray:
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


# steps a captured CUDA graph replays: a step is some twenty small
# launches, so a suite's thousands of cycles cost the host a few replays
GRAPH_STEPS = 256


def advance(step, state: tuple, t0: int, n: int) -> tuple:
    """``state = step(state, t)`` for ``t`` in ``[t0, t0 + n)``. On a CUDA
    device from cycle 0, whole blocks of ``GRAPH_STEPS`` steps replay one
    captured graph (a step depends on ``t`` through ``t`` mod a divisor of
    ``GRAPH_STEPS``); the rest run one by one."""
    t = t0
    blocks = n // GRAPH_STEPS
    if blocks > 1 and t0 == 0 and getattr(state[0], "is_cuda", False):
        import torch
        static = tuple(s.clone() for s in state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):     # warm-up, as capture needs
            out = static
            for k in range(GRAPH_STEPS):
                out = step(out, k)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = static
            for k in range(GRAPH_STEPS):
                out = step(out, k)
            for a, b in zip(static, out):
                a.copy_(b)
        for a, b in zip(static, state):
            a.copy_(b)
        for _ in range(blocks):
            graph.replay()
        state, t = static, blocks * GRAPH_STEPS
    for t in range(t, t0 + n):
        state = step(state, t)
    return state
