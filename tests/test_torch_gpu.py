"""The CUDA chunk kernel on the card, against its plain PyTorch version.

Marked ``gpu``: each test skips without a CUDA device (decided when the test
runs, never at import). This file imports neither JAX nor the reference
package, so it also runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.circuits import build
from repro_torch.core import bsp
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig
from repro_torch.kernels import vcycle as kv
from repro_torch.kernels.randprog import random_chunk

pytestmark = pytest.mark.gpu
HW = HardwareConfig(grid_width=5, grid_height=5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_args(rng, targets, C, Cp, T, R, S, L, n_sends, num_pro):
    """``random_chunk`` as CPU tensors, plus zero flags and a random
    starting cycle per element."""
    B = len(targets)
    arrays = random_chunk(rng, targets, C, T, R, S, L, n_sends, num_pro,
                          Cp=Cp)
    return [torch.from_numpy(a) for a in arrays] + [
        torch.zeros((B, C), dtype=torch.int32),
        torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))]


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("num_pro", [0, 3])
def test_kernel_matches_plain_on_random_programs(cuda, B, num_pro):
    rng = np.random.default_rng(B * 10 + num_pro)
    kw = dict(K=12, n_sends=9, num_pro=num_pro)
    targets = [3, 100, 7, 11, 5][:B]     # element 0 raises mid-chunk
    args = random_args(rng, targets, 37, 64, 20, 24, 16, 8, 9, num_pro)
    ref = kv.vcycle_chunk_ref(*args, 9, **kw)
    out = kv.vcycle_chunk(*[a.to(cuda) for a in args], 9, **kw)
    torch.cuda.synchronize()
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())
    assert ref[2][0].ne(0).any() and int(ref[3][0]) == 3
    pro_ref = kv.prologue_ref(args[0], args[2], args[5], args[6],
                              num_pro=num_pro)
    pro = kv.vcycle_prologue(*[a.to(cuda) for a in args[:7]],
                             num_pro=num_pro)
    assert torch.equal(pro_ref, pro.cpu())


@pytest.mark.parametrize("batched", [False, True])
def test_machine_on_card_matches_cpu(cuda, batched):
    """Both bindings on a compiled circuit with a retimed prologue."""
    b = build("bc", "full", seeds=[3, 11, 42])
    prog = compile_circuit(b.circuit, HW)
    assert prog.pipe_prologue > 0
    images = b.images(prog)
    if batched:
        ms = [bsp.BatchedMachine(prog, images=images, device=d, chunk=8)
              for d in (cuda, "cpu")]
        states = [m.run(m.init_state(), b.n_cycles + 10) for m in ms]
    else:
        ms = [bsp.Machine(prog, device=d, chunk=8) for d in (cuda, "cpu")]
        states = [m.run(m.init_state(images[0]), b.n_cycles + 10)
                  for m in ms]
    for x, y in zip(*states):
        assert torch.equal(x.cpu(), y)


def test_oversized_state_raises(cuda):
    rng = np.random.default_rng(0)
    args = random_args(rng, [100], 32, 32, 4, 4096, 1, 4, 2, 0)
    with pytest.raises(ValueError, match="shared memory"):
        kv.vcycle_chunk(*[a.to(cuda) for a in args], 4, K=1, n_sends=2)


def test_launch_bumps_the_counter(cuda):
    rng = np.random.default_rng(1)
    args = [a.to(cuda) for a in random_args(rng, [100, 100], 8, 32, 6, 8, 4,
                                            4, 2, 0)]
    kv.reset_counts()
    kv.vcycle_chunk(*args, 4, K=2, n_sends=2)
    assert kv.COUNTS["vcycle_chunk"] == 1
    kv.vcycle_chunk_ref(*[a.cpu() for a in args], 4, K=2, n_sends=2)
    assert kv.COUNTS["vcycle_chunk"] == 1
