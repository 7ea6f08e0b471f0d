"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips without a CUDA device (decided when the test
runs, never at import). This file imports neither JAX nor the reference
package, so it also runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.circuits import build
from repro_torch.circuits.fig8 import build_membench
from repro_torch.core import bsp
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig
from repro_torch.kernels import vcycle as kv
from repro_torch.kernels.randprog import random_chunk, random_vcycle
from repro_torch.kernels.ref import CacheModel

pytestmark = pytest.mark.gpu
HW = HardwareConfig(grid_width=5, grid_height=5)
# the Fig 8 benchmark's machine: one core, large scratchpad and registers
FIG8_HW = HardwareConfig(grid_width=1, grid_height=1, spad_words=1 << 14,
                         num_regs=4096, imem_slots=1 << 16)
CACHE = CacheModel(4, 14, 120)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_args(rng, targets, C, Cp, T, R, S, L, n_sends, num_pro, G=0):
    """``random_chunk`` as CPU tensors, plus zero flags and a random
    starting cycle per element; with ``G > 0`` also a ``dict`` of global
    memory keyword arguments."""
    B = len(targets)
    arrays = [torch.from_numpy(a) for a in random_chunk(
        rng, targets, C, T, R, S, L, n_sends, num_pro, Cp=Cp, G=G)]
    args = arrays[:7] + [
        torch.zeros((B, C), dtype=torch.int32),
        torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))]
    if not G:
        return args
    return args, dict(zip(("gmem", "tags", "counters"), arrays[7:]),
                      cache=CACHE)


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


@pytest.mark.parametrize("G", [1, 300])
def test_chunk_kernel_global_memory_matches_plain(cuda, G):
    """GLD/GST on core 0 through the cache model, with one element frozen
    mid-chunk: gmem, tags and counters equal the plain version's."""
    rng = np.random.default_rng(G)
    args, glob = random_args(rng, [3, 100, 6], 40, 64, 24, 20, 8, 4, 6, 2,
                             G=G)
    kw = dict(K=10, n_sends=6, num_pro=2)
    ref = kv.vcycle_chunk_ref(*args, 9, **kw, **glob)
    dev = {k: v.to(cuda) if torch.is_tensor(v) else v
           for k, v in glob.items()}
    out = kv.vcycle_chunk(*[a.to(cuda) for a in args], 9, **kw, **dev)
    torch.cuda.synchronize()
    assert len(out) == 7
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())
    assert int(ref[3][0]) == 3 and bool(ref[2][0].ne(0).any())
    # the inputs are left as they were
    assert torch.equal(dev["gmem"].cpu(), glob["gmem"])


@pytest.mark.parametrize("C,T,R,S,G", [(1, 4, 8, 16, 0), (37, 30, 24, 9, 0),
                                       (130, 64, 40, 4, 0),
                                       (1, 29, 22, 5, 64), (70, 40, 16, 8, 500)])
def test_seed_kernel_matches_plain_on_random_programs(cuda, C, T, R, S, G):
    """Every opcode with 32-bit words, masked register writes, raising
    EXPECTs and (G > 0) GLD/GST on one core through the cache."""
    rng = np.random.default_rng(C * 100 + T)
    Cp = ((C + 31) // 32) * 32
    arrays = [torch.from_numpy(a) for a in random_vcycle(
        rng, C, T, R, S, 8, G, 8, gcore=C // 2, Cp=Cp)]
    ref = kv.vcycle_seed_ref(*arrays, cache=CACHE)
    out = kv.vcycle_seed(*[a.to(cuda) for a in arrays], cache=CACHE)
    torch.cuda.synchronize()
    assert len(out) == len(ref) == (7 if G else 4)
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("name", ["bc", "mc"])
def test_seed_arm_on_card_matches_cpu(cuda, name):
    """``Machine(specialize=False)`` on the card and on the CPU; bc carries
    a retimed prologue, which the seed arm runs in the stream."""
    b = build(name, "small")
    prog = compile_circuit(b.circuit, HW)
    ms = [bsp.Machine(prog, device=d, specialize=False)
          for d in (cuda, "cpu")]
    states = [m.run(m.init_state(), b.n_cycles + 10) for m in ms]
    for x, y in zip(*states):
        assert torch.equal(x.cpu(), y)
    assert ms[1].perf(states[1])["vcycles"] == b.n_cycles


def test_fig8_ram_512k_on_card_matches_cpu(cuda):
    """Fig 8's ram/512 KiB memory (global, misses) through the chunk kernel
    (single and batched) and the seed kernel, card against CPU."""
    bench = build_membench("ram", 512, n_cycles=64, seeds=[0, 1, 2])
    prog = compile_circuit(bench.circuit, FIG8_HW)
    assert prog.has_global
    images = bench.images(prog)
    n = bench.n_cycles + 10
    for make in (lambda d: bsp.Machine(prog, device=d),
                 lambda d: bsp.Machine(prog, device=d, specialize=False),
                 lambda d: bsp.BatchedMachine(prog, images=images, device=d)):
        ms = [make(d) for d in (cuda, "cpu")]
        init = [m.init_state() if isinstance(m, bsp.BatchedMachine)
                else m.init_state(images[1]) for m in ms]
        states = [m.run(st, n) for m, st in zip(ms, init)]
        for x, y in zip(*states):
            assert torch.equal(x.cpu(), y)
        assert ms[0].perf(states[0]) == ms[1].perf(states[1])
        assert ms[0].perf(states[0])["gmisses"] > 0


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
    assert kv.COUNTS == {"vcycle_chunk": 1, "vcycle_seed": 0}
    kv.vcycle_chunk_ref(*[a.cpu() for a in args], 4, K=2, n_sends=2)
    seed = [torch.from_numpy(a) for a in random_vcycle(rng, 8, 6, 8, 4, 4)]
    kv.vcycle_seed(*[a.to(cuda) for a in seed])
    kv.vcycle_seed_ref(*seed)
    assert kv.COUNTS == {"vcycle_chunk": 1, "vcycle_seed": 1}
