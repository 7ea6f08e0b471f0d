"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips without a CUDA device (decided when the test
runs, never at import). This file imports neither JAX nor the reference
package, so it also runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.circuits import FINISH, build
from repro_torch.circuits.fig8 import build_membench
from repro_torch.core import bsp
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig
from repro_torch.kernels import vcycle as kv
from repro_torch.kernels import rows as kr
from repro_torch.kernels.randprog import (edge_chunk, random_chunk,
                                          random_vcycle)
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


@pytest.mark.parametrize("n_sends", [0, 9])
@pytest.mark.parametrize("G", [0, 40])
@pytest.mark.parametrize("num_pro", [0, 3])
def test_chunk_kernel_edge_programs_match_plain(cuda, n_sends, G, num_pro):
    """The compacted rows' edges on the card: a core with no live row, a
    core live in every slot, prologue rows, GLD/GST on the privileged core
    and no SEND at all; one element freezes mid-chunk."""
    rng = np.random.default_rng(100 * n_sends + G + num_pro)
    B, C = 3, 40
    arrays = [torch.from_numpy(a) for a in edge_chunk(
        rng, [3, 100, 6], C, 24, 20, 8, 4, n_sends, num_pro, Cp=64, G=G)]
    args = arrays[:7] + [torch.zeros((B, C), dtype=torch.int32),
                         torch.tensor([0, 2, 1], dtype=torch.int32)]
    glob = {}
    if G:
        glob = dict(zip(("gmem", "tags", "counters"), arrays[7:]),
                    cache=CACHE)
    kw = dict(K=10, n_sends=n_sends, num_pro=num_pro)
    tables = kr.chunk_rows(*arrays[:3], C, num_pro, n_sends, cuda)
    assert int(tables.ctab[C - 1, 1:3].sum()) == 0
    ref = kv.vcycle_chunk_ref(*args, 9, **kw, **glob)
    dev = {k: v.to(cuda) if torch.is_tensor(v) else v
           for k, v in glob.items()}
    out = kv.vcycle_chunk(*[a.to(cuda) for a in args], 9, **kw, **dev,
                          rows=tables)
    torch.cuda.synchronize()
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())
    assert int(ref[3][0]) == 3
    pro = kv.vcycle_prologue(*[a.to(cuda) for a in args[:7]],
                             num_pro=num_pro, rows=tables)
    assert torch.equal(kv.prologue_ref(args[0], args[2], args[5], args[6],
                                       num_pro=num_pro), pro.cpu())


@pytest.mark.parametrize("kernel", ["chunk", "seed"])
def test_luts_past_the_staging_limit_match_plain(cuda, kernel):
    """More distinct LUT tables than a block stages (random immediates
    clamp to each core's last table, one per core): the kernels read them
    from global memory, with the same results."""
    rng = np.random.default_rng(9)
    C, T = 300, 64
    if kernel == "chunk":
        args = random_args(rng, [100, 5], C, 320, T, 24, 4, 32, 12, 0)
        tables = kr.chunk_rows(*args[:3], C, 0, 12, "cpu")
        assert not kv.stage_luts(tables.n_tts)
        ref = kv.vcycle_chunk_ref(*args, 1000, K=8, n_sends=12)
        out = kv.vcycle_chunk(*[a.to(cuda) for a in args], 1000, K=8,
                              n_sends=12)
    else:
        args = [torch.from_numpy(a) for a in random_vcycle(
            rng, C, T, 24, 4, 32, Cp=320)]
        assert not kv.stage_luts(kr.seed_rows(args[0], args[1], C,
                                              "cpu").n_tts)
        ref = kv.vcycle_seed_ref(*args)
        out = kv.vcycle_seed(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("kernel", ["chunk", "seed"])
def test_rows_past_shared_memory_stream_and_match_plain(cuda, kernel):
    """A program whose code rows do not fit a block's shared memory: the
    kernels read them from global memory, with the same results."""
    rng = np.random.default_rng(11)
    C, T = 40, 1200
    if kernel == "chunk":
        args = random_args(rng, [2, 100], C, 64, T, 24, 4, 8, 12, 2)
        assert 20 * kr.chunk_rows(*args[:3], C, 2, 12, "cpu").n_rows \
            > kv.max_smem()
        ref = kv.vcycle_chunk_ref(*args, 1000, K=3, n_sends=12, num_pro=2)
        out = kv.vcycle_chunk(*[a.to(cuda) for a in args], 1000, K=3,
                              n_sends=12, num_pro=2)
    else:
        C, T = 8, 4000
        args = [torch.from_numpy(a) for a in random_vcycle(
            rng, C, T, 24, 4, 8, Cp=32)]
        assert 16 * T * kv.SEED_CORES_PER_BLOCK > kv.max_smem()
        ref = kv.vcycle_seed_ref(*args)
        out = kv.vcycle_seed(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())


def test_oversized_state_raises(cuda):
    rng = np.random.default_rng(0)
    args = random_args(rng, [100], 32, 32, 4, 4096, 1, 4, 2, 0)
    with pytest.raises(ValueError, match="shared memory"):
        kv.vcycle_chunk(*[a.to(cuda) for a in args], 4, K=1, n_sends=2)


def test_more_cores_than_threads_raises(cuda):
    """The chunk kernel runs one thread per core, at most 896 a block (its
    register budget): a program of 897 cores raises in the binding."""
    rng = np.random.default_rng(3)
    args = random_args(rng, [100], 897, 928, 4, 8, 1, 4, 2, 0)
    with pytest.raises(ValueError, match="C=897 exceeds 896 threads"):
        kv.vcycle_chunk(*[a.to(cuda) for a in args], 4, K=1, n_sends=2)


def test_bound_tables_on_the_host_match_plain(cuda):
    """A binding hands the kernels its row tables only: the dense tables
    it keeps stay on the host, and its card run equals its CPU run."""
    prog = compile_circuit(build("mc", "small").circuit, HW)
    m_gpu = bsp.Machine(prog, device=cuda)
    m_cpu = bsp.Machine(prog, device="cpu")
    k = m_gpu._kernel
    assert all(t.device.type == "cpu" for t in k.tables()[:3])
    assert k.rows.rows.device.type == "cuda"
    seed = bsp.Machine(prog, device=cuda, specialize=False)._seed
    assert (seed.code.device.type, seed.luts.device.type) == ("cpu", "cpu")
    assert seed.tables.rows.rows.device.type == "cuda"
    a = m_gpu.run(m_gpu.init_state(), 40)
    b = m_cpu.run(m_cpu.init_state(), 40)
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)


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


# ------------------------------------------------------- flash attention ----
FLASH_SHAPES = [
    # (BH, BHkv, S, dh, dtype, causal): tests/test_kernels.py's five, GQA,
    # a tail tile, the qwen3-0.6b prefill (B=4, H=16, Hkv=8, S=2048) and
    # whisper-medium's encoder
    (2, 2, 256, 64, torch.float32, True),
    (2, 2, 256, 64, torch.float32, False),
    (4, 4, 512, 128, torch.bfloat16, True),
    (1, 1, 128, 32, torch.float32, True),
    (3, 3, 384, 64, torch.bfloat16, True),
    (8, 4, 128, 32, torch.float32, True),
    (3, 3, 1000, 64, torch.bfloat16, True),
    (2, 1, 77, 16, torch.float32, False),
    (64, 32, 2048, 128, torch.bfloat16, True),
    # whisper-medium's encoder (B=4, H=16, 1500 frames, not causal)
    (64, 64, 1500, 64, torch.bfloat16, False),
    # zamba2-7b's shared attention (B=4, H=32, dh 112: the wgmma kernel
    # on zero columns up to 128) and a padded head dim under GQA with a
    # ragged tail tile
    (128, 128, 2048, 112, torch.bfloat16, True),
    (6, 2, 1000, 96, torch.bfloat16, False),
]


@pytest.mark.parametrize("BH,BHkv,S,dh,dtype,causal", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, BH, BHkv, S, dh, dtype, causal):
    """``flash_attention`` against ``flash_ref`` on the same CUDA tensors,
    through the kernel ``route`` picks: fp32 within 1e-4 (sums in another
    order), bf16 within 2e-2 (P and the output rounded to bf16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(BH * S + dh)
    q, k, v = (torch.randn((n, S, dh), generator=g, device=cuda).to(dtype)
               for n in (BH, BHkv, BHkv))
    fa.reset_counts()
    out = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    kernel = fa.route(dtype, dh)
    assert fa.COUNTS == {name: int(name == kernel) for name in fa.COUNTS}
    ref = flash_ref(q, k, v, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _bf16_qkv(cuda, BH, BHkv, S, dh, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn((n, S, dh), generator=g, device=cuda)
                 .to(torch.bfloat16) for n in (BH, BHkv, BHkv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 96, 112, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 17, 128, 129, 1000, 2048])
def test_flash_sm90_matches_plain(cuda, S, G, dh, causal):
    """The tensor-core kernel against ``flash_ref`` in bf16 within 2e-2:
    one key tile and less (S = 1, 17, 128: the accumulator-to-A-fragment
    identity on one tile), a tail tile of one row (129), many tiles with a
    ragged tail (1000) and the serving length (2048), each with 2 KV heads
    read by G query heads (G = 8: qwen2-vl-72b's); dh 96 and 112 at a tile
    width of 128 on zero columns."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_ref
    q, k, v = _bf16_qkv(cuda, 2 * G, 2, S, dh, S * 100 + G * 10 + dh)
    fa.reset_counts()
    out = fa.flash_attention_sm90(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS["flash_attention_sm90"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), flash_ref(q, k, v, causal)
                               .float(), rtol=2e-2, atol=2e-2)


def test_flash_sm90_reads_kv_head_h_div_g(cuda):
    """Distinct K/V per KV head at G = 2 over a ragged S: query row-set i
    must read K/V row-set i // G (repeat_interleave), not i % BHkv (tile),
    and only rows below S of its own row-set."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_ref
    BHkv, G, S = 3, 2, 200
    q, k, v = _bf16_qkv(cuda, BHkv * G, BHkv, S, 128, 5)
    out = fa.flash_attention_sm90(q, k, v).float()
    torch.testing.assert_close(out, flash_ref(q, k, v).float(), rtol=2e-2,
                               atol=2e-2)
    tiled = flash_ref(q, k.repeat(G, 1, 1), v.repeat(G, 1, 1)).float()
    assert float((out - tiled).abs().max()) > 0.2


@pytest.mark.parametrize("dh", [128, 112])
def test_flash_routing_picks_the_kernel(cuda, dh):
    """bf16 at dh = 128 and 112 runs on the wgmma kernel, float32 on the
    3xTF32 one, each launched once; bf16 at dh 100 (not a multiple of 8)
    on the 3xTF32 one."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _bf16_qkv(cuda, 4, 2, 64, dh, 0)
    for dtype, kernel in ((torch.bfloat16, "flash_attention_sm90"),
                          (torch.float32, "flash_attention_simt")):
        fa.reset_counts()
        fa.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        assert fa.COUNTS == {name: int(name == kernel)
                             for name in fa.COUNTS}
    with pytest.raises(ValueError, match="flash_attention_sm90 takes"):
        fa.flash_attention_sm90(q.float(), k.float(), v.float())
    fa.reset_counts()
    fa.flash_attention(*(t[..., :100].contiguous() for t in (q, k, v)))
    assert fa.COUNTS["flash_attention_simt"] == 1


def test_lm_prefill_and_decode_on_card_match_cpu(cuda):
    """qwen3-0.6b's SMOKE config in float32: the serve steps on the card
    (flash kernel in the prefill) against the same on the CPU."""
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE["qwen3-0.6b"].scaled(dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, prefill, decode = make_serve_steps(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        fa.reset_counts()
        logits, cache = prefill(params, {"tokens": tokens.to(dev)},
                                model.make_cache(2, 128))
        launches = fa.COUNTS["flash_attention_simt"]
        tok, seq = torch.argmax(logits[:, -1], -1)[:, None], []
        for i in range(4):
            tok, cache = decode(params, tok, cache, 100 + i)
            seq.append(tok.cpu())
        outs.append((logits.cpu(), torch.cat(seq, 1), launches))
    (lg, toks, n), (lc, tokc, nc) = outs
    assert n == cfg.n_layers and nc == 0 and not fa.COUNTS[
        "flash_attention_sm90"]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(toks, tokc)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_moe_prefill_and_decode_on_card_match_cpu(cuda, name):
    """The MoE SMOKE configs in float32: the serve steps on the card
    (routing by index, the flash kernel in deepseek's prefill; mixtral's
    window sends its prefill to plain attention) against the same on the
    CPU."""
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE[name].scaled(dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, prefill, decode = make_serve_steps(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        fa.reset_counts()
        logits, cache = prefill(params, {"tokens": tokens.to(dev)},
                                model.make_cache(2, 128))
        launches = fa.COUNTS["flash_attention_simt"]
        tok, seq = torch.argmax(logits[:, -1], -1)[:, None], []
        for i in range(4):
            tok, cache = decode(params, tok, cache, 100 + i)
            seq.append(tok.cpu())
        outs.append((logits.cpu(), torch.cat(seq, 1), launches))
    (lg, toks, n), (lc, tokc, nc) = outs
    windowed = cfg.swa_window is not None and cfg.swa_window < 100
    assert n == (0 if windowed else cfg.n_layers) and nc == 0
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(toks, tokc)


@pytest.mark.parametrize("name", ["zamba2-7b", "xlstm-125m"])
def test_ssm_prefill_and_decode_on_card_match_cpu(cuda, name):
    """The SSM SMOKE configs in float32: the serve steps on the card (the
    scans in place under ``inference_mode``; zamba2's shared attention on
    the flash kernel, one launch a group, its window covering the
    prompt) against the same on the CPU: the logits within 1e-4, the same
    greedy tokens, and each state leaf within 1e-4 of its max (the
    recurrences carry both devices' rounding through 100 steps; zamba2's
    second group's K sat 1.8e-4 from the CPU's at one element)."""
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE[name].scaled(dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, prefill, decode = make_serve_steps(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        fa.reset_counts()
        logits, cache = prefill(params, {"tokens": tokens.to(dev)},
                                model.make_cache(2, 128))
        launches = fa.COUNTS["flash_attention_simt"]
        tok, seq = torch.argmax(logits[:, -1], -1)[:, None], []
        for i in range(4):
            tok, cache = decode(params, tok, cache, 100 + i)
            seq.append(tok.cpu())
        outs.append((logits.cpu(), torch.cat(seq, 1), launches,
                     {k: v.cpu() for k, v in cache.items()}))
    (lg, toks, n, ck), (lc, tokc, nc, cc) = outs
    groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert n == groups and nc == 0
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(toks, tokc)
    for k in cc:
        err = float((ck[k] - cc[k]).abs().max())
        assert err <= 1e-4 * float(cc[k].abs().max()), (k, err)


@pytest.mark.parametrize("name", ["whisper-medium", "qwen2-vl-72b"])
def test_encdec_and_vlm_prefill_and_decode_on_card_match_cpu(cuda, name):
    """whisper-medium's and qwen2-vl-72b's SMOKE configs in float32, with
    their frames or 4 patches from a numpy seed: the serve steps on the
    card (one ``flash_attention_simt`` launch a layer of each stack in the
    prefill) against the same on the CPU: the logits within 1e-4, the
    same greedy tokens, each cache leaf within 1e-4 of its max."""
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.profile_serve import frontend_inputs
    from repro_torch.launch.steps import make_serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE[name].scaled(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (2, 100)))}
    extra = frontend_inputs(cfg, 2, rng)
    batch.update({k: torch.from_numpy(v) for k, v in extra.items()})
    start = 100 + (extra["patches"].shape[1] if "patches" in extra else 0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, prefill, decode = make_serve_steps(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        fa.reset_counts()
        logits, cache = prefill(params, {k: v.to(dev) for k, v in
                                         batch.items()},
                                model.make_cache(2, 512))
        launches = dict(fa.COUNTS)
        tok, seq = torch.argmax(logits[:, -1], -1)[:, None], []
        for i in range(4):
            tok, cache = decode(params, tok, cache, start + i)
            seq.append(tok.cpu())
        outs.append((logits.cpu(), torch.cat(seq, 1), launches,
                     {k: v.cpu() for k, v in cache.items()}))
    (lg, toks, n, ck), (lc, tokc, nc, cc) = outs
    assert n["flash_attention_simt"] == cfg.n_layers + cfg.n_enc_layers
    assert sum(n.values()) == n["flash_attention_simt"]
    assert not any(nc.values())
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(toks, tokc)
    for k in cc:
        err = float((ck[k] - cc[k]).abs().max())
        assert err <= 1e-4 * float(cc[k].abs().max()), (k, err)


def test_whisper_bf16_prefill_launches_sm90_in_both_stacks(cuda):
    """whisper-medium's SMOKE config in bf16 at dh 64 (the full config's
    head size): a prefill launches ``flash_attention_sm90`` once a layer
    of each stack (the encoder's not causal) and nothing else, and its
    logits sit within 2e-2 of their scale from the same prefill on the
    CPU (on ``flash_ref``)."""
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.profile_serve import frontend_inputs
    from repro_torch.launch.steps import make_serve_steps
    cfg = SMOKE["whisper-medium"].scaled(dtype="bfloat16", d_head=64)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (2, 100)))}
    batch.update({k: torch.from_numpy(v) for k, v in
                  frontend_inputs(cfg, 2, rng).items()})
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, prefill, _ = make_serve_steps(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        fa.reset_counts()
        logits, _ = prefill(params, {k: v.to(dev) for k, v in
                                     batch.items()},
                            model.make_cache(2, 128))
        outs.append((logits.cpu(), dict(fa.COUNTS)))
    (lg, n), (lc, nc) = outs
    assert n == {name: (cfg.n_layers + cfg.n_enc_layers
                        if name == "flash_attention_sm90" else 0)
                 for name in fa.COUNTS}
    assert not any(nc.values())
    err, scale = float((lg - lc).abs().max()), float(lc.abs().max())
    assert err <= 2e-2 * scale, (err, scale)


def test_moe_slots_on_card_match_cpu(cuda):
    """``moe.slots`` at deepseek-moe-16b's prefill width of routing (T =
    8192 tokens, top-6 of 64, skewed to a few experts) on the card: the
    stable sort gives each pair the slot it gets on the CPU and from the
    reference's one-hot cumsum, so capacity (C = 960) keeps the same
    pairs."""
    from repro_torch.models import moe as M
    g = torch.Generator().manual_seed(4)
    scores = torch.rand((8192, 64), generator=g) + torch.linspace(0, 1, 64)
    gate_idx = scores.topk(6, dim=-1).indices
    cpu = M.slots(gate_idx, 64)
    assert torch.equal(M.slots(gate_idx.to(cuda), 64).cpu(), cpu)
    oh = M.onehot_slots(gate_idx[:256], 64, 256)
    assert torch.equal(M.slots(gate_idx[:256].to(cuda), 64).cpu(),
                       oh.sum(2).argmax(-1))
    assert int((cpu >= M.capacity(8192, 64, 6, 1.25)).sum()) > 0


# (BH, BHkv, S, dh, dtype, causal): GQA, tail tiles, dh off 64 and 128,
# non-causal, and the qwen3-0.6b training shape (B=4, H=16, Hkv=8)
FLASH_BWD_SHAPES = [
    (2, 2, 256, 64, torch.float32, True),
    (8, 4, 77, 16, torch.float32, False),
    (4, 1, 129, 128, torch.float32, True),
    (16, 8, 300, 100, torch.float32, True),
    (6, 3, 1000, 64, torch.bfloat16, True),
    (8, 4, 512, 128, torch.bfloat16, False),
    (64, 32, 2048, 128, torch.bfloat16, True),
    # whisper-medium's encoder (B=4, H=16, 1500 frames, not causal)
    (64, 64, 1500, 64, torch.bfloat16, False),
]


@pytest.mark.parametrize("BH,BHkv,S,dh,dtype,causal", FLASH_BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda, BH, BHkv, S, dh, dtype,
                                        causal):
    """``flash_attention_bwd`` against ``flash_bwd_ref`` on the same CUDA
    tensors, each output within 1e-4 (fp32) or 2e-2 (bf16) of its max;
    one launch, and the same bits when launched again (no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref
    g = torch.Generator(device=cuda).manual_seed(BH * S + dh)
    q, do = (torch.randn((BH, S, dh), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((BHkv, S, dh), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    o = fa.flash_attention(q, k, v, causal)
    fa.reset_counts()
    got = fa.flash_attention_bwd(q, k, v, o, do, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS["flash_attention_bwd"] == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(got, flash_bwd_ref(q, k, v, o, do, causal)):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())
    again = fa.flash_attention_bwd(q, k, v, o, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 96, 112, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [64, 77, 129, 300, 1000, 2048])
def test_flash_bwd_sm90_matches_plain(cuda, S, G, dh, causal):
    """The tensor-core backward kernel against ``flash_bwd_ref(lse=)`` on
    the same CUDA tensors, with lse from the forward kernel: each of dq,
    dk, dv within 2e-2 of its max (P, dS and the outputs rounded to bf16);
    one launch, and the same bits on a relaunch (no atomics). The
    forward's lse within 1e-3 of ``flash_ref``'s (fp32 sums of bf16
    products in another order, and exp2/log2 in place of exp/log). S runs
    from one 64-row tile to the training length, with tails of 13, 1, 44
    and 104 rows; 2 KV heads read by G query heads."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
    q, k, v = _bf16_qkv(cuda, 2 * G, 2, S, dh, S * 100 + G * 10 + dh + 7)
    do = _bf16_qkv(cuda, 2 * G, 2, S, dh, S * 100 + G * 10 + dh + 8)[0]
    o, lse = fa.flash_attention_sm90(q, k, v, causal, return_lse=True)
    _, lse_ref = flash_ref(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
    fa.reset_counts()
    got = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS == {name: int(name == "flash_attention_bwd_sm90")
                         for name in fa.COUNTS}
    for a, b in zip(got, flash_bwd_ref(q, k, v, o, do, causal, lse=lse)):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(
            b.float().abs().max())
    again = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("S", [17, 2048])
def test_flash_sm90_pair_at_g12_matches_plain(cuda, S):
    """starcoder2-3b's heads at B = 4: 96 query row-sets over 8 KV
    row-sets (G = 12), dh 128, causal. The forward against ``flash_ref``
    within 2e-2, its lse within 1e-3 of ``flash_ref``'s, and the backward
    against ``flash_bwd_ref(lse=)`` within 2e-2 of each output's max; one
    launch each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
    q, k, v = _bf16_qkv(cuda, 96, 8, S, 128, S + 12)
    do = _bf16_qkv(cuda, 96, 8, S, 128, S + 13)[0]
    fa.reset_counts()
    o, lse = fa.flash_attention_sm90(q, k, v, True, return_lse=True)
    got = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, True)
    torch.cuda.synchronize()
    assert fa.COUNTS == {name: int(name in ("flash_attention_sm90",
                                            "flash_attention_bwd_sm90"))
                         for name in fa.COUNTS}
    want, lse_ref = flash_ref(q, k, v, True, return_lse=True)
    torch.testing.assert_close(o.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
    for a, b in zip(got, flash_bwd_ref(q, k, v, o, do, True, lse=lse)):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(
            b.float().abs().max())


# each row's error over the row's size, as chip_smoke.py's FLASH_ROW_TOL:
# on random inputs |o| falls as 1/sqrt(keys), so past a few thousand keys
# an absolute 2e-2 exceeds the values
ROW_TOL = 1e-2


def _worst_row(a, b):
    """The largest over rows of ||a - b|| / ||b||, in float32, where a
    row's ||b|| is taken as at least 1e-3 of the largest: dq's first
    causal row is zero but for rounding, in the kernel and the plain
    version alike."""
    a, b = a.float(), b.float()
    size = b.norm(dim=-1)
    size = size.clamp_min(1e-3 * float(size.max()))
    return float(((a - b).norm(dim=-1) / size).max())


def _check_sm90_pair(cuda, BH, BHkv, S, dh, causal, seed, heads=None):
    """The wgmma forward (saving lse) and backward at (BH, BHkv, S, dh,
    causal), one launch each: the output within 2e-2 of ``flash_ref``,
    lse within 1e-3 of its lse, each of dq, dk, dv within 2e-2 of its max
    off ``flash_bwd_ref(lse=)``, and each row of the four within ROW_TOL
    of its size (``_worst_row``). With ``heads``, the plain versions run
    on the first ``heads`` query row-sets and their key/value row-sets
    only (their S x S scores over every head would not fit), which the
    kernels' outputs are held to there."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
    q, k, v = _bf16_qkv(cuda, BH, BHkv, S, dh, seed)
    do = _bf16_qkv(cuda, BH, BHkv, S, dh, seed + 1)[0]
    fa.reset_counts()
    o, lse = fa.flash_attention_sm90(q, k, v, causal, return_lse=True)
    got = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS == {name: int(name in ("flash_attention_sm90",
                                            "flash_attention_bwd_sm90"))
                         for name in fa.COUNTS}
    h = heads or BH
    hk = h // (BH // BHkv)
    q, o, do, lse = q[:h], o[:h], do[:h], lse[:h]
    k, v = k[:hk], v[:hk]
    want, lse_ref = flash_ref(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(o.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _worst_row(o, want) <= ROW_TOL
    torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
    del want, lse_ref
    got = (got[0][:h], got[1][:hk], got[2][:hk])
    for a, b in zip(got, flash_bwd_ref(q, k, v, o, do, causal, lse=lse)):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(
            b.float().abs().max())
        assert _worst_row(a, b) <= ROW_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("grid", ["below", "equal", "many"])
def test_flash_sm90_pair_persistent_grid_covers_every_item(cuda, grid,
                                                           causal):
    """The persistent kernels walk their items (row-set, 128-row tile) in
    snake order over one block an SM: fewer items than SMs (some blocks
    idle), exactly as many (one item a block), and about nine times as
    many (rounds in both directions, longest causal rows first). Every
    output row must be computed, by the pair against the plain versions;
    G = 1, so the forward's, the dK/dV pass's and the dQ pass's item
    counts are all BH x ceil(S / 128)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if grid == "below":
        BH, S = 2, 3 * 128 - 5
    elif grid == "equal":
        BH = 2 if sms % 2 == 0 else 1
        S = 128 * (sms // BH)
    else:
        BH, S = 12, 128 * -(-9 * sms // 12)
    _check_sm90_pair(cuda, BH, BH, S, 128, causal, BH * S + int(causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("G", [12, 16])
def test_flash_sm90_pair_at_g12_and_g16_matches_plain(cuda, G, dh, causal):
    """Wide query groups (starcoder2-3b's G 12, and 16) over 2 KV
    row-sets at a ragged S: the dK/dV pass sums G query row-sets a key
    tile, the forward and the dQ pass read each KV tile for G row-sets."""
    _check_sm90_pair(cuda, 2 * G, 2, 300, dh, causal, G * 1000 + dh)


def test_flash_sm90_pair_at_s32768_on_two_heads(cuda):
    """The dry run's prefill length, S 32768 (256 key tiles, the longest
    causal loop), at two query heads over one KV head (G 2, as
    qwen3-0.6b's), causal, against the plain versions."""
    _check_sm90_pair(cuda, 2, 1, 32768, 128, True, 32768)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dh", [64, 112, 128])
def test_flash_sm90_pair_with_items_of_128_keys(cuda, dh, G, causal):
    """The dK/dV pass keeps items of 128 keys (each warpgroup its own 64)
    where they fill the card more than once, and splits them where they
    do not (the shapes of the matrix above): enough KV row-sets here for
    the first shape, at a ragged S."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    BHkv = -(-2 * sms // 8)
    _check_sm90_pair(cuda, G * BHkv, BHkv, 1000, dh, causal, dh + G)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_bwd_sm90_rerun_step_keeps_another_heads_inf_out(cuda, dh):
    """Where the dK/dV items are split (64 keys over both warpgroups) and
    an item's query tile count is odd, warpgroup 1's last step reruns
    warpgroup 0's last tile on P = dS = 0; that tile's ring stage must not
    take the next item's Q and dO under the rerun's products. Here every
    item's count is odd (G 3, not causal, 129 query tiles; G 12 makes it
    even), the blocks take about two items each, and the second KV
    row-set's query heads have dO = inf: dK and dV of the first KV
    row-set and dq of its heads stay finite and equal to the plain
    versions', over three launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    S = 64 * 129
    assert 2 * -(-S // 128) <= sms  # the launch splits the items
    assert 2 * -(-S // 64) > sms  # and some blocks take two
    q, k, v = _bf16_qkv(cuda, 6, 2, S, dh, dh)
    do = _bf16_qkv(cuda, 6, 2, S, dh, dh + 1)[0]
    o, lse = fa.flash_attention_sm90(q, k, v, False, return_lse=True)
    want = flash_bwd_ref(q[:3], k[:1], v[:1], o[:3], do[:3], False,
                         lse=lse[:3])
    do[3:] = float("inf")
    first = None
    for _ in range(3):
        dq, dk, dv = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, False)
        got = (dq[:3], dk[:1], dv[:1])
        for a, b in zip(got, want):
            assert bool(torch.isfinite(a).all())
            assert _worst_row(a, b) <= ROW_TOL
        if first is None:
            first = got
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("BH,BHkv,dh", [(16, 16, 112), (96, 8, 128),
                                        (128, 128, 112), (64, 32, 128)])
def test_flash_bwd_sm90_relaunch_gives_the_same_bits(cuda, BH, BHkv, dh):
    """No atomics and an item order that changes no result: the backward
    relaunched twice gives the same bits at zamba2-7b's dh 112 and at
    starcoder2-3b's G 12, at the training length (several rounds of items
    a block), with the dK/dV items split (few KV row-sets) and whole
    (zamba2's training shape, 128 KV row-sets; qwen3-0.6b's)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _bf16_qkv(cuda, BH, BHkv, 2048, dh, BH + dh)
    do = _bf16_qkv(cuda, BH, BHkv, 2048, dh, BH + dh + 1)[0]
    o, lse = fa.flash_attention_sm90(q, k, v, True, return_lse=True)
    first = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, True)
    for _ in range(2):
        again = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("name", ["qwen1.5-110b", "mixtral-8x7b",
                                  "zamba2-7b"])
def test_sharded_draw_on_four_shards_of_the_card_equals_one_device(cuda,
                                                                   name):
    """``init_sharded`` over mesh (1, 4) of ``["cuda:0"] * 4`` (SMOKE
    size, the generator on the card): every block bit-equal to the same
    block of ``model.init`` on the card, whole."""
    from repro_torch.configs import SMOKE
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build
    cfg = SMOKE[name]
    model = build(cfg, cuda)
    mesh = make_host_mesh(4, ["cuda:0"] * 4)
    sh = SH.to_named(mesh, SH.param_specs(cfg, mesh,
                                          model.abstract_params()))
    whole = model.init(torch.Generator(device=cuda).manual_seed(2))
    got = SH.init_sharded(model, torch.Generator(device=cuda).manual_seed(2),
                          sh)
    leaves = SH.tree_leaves(got)
    assert len(leaves) == len(SH.tree_leaves(whole))
    for t, w in zip(leaves, SH.tree_leaves(whole)):
        for pos in np.ndindex(t.blocks.shape):
            b = t.blocks[pos]
            assert b.device.type == "cuda"
            assert torch.equal(b, w[t.sharding.block(w.shape, pos)])


def test_flash_sm90_forward_without_lse_gives_the_same_output(cuda):
    """Asking the forward for lse changes nothing in its output."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _bf16_qkv(cuda, 8, 4, 300, 128, 3)
    o, _ = fa.flash_attention_sm90(q, k, v, return_lse=True)
    assert torch.equal(o, fa.flash_attention_sm90(q, k, v))


# (BH, BHkv, S, dh, dtype, causal) through the lse route of the 3xTF32
# kernels: float32 and bf16 off 64/128; GQA, three rows, tail tiles, a
# head dim off the 16-byte chunk (30: plain loads), the prefill's length + 1
FLASH_LSE_SHAPES = [
    (2, 2, 256, 64, torch.float32, True),
    (8, 4, 77, 16, torch.float32, False),
    (4, 1, 129, 128, torch.float32, True),
    (16, 8, 300, 100, torch.float32, True),
    (4, 2, 3, 128, torch.float32, True),
    (2, 1, 130, 30, torch.float32, True),
    (16, 8, 2049, 128, torch.float32, True),
    (6, 3, 1000, 32, torch.bfloat16, True),
    (4, 2, 200, 100, torch.bfloat16, False),
]


@pytest.mark.parametrize("BH,BHkv,S,dh,dtype,causal", FLASH_LSE_SHAPES)
def test_flash_lse_route_matches_plain(cuda, BH, BHkv, S, dh, dtype,
                                       causal):
    """``flash_attention_simt(return_lse=True)`` and ``flash_attention_bwd``
    given that lse, against ``flash_ref`` and ``flash_bwd_ref(lse=)`` on
    the same CUDA tensors: the output within 1e-4 (fp32) or 2e-2 (bf16),
    the fp32 lse within 1e-5 of ``flash_ref``'s, each of dq, dk, dv within
    1e-4 or 2e-2 of its max; one launch each, the output the same with
    and without lse, and the same bits on a relaunch (no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(BH * S + dh + 11)
    q, do = (torch.randn((BH, S, dh), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((BHkv, S, dh), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    fa.reset_counts()
    o, lse = fa.flash_attention_simt(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.COUNTS == {name: int(name == "flash_attention_simt")
                         for name in fa.COUNTS}
    ref_o, ref_lse = flash_ref(q, k, v, causal, return_lse=True)
    assert o.dtype == dtype and lse.shape == (BH, S)
    torch.testing.assert_close(o.float(), ref_o.float(), rtol=tol, atol=tol)
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
    torch.testing.assert_close(lse, ref_lse, rtol=lse_tol, atol=lse_tol)
    assert torch.equal(o, fa.flash_attention_simt(q, k, v, causal))
    o2, lse2 = fa.flash_attention_simt(q, k, v, causal, return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    fa.reset_counts()
    got = fa.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
    torch.cuda.synchronize()
    assert fa.COUNTS == {name: int(name == "flash_attention_bwd")
                         for name in fa.COUNTS}
    for a, b in zip(got, flash_bwd_ref(q, k, v, o, do, causal, lse=lse)):
        assert a.dtype == dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())
    again = fa.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # without lse the kernel computes it itself, to the same gradient
    alone = fa.flash_attention_bwd(q, k, v, o, do, causal)
    for a, b in zip(got, alone):
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())


def test_flash_fp32_autograd_saves_lse_for_the_backward(cuda):
    """float32 through ``FlashAttention`` on the card: one forward and one
    backward launch, the gradients within 1e-4 of each one's max of
    ``flash_bwd_ref``'s."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, do = (torch.randn((4 if i in (0, 3) else 2, 300, 64),
                               generator=g, device=cuda) for i in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_counts()
    out = fa.flash_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.COUNTS == {"flash_attention_sm90": 0,
                         "flash_attention_simt": 1, "flash_attention_bwd": 1,
                         "flash_attention_bwd_sm90": 0}
    o = flash_ref(q, k, v)
    for t, b in zip(leaves, flash_bwd_ref(q, k, v, o, do)):
        assert float((t.grad - b).abs().max()) <= 1e-4 * float(
            b.abs().max())


def test_tf32_rounding_equals_cvt_rna(cuda):
    """tf32x3.cuh's integer rounding to TF32 equals ``cvt.rna.tf32.f32``
    on normal floats over 60 binades, the same with their last 13 bits
    set to a tie (0x1000), zeros and large finite floats."""
    from repro_torch.kernels.build import check, load
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(1 << 20, generator=g, device=cuda) * torch.exp2(
        torch.randint(-30, 30, (1 << 20,), generator=g, device=cuda).float())
    ties = ((x.view(torch.int32) & ~0x1fff) | 0x1000).view(torch.float32)
    edge = torch.tensor([0.0, -0.0, 3.4e38, -3.4e38, 1.0, -1.5],
                        device=cuda)
    x = torch.cat([x, ties, edge])
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    check("tf32x3_rounding_mismatches", load().tf32x3_rounding_mismatches(
        x.data_ptr(), x.numel(), count.data_ptr(),
        torch.cuda.current_stream().cuda_stream))
    assert int(count) == 0


def test_lm_train_step_bf16_runs_the_sm90_backward(cuda):
    """qwen3-0.6b's SMOKE config in bf16 at d_head 128 on the card: each
    layer's forward and its recompute on ``flash_attention_sm90`` and its
    backward on ``flash_attention_bwd_sm90``, never the 3xTF32 kernel; every
    leaf's gradient finite and nonzero."""
    from unittest import mock
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    cfg = SMOKE["qwen3-0.6b"].scaled(dtype="bfloat16", d_head=128)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100)))
             .to(cuda) for k in ("tokens", "labels")}
    model, step, _, _ = steps.make_train_step(cfg, device=cuda)
    params = model.init(torch.Generator().manual_seed(0))
    grads, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        grads.append(g)
        return apply(p, g, o, **kw)

    fa.reset_counts()
    with mock.patch.object(steps.adamw, "apply", spy):
        step(params, adamw.init(params), batch)
    assert fa.COUNTS == {"flash_attention_sm90": 2 * cfg.n_layers,
                         "flash_attention_simt": 0, "flash_attention_bwd": 0,
                         "flash_attention_bwd_sm90": cfg.n_layers}
    for g in adamw.leaves(grads[0]):
        assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)


def test_lm_train_step_on_card_gives_every_leaf_a_gradient(cuda):
    """qwen3-0.6b's SMOKE config in float32, one ``make_train_step`` step
    on the card: two flash forwards a layer (the step and its recompute)
    and one backward, every leaf's gradient finite and nonzero, the loss
    and norm within 1e-4 of the same step on the CPU, and every gradient
    leaf within 1e-4 of that leaf's max on the CPU."""
    from unittest import mock
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE["qwen3-0.6b"].scaled(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100)))
             for k in ("tokens", "labels")}
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, step, _, _ = steps.make_train_step(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        grads, apply = [], adamw.apply

        def spy(p, g, o, **kw):
            grads.append(g)
            return apply(p, g, o, **kw)

        fa.reset_counts()
        with mock.patch.object(steps.adamw, "apply", spy):
            _, _, metrics = step(params, adamw.init(params),
                                 {k: t.to(dev) for k, t in batch.items()})
        if dev is cuda:
            assert fa.COUNTS == {"flash_attention_sm90": 0,
                                 "flash_attention_simt": 2 * cfg.n_layers,
                                 "flash_attention_bwd": cfg.n_layers,
                                 "flash_attention_bwd_sm90": 0}
        for g in adamw.leaves(grads[0]):
            assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
        outs.append((metrics, grads[0]))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = outs
    for key in ("loss", "gnorm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    pairs = list(zip(adamw.leaves(g_gpu), adamw.leaves(g_cpu)))
    assert len(pairs) == len(list(adamw.leaves(g_cpu)))
    for a, b in pairs:
        assert a.shape == b.shape
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())


def _train_batch(cfg, rng, B=2, S=100):
    """Tokens and labels (and whisper's frames, x0.02) from a numpy
    seed, on the CPU."""
    from repro_torch.launch.profile_serve import frontend_inputs
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
             for k in ("tokens", "labels")}
    batch.update({k: torch.from_numpy(v) for k, v in
                  frontend_inputs(cfg, B, rng).items()})
    return batch


def _attention_layers(cfg) -> int:
    """Flash calls a forward pass: zamba2's one a group, whisper's one a
    layer of each stack, none for xLSTM."""
    if cfg.block == "mamba2":
        return cfg.n_layers // cfg.attn_every
    if cfg.block == "xlstm":
        return 0
    return cfg.n_layers + cfg.n_enc_layers


@pytest.mark.parametrize("name", ["whisper-medium", "zamba2-7b",
                                  "xlstm-125m"])
def test_stack_train_step_on_card_matches_cpu(cuda, name):
    """The SMOKE configs of the three stacks that are not plain decoders
    in float32, one ``make_train_step`` step on the card (each layer and
    zamba2's shared attention checkpointed, the scans in checkpointed
    chunks): two ``flash_attention_simt`` launches an attention call (the
    forward and its recompute) and one ``flash_attention_bwd``, none for
    xLSTM; every leaf's gradient finite and nonzero; the loss and norm
    within 1e-4 of the same step on the CPU and every gradient leaf
    within 1e-4 of that leaf's max there."""
    from unittest import mock
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE[name].scaled(dtype="float32")
    batch = _train_batch(cfg, np.random.default_rng(2))
    n = _attention_layers(cfg)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model, step, _, _ = steps.make_train_step(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        grads, apply = [], adamw.apply

        def spy(p, g, o, **kw):
            grads.append(g)
            return apply(p, g, o, **kw)

        fa.reset_counts()
        with mock.patch.object(steps.adamw, "apply", spy):
            _, _, metrics = step(params, adamw.init(params),
                                 {k: t.to(dev) for k, t in batch.items()})
        want = {"flash_attention_sm90": 0, "flash_attention_simt": 0,
                "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0}
        if dev is cuda:
            want.update(flash_attention_simt=2 * n, flash_attention_bwd=n)
        assert fa.COUNTS == want
        for g in adamw.leaves(grads[0]):
            assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
        outs.append((metrics, grads[0]))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = outs
    for key in ("loss", "gnorm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    for a, b in zip(adamw.leaves(g_gpu), adamw.leaves(g_cpu)):
        assert a.shape == b.shape
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())


def test_whisper_bf16_train_step_runs_the_sm90_pair(cuda):
    """whisper-medium's SMOKE config in bf16 at dh 64 (the full config's):
    each layer of both stacks on ``flash_attention_sm90`` twice (the
    encoder's not causal) and on ``flash_attention_bwd_sm90`` once, never
    the 3xTF32 kernels; every leaf's gradient finite and nonzero."""
    from unittest import mock
    from repro_torch.configs import SMOKE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    cfg = SMOKE["whisper-medium"].scaled(dtype="bfloat16", d_head=64)
    batch = {k: t.to(cuda) for k, t in
             _train_batch(cfg, np.random.default_rng(3)).items()}
    model, step, _, _ = steps.make_train_step(cfg, device=cuda)
    params = model.init(torch.Generator().manual_seed(0))
    grads, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        grads.append(g)
        return apply(p, g, o, **kw)

    fa.reset_counts()
    with mock.patch.object(steps.adamw, "apply", spy):
        step(params, adamw.init(params), batch)
    n = _attention_layers(cfg)
    assert fa.COUNTS == {"flash_attention_sm90": 2 * n,
                         "flash_attention_simt": 0, "flash_attention_bwd": 0,
                         "flash_attention_bwd_sm90": n}
    for g in adamw.leaves(grads[0]):
        assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)


def _serve(device, plan=None):
    """Eight mixed mc+bc small requests at 5x5 through ``SimServer`` on
    ``device``; seed 13 poisoned by ``plan`` bisects its batch into odd
    sub-batches."""
    import asyncio
    from repro_torch import serve

    async def go():
        server = serve.SimServer(
            sessions=serve.SessionManager(cache=False, faults=plan,
                                          device=device),
            policy=serve.BatchPolicy(max_batch=8, max_wait_s=0.3),
            faults=plan, retry=serve.RetryPolicy(backoff_base_s=0.001))
        try:
            return await asyncio.gather(*(server.submit(serve.SimRequest(
                name, scale="small", seed=s,
                hw={"grid_width": 5, "grid_height": 5}))
                for s in (11, 12, 13, 14) for name in ("mc", "bc")))
        finally:
            await server.close()

    return asyncio.run(go())


def test_serve_on_card_matches_cpu(cuda):
    """The daemon's launch path on the card (worker threads, hot engines
    rebound across batches, a poisoned batch bisected into sub-batches of
    new sizes) answers what it answers on the CPU."""
    from repro_torch.serve import FaultPlan, FaultSpec
    for plan in (None, FaultPlan(0, launch=FaultSpec(
            poison_seeds=frozenset({13})))):
        kv.reset_counts()
        card = _serve(None, plan)
        assert kv.COUNTS["vcycle_chunk"] > 0
        cpu = _serve("cpu", plan)
        for a, b in zip(card, cpu):
            assert (a.status, a.error_code, a.batch, a.engine_kind) == \
                (b.status, b.error_code, b.batch, b.engine_kind)
            if a.ok:
                assert a.result == b.result
        assert sum(r.ok for r in card) == (8 if plan is None else 6)


def test_elastic_migration_on_card_matches_cpu(cuda):
    from repro_torch.runtime import elastic
    b = build("mc", "small")
    prog_a = compile_circuit(b.circuit, HardwareConfig(grid_width=3,
                                                       grid_height=3))
    prog_b = compile_circuit(b.circuit, HW)
    half = b.n_cycles // 2
    out = {}
    for dev in ("cuda", "cpu"):
        ma, mb = bsp.Machine(prog_a, device=dev), bsp.Machine(prog_b,
                                                              device=dev)
        st = elastic.migrate(prog_a, ma.run(ma.init_state(), half),
                             prog_b, mb)
        st = mb.run(st, b.n_cycles)
        out[dev] = ({n: mb.read_reg(st, n) for n in prog_b.state_regs},
                    mb.exceptions(st), mb.perf(st)["vcycles"])
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][2] + half == b.n_cycles


def test_elastic_migration_of_a_pipelined_program_on_card(cuda):
    """bc/full is modulo-pipelined on 5x5 and 15x15: migrated half way,
    it runs the prologue on the carried state and finishes where an
    uninterrupted 15x15 run does, with its registers, on the card."""
    from repro_torch.runtime import elastic
    b = build("bc", "full")
    prog_a = compile_circuit(b.circuit, HardwareConfig(grid_width=5,
                                                       grid_height=5))
    prog_b = compile_circuit(b.circuit, HardwareConfig())
    assert prog_a.pipe_prologue and prog_b.pipe_prologue
    half = b.n_cycles // 2
    ma, mb = bsp.Machine(prog_a, device="cuda"), bsp.Machine(prog_b,
                                                             device="cuda")
    st = elastic.migrate(prog_a, ma.run(ma.init_state(), half), prog_b, mb)
    st = mb.run(st, b.n_cycles)
    ref = mb.run(mb.init_state(), b.n_cycles + 10)
    assert mb.perf(st)["vcycles"] + half == b.n_cycles
    assert set(mb.exceptions(st).values()) == {FINISH}
    assert {n: mb.read_reg(st, n) for n in prog_b.state_regs} == \
        {n: mb.read_reg(ref, n) for n in prog_b.state_regs}


@pytest.mark.parametrize("D", [1, 4])
def test_sharded_on_card_matches_cpu(cuda, D):
    """bc/full on 5x5 (pipelined), B=7 over D shards of one card (padded
    to 8 at D=4): every leaf equals the same shards on the CPU, and every
    chunk of every shard launched the kernel."""
    b = build("bc", "full", seeds=range(7))
    prog = compile_circuit(b.circuit, HW)
    images = b.images_batch(prog)
    states = []
    for dev in (cuda, "cpu"):
        m = bsp.ShardedBatchedMachine(prog, images=images, devices=[dev] * D,
                                      chunk=8)
        kv.reset_counts()
        states.append(m.gather(m.run(m.init_state(), b.n_cycles + 10)))
        if dev is cuda:
            assert kv.COUNTS["vcycle_chunk"] == D * -(-b.n_cycles // 8)
    for x, y in zip(*states):
        assert torch.equal(x, y)
    assert not states[0].counters[7:].any()


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("batched", [False, True])
def test_grid_on_card_matches_cpu(cuda, D, batched):
    """bc/full on 5x5 unrotated over D shards of one card, unbatched and
    on three seeds: the state equals the CPU's, and each Vcycle of a chunk
    launched the kernel once a shard."""
    from repro_torch.core.grid import GridMachine
    b = build("bc", "full", seeds=[3, 11, 42] if batched else None)
    prog = compile_circuit(b.circuit, HW)
    images = b.images(prog) if batched else None
    states = []
    for dev in (cuda, "cpu"):
        gm = GridMachine(prog, [dev] * D, images=images, chunk=8)
        kv.reset_counts()
        st = gm.run(gm.init_state(), b.n_cycles + 10)
        states.append(gm.gather(st))
        if dev is cuda:
            assert kv.COUNTS["vcycle_chunk"] == D * 8 * -(-b.n_cycles // 8)
            assert gm.perf(st, 0 if batched else None)["vcycles"] == \
                b.n_cycles
    for x, y in zip(*states):
        np.testing.assert_array_equal(x, y)
