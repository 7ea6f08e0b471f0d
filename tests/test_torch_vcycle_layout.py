"""The Vcycle kernels' code-row layout (``repro_torch.kernels.rows``).

Both CUDA kernels execute 32-byte rows laid out at bind time: the chunk
kernel each core's live rows only (body, then prologue), the seed kernel
every slot. These tests decode the tables back to the dense stream, walk
them in Python as the kernels do (``walk_chunk``, ``walk_prologue``,
``walk_seed``) and hold the walks bit for bit against the plain versions
the kernels are compared with on the card, and against the reference's
Pallas chunk kernel in interpret mode. Edge programs: a core with no live
row, a core live in every slot, a modulo-pipelined program (bc's
prologue), GLD/GST on the privileged core, and no SEND at all.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_kernels import CHUNK_CASES, _pallas_chunk, u32

from repro_torch.circuits import build
from repro_torch.circuits.fig8 import build_membench
from repro_torch.core import bsp
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig, Op
from repro_torch.kernels import ops
from repro_torch.kernels import rows as kr
from repro_torch.kernels import vcycle as kv
from repro_torch.kernels.randprog import (edge_chunk, random_chunk,
                                          random_vcycle)
from repro_torch.kernels.ref import NO_WRITE_OPS, CacheModel

HW = HardwareConfig(grid_width=5, grid_height=5)
FIG8_HW = HardwareConfig(grid_width=1, grid_height=1, spad_words=1 << 14,
                         num_regs=4096, imem_slots=1 << 16)
CACHE = CacheModel(4, 14, 120)


def chunk_case(kind, seed=0):
    """(code, cap, luts, dcore, dreg, regs, spads, flags, cyc), keyword
    arguments for the chunk functions, and the global-memory keywords."""
    rng = np.random.default_rng(seed)
    targets = [3, 100, 7]
    n_sends, num_pro, G = {"random": (9, 0, 0), "prologue": (9, 3, 0),
                           "edge": (9, 2, 0), "no_sends": (0, 2, 0),
                           "global": (6, 2, 40)}[kind]
    make = random_chunk if kind == "random" else edge_chunk
    arrays = [torch.from_numpy(a) for a in make(
        rng, targets, 12, 18, 20, 8, 8, n_sends, num_pro, Cp=32, G=G)]
    B, C = len(targets), 12
    args = arrays[:7] + [torch.zeros((B, C), dtype=torch.int32),
                         torch.tensor([0, 2, 1], dtype=torch.int32)]
    glob = {}
    if G:
        glob = dict(zip(("gmem", "tags", "counters"), arrays[7:]),
                    cache=CACHE)
    return args, dict(K=10, n_sends=n_sends, num_pro=num_pro), glob


KINDS = ["random", "prologue", "edge", "no_sends", "global"]


def check_decodes(code, cap, luts, C, num_pro, n_sends, tables,
                  dense=False):
    """Each core's rows are its live body rows (``dense``: every slot),
    then its live prologue rows, in slot order, with their fields, capture
    indices and clamped LUT tables."""
    code, cap, luts = (np.asarray(x) for x in (code, cap, luts))
    f = kr.decode(tables)
    T, L = code.shape[0], luts.shape[1]
    assert f["ctab"].shape == (C, 4)
    assert np.array_equal(f["ctab"][:, 0], np.concatenate(
        [[0], np.cumsum(f["ctab"][:, 1] + f["ctab"][:, 2])[:-1]]))
    assert len(np.unique(f["tts"], axis=0)) == tables.n_tts
    for c in range(C):
        start, nb, npro, _ = f["ctab"][c]
        live = (code[:, c, 0] != int(Op.NOP)) | dense
        body = [t for t in range(num_pro, T)
                if live[t] or 0 <= cap[t, c] < n_sends]
        pro = [t for t in range(num_pro) if live[t]]
        assert f["slot"][start:start + nb].tolist() == body
        assert f["slot"][start + nb:start + nb + npro].tolist() == pro
        for i, t in enumerate(body + pro):
            j = start + i
            ins = code[t, c].astype(np.int64)
            assert [f["op"][j], f["dst"][j], *f["src"][j]] == ins[:6].tolist()
            assert f["writes"][j] == (ins[1] != 0 and ins[0] not in
                                      {int(o) for o in NO_WRITE_OPS})
            assert f["global"][j] == (ins[0] in (int(Op.GLD), int(Op.GST)))
            assert f["cap"][j] == (cap[t, c] if i < nb else kr.NO_CAPTURE)
            if ins[0] == int(Op.LUT):
                row = min(int(ins[6]) & 0xFFFFFFFF, L - 1)
                assert np.array_equal(f["tts"][f["imm"][j]],
                                      luts[c, row].view(np.uint32))
            else:
                assert f["imm"][j] == int(ins[6]) & 0xFFFFFFFF
    assert tables.busy == int((f["ctab"][:, 1] + f["ctab"][:, 2]).max())


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_rows_decode_to_each_cores_live_rows(kind):
    args, kw, _ = chunk_case(kind)
    C = args[5].shape[1]
    tables = kr.chunk_rows(*args[:3], C, kw["num_pro"], kw["n_sends"],
                           "cpu")
    check_decodes(*args[:3], C, kw["num_pro"], kw["n_sends"], tables)
    if kind in ("edge", "no_sends"):
        f = kr.decode(tables)
        assert f["ctab"][C - 1, 1:3].sum() == 0       # no live row
        assert f["ctab"][1, 1:3].sum() == 18          # live in every slot


def test_chunk_rows_keep_a_capturing_nop():
    """A body NOP whose slot captures a SEND value writes 0 into the
    buffer, so it is kept; a prologue NOP never captures and goes."""
    args, kw, _ = chunk_case("prologue")
    code, cap = args[0].clone(), args[1].clone()
    code[5, 2] = 0
    cap[5, 2] = 4
    code[1, 3] = 0
    tables = kr.chunk_rows(code, cap, args[2], 12, 3, 9, "cpu")
    f = kr.decode(tables)
    start, nb = f["ctab"][2, :2]
    assert 5 in f["slot"][start:start + nb].tolist()
    start, nb, npro = f["ctab"][3, :3]
    assert 1 not in f["slot"][start + nb:start + nb + npro].tolist()


def test_seed_rows_decode_to_the_dense_stream():
    rng = np.random.default_rng(3)
    code, luts, *_ = random_vcycle(rng, 9, 14, 16, 4, 8, Cp=32)
    tables = kr.seed_rows(code, luts, 9, "cpu")
    f = kr.decode(tables)
    assert f["ctab"][:, :3].tolist() == [[c * 14, 14, 0] for c in range(9)]
    assert tables.n_rows == 9 * 14 and tables.busy == 14
    assert (f["cap"] == kr.NO_CAPTURE).all()
    check_decodes(code, np.full((14, 32), -1, np.int32), luts, 9, 0, 0,
                  tables, dense=True)


@pytest.mark.parametrize("kind", KINDS)
def test_walker_matches_plain_on_random_programs(kind):
    """Per-element freeze at a mid-chunk EXPECT or the budget, prologue
    rows gated on the Vcycle raising nothing, global memory."""
    args, kw, glob = chunk_case(kind, seed=1)
    tables = kr.chunk_rows(*args[:3], 12, kw["num_pro"], kw["n_sends"],
                           "cpu")
    ref = kv.vcycle_chunk_ref(*args, 9, **kw, **glob)
    out = kr.walk_chunk(tables, args[3], args[4], *args[5:], 9, K=kw["K"],
                        n_sends=kw["n_sends"], **glob)
    assert len(out) == len(ref) == (7 if glob else 4)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)
    nexec = ref[3].tolist()
    assert nexec[0] == 3 and 0 < min(nexec) < kw["K"]
    pro = kr.walk_prologue(tables, args[5], args[6])
    assert torch.equal(pro, kv.prologue_ref(args[0], args[2], args[5],
                                            args[6], num_pro=kw["num_pro"]))


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_walker_matches_pallas_reference(case):
    """The walker against the reference's batched chunk kernel
    (``vcycle_chunk_pallas_batched`` in interpret mode)."""
    ref, args, kw = _pallas_chunk(case, "batched")
    code, cap, luts, dcore, dreg = args[:5]
    tables = kr.chunk_rows(code, cap, luts, args[5].shape[1],
                           kw["num_pro"], kw["n_sends"], "cpu")
    out = kr.walk_chunk(tables, dcore, dreg, *args[5:], K=kw["K"],
                        n_sends=kw["n_sends"])
    for a, b, name in zip(ref, out, ("regs", "spads", "flags", "nexec")):
        got = b.numpy() if name == "nexec" else u32(b)
        np.testing.assert_array_equal(a, got, err_msg=name)


def _run_walked(kernel, state, budget):
    """Chunks of a binding through the walker and through the plain
    version, from the same state, to the end: both must agree each chunk."""
    regs, spads, gmem, flags, tags, counters = state
    B = regs.shape[0]
    cyc = torch.zeros((B,), dtype=torch.int32)
    glob = {}
    if kernel.gcore >= 0:
        glob = dict(gmem=gmem, tags=tags, counters=counters,
                    cache=kernel.cache)
    kw = dict(K=kernel.K, n_sends=kernel.n_sends)
    for _ in range(100):
        args = (*kernel.tables(), regs, spads, flags, cyc)
        ref = kv.vcycle_chunk_ref(*args, budget, num_pro=kernel.num_pro,
                                  **kw, **glob)
        out = kr.walk_chunk(kernel.rows, kernel.dcore, kernel.dreg,
                            *args[5:], budget, **kw, **glob)
        for a, b in zip(ref, out):
            assert torch.equal(a, b)
        regs, spads, flags, nexec = ref[:4]
        if glob:
            glob.update(gmem=ref[4], tags=ref[5], counters=ref[6])
        cyc = cyc + nexec
        if bool(flags.ne(0).any(1).all()) or int(cyc.min()) >= budget:
            return flags, cyc
    raise AssertionError("did not finish")


@pytest.mark.parametrize("name", ["bc", "mc", "fig8"])
def test_walker_matches_plain_on_compiled_circuits(name):
    """bc on the 5x5 grid carries a retimed prologue and cores with no
    live row; Fig 8's RAM puts GLD/GST on the privileged core."""
    if name == "fig8":
        bench = build_membench("ram", 64, n_cycles=24, seeds=[0, 1])
        prog = compile_circuit(bench.circuit, FIG8_HW)
        assert prog.has_global
    else:
        bench = build(name, "full" if name == "bc" else "small",
                      seeds=[3, 11])
        prog = compile_circuit(bench.circuit, HW)
    m = bsp.BatchedMachine(prog, images=bench.images(prog), device="cpu",
                           chunk=8)
    k = m._kernel
    if name == "bc":
        assert k.num_pro > 0
        f = kr.decode(k.rows)
        assert (f["ctab"][:, 1:3].sum(1) == 0).any()
    flags, cyc = _run_walked(k, m.init_state(), bench.n_cycles + 10)
    assert cyc.tolist() == [bench.n_cycles] * 2
    assert bsp.from_words(flags).max() == 1          # FINISH


@pytest.mark.parametrize("G", [0, 64])
def test_seed_walker_matches_plain(G):
    rng = np.random.default_rng(G + 5)
    arrays = [torch.from_numpy(a) for a in random_vcycle(
        rng, 37, 30, 24, 9, 8, G, 8, gcore=20, Cp=64)]
    tables = kr.seed_rows(arrays[0], arrays[1], 37, "cpu")
    ref = kv.vcycle_seed_ref(*arrays, cache=CACHE)
    out = kr.walk_seed(tables, *arrays[2:], cache=CACHE)
    assert len(out) == len(ref) == (7 if G else 4)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)


def test_seed_layout_packs_each_blocks_named_registers():
    """The seed kernel stages, per block of ``SEED_CORES_PER_BLOCK``
    cores (a warp each), the registers each core's code names:
    ``block_words`` is the largest block's sum, ``rmax`` the largest
    core's."""
    rng = np.random.default_rng(8)
    code, luts, *_ = random_vcycle(rng, 70, 12, 40, 4, 8, Cp=96)
    lay = kv.seed_layout(code, luts, 70, "cpu")
    rows = code[:, :70, 1:6].max(axis=(0, 2)) + 1
    per_block = [rows[i:i + kv.SEED_CORES_PER_BLOCK].sum()
                 for i in range(0, 70, kv.SEED_CORES_PER_BLOCK)]
    assert np.array_equal(np.diff(lay.roff.numpy()), rows)
    assert lay.block_words == max(per_block)
    assert lay.rows.n_rows == 70 * 12
    assert (lay.T, lay.rmax) == (12, rows.max())


@pytest.mark.parametrize("field,value,why", [
    (0, 32, "not an ISA opcode"), (0, -1, "not an ISA opcode"),
    (1, 1 << 16, "16 bits"), (3, 70000, "16 bits")])
def test_binding_raises_on_what_the_row_cannot_hold(field, value, why):
    """A row holds an ISA opcode (5 bits) and 16-bit register fields: both
    layouts, and the bindings through them, raise on anything else."""
    prog = compile_circuit(build("mc", "small").circuit, HW)
    C, T = prog.used_cores, prog.code.shape[1]
    code = prog.code.copy()
    code[0, 0] = (int(Op.MOV), 1, 1, 1, 1, 1, 0)
    code[0, 0, field] = value
    bad = dataclasses.replace(prog, code=code)
    dense = code.transpose(1, 0, 2)
    with pytest.raises(ValueError, match=why):
        kr.chunk_rows(dense, prog.send_capture(T), prog.luts, C, 0,
                      prog.n_sends, "cpu")
    with pytest.raises(ValueError, match=why):
        kr.seed_rows(dense, prog.luts, C, "cpu")
    with pytest.raises(ValueError, match=why):
        ops.make_vcycle_chunk(bad, C, 8, device="cpu")
    if field == 0:
        # a register index past R is refused earlier, by seed_check
        with pytest.raises(ValueError, match=why):
            ops.make_vcycle(bad, C, prog.used_reg_count(), device="cpu")


def test_lut_tables_are_staged_up_to_the_limit():
    assert kv.stage_luts(kv.STAGE_LUT_BYTES // 64)
    assert not kv.stage_luts(kv.STAGE_LUT_BYTES // 64 + 1)
