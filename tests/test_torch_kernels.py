"""The port's ISA semantics and chunk engine against the reference kernels.

``repro_torch.kernels.ref`` (slot semantics) is held bit for bit against
``repro.kernels.ref.vcycle_ref``; ``vcycle_chunk_ref`` — the plain version
the CUDA kernel is compared with on the card, and what the kernel's
wrapper runs on CPU tensors — against the reference's chunk kernels
``vcycle_chunk_pallas`` and ``vcycle_chunk_pallas_batched`` in interpret
mode. Everything is integer: the tolerance is 0.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.isa import Op as JOp
from repro.kernels.ref import vcycle_ref as j_vcycle_ref
from repro.kernels.vcycle import (vcycle_chunk_pallas,
                                  vcycle_chunk_pallas_batched)
from test_kernels import random_program

from repro_torch.core.isa import Op
from repro_torch.kernels import vcycle as kv
from repro_torch.kernels.randprog import random_chunk, random_vcycle
from repro_torch.kernels.ref import CacheModel, vcycle_ref

def t32(a):
    """numpy words -> the port's int32 tensor of their bit patterns."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def check_vcycle(code, luts, regs, spads, flags):
    ref = j_vcycle_ref(jnp.asarray(code), jnp.asarray(luts),
                       jnp.asarray(regs), jnp.asarray(spads),
                       jnp.asarray(flags))
    out = vcycle_ref(torch.from_numpy(code), t32(luts), t32(regs),
                     t32(spads), t32(flags))
    for a, b, name in zip(ref, out, ("regs", "spads", "flags", "trace")):
        np.testing.assert_array_equal(np.asarray(a), u32(b), err_msg=name)


@pytest.mark.parametrize("C,T,R,S", [
    (1, 4, 8, 16), (4, 16, 32, 64), (8, 32, 64, 32), (16, 8, 16, 16),
    (6, 12, 24, 48)])
def test_slot_semantics_match_reference_sweep(C, T, R, S):
    rng = np.random.default_rng(C * 1000 + T)
    check_vcycle(*random_program(rng, C, T, R, S))


def test_wide_words_and_negative_immediates():
    """Full 32-bit register words and immediates over the whole int32
    range: every place the reference's uint32 arithmetic wraps (SUB, SUBB,
    BORROW's v2+v3, MUL/MULH, SRA's cast, the unsigned LUT-row minimum,
    MOVI's mask, 32-bit EXPECT flags)."""
    rng = np.random.default_rng(7)
    C, T, R, S = 8, 24, 16, 8
    code, luts, regs, spads, flags = random_program(rng, C, T, R, S)
    code[..., 6] = rng.integers(-2**31, 2**31, (T, C))
    luts = rng.integers(0, 2**32, luts.shape, dtype=np.uint64)
    regs = rng.integers(0, 2**32, regs.shape, dtype=np.uint64)
    regs[:, 0] = 0
    spads = rng.integers(0, 2**32, spads.shape, dtype=np.uint64)
    check_vcycle(code, luts.astype(np.uint32), regs.astype(np.uint32),
                 spads.astype(np.uint32), flags)


def _one_core(rows, regs, S=4, L=4, spads=None):
    """A single-core program from (op, dst, s1, s2, s3, s4, imm) rows."""
    code = np.array(rows, np.int32).reshape(len(rows), 1, 7)
    regs = np.array(regs, np.uint32)[None]
    sp = np.arange(100, 100 + S, dtype=np.uint32)[None] if spads is None \
        else np.array(spads, np.uint32)[None]
    luts = np.random.default_rng(0).integers(
        0, 1 << 16, (1, L, 16)).astype(np.uint32)
    return code, luts, regs, sp, np.zeros((1,), np.uint32)


EDGE_CASES = {
    # r1 = 0x8001 (negative), r2 = 0x7fff: arithmetic shifts of both signs
    "sra": ([(Op.SRA, 3, 1, 0, 0, 0, 4), (Op.SRA, 4, 2, 0, 0, 0, 15),
             (Op.SRA, 5, 1, 0, 0, 0, 0)], [0, 0x8001, 0x7FFF, 0, 0, 0]),
    "mulh": ([(Op.MULH, 3, 1, 1, 0, 0, 0), (Op.MUL, 4, 1, 1, 0, 0, 0),
              (Op.MULH, 5, 1, 2, 0, 0, 0)], [0, 0xFFFF, 0x8000, 0, 0, 0]),
    "borrow_17_bit": ([(Op.BORROW, 3, 1, 1, 1, 0, 0),
                       (Op.BORROW, 4, 2, 1, 2, 0, 0),
                       (Op.SUBB, 5, 2, 1, 1, 0, 0)],
                      [0, 0xFFFF, 1, 0, 0, 0]),
    "slice_width_0_and_off_ge_32": (
        [(Op.SLICE, 3, 1, 0, 0, 0, 5 * 32 + 0),
         (Op.SLICE, 4, 1, 0, 0, 0, 32 * 32 + 16),
         (Op.SLICE, 5, 1, 0, 0, 0, 40 * 32 + 31),
         (Op.SLICE, 2, 1, 0, 0, 0, 3 * 32 + 31)],
        [0, 0xBEEF, 0, 0, 0, 0]),
    "ld_st_mod_s": ([(Op.ST, 0, 1, 2, 2, 0, 0), (Op.LD, 3, 1, 0, 0, 0, 0),
                     (Op.ST, 0, 4, 1, 0, 0, 0), (Op.LD, 5, 4, 0, 0, 0, 0)],
                    [0, 9, 0x1234, 0, 6, 0]),
    "first_expect_wins": ([(Op.EXPECT, 0, 1, 2, 0, 0, 11),
                           (Op.EXPECT, 0, 1, 3, 0, 0, 22),
                           (Op.EXPECT, 0, 1, 1, 0, 0, 33)],
                          [0, 1, 2, 3, 0, 0]),
    "expect_keeps_32_bit_imm": ([(Op.EXPECT, 0, 1, 2, 0, 0, -5)],
                                [0, 1, 2, 0, 0, 0]),
    "r0_never_written": ([(Op.MOVI, 0, 0, 0, 0, 0, 77),
                          (Op.ADD, 0, 1, 1, 0, 0, 0),
                          (Op.MOV, 3, 0, 0, 0, 0, 0)],
                         [0, 5, 0, 0, 0, 0]),
    "lut_row_unsigned_min": ([(Op.LUT, 3, 1, 2, 4, 5, -1),
                              (Op.LUT, 4, 1, 2, 4, 5, 2),
                              (Op.MOVI, 5, 0, 0, 0, 0, -2)],
                             [0, 0xF0F0, 0xCCCC, 0, 0xAAAA, 0xFF00]),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_slot_semantics_edge_cases(case):
    rows, regs = EDGE_CASES[case]
    check_vcycle(*_one_core([(int(r[0]),) + tuple(r[1:]) for r in rows],
                            regs))


# ----------------------------------------------------------- chunk ----
def chunk_program(rng, C, T, R, S, n_sends, num_pro, targets, L=8):
    """``random_chunk`` with the reference's dtypes: 32-bit words as uint32
    for luts, regs and spads."""
    code, cap, luts, dcore, dreg, regs, spads = random_chunk(
        rng, targets, C, T, R, S, L, n_sends, num_pro)
    return (code, cap, luts.view(np.uint32), dcore, dreg,
            regs.view(np.uint32), spads.view(np.uint32))


CHUNK_CASES = {
    # name: (targets per element, cyc per element, budget, num_pro, flagged)
    "mid_chunk_expect": ([3, 6, 100], [0, 0, 0], 1000, 0, None),
    "mid_chunk_budget": ([100, 100, 2], [0, 3, 1], 5, 0, None),
    "prologue": ([4, 100, 1], [0, 2, 0], 7, 3, None),
    "already_raised": ([100, 2, 100], [0, 0, 0], 1000, 2, 2),
}


def _pallas_chunk(case, binding):
    targets, cyc, budget, num_pro, flagged = CHUNK_CASES[case]
    rng = np.random.default_rng(sorted(CHUNK_CASES).index(case))
    C, T, R, S, K, n_sends = 6, 14, 20, 8, 8, 7
    code, cap, luts, dcore, dreg, regs, spads = chunk_program(
        rng, C, T, R, S, n_sends, num_pro, targets)
    B = len(targets)
    flags = np.zeros((B, C), np.uint32)
    if flagged is not None:
        flags[flagged, 1] = 9
    op_set = frozenset(JOp(int(o)) for o in np.unique(code[..., 0]))
    shared = (jnp.asarray(code), jnp.asarray(cap), jnp.asarray(luts),
              jnp.asarray(dcore), jnp.asarray(dreg))
    kw = dict(K=K, n_sends=n_sends, op_set=op_set, num_pro=num_pro,
              interpret=True)
    budget_a = jnp.asarray([budget], jnp.int32)
    if binding == "batched":
        ref = vcycle_chunk_pallas_batched(
            *shared, jnp.asarray(regs), jnp.asarray(spads),
            jnp.asarray(flags), jnp.asarray(cyc, jnp.int32), budget_a, **kw)
        ref = [np.asarray(x) for x in ref]
    else:
        outs = [vcycle_chunk_pallas(
            *shared, jnp.asarray(regs[b]), jnp.asarray(spads[b]),
            jnp.asarray(flags[b]), jnp.asarray([cyc[b]], jnp.int32),
            budget_a, **kw) for b in range(B)]
        ref = [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]
        ref.append(np.concatenate([np.asarray(o[3]) for o in outs]))
    port_args = [torch.from_numpy(code), torch.from_numpy(cap), t32(luts),
                 torch.from_numpy(dcore), torch.from_numpy(dreg), t32(regs),
                 t32(spads), t32(flags), torch.tensor(cyc, dtype=torch.int32),
                 budget]
    return ref, port_args, dict(K=K, n_sends=n_sends, num_pro=num_pro)


@pytest.mark.parametrize("binding", ["single", "batched"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_plain_matches_pallas(case, binding):
    """``vcycle_chunk_ref`` and the wrapper on CPU tensors against the
    reference's chunk kernels: per-element freeze at a mid-chunk EXPECT or
    budget, compact SEND capture + exchange, gated prologue tail."""
    ref, args, kw = _pallas_chunk(case, binding)
    nexec = ref[3]
    assert 0 < nexec.sum() < len(nexec) * kw["K"], "freeze must be mid-chunk"
    for fn in (kv.vcycle_chunk_ref, kv.vcycle_chunk):
        out = fn(*args, **kw)
        for a, b, name in zip(ref, out, ("regs", "spads", "flags", "nexec")):
            got = b.numpy() if name == "nexec" else u32(b)
            np.testing.assert_array_equal(a, got, err_msg=f"{fn.__name__} "
                                          f"{name}")


def test_cpu_wrapper_never_counts_launches():
    kv.reset_counts()
    _, args, kw = _pallas_chunk("prologue", "batched")
    kv.vcycle_chunk(*args, **kw)
    rng = np.random.default_rng(0)
    kv.vcycle_seed(*[torch.from_numpy(a) for a in random_vcycle(
        rng, 4, 8, 8, 4, 4, G=16)], cache=CacheModel(4, 14, 120))
    assert kv.COUNTS == {"vcycle_chunk": 0, "vcycle_seed": 0}


def test_packed_register_layout_covers_every_named_register():
    """The kernel keeps core c's registers [0, rows[c]) packed at
    ``roff[c]``: rows[c] must cover every register core c's code or the
    exchange names, and nothing more."""
    rng = np.random.default_rng(5)
    code, cap, luts, dcore, dreg, regs, spads = chunk_program(
        rng, 6, 14, 20, 8, 7, 2, [3])
    lay = kv.reg_layout(code, dcore, dreg, 6, 7, "cpu")
    rows = np.diff(lay.roff.numpy())
    for c in range(6):
        named = set(code[:, c, 1:6].ravel()) | set(dreg[dcore == c])
        assert rows[c] == max(named) + 1
    assert lay.words == rows.sum() and lay.rmax == rows.max() <= 20
