// One Manticore instruction on one core, and the code-row stream that feeds
// it: what both Vcycle kernels share (vcycle_chunk.cu, vcycle_seed.cu).
// Machine words are uint32; the plain PyTorch version of every line here is
// kernels/ref.py, and the row layout is kernels/rows.py's.
//
// A code row is 32 bytes, built once at bind time: op | a "writes" bit | a
// "global" bit | dst << 16, s1 | s2 << 16, s3 | s4 << 16, imm (a LUT row: the
// index of its truth table, already clamped and resolved), the SEND capture
// index, the dense slot, two zero words. Where a program's rows fit, a kernel copies their first 16
// bytes into shared memory once per launch (StagedRows), else it reads the
// rows from global memory (GlobalRows); either way each thread reads its
// next row while the current one executes (run_rows). A row then costs its
// register reads from shared memory, one dispatch through a jump table,
// the ALU operation and one write (exec_row).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace isa {

enum Opcode : int {
  NOP = 0, MOV, MOVI, ADD, ADDC, CARRY, SUB, SUBB, BORROW, MUL, MULH, AND,
  OR, XOR, NOT, MUX, SEQ, SNE, SLTU, SLL, SRL, SRA, SLLV, SRLV, SLICE, LUT,
  LD, ST, GLD, GST, SEND, EXPECT
};

constexpr uint32_t kMask = 0xFFFFu;

// The privileged core's global memory and its direct-mapped cache/stall
// model (repro/core/bsp.py make_window_step). Only the thread that runs the
// privileged core holds a non-null `gmem`; the bindings check that GLD/GST
// sit on that one core, so no other thread ever touches these arrays.
struct Glob {
  uint32_t* gmem;      // [G] words of this element
  int* tags;           // [lines] cache tags, -1 = invalid
  uint32_t* cnt;       // [4] counters: vcycles, hits, misses, stall cycles
  uint32_t G, lines, line_words, hit_stall, miss_stall;
};

__device__ __forceinline__ uint32_t global_addr(const Glob& g, uint32_t v1,
                                                uint32_t v2) {
  return ((v1 << 16) | v2) % g.G;
}

// One access through the cache: hit iff the line's tag matches; the tag is
// then the line; hits, misses and stall cycles are counted.
__device__ __forceinline__ void cache_access(const Glob& g, uint32_t addr) {
  const int line = static_cast<int>(addr / g.line_words);
  int* tag = g.tags + static_cast<uint32_t>(line) % g.lines;
  const bool hit = *tag == line;
  *tag = line;
  g.cnt[hit ? 1 : 2] += 1u;
  g.cnt[3] += hit ? g.hit_stall : g.miss_stall;
}

// One decoded code row: the first 16 bytes and the capture index.
struct Row {
  uint32_t w0, w1, w2, imm, cap;
};

// Where a thread takes its core's rows from: row(j) is its row j (the
// chunk kernel's body rows first, then its prologue rows).
//
// StagedRows: the block copied the first 16 bytes of every row (and, for
// the chunk kernel, the capture indices) into shared memory once per
// launch.
struct StagedRows {
  const uint4* hot;     // this core's rows
  const uint32_t* cap;  // this core's capture indices, or null

  __device__ __forceinline__ Row row(int j) const {
    const uint4 a = hot[j];
    return Row{a.x, a.y, a.z, a.w, cap != nullptr ? cap[j] : 0xFFFFFFFFu};
  }
};

// GlobalRows: for a program whose rows do not fit a block's shared memory,
// the 32-byte rows themselves, read through L1 (a core's rows are
// contiguous, four to a 128-byte line).
struct GlobalRows {
  const uint4* rows;  // this core's row 0, two uint4 a row

  __device__ __forceinline__ Row row(int j) const {
    const uint4 a = __ldg(rows + 2 * j);
    return Row{a.x, a.y, a.z, a.w,
               __ldg(reinterpret_cast<const uint32_t*>(rows + 2 * j + 1))};
  }
};

// One row's result and effects on its core, by one indirect branch through
// a jump table (brx.idx) on the opcode: a warp pays one dispatch, plus one
// short target for each distinct opcode among its lanes. Every opcode but
// GLD/GST is a target here (GLD/GST: exec_row): LUT reads its 16-word table
// at `tts` + 64 * imm and selects it by a mux tree on v1..v4 (bits 16-31 of
// the result are v1 & v2 & v3 & v4 & tt[15], as the plain version's
// 16-bit complements leave them); LD reads, and ST (when kSideEffects and
// v3 != 0) writes, the scratchpad word v1 % S at `spad`; EXPECT (when
// kSideEffects) sets `flag` to imm iff v1 != v2 and no flag is set yet.
template <bool kSideEffects>
__device__ __forceinline__ uint32_t alu(uint32_t op, uint32_t v1,
                                        uint32_t v2, uint32_t v3, uint32_t v4,
                                        uint32_t imm, const uint4* tts,
                                        uint32_t* spad, uint32_t S,
                                        uint32_t& flag) {
  uint32_t r;
  asm volatile(
      "{\n\t"
      ".reg .u32 t, u, w, h;\n\t"
      ".reg .u32 q<16>;\n\t"
      ".reg .u64 ad;\n\t"
      ".reg .pred p, se;\n\t"
      "mov.u32 w, %11;\n\t"
      "setp.ne.u32 se, w, 0;\n\t"
      "Ltab: .branchtargets Lz, Lmov, Lmovi, Ladd, Laddc, Lcarry, Lsub, "
      "Lsubb, Lborrow, Lmul, Lmulh, Land, Lor, Lxor, Lnot, Lmux, Lseq, Lsne, "
      "Lsltu, Lsll, Lsrl, Lsra, Lsllv, Lsrlv, Lslice, Llut, Lld, Lst, Lz, "
      "Lz, Lmov, Lexp;\n\t"
      "brx.idx %2, Ltab;\n\t"
      "Lz: mov.u32 %0, 0;\n\tbra Ld;\n\t"
      "Lmov: mov.u32 %0, %3;\n\tbra Ld;\n\t"
      "Lmovi: and.b32 %0, %7, 65535;\n\tbra Ld;\n\t"
      "Ladd: add.u32 t, %3, %4;\n\tand.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Laddc: add.u32 t, %3, %4;\n\tadd.u32 t, t, %5;\n\t"
      "and.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lcarry: add.u32 t, %3, %4;\n\tadd.u32 t, t, %5;\n\t"
      "shr.u32 %0, t, 16;\n\tbra Ld;\n\t"
      "Lsub: sub.u32 t, %3, %4;\n\tand.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lsubb: sub.u32 t, %3, %4;\n\tsub.u32 t, t, %5;\n\t"
      "and.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lborrow: add.u32 t, %4, %5;\n\tsetp.lt.u32 p, %3, t;\n\t"
      "selp.u32 %0, 1, 0, p;\n\tbra Ld;\n\t"
      "Lmul: mul.lo.u32 t, %3, %4;\n\tand.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lmulh: mul.lo.u32 t, %3, %4;\n\tshr.u32 %0, t, 16;\n\tbra Ld;\n\t"
      "Land: and.b32 %0, %3, %4;\n\tbra Ld;\n\t"
      "Lor: or.b32 %0, %3, %4;\n\tbra Ld;\n\t"
      "Lxor: xor.b32 %0, %3, %4;\n\tbra Ld;\n\t"
      "Lnot: not.b32 t, %3;\n\tand.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lmux: setp.ne.u32 p, %3, 0;\n\tselp.b32 %0, %4, %5, p;\n\tbra Ld;\n\t"
      "Lseq: setp.eq.u32 p, %3, %4;\n\tselp.u32 %0, 1, 0, p;\n\tbra Ld;\n\t"
      "Lsne: setp.ne.u32 p, %3, %4;\n\tselp.u32 %0, 1, 0, p;\n\tbra Ld;\n\t"
      "Lsltu: setp.lt.u32 p, %3, %4;\n\tselp.u32 %0, 1, 0, p;\n\tbra Ld;\n\t"
      "Lsll: and.b32 t, %7, 15;\n\tshl.b32 t, %3, t;\n\t"
      "and.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lsrl: and.b32 t, %7, 15;\n\tshr.u32 %0, %3, t;\n\tbra Ld;\n\t"
      "Lsra: xor.b32 t, %3, 32768;\n\tsub.u32 t, t, 32768;\n\t"
      "and.b32 u, %7, 15;\n\tshr.s32 t, t, u;\n\t"
      "and.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lsllv: and.b32 t, %4, 15;\n\tshl.b32 t, %3, t;\n\t"
      "and.b32 %0, t, 65535;\n\tbra Ld;\n\t"
      "Lsrlv: and.b32 t, %4, 15;\n\tshr.u32 %0, %3, t;\n\tbra Ld;\n\t"
      // a logical shift by 32 or more gives 0, as XLA's does
      "Lslice: shr.u32 t, %7, 5;\n\tshr.u32 t, %3, t;\n\t"
      "and.b32 u, %7, 31;\n\tmov.u32 w, 1;\n\tshl.b32 u, w, u;\n\t"
      "sub.u32 u, u, 1;\n\tand.b32 %0, t, u;\n\tbra Ld;\n\t"
      // a mux tree on v1, v2, v3, v4 over tt[v1 + 2 v2 + 4 v3 + 8 v4]
      "Llut: mul.wide.u32 ad, %7, 64;\n\tadd.u64 ad, ad, %8;\n\t"
      "ld.v4.u32 {q0, q1, q2, q3}, [ad];\n\t"
      "ld.v4.u32 {q4, q5, q6, q7}, [ad+16];\n\t"
      "ld.v4.u32 {q8, q9, q10, q11}, [ad+32];\n\t"
      "ld.v4.u32 {q12, q13, q14, q15}, [ad+48];\n\t"
      "and.b32 h, %3, %4;\n\tand.b32 h, h, %5;\n\tand.b32 h, h, %6;\n\t"
      "and.b32 h, h, q15;\n\tand.b32 h, h, 0xFFFF0000;\n\t"
      "lop3.b32 q0, %3, q1, q0, 0xCA;\n\tlop3.b32 q1, %3, q3, q2, 0xCA;\n\t"
      "lop3.b32 q2, %3, q5, q4, 0xCA;\n\tlop3.b32 q3, %3, q7, q6, 0xCA;\n\t"
      "lop3.b32 q4, %3, q9, q8, 0xCA;\n\tlop3.b32 q5, %3, q11, q10, 0xCA;\n\t"
      "lop3.b32 q6, %3, q13, q12, 0xCA;\n\t"
      "lop3.b32 q7, %3, q15, q14, 0xCA;\n\t"
      "lop3.b32 q0, %4, q1, q0, 0xCA;\n\tlop3.b32 q1, %4, q3, q2, 0xCA;\n\t"
      "lop3.b32 q2, %4, q5, q4, 0xCA;\n\tlop3.b32 q3, %4, q7, q6, 0xCA;\n\t"
      "lop3.b32 q0, %5, q1, q0, 0xCA;\n\tlop3.b32 q1, %5, q3, q2, 0xCA;\n\t"
      "lop3.b32 q0, %6, q1, q0, 0xCA;\n\tand.b32 q0, q0, 65535;\n\t"
      "or.b32 %0, q0, h;\n\tbra Ld;\n\t"
      "Lld: rem.u32 t, %3, %10;\n\tmul.wide.u32 ad, t, 4;\n\t"
      "add.u64 ad, ad, %9;\n\tld.u32 %0, [ad];\n\tbra Ld;\n\t"
      "Lst: mov.u32 %0, 0;\n\tsetp.ne.and.u32 p, %5, 0, se;\n\t"
      "@!p bra Ld;\n\trem.u32 t, %3, %10;\n\tmul.wide.u32 ad, t, 4;\n\t"
      "add.u64 ad, ad, %9;\n\tst.u32 [ad], %4;\n\tbra Ld;\n\t"
      // the earliest raising EXPECT of the Vcycle wins
      "Lexp: mov.u32 %0, 0;\n\tsetp.ne.and.u32 p, %3, %4, se;\n\t"
      "setp.eq.and.u32 p, %1, 0, p;\n\t@p mov.u32 %1, %7;\n\t"
      "Ld:\n\t"
      "}"
      : "=r"(r), "+r"(flag)
      : "r"(op), "r"(v1), "r"(v2), "r"(v3), "r"(v4), "r"(imm), "l"(tts),
        "l"(spad), "r"(S), "n"(kSideEffects ? 1 : 0)
      : "memory");
  return r;
}

// Word 0 of a row: the opcode, and two bits the binding sets (rows.py).
constexpr uint32_t kOpBits = 0x1Fu;
constexpr uint32_t kWrites = 0x20u;  // the row writes register dst
constexpr uint32_t kGlobalOp = 0x40u;  // GLD or GST

// One row of one core. The result goes to `dst` when the row writes one,
// masked to 16 bits first when kMaskWrite. kSideEffects: also apply ST,
// GLD/GST through the cache and EXPECT (prologue rows are pure and write
// registers only). kGlobal: the program holds GLD/GST, which only the
// privileged core's thread (non-null g.gmem) executes. `tts` holds the
// program's distinct LUT truth tables, four uint4 each. Returns the
// unmasked result.
template <bool kSideEffects, bool kMaskWrite, bool kGlobal>
__device__ __forceinline__ uint32_t exec_row(const Row& row,
                                             const uint4* tts,
                                             uint32_t* regs_c,
                                             uint32_t* spad_c, uint32_t S,
                                             uint32_t& flag, const Glob& g) {
  const uint32_t v1 = regs_c[row.w1 & kMask];
  const uint32_t v2 = regs_c[row.w1 >> 16];
  const uint32_t v3 = regs_c[row.w2 & kMask];
  const uint32_t v4 = regs_c[row.w2 >> 16];
  uint32_t res = alu<kSideEffects>(row.w0 & kOpBits, v1, v2, v3, v4, row.imm,
                                   tts, spad_c, S, flag);
  if (kGlobal && (row.w0 & kGlobalOp) && g.gmem != nullptr) {
    const bool gld = (row.w0 & kOpBits) == GLD;
    const uint32_t a = global_addr(g, v1, v2);
    if (gld) res = g.gmem[a];
    if (kSideEffects && (gld || v4 != 0u)) {
      if (!gld) g.gmem[a] = v3;
      cache_access(g, a);
    }
  }
  if (row.w0 & kWrites) regs_c[row.w0 >> 16] = kMaskWrite ? res & kMask : res;
  return res;
}

// Rows [first, first + n) of `src` on one core, in order; sink(row, result)
// sees each row's unmasked result. Row j + 1 is read while row j executes.
// Unrolled 8 deep: on the chip that beat the compiler's own choice of 4
// and deeper unrolling, whose loop outgrew the instruction cache.
template <bool kSideEffects, bool kMaskWrite, bool kGlobal, class Src,
          class Sink>
__device__ __forceinline__ void run_rows(const Src& src, int first, int n,
                                         const uint4* tts, uint32_t* regs_c,
                                         uint32_t* spad_c, uint32_t S,
                                         uint32_t& flag, const Glob& g,
                                         Sink sink) {
  if (n <= 0) return;
  Row row = src.row(first);
#pragma unroll 8
  for (int j = first + 1; j <= first + n; ++j) {
    Row next = row;
    if (j < first + n) next = src.row(j);
    sink(row, exec_row<kSideEffects, kMaskWrite, kGlobal>(
                  row, tts, regs_c, spad_c, S, flag, g));
    row = next;
  }
}

}  // namespace isa
