// One Manticore instruction on one core: the ISA semantics both Vcycle
// kernels share (vcycle_chunk.cu, vcycle_seed.cu). Machine words are uint32;
// the plain PyTorch version of every line here is kernels/ref.py.
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

// Per-bit-lane 4-input LUT: OR over patterns p of (minterm_p & tt[p]).
__device__ __forceinline__ uint32_t lut4(const uint32_t* __restrict__ tt,
                                         uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  const uint32_t na = ~a & kMask, nb = ~b & kMask, nc = ~c & kMask,
                 nd = ~d & kMask;
  uint32_t out = 0u;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const uint32_t m = ((p & 1) ? a : na) & ((p & 2) ? b : nb) &
                       ((p & 4) ? c : nc) & ((p & 8) ? d : nd);
    out |= m & __ldg(tt + p);
  }
  return out;
}

// One instruction `ins` (op, dst, s1..s4, imm) of one core. The result goes
// to `dst` (never r0, never for NOP/ST/GST/EXPECT/SEND), masked to 16 bits
// first when kMaskWrite. kSideEffects: also apply ST, GLD/GST through the
// cache and EXPECT (prologue rows are pure and write registers only).
// Returns the unmasked result.
template <bool kSideEffects, bool kMaskWrite>
__device__ __forceinline__ uint32_t exec_ins(
    const int* __restrict__ ins, const uint32_t* __restrict__ luts_c, int L,
    uint32_t* regs_c, uint32_t* spad_c, int S, uint32_t& flag,
    const Glob& g) {
  const int op = __ldg(ins + 0);
  const int dst = __ldg(ins + 1);
  const uint32_t v1 = regs_c[__ldg(ins + 2)];
  const uint32_t v2 = regs_c[__ldg(ins + 3)];
  const uint32_t v3 = regs_c[__ldg(ins + 4)];
  const uint32_t v4 = regs_c[__ldg(ins + 5)];
  const uint32_t imm = static_cast<uint32_t>(__ldg(ins + 6));
  uint32_t res = 0u;
  switch (op) {
    case MOV: res = v1; break;
    case MOVI: res = imm & kMask; break;
    case ADD: res = (v1 + v2) & kMask; break;
    case ADDC: res = (v1 + v2 + v3) & kMask; break;
    case CARRY: res = ((v1 + v2 + v3) >> 16) & kMask; break;
    case SUB: res = (v1 - v2) & kMask; break;
    case SUBB: res = (v1 - v2 - v3) & kMask; break;
    case BORROW: res = v1 < v2 + v3 ? 1u : 0u; break;
    case MUL: res = (v1 * v2) & kMask; break;
    case MULH: res = ((v1 * v2) >> 16) & kMask; break;
    case AND: res = v1 & v2; break;
    case OR: res = v1 | v2; break;
    case XOR: res = v1 ^ v2; break;
    case NOT: res = ~v1 & kMask; break;
    case MUX: res = v1 != 0u ? v2 : v3; break;
    case SEQ: res = v1 == v2 ? 1u : 0u; break;
    case SNE: res = v1 != v2 ? 1u : 0u; break;
    case SLTU: res = v1 < v2 ? 1u : 0u; break;
    case SLL: res = (v1 << (imm & 15u)) & kMask; break;
    case SRL: res = v1 >> (imm & 15u); break;
    case SRA:
      res = static_cast<uint32_t>(
                static_cast<int32_t>((v1 ^ 0x8000u) - 0x8000u) >>
                (imm & 15u)) & kMask;
      break;
    case SLLV: res = (v1 << (v2 & 15u)) & kMask; break;
    case SRLV: res = v1 >> (v2 & 15u); break;
    case SLICE: {
      // a logical shift by 32 or more gives 0, as XLA's does
      const uint32_t off = imm >> 5;
      res = (off >= 32u ? 0u : v1 >> off) & ((1u << (imm & 31u)) - 1u);
      break;
    }
    case LUT: {
      const uint32_t last = static_cast<uint32_t>(L - 1);
      res = lut4(luts_c + (imm < last ? imm : last) * 16u, v1, v2, v3, v4);
      break;
    }
    case LD: res = spad_c[v1 % static_cast<uint32_t>(S)]; break;
    case GLD:
      if (g.gmem != nullptr) res = g.gmem[global_addr(g, v1, v2)];
      break;
    case SEND: res = v1; break;
    default: break;  // NOP, ST, GST, EXPECT: no ALU result
  }
  const bool writes = dst != 0 && op != NOP && op != ST && op != GST &&
                      op != EXPECT && op != SEND;
  if (writes) regs_c[dst] = kMaskWrite ? res & kMask : res;
  if (kSideEffects) {
    if (op == ST && v3 != 0u) spad_c[v1 % static_cast<uint32_t>(S)] = v2;
    if (g.gmem != nullptr && (op == GLD || (op == GST && v4 != 0u))) {
      const uint32_t a = global_addr(g, v1, v2);
      if (op == GST) g.gmem[a] = v3;
      cache_access(g, a);
    }
    // the earliest raising EXPECT of the Vcycle wins
    if (op == EXPECT && v1 != v2 && flag == 0u) flag = imm;
  }
  return res;
}

}  // namespace isa
