// One Vcycle of the seed engine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of the seed arm, Machine(specialize=False):
//   src/repro/kernels/vcycle.py:45  _vcycle_kernel  (wrapper :146 vcycle_pallas)
// It runs one Vcycle's slot loop over every core: the full ISA select on
// every slot, each result masked to 16 bits before its register write, and
// the whole [T, C] result trace written out. The BSP exchange is not here:
// the engine routes SEND values from the trace after the launch, as the
// reference does outside its kernel. To the TPU kernel's ISA it adds GLD/GST
// and the privileged core's direct-mapped cache/stall model, which the
// reference's seed arm runs in its jnp engine.
//
// Layout: one thread per core, 128 cores a block; within a Vcycle cores
// never talk to each other, so blocks and threads are independent. Each
// thread copies its core's register row and scratchpad into the outputs
// once, then walks all T slots updating them there (the rows stay in L1 for
// the Vcycle), and writes trace[t, c] (neighbouring threads, neighbouring
// words). Program tables are padded to Cp >= C cores; threads >= C return.
// The thread of the privileged core `gcore` owns gmem [G], the cache tags
// [lines] and counters [4] (updated in place); the binding checks that
// GLD/GST sit on that core only, so no ordering across threads is needed.
//
// Bound on this card: the bytes it must move (state in and out, the [T, C]
// trace and the program tables) against T * C instructions over the INT32
// rate. The real limit is neither: each thread walks T dependent slots (a
// code-row load, register reads through L1, a branch on the opcode, a
// write), and a Vcycle has only C threads, far fewer than the card holds.
#include "isa.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void vcycle_seed_kernel(
    const int* __restrict__ code, const uint32_t* __restrict__ luts,
    const uint32_t* __restrict__ regs_in,
    const uint32_t* __restrict__ spads_in,
    const uint32_t* __restrict__ flags_in, uint32_t* __restrict__ regs_out,
    uint32_t* __restrict__ spads_out, uint32_t* __restrict__ flags_out,
    uint32_t* __restrict__ trace, uint32_t* __restrict__ gmem,
    int* __restrict__ tags, uint32_t* __restrict__ counters, int C, int Cp,
    int T, int R, int S, int L, int G, int lines, int line_words,
    int hit_stall, int miss_stall, int gcore) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  uint32_t* regs = regs_out + static_cast<size_t>(c) * R;
  uint32_t* spad = spads_out + static_cast<size_t>(c) * S;
  const uint32_t* src_r = regs_in + static_cast<size_t>(c) * R;
  const uint32_t* src_s = spads_in + static_cast<size_t>(c) * S;
  for (int r = 0; r < R; ++r) regs[r] = src_r[r];
  for (int i = 0; i < S; ++i) spad[i] = src_s[i];
  uint32_t flag = flags_in[c];
  isa::Glob g = {};
  if (gmem != nullptr && c == gcore)
    g = isa::Glob{gmem, tags, counters, static_cast<uint32_t>(G),
                  static_cast<uint32_t>(lines),
                  static_cast<uint32_t>(line_words),
                  static_cast<uint32_t>(hit_stall),
                  static_cast<uint32_t>(miss_stall)};
  const uint32_t* my_luts = luts + static_cast<size_t>(c) * L * 16;
  for (int t = 0; t < T; ++t) {
    const uint32_t res = isa::exec_ins<true, true>(
        code + (static_cast<size_t>(t) * Cp + c) * 7, my_luts, L, regs, spad,
        S, flag, g);
    trace[static_cast<size_t>(t) * C + c] = res & isa::kMask;
  }
  flags_out[c] = flag;
}

}  // namespace

extern "C" {

// Launches one Vcycle on `stream`; returns the cudaError_t of the launch.
// gmem [G], tags [lines] and counters [4] are updated in place; all three
// are null for a program without global memory.
int vcycle_seed_launch(const int* code, const uint32_t* luts,
                       const uint32_t* regs_in, const uint32_t* spads_in,
                       const uint32_t* flags_in, uint32_t* regs_out,
                       uint32_t* spads_out, uint32_t* flags_out,
                       uint32_t* trace, uint32_t* gmem, int* tags,
                       uint32_t* counters, int C, int Cp, int T, int R, int S,
                       int L, int G, int lines, int line_words, int hit_stall,
                       int miss_stall, int gcore, void* stream) {
  if (C <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (C + kThreads - 1) / kThreads;
  const int threads = C < kThreads ? ((C + 31) / 32) * 32 : kThreads;
  vcycle_seed_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      code, luts, regs_in, spads_in, flags_in, regs_out, spads_out, flags_out,
      trace, gmem, tags, counters, C, Cp, T, R, S, L, G, lines, line_words,
      hit_stall, miss_stall, gcore);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
