// Chunked K-Vcycle engine for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels on the simulator's main path:
//   src/repro/kernels/vcycle.py:199  _chunk_kernel          (one stimulus)
//   src/repro/kernels/vcycle.py:262  _chunk_kernel_batched  (grid over B)
// The single-stimulus binding is this kernel at B = 1.
//
// Layout: one block per batch element, one thread per simulated core (block
// size C rounded up to a warp; lanes >= C idle). The element's register file
// and scratchpad [C, S] are copied into dynamic shared memory once per
// launch, stay there for all K Vcycles, and are written back once. The
// register file is packed per core: core c owns rows [roff[c], roff[c+1]),
// as many registers as its own code and exchange ever name. The dense
// [C, R] state pads every core to the busiest one (mc at 8 seeds: 176 KB
// dense, 7 KB packed; mm: 284 KB dense, 82 KB packed), so packing is what
// lets every benchmark fit a block and several blocks share an SM. Program
// tables (code, capture map, LUTs, exchange, roff) stay in global memory:
// every block reads the same ones, so they live in L2.
//
// Per Vcycle: a block-wide OR of the exception flags and the budget test
// decide whether the element runs (once frozen it stays frozen, so the loop
// breaks); each thread runs its core's body rows [num_pro, T) slot by slot
// (within a Vcycle a core touches only its own registers and scratchpad, so
// no barrier is needed between slots); SENDs land in a compact buffer; after
// a barrier the exchange scatters that buffer into the destination
// registers; after a second barrier, which also ORs the flags raised in this
// Vcycle, the prologue rows [0, num_pro) of a modulo-pipelined program run
// iff nothing was raised.
//
// Global memory (programs with GLD/GST): the thread that runs the privileged
// core `gcore` reads and writes the element's gmem [G], cache tags [lines]
// and counters [4] in device memory directly, in slot order; no other
// thread touches them (the binding checks that GLD/GST sit on one core), so
// no ordering across threads is needed. A raising Vcycle commits its GSTs
// and counts like the rest of its body; a frozen element touches nothing.
// Without global memory the pointers are null and cost nothing.
//
// Bound on this card: the bytes it must move (state in and out plus the
// program tables, over 3.35 TB/s) against the integer operations it must do
// (B * Vcycles * T * C instructions over the INT32 rate). At the main path's
// shapes both are tens of microseconds. The real limit is neither: it is the
// dependent chain of K * T slots each thread walks in order (a shared-memory
// read, a branch on the opcode and a shared-memory write per slot), which
// only more independent elements per SM can hide.
#include "isa.cuh"

namespace {

using isa::Glob;

// One slot of one core; kBody: also ST, GLD/GST, EXPECT and the SEND
// capture (prologue rows are pure and write registers only).
template <bool kBody>
__device__ __forceinline__ void exec_slot(const int* __restrict__ ins,
                                          const uint32_t* __restrict__ luts_c,
                                          int L, uint32_t* regs_c,
                                          uint32_t* spad_c, int S,
                                          uint32_t& flag, const Glob& g,
                                          uint32_t* sbuf, int capi,
                                          int n_sends) {
  const uint32_t res = isa::exec_ins<kBody, false>(ins, luts_c, L, regs_c,
                                                   spad_c, S, flag, g);
  if (kBody && static_cast<unsigned>(capi) < static_cast<unsigned>(n_sends))
    sbuf[capi] = res & isa::kMask;
}

__global__ void vcycle_chunk_kernel(
    const int* __restrict__ code, const int* __restrict__ cap,
    const uint32_t* __restrict__ luts, const int* __restrict__ dcore,
    const int* __restrict__ dreg, const int* __restrict__ roff,
    const uint32_t* __restrict__ regs_in,
    const uint32_t* __restrict__ spads_in,
    const uint32_t* __restrict__ flags_in, const int* __restrict__ cyc,
    uint32_t* __restrict__ regs_out, uint32_t* __restrict__ spads_out,
    uint32_t* __restrict__ flags_out, int* __restrict__ nexec_out,
    uint32_t* __restrict__ gmem, int* __restrict__ tags,
    uint32_t* __restrict__ counters, int C, int Cp, int T, int R, int S,
    int L, int n_sends, int num_pro, int K, int budget, int prologue_only,
    int G, int lines, int line_words, int hit_stall, int miss_stall,
    int gcore) {
  extern __shared__ uint32_t smem[];
  uint32_t* regs = smem;                                  // [roff[C]]
  uint32_t* spads = regs + __ldg(roff + C);               // [C, S]
  uint32_t* sbuf = spads + static_cast<size_t>(C) * S;    // [n_sends + 1]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, wl = tid & 31, nwarps = nt >> 5;
  const size_t rbase = static_cast<size_t>(b) * C * R;
  const size_t sbase = static_cast<size_t>(b) * C * S;
  // a warp per core row: coalesced reads of the dense [C, R] state
  for (int c = warp; c < C; c += nwarps) {
    const int o = __ldg(roff + c), rc = __ldg(roff + c + 1) - o;
    const uint32_t* src = regs_in + rbase + static_cast<size_t>(c) * R;
    for (int r = wl; r < rc; r += 32) regs[o + r] = src[r];
  }
  for (int i = tid; i < C * S; i += nt) spads[i] = spads_in[sbase + i];
  for (int i = tid; i <= n_sends; i += nt) sbuf[i] = 0u;
  const bool lane = tid < C;
  uint32_t flag = lane ? flags_in[static_cast<size_t>(b) * C + tid] : 0u;
  uint32_t* my_regs = regs + (lane ? __ldg(roff + tid) : 0);
  uint32_t* my_spad = spads + static_cast<size_t>(tid) * S;
  const uint32_t* my_luts = luts + static_cast<size_t>(tid) * L * 16;
  Glob g = {};
  if (gmem != nullptr && tid == gcore)
    g = Glob{gmem + static_cast<size_t>(b) * G,
             tags + static_cast<size_t>(b) * lines, counters + 4 * b,
             static_cast<uint32_t>(G), static_cast<uint32_t>(lines),
             static_cast<uint32_t>(line_words),
             static_cast<uint32_t>(hit_stall),
             static_cast<uint32_t>(miss_stall)};
  __syncthreads();

  int n = 0;
  if (prologue_only) {
    if (lane)
      for (int t = 0; t < num_pro; ++t)
        exec_slot<false>(code + (static_cast<size_t>(t) * Cp + tid) * 7,
                         my_luts, L, my_regs, my_spad, S, flag, g, sbuf,
                         n_sends, n_sends);
  } else {
    const int base = cyc[b];
    for (int k = 0; k < K; ++k) {
      // freeze predicate, fixed at the start of the Vcycle (block-uniform)
      if (__syncthreads_or(flag != 0u) || base + n >= budget) break;
      if (lane)
        for (int t = num_pro; t < T; ++t) {
          const size_t row = static_cast<size_t>(t) * Cp + tid;
          exec_slot<true>(code + row * 7, my_luts, L, my_regs, my_spad, S,
                          flag, g, sbuf, __ldg(cap + row), n_sends);
        }
      __syncthreads();
      // BSP exchange; the buffer is cleared for the next Vcycle as it is read
      for (int i = tid; i < n_sends; i += nt) {
        regs[__ldg(roff + __ldg(dcore + i)) + __ldg(dreg + i)] = sbuf[i];
        sbuf[i] = 0u;
      }
      // the in-flight prologue commits only if this Vcycle raised nothing
      const int raised = __syncthreads_or(flag != 0u);
      if (!raised && lane)
        for (int t = 0; t < num_pro; ++t)
          exec_slot<false>(code + (static_cast<size_t>(t) * Cp + tid) * 7,
                           my_luts, L, my_regs, my_spad, S, flag, g, sbuf,
                           n_sends, n_sends);
      ++n;
    }
  }
  __syncthreads();
  // registers a core never names keep their input values
  for (int c = warp; c < C; c += nwarps) {
    const int o = __ldg(roff + c), rc = __ldg(roff + c + 1) - o;
    const size_t row = rbase + static_cast<size_t>(c) * R;
    for (int r = wl; r < R; r += 32)
      regs_out[row + r] = r < rc ? regs[o + r] : regs_in[row + r];
  }
  for (int i = tid; i < C * S; i += nt) spads_out[sbase + i] = spads[i];
  if (lane) flags_out[static_cast<size_t>(b) * C + tid] = flag;
  if (tid == 0) nexec_out[b] = n;
}

}  // namespace

extern "C" {

// Launches one chunk on `stream`; returns the cudaError_t of the launch.
// gmem [B, G], tags [B, lines] and counters [B, 4] are updated in place;
// all three are null for a program without global memory.
int vcycle_chunk_launch(const int* code, const int* cap, const uint32_t* luts,
                        const int* dcore, const int* dreg, const int* roff,
                        const uint32_t* regs_in, const uint32_t* spads_in,
                        const uint32_t* flags_in, const int* cyc,
                        uint32_t* regs_out, uint32_t* spads_out,
                        uint32_t* flags_out, int* nexec_out, uint32_t* gmem,
                        int* tags, uint32_t* counters, int B, int C,
                        int Cp, int T, int R, int S, int L, int n_sends,
                        int num_pro, int K, int budget, int prologue_only,
                        int reg_words, int G, int lines, int line_words,
                        int hit_stall, int miss_stall, int gcore,
                        void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      sizeof(uint32_t) * (static_cast<size_t>(reg_words) +
                          static_cast<size_t>(C) * S + n_sends + 1);
  cudaError_t err = cudaFuncSetAttribute(
      vcycle_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((C + 31) / 32) * 32;
  vcycle_chunk_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      code, cap, luts, dcore, dreg, roff, regs_in, spads_in, flags_in, cyc,
      regs_out, spads_out, flags_out, nexec_out, gmem, tags, counters, C, Cp,
      T, R, S, L, n_sends, num_pro, K, budget, prologue_only, G, lines,
      line_words, hit_stall, miss_stall, gcore);
  return static_cast<int>(cudaGetLastError());
}

const char* vcycle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opt-in dynamic shared memory a block may use on the current device.
int vcycle_max_smem(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

}  // extern "C"
