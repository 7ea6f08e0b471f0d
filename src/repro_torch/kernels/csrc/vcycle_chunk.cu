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
// as many registers as its own code and exchange ever name (mc at 512 seeds:
// 8 KB; mm: 82 KB packed against 284 KB dense).
//
// Code: each thread walks only its own core's live rows, compacted at bind
// time (kernels/rows.py chunk_rows): the body rows [num_pro, T), then the
// prologue rows [0, num_pro), in slot order, each a 32-byte row with its
// capture index and its LUT table resolved. Within a Vcycle a core touches
// only its own registers, scratchpad and flag, and GLD/GST sit on one core,
// so a core's NOP slots can be skipped without changing any result. Where
// they fit a block (all nine circuits but mm), the first 16 bytes of every
// row and the capture indices are copied into shared memory once per
// launch (kStaged), else each thread reads its rows from global memory;
// either way it reads row j + 1 while row j executes (isa.cuh run_rows).
// Every row dispatches through one jump table (isa.cuh alu). The distinct
// LUT truth tables are staged in shared memory when they fit (stage_luts),
// else read from global memory. kGlobal instances carry GLD/GST.
//
// Per Vcycle: a block-wide OR of the exception flags and the budget test
// decide whether the element runs (once frozen it stays frozen, so the loop
// breaks); each thread runs its core's body rows; SENDs land in a compact
// buffer; after a barrier the exchange scatters that buffer into the
// destination registers; after a second barrier, which also ORs the flags
// raised in this Vcycle, the prologue rows of a modulo-pipelined program run
// iff nothing was raised.
//
// Global memory (programs with GLD/GST): the thread that runs the privileged
// core `gcore` reads and writes the element's gmem [G], cache tags [lines]
// and counters [4] in device memory directly, in slot order; no other
// thread touches them. A raising Vcycle commits its GSTs and counts like the
// rest of its body; a frozen element touches nothing.
//
// Bound on this card: the bytes it must move (state in and out plus the
// tables it is handed, over 3.35 TB/s) against the instructions it must do
// (over the INT32 rate); both are tens of microseconds at the main path's
// shapes. What bounds it is the dependent chain of the busiest core: K
// Vcycles x its rows (mc at 512 seeds: one core is live in all 263 slots,
// while the mean core has 10.9 rows), each a shared-memory read of its
// operands, a dispatch, the operation and a write, about 150 ns (PERF.md).
// On the chip a row got cheaper as each of these came off that chain: a
// per-row cp.async ring and a compare tree for the opcode (the first
// design, 230-270 ns a row), a separate branch for the rare opcodes (which
// cost common rows even untaken), a rolled loop. Compaction also cuts the
// code rows an element reads 48-fold at mc/full B=512 (2120 live rows of
// 194 x 263), and staging reads them once a block a launch.
#include <type_traits>

#include "isa.cuh"

namespace {

using isa::Glob;
using isa::Row;

// The most threads (cores) a block runs, set by the register budget:
// __launch_bounds__(896) holds ptxas to 72 registers a thread (65536 / 896,
// rounded down to its allocation unit of 8), so that four blocks of 224
// threads (mc at 512 seeds, 194 cores) share an SM's 65536 registers and
// B=512 runs in one wave. A program of more cores raises in the binding;
// the repo's largest grid has 225.
constexpr int kMaxThreads = 896;

// Shared memory of one block, in order: the staged rows (kStaged: the first
// 16 bytes of all n_rows rows), the LUT tables (staged), the staged capture
// indices, the packed registers, the scratchpads and the SEND buffer.
struct Smem {
  size_t rows, tts, caps, words;  // uint4, uint4, uint32, uint32 counts
  __host__ __device__ Smem(bool staged, int n_rows, int reg_words, int C,
                           int S, int n_sends, int n_tts, int stage_luts)
      : rows(staged ? static_cast<size_t>(n_rows) : 0),
        tts(stage_luts ? 4 * static_cast<size_t>(n_tts) : 0),
        caps(staged ? static_cast<size_t>(n_rows) : 0),
        words(static_cast<size_t>(reg_words) + static_cast<size_t>(C) * S +
              n_sends + 1) {}
  __host__ __device__ size_t bytes() const {
    return 16 * (rows + tts) + 4 * (caps + words);
  }
};

template <bool kStaged, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads) vcycle_chunk_kernel(
    const uint4* __restrict__ rows, const int4* __restrict__ ctab,
    const uint4* __restrict__ tts_g, const int* __restrict__ dcore,
    const int* __restrict__ dreg, const int* __restrict__ roff,
    const uint32_t* __restrict__ regs_in,
    const uint32_t* __restrict__ spads_in,
    const uint32_t* __restrict__ flags_in, const int* __restrict__ cyc,
    uint32_t* __restrict__ regs_out, uint32_t* __restrict__ spads_out,
    uint32_t* __restrict__ flags_out, int* __restrict__ nexec_out,
    uint32_t* __restrict__ gmem, int* __restrict__ tags,
    uint32_t* __restrict__ counters, int C, int R, int S, int n_sends,
    int n_rows, int n_tts, int stage_luts, int K, int budget,
    int prologue_only, int G, int lines, int line_words, int hit_stall,
    int miss_stall, int gcore) {
  extern __shared__ uint4 smem4[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, wl = tid & 31, nwarps = nt >> 5;
  const int reg_words = __ldg(roff + C);
  const Smem lay(kStaged, n_rows, reg_words, C, S, n_sends, n_tts,
                 stage_luts);
  uint4* rowbuf = smem4;                                // staged rows
  uint4* tts_s = rowbuf + lay.rows;                     // [n_tts][4]
  uint32_t* caps = reinterpret_cast<uint32_t*>(tts_s + lay.tts);
  uint32_t* regs = caps + lay.caps;                     // [roff[C]]
  uint32_t* spads = regs + reg_words;                   // [C, S]
  uint32_t* sbuf = spads + static_cast<size_t>(C) * S;  // [n_sends + 1]

  const bool lane = tid < C;
  const int4 ct = lane ? __ldg(ctab + tid) : make_int4(0, 0, 0, 0);
  const int nb = ct.y, np = ct.z;
  using Src = typename std::conditional<kStaged, isa::StagedRows,
                                        isa::GlobalRows>::type;
  Src src;
  if constexpr (kStaged) {
    // the first 16 bytes of every row, and the capture indices
    for (int j = tid; j < n_rows; j += nt) {
      rowbuf[j] = __ldg(rows + 2 * j);
      caps[j] = __ldg(reinterpret_cast<const uint32_t*>(rows + 2 * j + 1));
    }
    src = isa::StagedRows{rowbuf + ct.x, caps + ct.x};
  } else {
    src = isa::GlobalRows{rows + 2 * static_cast<size_t>(ct.x)};
  }

  const size_t rbase = static_cast<size_t>(b) * C * R;
  const size_t sbase = static_cast<size_t>(b) * C * S;
  // a warp per core row: coalesced reads of the dense [C, R] state
  for (int c = warp; c < C; c += nwarps) {
    const int o = __ldg(roff + c), rc = __ldg(roff + c + 1) - o;
    const uint32_t* src_r = regs_in + rbase + static_cast<size_t>(c) * R;
    for (int r = wl; r < rc; r += 32) regs[o + r] = src_r[r];
  }
  for (int i = tid; i < C * S; i += nt) spads[i] = spads_in[sbase + i];
  for (int i = tid; i <= n_sends; i += nt) sbuf[i] = 0u;
  if (stage_luts)
    for (int i = tid; i < 4 * n_tts; i += nt) tts_s[i] = __ldg(tts_g + i);
  const uint4* tts = stage_luts ? tts_s : tts_g;
  uint32_t flag = lane ? flags_in[static_cast<size_t>(b) * C + tid] : 0u;
  uint32_t* my_regs = regs + (lane ? __ldg(roff + tid) : 0);
  uint32_t* my_spad = spads + static_cast<size_t>(tid) * S;
  const uint32_t uS = static_cast<uint32_t>(S);
  const Glob none = {};
  Glob g = {};
  if (gmem != nullptr && tid == gcore)
    g = Glob{gmem + static_cast<size_t>(b) * G,
             tags + static_cast<size_t>(b) * lines, counters + 4 * b,
             static_cast<uint32_t>(G), static_cast<uint32_t>(lines),
             static_cast<uint32_t>(line_words),
             static_cast<uint32_t>(hit_stall),
             static_cast<uint32_t>(miss_stall)};
  __syncthreads();

  const auto no_sink = [](const Row&, uint32_t) {};
  const auto capture = [&](const Row& row, uint32_t res) {
    if (row.cap < static_cast<uint32_t>(n_sends))
      sbuf[row.cap] = res & isa::kMask;
  };
  int n = 0;
  if (prologue_only) {
    isa::run_rows<false, false, false>(src, nb, np, tts, my_regs, my_spad,
                                       uS, flag, none, no_sink);
  } else {
    const int base = cyc[b];
    for (int k = 0; k < K; ++k) {
      // freeze predicate, fixed at the start of the Vcycle (block-uniform)
      if (__syncthreads_or(flag != 0u) || base + n >= budget) break;
      isa::run_rows<true, false, kGlobal>(src, 0, nb, tts, my_regs, my_spad,
                                          uS, flag, g, capture);
      __syncthreads();
      // BSP exchange; the buffer is cleared for the next Vcycle as it is read
      for (int i = tid; i < n_sends; i += nt) {
        regs[__ldg(roff + __ldg(dcore + i)) + __ldg(dreg + i)] = sbuf[i];
        sbuf[i] = 0u;
      }
      // the in-flight prologue commits only if this Vcycle raised nothing
      const int raised = __syncthreads_or(flag != 0u);
      if (!raised)
        isa::run_rows<false, false, false>(src, nb, np, tts, my_regs,
                                           my_spad, uS, flag, none, no_sink);
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

int chunk_threads(int C) { return ((C + 31) / 32) * 32; }

using Kernel = decltype(&vcycle_chunk_kernel<true, true>);

// The instance for staged or streamed rows, with or without GLD/GST, its
// dynamic shared memory allowed up to `smem`.
Kernel pick(int stage_rows, bool global, size_t smem, cudaError_t* err) {
  const Kernel k = stage_rows ? (global ? vcycle_chunk_kernel<true, true>
                                        : vcycle_chunk_kernel<true, false>)
                              : (global ? vcycle_chunk_kernel<false, true>
                                        : vcycle_chunk_kernel<false, false>);
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  return k;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the chunk kernel takes, with its rows
// staged (stage_rows) or streamed.
size_t vcycle_chunk_smem(int C, int n_rows, int reg_words, int S,
                         int n_sends, int n_tts, int stage_luts,
                         int stage_rows) {
  return Smem(stage_rows != 0, n_rows, reg_words, C, S, n_sends, n_tts,
              stage_luts)
      .bytes();
}

// Blocks of the chunk kernel one SM holds at this shape (registers, shared
// memory and threads together); 0 when one does not fit.
int vcycle_chunk_blocks_per_sm(int C, int n_rows, int reg_words, int S,
                               int n_sends, int n_tts, int stage_luts,
                               int stage_rows, int global, int* out) {
  const size_t smem = vcycle_chunk_smem(C, n_rows, reg_words, S, n_sends,
                                        n_tts, stage_luts, stage_rows);
  cudaError_t err;
  const Kernel k = pick(stage_rows, global != 0, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k, chunk_threads(C), smem));
}

// Most threads (cores) a block of the chunk kernel may have.
int vcycle_chunk_max_threads() { return kMaxThreads; }

// Launches one chunk on `stream`; returns the cudaError_t of the launch.
// gmem [B, G], tags [B, lines] and counters [B, 4] are updated in place;
// all three are null for a program without global memory.
int vcycle_chunk_launch(const int* rows, const int* ctab, const int* tts,
                        const int* dcore, const int* dreg, const int* roff,
                        const uint32_t* regs_in, const uint32_t* spads_in,
                        const uint32_t* flags_in, const int* cyc,
                        uint32_t* regs_out, uint32_t* spads_out,
                        uint32_t* flags_out, int* nexec_out, uint32_t* gmem,
                        int* tags, uint32_t* counters, int B, int C, int R,
                        int S, int n_sends, int n_rows, int n_tts,
                        int stage_luts, int stage_rows, int K, int budget,
                        int prologue_only, int reg_words, int G, int lines,
                        int line_words, int hit_stall, int miss_stall,
                        int gcore, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = vcycle_chunk_smem(C, n_rows, reg_words, S, n_sends,
                                        n_tts, stage_luts, stage_rows);
  cudaError_t err;
  const Kernel kernel = pick(stage_rows, gmem != nullptr, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, chunk_threads(C), smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(rows),
      reinterpret_cast<const int4*>(ctab),
      reinterpret_cast<const uint4*>(tts), dcore, dreg, roff, regs_in,
      spads_in, flags_in, cyc, regs_out, spads_out, flags_out, nexec_out,
      gmem, tags, counters, C, R, S, n_sends, n_rows, n_tts, stage_luts, K,
      budget, prologue_only, G, lines, line_words, hit_stall, miss_stall,
      gcore);
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
