// One Vcycle of the seed engine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of the seed arm, Machine(specialize=False):
//   src/repro/kernels/vcycle.py:45  _vcycle_kernel  (wrapper :146 vcycle_pallas)
// It runs one Vcycle's slot loop over every core: the full ISA select on
// every slot (NOP slots included: the seed arm is the unspecialized
// baseline), each result masked to 16 bits before its register write, and
// the whole [T, C] result trace written out. The BSP exchange is not here:
// the engine routes SEND values from the trace after the launch, as the
// reference does outside its kernel. To the TPU kernel's ISA it adds GLD/GST
// and the privileged core's direct-mapped cache/stall model, which the
// reference's seed arm runs in its jnp engine.
//
// Layout: one warp per core, four cores a block; within a Vcycle cores
// never talk to each other, so warps are independent. The warp copies its
// core's register row (packed: core c keeps the registers its code names,
// roff[c + 1] - roff[c] of them; mm's 49 cores need 82 KB where dense rows
// of R registers would not fit), coalesced, its scratchpad and the first
// 16 bytes of its T rows (kernels/rows.py seed_rows: the LUT table already
// resolved; global memory instead when they do not fit) into shared
// memory; lane 0 walks the T slots, reading slot t + 1's row while slot t
// executes and dispatching every slot through one jump table (isa.cuh
// run_rows, alu), and writes trace[t, c]; the warp writes the state back
// once, copying through registers a core never names. The lane of the
// privileged core `gcore` owns gmem [G], the cache tags [lines] and
// counters [4] (updated in place); the binding checks that GLD/GST sit on
// that core only; kGlobal instances carry GLD/GST.
//
// Bound on this card: the bytes it must move (state in and out, the [T, C]
// trace and the tables it is handed) against T * C instructions over the
// INT32 rate; both are well under a microsecond at mc/full. What bounds it
// is the chain of T slots one lane walks (register reads from shared
// memory, a dispatch, the operation, a write), plus the launch and the
// staging of the state. A lane per warp, where 32 lanes walked 32 cores
// before: on the chip a warp's 32 lanes took a slot markedly longer than
// one lane alone (bank conflicts on the packed registers, lanes on
// different opcodes), and the card has warps to spare for one Vcycle's C
// cores (PERF.md).
#include <type_traits>

#include "isa.cuh"

namespace {

constexpr int kCores = 4;             // cores a block: a warp each
constexpr int kThreads = 32 * kCores;
// __launch_bounds__(kThreads, 1): with no minimum of blocks an SM, ptxas
// capped the kernel near 48 registers and spilled

// Shared memory of one block, in order: the staged rows (kStaged: the first
// 16 bytes of the T rows of each of its cores), the LUT tables (staged),
// the packed registers and the scratchpads.
struct Smem {
  size_t rows, tts, words;  // uint4, uint4, uint32 counts
  __host__ __device__ Smem(bool staged, int T, int block_words, int S,
                           int n_tts, int stage_luts)
      : rows(staged ? static_cast<size_t>(T) * kCores : 0),
        tts(stage_luts ? 4 * static_cast<size_t>(n_tts) : 0),
        words(static_cast<size_t>(block_words) +
              static_cast<size_t>(kCores) * S) {}
  __host__ __device__ size_t bytes() const {
    return 16 * (rows + tts) + 4 * words;
  }
};

template <bool kStaged, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1) vcycle_seed_kernel(
    const uint4* __restrict__ rows, const uint4* __restrict__ tts_g,
    const int* __restrict__ roff, const uint32_t* __restrict__ regs_in,
    const uint32_t* __restrict__ spads_in,
    const uint32_t* __restrict__ flags_in, uint32_t* __restrict__ regs_out,
    uint32_t* __restrict__ spads_out, uint32_t* __restrict__ flags_out,
    uint32_t* __restrict__ trace, uint32_t* __restrict__ gmem,
    int* __restrict__ tags, uint32_t* __restrict__ counters, int C, int T,
    int R, int S, int n_tts, int stage_luts, int block_words, int G,
    int lines, int line_words, int hit_stall, int miss_stall, int gcore) {
  extern __shared__ uint4 smem4[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const int c0 = blockIdx.x * kCores;
  const int c = c0 + warp;
  const bool live = c < C;
  const int rbase = __ldg(roff + c0);
  const Smem lay(kStaged, T, block_words, S, n_tts, stage_luts);
  uint4* rowbuf = smem4 + static_cast<size_t>(warp) * T;  // staged rows
  uint4* tts_s = smem4 + lay.rows;                         // [n_tts][4]
  uint32_t* regs = reinterpret_cast<uint32_t*>(tts_s + lay.tts);
  uint32_t* my_spad = regs + block_words + static_cast<size_t>(warp) * S;
  const int o = live ? __ldg(roff + c) - rbase : 0;
  const int rc = live ? __ldg(roff + c + 1) - rbase - o : 0;
  uint32_t* my_regs = regs + o;

  // the warp stages its core: rows, registers (coalesced), scratchpad
  if (live) {
    if constexpr (kStaged) {
      const uint4* mine = rows + 2 * static_cast<size_t>(c) * T;
      for (int t = wl; t < T; t += 32) rowbuf[t] = __ldg(mine + 2 * t);
    }
    const uint32_t* src_r = regs_in + static_cast<size_t>(c) * R;
    for (int r = wl; r < rc; r += 32) my_regs[r] = src_r[r];
    for (int i = wl; i < S; i += 32)
      my_spad[i] = spads_in[static_cast<size_t>(c) * S + i];
  }
  if (stage_luts)
    for (int i = tid; i < 4 * n_tts; i += kThreads)
      tts_s[i] = __ldg(tts_g + i);
  __syncthreads();
  if (!live) return;

  // lane 0 walks the core's T slots
  if (wl == 0) {
    const uint4* tts = stage_luts ? tts_s : tts_g;
    typename std::conditional<kStaged, isa::StagedRows,
                              isa::GlobalRows>::type src;
    if constexpr (kStaged)
      src = isa::StagedRows{rowbuf, nullptr};
    else
      src = isa::GlobalRows{rows + 2 * static_cast<size_t>(c) * T};
    uint32_t flag = flags_in[c];
    isa::Glob g = {};
    if (gmem != nullptr && c == gcore)
      g = isa::Glob{gmem, tags, counters, static_cast<uint32_t>(G),
                    static_cast<uint32_t>(lines),
                    static_cast<uint32_t>(line_words),
                    static_cast<uint32_t>(hit_stall),
                    static_cast<uint32_t>(miss_stall)};
    uint32_t* my_trace = trace + c;
    isa::run_rows<true, true, kGlobal>(src, 0, T, tts, my_regs, my_spad,
                                       static_cast<uint32_t>(S), flag, g,
                                       [&](const isa::Row&, uint32_t res) {
                                         *my_trace = res & isa::kMask;
                                         my_trace += C;
                                       });
    flags_out[c] = flag;
  }
  __syncwarp();
  // registers a core never names keep their input values
  const size_t row = static_cast<size_t>(c) * R;
  for (int r = wl; r < R; r += 32)
    regs_out[row + r] = r < rc ? my_regs[r] : regs_in[row + r];
  for (int i = wl; i < S; i += 32)
    spads_out[static_cast<size_t>(c) * S + i] = my_spad[i];
}

using Kernel = decltype(&vcycle_seed_kernel<true, true>);

// The instance for staged or streamed rows, with or without GLD/GST, its
// dynamic shared memory allowed up to `smem`.
Kernel pick(int stage_rows, bool global, size_t smem, cudaError_t* err) {
  const Kernel k = stage_rows ? (global ? vcycle_seed_kernel<true, true>
                                        : vcycle_seed_kernel<true, false>)
                              : (global ? vcycle_seed_kernel<false, true>
                                        : vcycle_seed_kernel<false, false>);
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  return k;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the seed kernel takes, with its rows
// staged (stage_rows) or streamed, for the most packed register words any
// block's cores hold.
size_t vcycle_seed_smem(int T, int block_words, int S, int n_tts,
                        int stage_luts, int stage_rows) {
  return Smem(stage_rows != 0, T, block_words, S, n_tts, stage_luts).bytes();
}

// Launches one Vcycle on `stream`; returns the cudaError_t of the launch.
// gmem [G], tags [lines] and counters [4] are updated in place; all three
// are null for a program without global memory.
int vcycle_seed_launch(const int* rows, const int* tts, const int* roff,
                       const uint32_t* regs_in, const uint32_t* spads_in,
                       const uint32_t* flags_in, uint32_t* regs_out,
                       uint32_t* spads_out, uint32_t* flags_out,
                       uint32_t* trace, uint32_t* gmem, int* tags,
                       uint32_t* counters, int C, int T, int R, int S,
                       int n_tts, int stage_luts, int stage_rows,
                       int block_words, int G, int lines, int line_words,
                       int hit_stall, int miss_stall, int gcore,
                       void* stream) {
  if (C <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = vcycle_seed_smem(T, block_words, S, n_tts, stage_luts,
                                       stage_rows);
  cudaError_t err;
  const Kernel kernel = pick(stage_rows, gmem != nullptr, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(C + kCores - 1) / kCores, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(rows),
      reinterpret_cast<const uint4*>(tts), roff, regs_in, spads_in, flags_in,
      regs_out, spads_out, flags_out, trace, gmem, tags, counters, C, T, R, S,
      n_tts, stage_luts, block_words, G, lines, line_words, hit_stall,
      miss_stall, gcore);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
