// The gradient of fused (flash) softmax attention for Hopper (sm_90a),
// causal or not, with grouped-query attention, in float32 (and bf16 at the
// head dims flash_attention_bwd_sm90.cu does not take).
//
// No TPU kernel is replaced: this is the gradient of
// src/repro/kernels/flash_attention.py:33 `_flash_kernel`, which the
// reference takes by XLA's autodiff of src/repro/models/layers.py:116
// `_sdpa` (it ships no backward kernel). Given q, o, dO [BH, S, dh] and
// k, v [BHkv, S, dh] (query row-set i reads key/value row-set i / G,
// G = BH / BHkv) and each query row's lse, the natural log-sum-exp of its
// scores that flash_attention.cu saves, it computes with scores
// S = q k^T / sqrt(dh), masked to -1e30 above the diagonal when causal:
//   D = rowsum(dO * O), P = exp(S - lse),
//   dV = P^T dO, dP = dO V^T, dS = P (dP - D) / sqrt(dh),
//   dQ = dS K, dK = dS^T Q,
// with dK and dV summed over the G query row-sets of a key/value row-set.
// Every sum is fp32; the outputs are rounded to the inputs' type (fp32 or
// bf16). Without lse it first launches flash_attention.cu for lse alone.
// Plain version: kernels/ref.py `flash_bwd_ref`.
//
// Three kernels, launched in order on one stream, and no atomics, so a
// relaunch gives the same bits whatever order blocks run in:
//   1. delta: D of every row, one warp a row;
//   2. dkdv: a block of 8 warps owns 64 keys of a key/value row-set and
//      streams the 32-row query tiles of its G query row-sets that meet
//      the causal triangle. Warps w and w + 4 share 16 keys: the first
//      computes S^T = K Q^T, P^T, and dV += P^T dO; the second dP^T =
//      V dO^T, dS^T from the first's P^T (through shared memory, on a
//      named barrier of the pair), and dK += dS^T Q. Each holds one of
//      dK, dV in registers;
//   3. dq: a block of 4 warps owns 64 query rows (16 a warp) and streams
//      the 16-row key tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
// Seven products, not five: S and dP are recomputed in the dQ pass, which
// keeps dQ free of atomics.
//
// What bounds it on this card: at the qwen3-0.6b training shape (BH = 64,
// BHkv = 32, S = 2048, dh = 128, causal) the five products of the gradient
// are 171.8 GFLOP: 2.56 ms on the CUDA cores in fp32 (67 TFLOP/s). Every
// product here runs on the tensor cores in 3xTF32 (tf32x3.cuh: three TF32
// mma.sync products per fp32 product), bound 3 x 171.8 GFLOP at 495
// TFLOP/s, 1.04 ms; the seven products it does are 1.4x that. bf16 inputs
// are exact in TF32: products of two inputs are one TF32 product there,
// products with P or dS two.
//
// Design: each pass keeps the block's own 64-row tiles (K and V, or Q and
// dO) in shared memory and streams the other side's tiles (and their lse
// and D) through a two-stage cp.async ring, so the next tile loads while
// this one computes. S^T (or S) and dP^T (or dP) are accumulators of 16
// rows a warp, whose P^T and dS^T (dS) become the A operands of the next
// products in registers (tf32x3.cuh: the permuted k). Each product sums
// into a fresh accumulator, kGroup head-dim steps or one streamed tile at
// a time, added to the long sums (dK, dV, dQ) on the CUDA cores
// (tf32x3.cuh: the tensor cores' sums truncate). A warp whose keys and
// queries miss the causal triangle skips the tile's products. At dh 128
// in fp32 a dK/dV block takes 143,872 bytes of shared memory (one block an
// SM, 8 warps) and a dQ block 101,376 (two an SM).
#include "tf32x3.cuh"

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int BH, int BHkv, int S, int dh,
                                      int causal, int is_bf16, float scale,
                                      void* stream);

namespace {

using namespace tf32x3;

constexpr int kBlock = 64;           // rows a block owns, 16 a warp
constexpr int kStages = 2;           // streamed tiles in flight
constexpr int kDeltaRows = 8;        // rows a block of the delta pass
// dK/dV pass: 8 warps, warp w and w + 4 on keys 16 (w % 4) of the block's
// 64: the first P and dV, the second dP, dS and dK
constexpr int kKvThreads = 256;
constexpr int kKvStep = 32;          // query rows of a streamed tile
// dQ pass: 4 warps
constexpr int kQThreads = 128;
constexpr int kQStep = 16;           // key rows of a streamed tile

// dK/dV: K and V, kStages x (Q, dO) tiles, kStages x (lse, D), and P of
// each warp pair (16 keys x kKvStep queries).
template <typename T, int DP>
__host__ __device__ constexpr size_t dkdv_smem() {
  return sizeof(T) * ld<T, DP>() * (2 * kBlock + kStages * 2 * kKvStep) +
         sizeof(float) * (kStages * 2 * kKvStep + 4 * 16 * kKvStep);
}

// dQ: Q and dO, kStages x (K, V) tiles.
template <typename T, int DP>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(T) * ld<T, DP>() * (2 * kBlock + kStages * 2 * kQStep);
}

// A named barrier of the two warps of a pair (ids 1-4; 0 is
// __syncthreads): the P warp arrives once P is in shared memory, the dK
// warp waits for it.
__device__ __forceinline__ void pair_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// 1. D of rows [8 blockIdx.x, + 8) of the [rows, dh] o and dout.
template <typename T>
__global__ void __launch_bounds__(32 * kDeltaRows)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta, int rows,
                                     int dh) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  if (r >= rows) return;
  const size_t off = static_cast<size_t>(r) * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc = fmaf(to_f32(o[off + d]), to_f32(dout[off + d]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[r] = acc;
}

// Rows [r0, r0 + 16) (two per lane: r0 + g and r0 + g + 8) of a [S, dh]
// row-set from an [ND][4] accumulator, times `scale`.
template <typename T, int ND>
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          const float (&acc)[ND][4], int r0,
                                          int S, int dh, float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
    T* out = dst + static_cast<size_t>(row) * dh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < dh) store(out + col, acc[n][2 * h + e] * scale);
      }
  }
}

// 2. dK and dV of key rows [k0, k0 + kBlock) of key/value row-set
// blockIdx.y, over its G query row-sets.
template <typename T, int DP>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_attention_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int S, int dh, int G,
        int causal, float scale, int vec) {
  constexpr int LD = ld<T, DP>();
  constexpr bool kSplit = !exact_in_tf32<T>();
  constexpr int ND = DP / 8;
  constexpr int NQ = kKvStep / 8;    // 8-wide query tiles
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);
  T* vs = ks + kBlock * LD;
  T* ring = vs + kBlock * LD;        // stage s: Q, then dO, kKvStep rows
  float* rowv = reinterpret_cast<float*>(ring + kStages * 2 * kKvStep * LD);
  float* pbuf = rowv + kStages * 2 * kKvStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % 4;           // the pair's 16 keys
  const bool p_warp = warp < 4;      // P and dV; else dP, dS and dK
  float* pw = pbuf + kw * 16 * kKvStep;  // the pair's P, lane-major
  const int k0 = blockIdx.x * kBlock, h = blockIdx.y;
  const size_t kvoff = static_cast<size_t>(h) * S * dh;
  if (dh < DP) {  // the padding columns, which no copy writes
    zero_smem<kKvThreads>(smem4, dkdv_smem<T, DP>());
    __syncthreads();
  }
  // the query tiles that meet the causal triangle of this key tile, for
  // each of the G query row-sets
  const int nq = (S + kKvStep - 1) / kKvStep;
  const int qt_lo = causal ? k0 / kKvStep : 0;
  const int per_g = nq - qt_lo;
  const int n_it = G * per_g;
  auto load_q = [&](int it) {
    const int bh = h * G + it / per_g, q0 = (qt_lo + it % per_g) * kKvStep;
    const size_t qoff = static_cast<size_t>(bh) * S * dh;
    T* qs = ring + (it % kStages) * 2 * kKvStep * LD;
    load_tile<T, DP, kKvStep, kKvThreads>(qs, q + qoff, q0, S, dh, vec);
    load_tile<T, DP, kKvStep, kKvThreads>(qs + kKvStep * LD, dout + qoff,
                                          q0, S, dh, vec);
    float* rv = rowv + (it % kStages) * 2 * kKvStep;
    load_rows<kKvStep>(rv, lse + static_cast<size_t>(bh) * S, q0, S, 0);
    load_rows<kKvStep>(rv + kKvStep, delta + static_cast<size_t>(bh) * S,
                       q0, S, kKvStep);
  };
  load_tile<T, DP, kBlock, kKvThreads>(ks, k + kvoff, k0, S, dh, vec);
  load_tile<T, DP, kBlock, kKvThreads>(vs, v + kvoff, k0, S, dh, vec);
  load_q(0);
  cp_async_commit();

  float acc[ND][4];                  // dV (P warps) or dK (the others)
#pragma unroll
  for (int n = 0; n < ND; ++n) zero4(acc[n]);
  const int kr0 = k0 + 16 * kw;      // this pair's keys
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    // tile it is in; every warp is done with tile it - 1 (and with pw)
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
    const int q0 = (qt_lo + it % per_g) * kKvStep;
    // every query before this pair's keys, or no key below S
    if ((causal && q0 + kKvStep - 1 < kr0) || kr0 >= S) continue;
    const T* qs = ring + (it % kStages) * 2 * kKvStep * LD;
    const T* dos = qs + kKvStep * LD;
    const float* lse_s = rowv + (it % kStages) * 2 * kKvStep;
    const float* d_s = lse_s + kKvStep;
    // rows the pair's 16 keys, columns the tile's queries: S^T = K Q^T
    // (P warps) or dP^T = V dO^T; then P^T or dS^T (without its
    // 1/sqrt(dh), applied to dK at the end)
    float c[NQ][4];
    if (p_warp) {
      dot_rows<kSplit, NQ, DP>(c, ks, 16 * kw, qs);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kr0 + g + 8 * (e >> 1);
          const int qc = 8 * n + 2 * t + (e & 1), qi = q0 + qc;
          const bool live = key < S && qi < S && (!causal || key <= qi);
          c[n][e] = live ? expf(c[n][e] * scale - lse_s[qc]) : 0.f;
          pw[(4 * n + e) * 32 + lane] = c[n][e];
        }
      pair_arrive(1 + kw);
    } else {
      dot_rows<kSplit, NQ, DP>(c, vs, 16 * kw, dos);
      pair_sync(1 + kw);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * n + 2 * t + (e & 1);
          c[n][e] = pw[(4 * n + e) * 32 + lane] * (c[n][e] - d_s[qc]);
        }
    }
    // dV += P^T dO or dK += dS^T Q: k over the tile's queries
    FragA a[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) a[j] = acc_as_a(c[j]);
    acc_rows<kSplit, NQ, DP>(acc, a, p_warp ? dos : qs);
  }
  cp_async_wait<0>();
  if (p_warp)
    store_acc<T, ND>(dv + kvoff, acc, kr0, S, dh, 1.f);
  else
    store_acc<T, ND>(dk + kvoff, acc, kr0, S, dh, scale);
}

// 3. dQ of query rows [q0, q0 + kBlock) of row-set blockIdx.y.
template <typename T, int DP>
__global__ void __launch_bounds__(kQThreads, 2)
    flash_attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dq, int S, int dh, int G, int causal, float scale,
        int vec) {
  constexpr int LD = ld<T, DP>();
  constexpr bool kSplit = !exact_in_tf32<T>();
  constexpr int ND = DP / 8;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* dos = qs + kBlock * LD;
  T* ring = dos + kBlock * LD;       // stage s: K, then V, kQStep rows each
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (S + kBlock - 1) / kBlock;
  // the longest causal rows first, so the last wave of blocks is short
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlock;
  const int bh = blockIdx.y;
  const size_t qoff = static_cast<size_t>(bh) * S * dh;
  const size_t kvoff = static_cast<size_t>(bh / G) * S * dh;
  if (dh < DP) {
    zero_smem<kQThreads>(smem4, dq_smem<T, DP>());
    __syncthreads();
  }
  const int n_k = (S + kQStep - 1) / kQStep;
  const int n_kt = causal ? min((q0 + kBlock - 1) / kQStep + 1, n_k) : n_k;
  auto load_kv = [&](int kt) {
    T* kst = ring + (kt % kStages) * 2 * kQStep * LD;
    load_tile<T, DP, kQStep, kQThreads>(kst, k + kvoff, kt * kQStep, S,
                                        dh, vec);
    load_tile<T, DP, kQStep, kQThreads>(kst + kQStep * LD, v + kvoff,
                                        kt * kQStep, S, dh, vec);
  };
  load_tile<T, DP, kBlock, kQThreads>(qs, q + qoff, q0, S, dh, vec);
  load_tile<T, DP, kBlock, kQThreads>(dos, dout + qoff, q0, S, dh, vec);
  load_kv(0);
  cp_async_commit();

  const int r0 = q0 + 16 * warp;     // this warp's rows
  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    const size_t i = static_cast<size_t>(bh) * S + min(row, S - 1);
    lse_r[h] = lse[i];
    d_r[h] = delta[i];
  }
  float adq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();
    const int k0 = kt * kQStep;
    // every key above this warp's rows, or no row below S
    if ((causal && k0 > r0 + 15) || r0 >= S) continue;
    const T* kst = ring + (kt % kStages) * 2 * kQStep * LD;
    const T* vst = kst + kQStep * LD;
    // S = Q K^T and dP = dO V^T over the warp's 16 rows and 16 keys
    float s[2][4], dp[2][4];
    dot_rows<kSplit, 2, DP>(s, qs, 16 * warp, kst);
    dot_rows<kSplit, 2, DP>(dp, dos, 16 * warp, vst);
    // dS (without its 1/sqrt(dh), applied to dQ at the end)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1);
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const bool live = row < S && key < S && (!causal || key <= row);
        const float p =
            live ? expf(s[n][e] * scale - lse_r[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - d_r[e >> 1]);
      }
    // dQ += dS K: k over the tile's keys
    const FragA ads[2] = {acc_as_a(dp[0]), acc_as_a(dp[1])};
    acc_rows<kSplit, 2, DP>(adq, ads, kst);
  }
  cp_async_wait<0>();
  store_acc<T, ND>(dq + qoff, adq, r0, S, dh, scale);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dq, void* dk, void* dv, float* scratch, int BH,
                   int BHkv, int S, int dh, int causal, float scale,
                   cudaStream_t stream) {
  const int G = BH / BHkv, n_tiles = (S + kBlock - 1) / kBlock;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tdo = static_cast<const T*>(dout);
  constexpr size_t smem_kv = dkdv_smem<T, DP>(), smem_q = dq_smem<T, DP>();
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, DP>;
  auto dqk = flash_attention_bwd_dq_kernel<T, DP>;
  cudaError_t err;
  if ((err = allow_smem(dkdv, smem_kv)) != cudaSuccess ||
      (err = allow_smem(dqk, smem_q)) != cudaSuccess)
    return err;
  float* delta = scratch + static_cast<size_t>(BH) * S;
  const float* l = static_cast<const float*>(lse);
  if (l == nullptr) {  // lse alone from the forward kernel, into scratch
    const int e = flash_attention_launch(q, k, v, nullptr, scratch, BH, BHkv,
                                         S, dh, causal, sizeof(T) == 2,
                                         scale, stream);
    if (e != 0) return static_cast<cudaError_t>(e);
    l = scratch;
  }
  const int rows = BH * S;
  flash_attention_bwd_delta_kernel<T>
      <<<(rows + kDeltaRows - 1) / kDeltaRows, 32 * kDeltaRows, 0, stream>>>(
          to, tdo, delta, rows, dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int vec = dh % (16 / sizeof(T)) == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);
  dkdv<<<dim3(n_tiles, BHkv), kKvThreads, smem_kv, stream>>>(
      tq, tk, tv, tdo, l, delta, static_cast<T*>(dk), static_cast<T*>(dv), S,
      dh, G, causal, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3(n_tiles, BH), kQThreads, smem_q, stream>>>(
      tq, tk, tv, tdo, l, delta, static_cast<T*>(dq), S, dh, G, causal,
      scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* dq, void* dk, void* dv, float* scratch, int BH,
                      int BHkv, int S, int dh, int causal, float scale,
                      cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, o, dout, lse, dq, dk, dv, scratch, BH,
                         BHkv, S, dh, causal, scale, stream);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, scratch, BH,
                         BHkv, S, dh, causal, scale, stream);
  return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, scratch, BH,
                        BHkv, S, dh, causal, scale, stream);
}

template <typename K>
int occupancy(K kernel, int threads, size_t smem) {
  int blocks = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? blocks : -1;
}

template <int DP>
int blocks_per_sm(int pass) {
  return pass == 0 ? occupancy(flash_attention_bwd_dkdv_kernel<float, DP>,
                               kKvThreads, dkdv_smem<float, DP>())
                   : occupancy(flash_attention_bwd_dq_kernel<float, DP>,
                               kQThreads, dq_smem<float, DP>());
}

template <typename T>
size_t smem_dh(int pass, int dh) {
  if (pass == 0)
    return dh <= 32   ? dkdv_smem<T, 32>()
           : dh <= 64 ? dkdv_smem<T, 64>()
                      : dkdv_smem<T, 128>();
  return dh <= 32 ? dq_smem<T, 32>() : dh <= 64 ? dq_smem<T, 64>()
                                                : dq_smem<T, 128>();
}

}  // namespace

extern "C" {

// dq [BH, S, dh], dk, dv [BHkv, S, dh]: the gradient of attention o of q
// [BH, S, dh] over k, v [BHkv, S, dh] given dO = dout, on `stream`; every
// tensor contiguous, fp32 (is_bf16 = 0) or bf16 (1). lse [BH, S] fp32: the
// forward's (flash_attention_launch's), or null to compute it first.
// `scratch` is fp32 [2, BH, S] (lse when not given, then D). Returns the
// cudaError_t of the launches.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dq, void* dk, void* dv,
                               void* scratch, int BH, int BHkv, int S,
                               int dh, int causal, int is_bf16, float scale,
                               void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || BH > 65535 || S <= 0 ||
      dh <= 0 || dh > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv,
                                         f, BH, BHkv, S, dh, causal, scale, s)
              : launch_dh<float>(q, k, v, o, dout, lse, dq, dk, dv, f, BH,
                                 BHkv, S, dh, causal, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of a block of the dK/dV (pass 0) or dQ (pass 1)
// kernel at head dim dh.
int flash_attention_bwd_smem_bytes(int pass, int dh, int is_bf16) {
  return static_cast<int>(is_bf16 ? smem_dh<__nv_bfloat16>(pass, dh)
                                  : smem_dh<float>(pass, dh));
}

// Blocks of the float32 dK/dV (pass 0) or dQ (pass 1) kernel that fit an
// SM at head dim dh, or -1 on an error.
int flash_attention_bwd_blocks_per_sm(int pass, int dh) {
  return dh <= 32   ? blocks_per_sm<32>(pass)
         : dh <= 64 ? blocks_per_sm<64>(pass)
                    : blocks_per_sm<128>(pass);
}

}  // extern "C"
