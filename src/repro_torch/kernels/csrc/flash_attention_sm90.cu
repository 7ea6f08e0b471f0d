// Fused (flash) softmax attention in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:33
// `_flash_kernel` (wrapper `flash_attention` :74) for bf16 with dh = 64 or
// a multiple of 8 from 72 to 128: o = softmax(q k^T / sqrt(dh)) v over
// [BH, S, dh], with per-query-row running (max, sum, acc) state in fp32 and
// key tiles above the causal diagonal skipped, as that kernel computes it.
// As in flash_attention.cu (the 3xTF32 kernel, which keeps float32 and the
// other head dims): any S, and grouped-query attention without a copy,
// query row-set i reading key/value row-set i / G.
//
// What bounds it on this card: causal attention at the serving shape
// (BH = 64, S = 2048, dh = 128) does 2 BH S^2 dh = 68.7 GFLOP on about
// 100 MB, so the tensor cores' rate (989 TFLOP/s bf16) bounds it, not the
// bytes. Design, one block of two consumer warpgroups (256 threads) per 128
// query rows, each warpgroup owning 64 of them:
// * The tile width DP is a template argument, 64 or 128; the real dh is a
//   run-time argument. A dh between 72 and 128 runs at DP = 128 on zero
//   columns: the tensor maps have the real dh as their inner dimension and
//   row stride, so TMA fills the columns from dh to 128 of the second box
//   with zeros. Q K^T over 128 columns then equals Q K^T over dh, and the
//   extra output columns of P V are zero and never stored. No padded copy
//   is made; at dh 112 the tensor cores do 8/7 of the work.
// * Loads by TMA (cp.async.bulk.tensor) with 128-byte swizzle, boxes of
//   128 rows x 64 columns from 3-D [rows-sets, S, dh] tensor maps, so rows
//   past S of a row-set arrive as zeros and never as the next row-set's.
//   Q is loaded once; K and V tiles of 128 keys go through a ring of
//   kStages stages, each with a "full" mbarrier (the TMA's transaction
//   bytes) and an "empty" one (one arrival per warp). Thread 0 issues
//   tile t + 1 while tile t is consumed.
// * S = Q K^T by wgmma m64n128k16 with both operands K-major in shared
//   memory; P V by wgmma m64n{DP}k16 with P in registers (the fp32 score
//   accumulator, exponentiated and packed to bf16 pairs in place, is the
//   A-register fragment) and V read N-major with imm-trans-b = 1. The
//   64 x DP fp32 output stays in registers for the whole key loop.
// * Softmax in the exp2 domain (scores scaled by log2(e) / sqrt(dh)); row
//   max over the 4 lanes that share a row; masks only on the diagonal tile
//   and the tail tile; blocks with the longest causal rows are launched
//   first (query blocks on grid y, heads on grid x).
// * Optionally the log-sum-exp of each query row, for the backward kernel
//   (flash_attention_bwd_sm90.cu): lse [BH, S] fp32, in natural-log units
//   of the scores q k^T / sqrt(dh) (the kernel's log2-domain max and sum
//   times ln 2), so that P = exp(q k^T / sqrt(dh) - lse). Serving passes
//   no lse and stores nothing more.
// No producer warp, no ping-pong between the warpgroups, no persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;              // query rows a block, keys a tile
constexpr int kWarpgroups = 2;          // each owns 64 query rows
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 2;              // K/V ring in shared memory
constexpr uint32_t kBox = kRows * 128;  // a 128-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One [128, DP] bf16 tile: DP / 64 boxes, each 128 rows of 128 bytes.
template <int DP>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (DP / 64) * kBox;
}

// Q, then kStages (K, V) pairs, plus slack to align the base to 1024 bytes.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (1 + 2 * kStages) * static_cast<size_t>(tile_bytes<DP>());
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_m64n128k16_tb(o, a, db);
  else
    wgmma_rs_m64n64k16_tb(o, a, db);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K and V tile t of key/value row-set kvh into stage t % kStages (columns
// past dh arrive as zeros and count their bytes).
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sq,
                                        uint32_t full, int t, int kvh) {
  constexpr uint32_t kTile = tile_bytes<DP>();
  const uint32_t ks = sq + (1 + 2 * (t % kStages)) * kTile;
  mbar_arrive_expect_tx(full, 2 * kTile);
#pragma unroll
  for (int h = 0; h < DP / 64; ++h) {
    tma_load_3d(ks + h * kBox, tk, full, 64 * h, t * kRows, kvh);
    tma_load_3d(ks + kTile + h * kBox, tv, full, 64 * h, t * kRows, kvh);
  }
}

// One block: query rows [q0, q0 + 128) of row-set blockIdx.x, at tile
// width DP for head dim dh <= DP.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                                __grid_constant__ const CUtensorMap tk,
                                __grid_constant__ const CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int S, int dh,
                                int G, int causal, float scale_log2) {
  constexpr uint32_t kTile = tile_bytes<DP>();
  extern __shared__ uint8_t smem[];
  // barrier 0: Q; 1 + s: stage s full; 1 + kStages + s: stage s empty
  __shared__ uint64_t bars[1 + 2 * kStages];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t qbar = smem_u32(&bars[0]);
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int n_tiles = (S + kRows - 1) / kRows;
  // the longest causal rows first, so the last wave of blocks is short
  const int qb = n_tiles - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qb * kRows;
  const int bh = blockIdx.x, kvh = bh / G;
  const int n_kt = causal ? qb + 1 : n_tiles;  // key tiles this block reads

  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + kStages + s]), kThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(qbar, kTile);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h)
      tma_load_3d(sq + h * kBox, &tq, qbar, 64 * h, q0, bh);
    for (int t = 0; t < kStages && t < n_kt; ++t)
      load_kv<DP>(&tk, &tv, sq, smem_u32(&bars[1 + t]), t, kvh);
  }
  __syncwarp();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // this thread's rows r0 and r0 + 8: running max (log2 domain) and its
  // share of the running sum (the 4 lanes of a row are summed at the end)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);  // its first column in each 8
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's 64 Q rows
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    // tile t + 1 into the stage that tile t + 1 - kStages used, once every
    // warp has released it
    if (tid == 0 && t + 1 >= kStages && t + 1 < n_kt) {
      const int s1 = (t + 1) % kStages;
      mbar_wait(smem_u32(&bars[1 + kStages + s1]),
                ((t + 1) / kStages - 1) & 1);
      load_kv<DP>(&tk, &tv, sq, smem_u32(&bars[1 + s1]), t + 1, kvh);
    }
    __syncwarp();
    mbar_wait(smem_u32(&bars[1 + s]), (t / kStages) & 1);
    const uint32_t ks = sq + (1 + 2 * s) * kTile, vs = ks + kTile;

    // S = Q K^T: 64 x 128 fp32 per warpgroup, DP / 16 steps of k16 (the
    // zero columns past dh add nothing); a step is 32 bytes into a 128-byte
    // swizzled row, 4 steps to a box
    float sc[64];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const uint32_t off = (j / 4) * kBox + (j % 4) * 32;
      wgmma_ss_m64n128k16(sc, desc_sw128(qa + off, 16, 1024),
                          desc_sw128(ks + off, 16, 1024), j > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale to the log2 domain; mask keys past S and above the diagonal
    const int k0 = t * kRows;
    const bool edge = (causal && t == qb) || k0 + kRows > S;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x0 = sc[4 * i + c] * scale_log2;
        float x1 = sc[4 * i + 2 + c] * scale_log2;
        if (edge) {
          const int kj = k0 + 8 * i + c0 + c;
          if (kj >= S || (causal && kj > r0)) x0 = -INFINITY;
          if (kj >= S || (causal && kj > r0 + 8)) x1 = -INFINITY;
        }
        sc[4 * i + c] = x0;
        sc[4 * i + 2 + c] = x1;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // a row with no live key yet keeps -inf: subtract 0 so exp2 gives 0
    const float b0 = mx0 == -INFINITY ? 0.f : mx0;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1;
    const float al0 = exp2f(m0 - b0), al1 = exp2f(m1 - b1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sc[4 * i + c] = exp2f(sc[4 * i + c] - b0);
        sc[4 * i + 2 + c] = exp2f(sc[4 * i + 2 + c] - b1);
        s0 += sc[4 * i + c];
        s1 += sc[4 * i + 2 + c];
      }
    }
    l0 = l0 * al0 + s0;
    l1 = l1 * al1 + s1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      acc[4 * i] *= al0;
      acc[4 * i + 1] *= al0;
      acc[4 * i + 2] *= al1;
      acc[4 * i + 3] *= al1;
    }
    // P in bf16: keys 16j..16j+15 of the accumulator are the A fragment
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
    }

    // O += P V: 8 steps of 16 keys = two 8-key groups of 1024 bytes; V's
    // 64-column boxes lie kBox apart along N
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_regs(pa[j]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma_pv<DP>(acc, pa[j], desc_sw128(vs + j * 2048, kBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[1 + kStages + s]));
  }

  const float sum0 = fmaxf(quad_sum(l0), 1e-20f);
  const float sum1 = fmaxf(quad_sum(l1), 1e-20f);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  if (lse != nullptr && lane % 4 == 0) {
    // natural log-sum-exp of the row's scaled scores (m is log2-domain)
    float* row = lse + static_cast<size_t>(bh) * S;
    if (r0 < S) row[r0] = (m0 + log2f(sum0)) * kLn2;
    if (r0 + 8 < S) row[r0 + 8] = (m1 + log2f(sum1)) * kLn2;
  }
  // rows of dh columns; the columns from dh to DP are zero and not stored
  // (dh is a multiple of 8, so a pair at col < dh ends below dh)
  __nv_bfloat16* out = o + static_cast<size_t>(bh) * S * dh;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c0;
    if (col >= dh) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r0) * dh + col) =
          __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r0 + 8) * dh + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                acc[4 * i + 3] * inv1);
  }
}

// ------------------------------------------------------------------ host ----
template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int BHkv, int S, int dh, int causal,
                   float scale, cudaStream_t stream) {
  // encoded per call: the pointers change; the real dh is the maps' inner
  // dimension and row stride, so columns past it read as zeros
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, BH, S, dh, kRows) ||
      !make_map(&tk, k, BHkv, S, dh, kRows) ||
      !make_map(&tv, v, BHkv, S, dh, kRows))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_sm90_kernel<DP>;
  const size_t smem = smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                           static_cast<__nv_bfloat16*>(o),
                                           lse, S, dh, BH / BHkv, causal,
                                           scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o [BH, S, dh] = attention of q [BH, S, dh] over k, v [BHkv, S, dh] on
// `stream`; every tensor contiguous bf16 on 16-byte boundaries, dh = 64 or
// a multiple of 8 from 72 to 128 (the latter at tile width 128). Where
// `lse` is not null it receives each row's natural log-sum-exp of
// q k^T * scale, fp32 [BH, S]. Returns the cudaError_t of the launch.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int BHkv, int S,
                                int dh, int causal, float scale,
                                void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || S <= 0 ||
      (S + kRows - 1) / kRows > 65535 || !head_dim_ok(dh) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      tile_width(dh) == 128
          ? launch<128>(q, k, v, o, l, BH, BHkv, S, dh, causal, scale, s)
          : launch<64>(q, k, v, o, l, BH, BHkv, S, dh, causal, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory a block of the kernel for head dim dh takes.
int flash_attention_sm90_smem_bytes(int dh) {
  return static_cast<int>(tile_width(dh) == 128 ? smem_bytes<128>()
                                                : smem_bytes<64>());
}

}  // extern "C"
