// The gradient of fused (flash) softmax attention in bf16 on Hopper's tensor
// cores (sm_90a): dh = 64 or a multiple of 8 from 72 to 128, any S, causal
// or not, grouped-query attention with query row-set i reading key/value
// row-set i / G.
//
// No TPU kernel is replaced: this is the gradient of
// src/repro/kernels/flash_attention.py:33 `_flash_kernel`, which the
// reference takes by XLA's autodiff of src/repro/models/layers.py:116
// `_sdpa` (it ships no backward kernel). It computes what kernels/ref.py
// `flash_bwd_ref(..., lse=)` computes: with scores S = q k^T / sqrt(dh)
// and the forward's lse (flash_attention_sm90.cu writes it),
//   D = rowsum(dO * O), P = exp(S - lse), dV = P^T dO, dP = dO V^T,
//   dS = P (dP - D), dQ = dS K / sqrt(dh), dK = dS^T Q / sqrt(dh),
// with dK and dV summed over the G query row-sets of a key/value row-set.
// Every sum is fp32; dq, dk and dv are rounded to bf16. The 3xTF32 kernel
// flash_attention_bwd.cu keeps float32 and the other head dims.
//
// What bounds it on this card: at the qwen3-0.6b training shape (BH = 64,
// BHkv = 32, S = 2048, dh = 128, causal) the five products of the
// gradient are 171.8 GFLOP, 0.174 ms at the tensor cores' 989 TFLOP/s
// bf16; its bytes (q, k, v, o, dO, lse in; dq, dk, dv out) are about
// 0.1 GB, 0.03 ms. So the tensor cores bound it. The tile width DP (64 or
// 128) is a template argument and the real dh a run-time one, as in the
// forward: a dh between 72 and 128 runs at DP = 128, the tensor maps have
// the real dh as inner dimension and row stride, and TMA fills the columns
// from dh to 128 with zeros, so every product over 128 columns equals the
// product over dh and the extra columns of dQ, dK and dV are zero and never
// stored. Design: three kernels on one stream, and no atomics, so a
// relaunch gives the same bits:
// 1. delta: one warp a query row computes D from o and dO, and stores
//    {lse * log2(e), D} as a float2 into scratch [BH, Sp] (Sp = S rounded
//    up to 128). Rows past S get {+inf, 0}, so P = exp2(x - inf) = 0 for
//    them: zero-filled query rows never turn into P = 1. This pass moves
//    bytes only; lse comes from the forward, nothing is recomputed.
// 2. dkdv: one block owns (key/value row-set, 128-key tile), two consumer
//    warpgroups of 64 keys each. K and V arrive once by TMA; the block
//    loops over its G query row-sets and the 64-row query tiles that meet
//    the causal triangle, whose Q and dO come by TMA through a 2-stage
//    mbarrier ring (thread 0 issues tile i + 1 while tile i is consumed).
//    Per query tile: S^T = K Q^T and dP^T = V dO^T by SS wgmma m64n64k16;
//    P^T and dS^T in registers, packed to bf16 A fragments in place (the
//    accumulator-to-A identity of sm90.cuh); dV += P^T dO and
//    dK += dS^T Q by RS wgmma with dO and Q read N-major (imm-trans-b).
//    dK and dV stay in fp32 registers for the whole loop; dK is scaled by
//    1/sqrt(dh) once at the end. A warpgroup whose keys all lie above the
//    tile's queries (or past S) skips the tile's products.
// 3. dq: one block owns (row-set, 128 query rows), 64 rows a warpgroup;
//    Q and dO arrive once, K and V tiles of 128 keys through the ring:
//    S = Q K^T and dP = dO V^T by SS wgmma m64n128k16, dS in registers,
//    dQ += dS K by RS wgmma with K read N-major.
// That is seven products against the bound's five (S and dP are
// recomputed in the dq pass). Loads are 3-D tensor maps with 128-byte
// swizzle, as in the forward, so rows past S of a row-set read as zeros.
// Masks are applied on the diagonal and tail tiles only; blocks with the
// longest causal loops are launched first. Not here: a producer warp with
// setmaxnreg, ping-pong of the warpgroups, a persistent grid, dQ folded
// into the dkdv pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 128;              // keys a dkdv block and a dq tile
constexpr int kQTile = 64;              // query rows a dkdv tile
constexpr int kQBlock = 128;            // query rows a dq block
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kStages = 2;              // the TMA ring
constexpr int kPad = 128;               // scratch rows are padded to this
constexpr uint32_t kBox128 = 128 * 128; // 128 rows x 64 bf16 columns
constexpr uint32_t kBox64 = 64 * 128;   // 64 rows x 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

// A [rows, DP] bf16 tile: DP / 64 boxes of 128-byte rows.
template <int DP>
__host__ __device__ constexpr uint32_t tile128() {
  return (DP / 64) * kBox128;
}
template <int DP>
__host__ __device__ constexpr uint32_t tile64() {
  return (DP / 64) * kBox64;
}

// dkdv: K, V (128 rows), then kStages (Q, dO) pairs of 64 rows; dq: Q, dO
// (128 rows), then kStages (K, V) pairs of 128 rows. Plus slack to align
// the base to 1024 bytes.
template <int DP>
__host__ __device__ constexpr size_t dkdv_smem() {
  return 1024 + 2 * static_cast<size_t>(tile128<DP>()) +
         2 * kStages * static_cast<size_t>(tile64<DP>());
}
template <int DP>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + (2 + 2 * kStages) * static_cast<size_t>(tile128<DP>());
}

// D[64 x DP] += A[64 x 16] B[16 x DP], A in registers, B N-major.
template <int DP>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[DP / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_m64n128k16_tb(d, a, db);
  else
    wgmma_rs_m64n64k16_tb(d, a, db);
}

// Rows r and r + 8 of a [64, DP] fp32 accumulator, times `scale`, into
// rows of a [S, dh] bf16 row-set; rows at or past S and columns at or past
// dh (zero: dh is a multiple of 8, so a pair at col < dh ends below dh) are
// not written.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[DP / 2], int r,
                                           int c0, int S, int dh,
                                           float scale) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c0;
    if (col >= dh) continue;
    if (r < S)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * dh +
                                         col) =
          __floats2bfloat162_rn(acc[4 * i] * scale, acc[4 * i + 1] * scale);
    if (r + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r + 8) * dh + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * scale,
                                acc[4 * i + 3] * scale);
  }
}

// 1. {lse * log2(e), rowsum(dO * O)} of row blockIdx.x * 8 + warp of the
// padded [BH, Sp] scratch; {+inf, 0} past S. o and dO are read directly,
// rows of dh columns; the loop over DP is unrolled, so a lane's loads are
// all in flight at once.
template <int DP>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_sm90_delta_kernel(
        const __nv_bfloat16* __restrict__ o,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, float2* __restrict__ ld, int BH,
        int S, int Sp, int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * 8 + warp;
  if (row >= static_cast<size_t>(BH) * Sp) return;
  const int bh = static_cast<int>(row / Sp), i = static_cast<int>(row % Sp);
  float2 out = make_float2(INFINITY, 0.f);
  if (i < S) {  // the same for the whole warp
    const size_t base = (static_cast<size_t>(bh) * S + i) * dh;
    float acc = 0.f;
#pragma unroll
    for (int d = 2 * lane; d < DP; d += 64) {
      if (d >= dh) break;
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + base + d));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + base + d));
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    out = make_float2(lse[static_cast<size_t>(bh) * S + i] * kLog2e, acc);
  }
  if (lane == 0) ld[row] = out;
}

// Q and dO of dkdv iteration `it` (query row-set g = it / per_g, query
// tile qt0 + it % per_g) into ring stage it % kStages.
template <int DP>
__device__ __forceinline__ void load_qdo(const CUtensorMap* tq,
                                         const CUtensorMap* tdo,
                                         uint32_t ring, uint32_t full,
                                         int it, int per_g, int qt0,
                                         int kvh, int G) {
  constexpr uint32_t kT = tile64<DP>();
  const uint32_t qs = ring + 2 * (it % kStages) * kT;
  const int bh = kvh * G + it / per_g, q0 = (qt0 + it % per_g) * kQTile;
  mbar_arrive_expect_tx(full, 2 * kT);
#pragma unroll
  for (int h = 0; h < DP / 64; ++h) {
    tma_load_3d(qs + h * kBox64, tq, full, 64 * h, q0, bh);
    tma_load_3d(qs + kT + h * kBox64, tdo, full, 64 * h, q0, bh);
  }
}

// 2. dK and dV of keys [k0, k0 + 128) of key/value row-set blockIdx.x,
// k0 = 128 blockIdx.y (the longest causal loops first).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_sm90_dkdv_kernel(
        __grid_constant__ const CUtensorMap tq,
        __grid_constant__ const CUtensorMap tdo,
        __grid_constant__ const CUtensorMap tk,
        __grid_constant__ const CUtensorMap tv,
        const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int S, int Sp, int dh, int G,
        int causal, float scale_log2, float scale) {
  constexpr uint32_t kKV = tile128<DP>(), kQ = tile64<DP>();
  extern __shared__ uint8_t smem[];
  // barrier 0: K and V; 1 + s: stage s full; 1 + kStages + s: stage s empty
  __shared__ uint64_t bars[1 + 2 * kStages];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sv = sk + kKV, ring = sv + kKV;
  const uint32_t kvbar = smem_u32(&bars[0]);
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int kvh = blockIdx.x, k0 = static_cast<int>(blockIdx.y) * kKeys;
  const int n_qt = (S + kQTile - 1) / kQTile;
  const int qt0 = causal ? k0 / kQTile : 0;  // first tile meeting the keys
  const int per_g = n_qt - qt0, n_it = G * per_g;

  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tdo);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + kStages + s]), kThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kvbar, 2 * kKV);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      tma_load_3d(sk + h * kBox128, &tk, kvbar, 64 * h, k0, kvh);
      tma_load_3d(sv + h * kBox128, &tv, kvbar, 64 * h, k0, kvh);
    }
    for (int it = 0; it < kStages && it < n_it; ++it)
      load_qdo<DP>(&tq, &tdo, ring, smem_u32(&bars[1 + it]), it, per_g, qt0,
                   kvh, G);
  }
  __syncwarp();

  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.f;
  const int kmin = k0 + wg * 64;                   // this warpgroup's keys
  const int kr = kmin + warp * 16 + lane / 4;      // rows kr and kr + 8
  const int c0 = 2 * (lane % 4);                   // its first column in 8
  const uint32_t ka = sk + wg * 64 * 128, va = sv + wg * 64 * 128;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    // tile it + 1 into the stage that tile it + 1 - kStages used, once
    // every warp has released it
    if (tid == 0 && it + 1 >= kStages && it + 1 < n_it) {
      const int s1 = (it + 1) % kStages;
      mbar_wait(smem_u32(&bars[1 + kStages + s1]),
                ((it + 1) / kStages - 1) & 1);
      load_qdo<DP>(&tq, &tdo, ring, smem_u32(&bars[1 + s1]), it + 1, per_g,
                   qt0, kvh, G);
    }
    __syncwarp();
    mbar_wait(smem_u32(&bars[1 + s]), (it / kStages) & 1);
    const int bh = kvh * G + it / per_g;
    const int q0 = (qt0 + it % per_g) * kQTile;
    const uint32_t qs = ring + 2 * s * kQ, dos = qs + kQ;
    // every key of this warpgroup past S, or above every query of the tile
    const bool skip = kmin >= S || (causal && kmin > q0 + kQTile - 1);
    if (!skip) {
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, DP / 16
      // steps of k16 (32 bytes into a 128-byte swizzled row, 4 a box)
      float st[32], dpt[32];
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wgmma_ss_m64n64k16(
            st, desc_sw128(ka + (j / 4) * kBox128 + (j % 4) * 32, 16, 1024),
            desc_sw128(qs + (j / 4) * kBox64 + (j % 4) * 32, 16, 1024), j > 0);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wgmma_ss_m64n64k16(
            dpt, desc_sw128(va + (j / 4) * kBox128 + (j % 4) * 32, 16, 1024),
            desc_sw128(dos + (j / 4) * kBox64 + (j % 4) * 32, 16, 1024),
            j > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T log2(e) / sqrt(dh) - lse log2(e)) and
      // dS^T = P^T (dP^T - D); a column is a query, {lse2, D} per column
      // (queries past S have lse2 = +inf, so P = 0 there)
      const bool edge = (causal && kmin + 63 > q0) || kmin + 64 > S;
      const float2* row = ld + static_cast<size_t>(bh) * Sp + q0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(row + 8 * i + c0);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float l2 = c ? x.z : x.x, dd = c ? x.w : x.y;
          float p0 = exp2f(st[4 * i + c] * scale_log2 - l2);
          float p1 = exp2f(st[4 * i + 2 + c] * scale_log2 - l2);
          if (edge) {
            const int qc = q0 + 8 * i + c0 + c;
            if (kr >= S || (causal && kr > qc)) p0 = 0.f;
            if (kr + 8 >= S || (causal && kr + 8 > qc)) p1 = 0.f;
          }
          st[4 * i + c] = p0;
          st[4 * i + 2 + c] = p1;
          dpt[4 * i + c] = p0 * (dpt[4 * i + c] - dd);
          dpt[4 * i + 2 + c] = p1 * (dpt[4 * i + 2 + c] - dd);
        }
      }
      // queries 16j..16j+15 of the accumulators are the A fragments
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[j][r] = pack_bf16(st[8 * j + 2 * r], st[8 * j + 2 * r + 1]);
          da[j][r] = pack_bf16(dpt[8 * j + 2 * r], dpt[8 * j + 2 * r + 1]);
        }
      }

      // dV += P^T dO, dK += dS^T Q: 4 steps of 16 queries = two 8-row
      // groups of 1024 bytes; the 64-column boxes lie kBox64 apart along N
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_regs(pa[j]);
        fence_regs(da[j]);
      }
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs_tb<DP>(adv, pa[j], desc_sw128(dos + j * 2048, kBox64, 1024));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs_tb<DP>(adk, da[j], desc_sw128(qs + j * 2048, kBox64, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(adk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[1 + kStages + s]));
  }

  const size_t off = static_cast<size_t>(kvh) * S * dh;
  store_rows<DP>(dk + off, adk, kr, c0, S, dh, scale);
  store_rows<DP>(dv + off, adv, kr, c0, S, dh, 1.f);
}

// K and V tile t of key/value row-set kvh into ring stage t % kStages.
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t ring,
                                        uint32_t full, int t, int kvh) {
  constexpr uint32_t kT = tile128<DP>();
  const uint32_t ks = ring + 2 * (t % kStages) * kT;
  mbar_arrive_expect_tx(full, 2 * kT);
#pragma unroll
  for (int h = 0; h < DP / 64; ++h) {
    tma_load_3d(ks + h * kBox128, tk, full, 64 * h, t * kKeys, kvh);
    tma_load_3d(ks + kT + h * kBox128, tv, full, 64 * h, t * kKeys, kvh);
  }
}

// 3. dQ of query rows [q0, q0 + 128) of row-set blockIdx.x (the longest
// causal rows first).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_sm90_dq_kernel(
        __grid_constant__ const CUtensorMap tq,
        __grid_constant__ const CUtensorMap tdo,
        __grid_constant__ const CUtensorMap tk,
        __grid_constant__ const CUtensorMap tv,
        const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dq, int S,
        int Sp, int dh, int G, int causal, float scale_log2, float scale) {
  constexpr uint32_t kT = tile128<DP>();
  extern __shared__ uint8_t smem[];
  // barrier 0: Q and dO; 1 + s: stage s full; 1 + kStages + s: stage s empty
  __shared__ uint64_t bars[1 + 2 * kStages];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + kT, ring = sdo + kT;
  const uint32_t qbar = smem_u32(&bars[0]);
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int qb = n_tiles - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qb * kQBlock;
  const int bh = blockIdx.x, kvh = bh / G;
  const int n_kt = causal ? qb + 1 : n_tiles;

  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tdo);
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
    mbar_arrive_expect_tx(qbar, 2 * kT);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      tma_load_3d(sq + h * kBox128, &tq, qbar, 64 * h, q0, bh);
      tma_load_3d(sdo + h * kBox128, &tdo, qbar, 64 * h, q0, bh);
    }
    for (int t = 0; t < kStages && t < n_kt; ++t)
      load_kv<DP>(&tk, &tv, ring, smem_u32(&bars[1 + t]), t, kvh);
  }
  __syncwarp();

  float adq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adq[i] = 0.f;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);
  // {lse2, D} of the two rows (past S: {+inf, 0}, and never stored)
  const float2 x0 = ld[static_cast<size_t>(bh) * Sp + r0];
  const float2 x1 = ld[static_cast<size_t>(bh) * Sp + r0 + 8];
  const uint32_t qa = sq + wg * 64 * 128, doa = sdo + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    if (tid == 0 && t + 1 >= kStages && t + 1 < n_kt) {
      const int s1 = (t + 1) % kStages;
      mbar_wait(smem_u32(&bars[1 + kStages + s1]),
                ((t + 1) / kStages - 1) & 1);
      load_kv<DP>(&tk, &tv, ring, smem_u32(&bars[1 + s1]), t + 1, kvh);
    }
    __syncwarp();
    mbar_wait(smem_u32(&bars[1 + s]), (t / kStages) & 1);
    const uint32_t ks = ring + 2 * s * kT, vs = ks + kT;

    // S = Q K^T and dP = dO V^T: 64 x 128 fp32 per warpgroup each
    float sc[64], dp[64];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const uint32_t off = (j / 4) * kBox128 + (j % 4) * 32;
      wgmma_ss_m64n128k16(sc, desc_sw128(qa + off, 16, 1024),
                          desc_sw128(ks + off, 16, 1024), j > 0);
    }
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const uint32_t off = (j / 4) * kBox128 + (j % 4) * 32;
      wgmma_ss_m64n128k16(dp, desc_sw128(doa + off, 16, 1024),
                          desc_sw128(vs + off, 16, 1024), j > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - D), P = exp2(S log2(e) / sqrt(dh) - lse2); masks on the
    // diagonal tile and the tail tile
    const int k0 = t * kKeys;
    const bool edge = (causal && t == qb) || k0 + kKeys > S;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p0 = exp2f(sc[4 * i + c] * scale_log2 - x0.x);
        float p1 = exp2f(sc[4 * i + 2 + c] * scale_log2 - x1.x);
        if (edge) {
          const int kj = k0 + 8 * i + c0 + c;
          if (kj >= S || (causal && kj > r0)) p0 = 0.f;
          if (kj >= S || (causal && kj > r0 + 8)) p1 = 0.f;
        }
        sc[4 * i + c] = p0 * (dp[4 * i + c] - x0.y);
        sc[4 * i + 2 + c] = p1 * (dp[4 * i + 2 + c] - x1.y);
      }
    }
    uint32_t da[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
    }

    // dQ += dS K: 8 steps of 16 keys; K's 64-column boxes kBox128 apart
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_regs(da[j]);
    fence_regs(adq);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma_rs_tb<DP>(adq, da[j], desc_sw128(ks + j * 2048, kBox128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adq);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[1 + kStages + s]));
  }

  store_rows<DP>(dq + static_cast<size_t>(bh) * S * dh, adq, r0, c0, S, dh,
                 scale);
}

// ------------------------------------------------------------------ host ----
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float2* ld, int BH,
                   int BHkv, int S, int dh, int causal, float scale,
                   cudaStream_t stream) {
  const int G = BH / BHkv, Sp = (S + kPad - 1) / kPad * kPad;
  const int n_tiles = (S + kKeys - 1) / kKeys;
  // encoded per call: the pointers change; the real dh is the maps' inner
  // dimension and row stride, so columns past it read as zeros
  CUtensorMap q64, do64, q128, do128, k128, v128;
  if (!make_map(&q64, q, BH, S, dh, kQTile) ||
      !make_map(&do64, dout, BH, S, dh, kQTile) ||
      !make_map(&q128, q, BH, S, dh, kQBlock) ||
      !make_map(&do128, dout, BH, S, dh, kQBlock) ||
      !make_map(&k128, k, BHkv, S, dh, kKeys) ||
      !make_map(&v128, v, BHkv, S, dh, kKeys))
    return cudaErrorInvalidValue;
  auto dkdv = flash_attention_bwd_sm90_dkdv_kernel<DP>;
  auto dqk = flash_attention_bwd_sm90_dq_kernel<DP>;
  cudaError_t err;
  if ((err = allow_smem(dkdv, dkdv_smem<DP>())) != cudaSuccess ||
      (err = allow_smem(dqk, dq_smem<DP>())) != cudaSuccess)
    return err;
  const float scale_log2 = scale * kLog2e;
  const size_t rows = static_cast<size_t>(BH) * Sp;
  flash_attention_bwd_sm90_delta_kernel<DP><<<
      static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ld, BH, S, Sp, dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<dim3(BHkv, n_tiles), kThreads, dkdv_smem<DP>(), stream>>>(
      q64, do64, k128, v128, ld, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Sp, dh, G, causal, scale_log2,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3(BH, n_tiles), kThreads, dq_smem<DP>(), stream>>>(
      q128, do128, k128, v128, ld, static_cast<__nv_bfloat16*>(dq), S, Sp,
      dh, G, causal, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dq [BH, S, dh], dk, dv [BHkv, S, dh]: the gradient of attention o of q
// [BH, S, dh] over k, v [BHkv, S, dh] given dO = dout and the forward's
// lse (fp32 [BH, S], natural log-sum-exp of q k^T * scale), on `stream`.
// q, k, v, o, dout, dq, dk, dv contiguous bf16 on 16-byte boundaries,
// dh = 64 or a multiple of 8 from 72 to 128 (the latter at tile width 128);
// `scratch` is fp32 [BH, Sp, 2] with Sp = S rounded up to 128, on a 16-byte
// boundary. Returns the cudaError_t of the launches.
int flash_attention_bwd_sm90_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* dq, void* dk, void* dv,
                                    void* scratch, int BH, int BHkv, int S,
                                    int dh, int causal, float scale,
                                    void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || S <= 0 ||
      (S + kKeys - 1) / kKeys > 65535 || !head_dim_ok(dh) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv) || !aligned16(scratch) || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* ld = static_cast<float2*>(scratch);
  const cudaError_t err =
      tile_width(dh) == 128
          ? launch<128>(q, k, v, o, dout, l, dq, dk, dv, ld, BH, BHkv, S, dh,
                        causal, scale, s)
          : launch<64>(q, k, v, o, dout, l, dq, dk, dv, ld, BH, BHkv, S, dh,
                       causal, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory a block of each pass takes for head dim dh:
// pass 0 the dK/dV pass, 1 the dQ pass.
int flash_attention_bwd_sm90_smem_bytes(int dh, int pass) {
  const bool wide = tile_width(dh) == 128;
  if (pass == 0)
    return static_cast<int>(wide ? dkdv_smem<128>() : dkdv_smem<64>());
  return static_cast<int>(wide ? dq_smem<128>() : dq_smem<64>());
}

}  // extern "C"
