// The gradient of fused (flash) softmax attention for Hopper (sm_90a),
// causal or not, with grouped-query attention.
//
// No TPU kernel is replaced: this is the gradient of
// src/repro/kernels/flash_attention.py:33 `_flash_kernel`, which the
// reference takes by XLA's autodiff of src/repro/models/layers.py:116
// `_sdpa` (it ships no backward kernel). Given q, o, dO [BH, S, dh] and
// k, v [BHkv, S, dh] (query row-set i reads key/value row-set i / G,
// G = BH / BHkv), it computes with scores S = q k^T / sqrt(dh), masked
// to -1e30 above the diagonal when causal:
//   lse = logsumexp_j S, D = rowsum(dO * O), P = exp(S - lse),
//   dV = P^T dO, dP = dO V^T, dS = P (dP - D) / sqrt(dh),
//   dQ = dS K, dK = dS^T Q,
// with dK and dV summed over the G query row-sets of a key/value row-set.
// Every sum is fp32; the outputs are rounded to the inputs' type (fp32 or
// bf16). Plain version: kernels/ref.py `flash_bwd_ref`.
//
// Three kernels, launched in order on one stream, and no atomics, so the
// result does not depend on the order blocks run in:
//   1. prep: one block a (row-set, 64-row query tile) recomputes each
//      row's lse from q and k, and D from o and dO, into fp32 scratch
//      (the forward kernels stay as they are and save nothing);
//   2. dkdv: one block owns a (key/value row-set, 64-row key tile) and
//      loops over its G query row-sets and the query tiles that meet the
//      causal triangle, holding dK and dV in registers;
//   3. dq: one block owns a (row-set, query tile) and loops over the key
//      tiles, holding dQ in registers.
//
// What bounds it on this card: at the qwen3-0.6b training shape (BH = 64,
// BHkv = 32, S = 2048, dh = 128, causal) the five products of the
// gradient are 2.5x the forward's 68.7 GFLOP, 171.8 GFLOP, which the
// tensor cores (989 TFLOP/s bf16) could do in 0.17 ms; the bytes (q, k,
// v, o, dO in, dq, dk, dv out) are about 0.1 GB. This first kernel runs on
// the CUDA cores in fp32 (no mma.sync or wgmma, no TMA) and does eight
// products, not five (S in all three passes, dP in two): each 64 x 64
// product tile is 256 threads with a 4 x 4 register tile each, rows
// ty + 16 i and columns tx + 16 j, fed by float4 reads of fp32 tiles in
// shared memory whose row stride is 4 mod 32 words (a quarter-warp's
// eight rows fall on distinct banks). Shared-memory bandwidth and the
// fp32 FMA rate are its limits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;           // query rows and key rows of a tile
constexpr int kThreads = 256;       // a 16 x 16 grid over a 64 x 64 tile
constexpr int kSub = 4;             // a thread's rows (and columns) there
constexpr int kLdP = kTile + 16;    // row stride of the P and dS tiles,
                                    // 16 mod 32: two rows hit both halves
constexpr float kNeg = -1e30f;      // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Row stride in words of the fp32 [kTile][dh] tiles: NV * 64 head dims
// (zero past dh) plus 4.
template <int NV>
__host__ __device__ constexpr int row_stride() {
  return 64 * NV + 4;
}

template <int NV>
constexpr size_t prep_smem() {
  return sizeof(float) * 2 * kTile * row_stride<NV>();
}
template <int NV>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (4 * kTile * row_stride<NV>() + 2 * kTile * kLdP + 2 * kTile);
}
template <int NV>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (4 * kTile * row_stride<NV>() + kTile * kLdP + 2 * kTile);
}

// Rows [row0, row0 + kTile) of a [S, dh] row-set into dst [kTile][ld] as
// fp32; rows at or past S and columns at or past dh are 0.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                          int S, int dh, int ld) {
  for (int i = threadIdx.x; i < kTile * ld; i += kThreads) {
    const int r = i / ld, d = i - r * ld;
    float x = 0.f;
    if (row0 + r < S && d < dh)
      x = to_f32(src[static_cast<size_t>(row0 + r) * dh + d]);
    dst[i] = x;
  }
}

// Entries [row0, row0 + kTile) of a per-row vector; 0 past S.
__device__ void load_rows(float* dst, const float* __restrict__ src,
                          int row0, int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Reductions over the 16 lanes of one tile row (threads ty * 16 + tx).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d] over tiles [kTile][ld].
__device__ __forceinline__ void tile_dot(float (&s)[kSub][kSub],
                                         const float* a, const float* b,
                                         int ld, int dh, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < dh; d += 4) {
    float4 x[kSub], y[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
  }
}

__device__ __forceinline__ bool live(int qi, int kj, int S, int causal) {
  return qi < S && kj < S && (!causal || kj <= qi);
}

// P and dS of one (query tile, key tile) pair into ps and dss [kTile][kLdP]
// (rows: queries, columns: keys), from the fp32 tiles qs, dos (queries) and
// ks, vs (keys), and the query rows' lse and D.
template <int NV>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* d_s, float* ps,
                                         float* dss, int q0, int k0, int S,
                                         int dh, int causal, float scale) {
  constexpr int ld = row_stride<NV>();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[kSub][kSub], dp[kSub][kSub];
  tile_dot(s, qs, ks, ld, dh, ty, tx);
  tile_dot(dp, dos, vs, ld, dh, ty, tx);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int qr = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int kc = tx + 16 * j;
      const float p = live(q0 + qr, k0 + kc, S, causal)
                          ? expf(s[i][j] * scale - lse_s[qr])
                          : 0.f;
      if (ps != nullptr) ps[qr * kLdP + kc] = p;
      dss[qr * kLdP + kc] = p * (dp[i][j] - d_s[qr]);
    }
  }
}

// Writes rows [row0, row0 + kTile) of a [S, dh] row-set from acc, where
// thread (ty, tx) holds rows ty + 16 i and head dims tx * 4 + 64 n, times
// `scale`.
template <typename T, int NV>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float4 (&acc)[kSub][NV],
                                           int row0, int S, int dh,
                                           float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= S) continue;
    T* out = dst + static_cast<size_t>(r) * dh;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int d = tx * 4 + 64 * n;
      const float x[4] = {acc[i][n].x, acc[i][n].y, acc[i][n].z,
                          acc[i][n].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < dh) store(out + d + e, x[e] * scale);
    }
  }
}

// 1. lse and D of query rows [q0, q0 + kTile) of row-set blockIdx.y.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_prep_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ lse,
                                    float* __restrict__ delta, int S, int dh,
                                    int G, int causal, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int ld = row_stride<NV>();
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * ld;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (S + kTile - 1) / kTile;
  // the longest causal rows first, so the last wave of blocks is short
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile, bh = blockIdx.y;
  const size_t qoff = static_cast<size_t>(bh) * S * dh;
  const size_t kvoff = static_cast<size_t>(bh / G) * S * dh;
  load_tile(qs, q + qoff, q0, S, dh, ld);
  float m[kSub], l[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every thread is done with the previous key tile
    load_tile(ks, k + kvoff, k0, S, dh, ld);
    __syncthreads();
    float s[kSub][kSub];
    tile_dot(s, qs, ks, ld, dh, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int kj = k0 + tx + 16 * j;
        // rows past S count every key below S, so none is empty
        s[i][j] = kj < S && (!causal || kj <= qi) ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi < S) lse[static_cast<size_t>(bh) * S + qi] = m[i] + logf(l[i]);
    }
  }
  // D: one warp a row, a lane every 32nd head dim
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTile && q0 + r < S; r += kThreads / 32) {
    const size_t row = qoff + static_cast<size_t>(q0 + r) * dh;
    float acc = 0.f;
    for (int d = lane; d < dh; d += 32)
      acc = fmaf(to_f32(o[row + d]), to_f32(dout[row + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
  }
}

// 2. dK and dV of key rows [k0, k0 + kTile) of key/value row-set
// blockIdx.y, over its G query row-sets.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int S, int dh, int G,
        int causal, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int ld = row_stride<NV>();
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* ps = dos + kTile * ld;
  float* dss = ps + kTile * kLdP;
  float* lse_s = dss + kTile * kLdP;
  float* d_s = lse_s + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x, k0 = kt * kTile, h = blockIdx.y;
  const size_t kvoff = static_cast<size_t>(h) * S * dh;
  load_tile(ks, k + kvoff, k0, S, dh, ld);
  load_tile(vs, v + kvoff, k0, S, dh, ld);
  // thread (ty, tx) sums key rows ty + 16 i, head dims tx * 4 + 64 n
  float4 adk[kSub][NV], adv[kSub][NV];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int n = 0; n < NV; ++n)
      adk[i][n] = adv[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {
    const int bh = h * G + g;
    const size_t qoff = static_cast<size_t>(bh) * S * dh;
    // the query tiles that meet the causal triangle of this key tile
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every thread is done with the previous tiles
      load_tile(qs, q + qoff, q0, S, dh, ld);
      load_tile(dos, dout + qoff, q0, S, dh, ld);
      load_rows(lse_s, lse + static_cast<size_t>(bh) * S, q0, S);
      load_rows(d_s, delta + static_cast<size_t>(bh) * S, q0, S);
      __syncthreads();
      p_and_ds<NV>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, S, dh,
                   causal, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's query rows below S
      const int rows = min(kTile, S - q0);
      for (int qr = 0; qr < rows; ++qr) {
        float4 dov[NV], qv[NV];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          dov[n] = *reinterpret_cast<const float4*>(dos + qr * ld + tx * 4 +
                                                    64 * n);
          qv[n] = *reinterpret_cast<const float4*>(qs + qr * ld + tx * 4 +
                                                   64 * n);
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float p = ps[qr * kLdP + ty + 16 * i];
          const float ds = dss[qr * kLdP + ty + 16 * i];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            fma4(adv[i][n], p, dov[n]);
            fma4(adk[i][n], ds, qv[n]);
          }
        }
      }
    }
  }
  store_rows<T, NV>(dk + kvoff, adk, k0, S, dh, scale);
  store_rows<T, NV>(dv + kvoff, adv, k0, S, dh, 1.f);
}

// 3. dQ of query rows [q0, q0 + kTile) of row-set blockIdx.y.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dq, int S, int dh, int G, int causal, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int ld = row_stride<NV>();
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;
  float* lse_s = dss + kTile * kLdP;
  float* d_s = lse_s + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile, bh = blockIdx.y;
  const size_t qoff = static_cast<size_t>(bh) * S * dh;
  const size_t kvoff = static_cast<size_t>(bh / G) * S * dh;
  load_tile(qs, q + qoff, q0, S, dh, ld);
  load_tile(dos, dout + qoff, q0, S, dh, ld);
  load_rows(lse_s, lse + static_cast<size_t>(bh) * S, q0, S);
  load_rows(d_s, delta + static_cast<size_t>(bh) * S, q0, S);
  // thread (ty, tx) sums query rows ty + 16 i, head dims tx * 4 + 64 n
  float4 adq[kSub][NV];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int n = 0; n < NV; ++n) adq[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every thread is done with the previous tiles
    load_tile(ks, k + kvoff, k0, S, dh, ld);
    load_tile(vs, v + kvoff, k0, S, dh, ld);
    __syncthreads();
    p_and_ds<NV>(qs, dos, ks, vs, lse_s, d_s, nullptr, dss, q0, k0, S, dh,
                 causal, scale);
    __syncthreads();
    // dQ += dS K over the tile's key rows below S
    const int cols = min(kTile, S - k0);
    for (int kc = 0; kc < cols; ++kc) {
      float4 kv[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n)
        kv[n] = *reinterpret_cast<const float4*>(ks + kc * ld + tx * 4 +
                                                 64 * n);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float ds = dss[(ty + 16 * i) * kLdP + kc];
#pragma unroll
        for (int n = 0; n < NV; ++n) fma4(adq[i][n], ds, kv[n]);
      }
    }
  }
  store_rows<T, NV>(dq + qoff, adq, q0, S, dh, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* scratch, int BH, int BHkv, int S, int dh,
                   int causal, float scale, cudaStream_t stream) {
  const int G = BH / BHkv, n_tiles = (S + kTile - 1) / kTile;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tdo = static_cast<const T*>(dout);
  float* lse = scratch;
  float* delta = scratch + static_cast<size_t>(BH) * S;
  auto prep = flash_attention_bwd_prep_kernel<T, NV>;
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, NV>;
  auto dqk = flash_attention_bwd_dq_kernel<T, NV>;
  cudaError_t err;
  if ((err = allow_smem(prep, prep_smem<NV>())) != cudaSuccess ||
      (err = allow_smem(dkdv, dkdv_smem<NV>())) != cudaSuccess ||
      (err = allow_smem(dqk, dq_smem<NV>())) != cudaSuccess)
    return err;
  prep<<<dim3(n_tiles, BH), kThreads, prep_smem<NV>(), stream>>>(
      tq, tk, to, tdo, lse, delta, S, dh, G, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<dim3(n_tiles, BHkv), kThreads, dkdv_smem<NV>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, dh, G, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3(n_tiles, BH), kThreads, dq_smem<NV>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, dh, G, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, void* dq, void* dk,
                      void* dv, float* scratch, int BH, int BHkv, int S,
                      int dh, int causal, float scale, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 1>(q, k, v, o, dout, dq, dk, dv, scratch, BH, BHkv, S,
                        dh, causal, scale, stream);
  return launch<T, 2>(q, k, v, o, dout, dq, dk, dv, scratch, BH, BHkv, S, dh,
                      causal, scale, stream);
}

}  // namespace

extern "C" {

// dq [BH, S, dh], dk, dv [BHkv, S, dh]: the gradient of attention o of q
// [BH, S, dh] over k, v [BHkv, S, dh] given dO = dout, on `stream`; every
// tensor contiguous, fp32 (is_bf16 = 0) or bf16 (1); `scratch` is fp32
// [2, BH, S] (lse, then D). Returns the cudaError_t of the launches.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, void* scratch, int BH,
                               int BHkv, int S, int dh, int causal,
                               int is_bf16, float scale, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || BH > 65535 || S <= 0 ||
      dh <= 0 || dh > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, f, BH,
                                         BHkv, S, dh, causal, scale, s)
              : launch_dh<float>(q, k, v, o, dout, dq, dk, dv, f, BH, BHkv,
                                 S, dh, causal, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
