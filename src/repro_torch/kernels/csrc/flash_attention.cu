// Fused (flash) softmax attention for Hopper (sm_90a), causal or not.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:33
// `_flash_kernel` (wrapper `flash_attention` :74): o = softmax(q k^T /
// sqrt(dh)) v over [BH, S, dh], with per-query-row running (max, sum, acc)
// state in fp32, key tiles above the causal diagonal skipped and masked
// scores set to -1e30, as that kernel computes them. Two things differ in
// the contract, not in the function: any S (the tail tile is masked, where
// the TPU wrapper asserts S % block == 0), and grouped-query attention
// without a copy: k and v hold BH / G row-sets and query row-set i reads
// key/value row-set i / G (G = 1 is the TPU kernel's contract).
//
// What bounds it on this card: causal attention at the serving shape
// (BH = 64, S = 2048, dh = 128, bf16) does 2 BH S^2 dh = 68.7 GFLOP on
// about 134 MB of q/k/v/o, so the tensor cores' rate (989 TFLOP/s bf16)
// bounds it, not the bytes. This first kernel computes on the CUDA cores
// in fp32 (no mma.sync/wgmma, no TMA): one block of 8 warps owns 64 query
// rows; each 64-row K/V tile is converted to fp32 in shared memory; a warp
// advances 4 of its rows at a time, one lane per key for the scores
// (float4 reads of rows padded to a stride of 4 mod 8 words, so a
// quarter-warp touches 32 distinct banks) and one lane per head dimension
// for P V. Shared-memory bandwidth, not the FMA rate, is its limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;                      // query rows a block, key rows a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;   // 8
constexpr int kGroup = 4;                      // rows a warp advances together
constexpr float kNeg = -1e30f;                 // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Row stride in words of every fp32 tile: dh rounded up to 8, plus 4.
__host__ __device__ __forceinline__ int row_stride(int dh) {
  return ((dh + 7) / 8) * 8 + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int dh) {
  return sizeof(float) *
         (3 * static_cast<size_t>(kTile) * row_stride(dh) +
          kWarps * kGroup * kTile);
}

// Rows [row0, row0 + kTile) of a [S, dh] row-set into dst [kTile][ld] as
// fp32 times `scale`; rows at or past S and columns at or past dh are 0.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                          int S, int dh, int ld, float scale) {
  for (int i = threadIdx.x; i < kTile * ld; i += kThreads) {
    const int r = i / ld, d = i - r * ld;
    float x = 0.f;
    if (row0 + r < S && d < dh)
      x = to_f32(src[static_cast<size_t>(row0 + r) * dh + d]) * scale;
    dst[i] = x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float lane_of(float4 p, int j) {
  return j == 0 ? p.x : j == 1 ? p.y : j == 2 ? p.z : p.w;
}

// One block: query rows [q0, q0 + kTile) of row-set blockIdx.y. NV is the
// number of head dimensions a lane accumulates (dh <= 32 * NV).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int dh, int G, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = row_stride(dh);
  float* qs = smem;              // [kTile][ld], pre-scaled by 1/sqrt(dh)
  float* ks = qs + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = vs + kTile * ld + warp * kGroup * kTile;  // [kGroup][kTile]

  const int n_tiles = (S + kTile - 1) / kTile;
  // the longest causal rows first, so the last wave of blocks is short
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const size_t qoff = static_cast<size_t>(blockIdx.y) * S * dh;
  const size_t kvoff = static_cast<size_t>(blockIdx.y / G) * S * dh;
  load_tile(qs, q + qoff, q0, S, dh, ld, scale);

  float acc[kRowsPerWarp][NV], m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
  }

  // key tiles that meet this block's causal triangle
  const int live = causal ? min(qt + 1, n_tiles) : n_tiles;
  for (int kt = 0; kt < live; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, k + kvoff, k0, S, dh, ld, 1.f);
    load_tile(vs, v + kvoff, k0, S, dh, ld, 1.f);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kRowsPerWarp / kGroup; ++g) {
      const int lr0 = warp * kRowsPerWarp + g * kGroup;  // block-local row
      // scores of keys k0 + lane and k0 + lane + 32 for kGroup rows
      float s[kGroup][2];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) s[r][0] = s[r][1] = 0.f;
      const float* ka = ks + lane * ld;
      const float* kb = ks + (lane + 32) * ld;
      for (int d = 0; d < dh; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(ka + d);
        const float4 b = *reinterpret_cast<const float4*>(kb + d);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float4 x =
              *reinterpret_cast<const float4*>(qs + (lr0 + r) * ld + d);
          s[r][0] = dot4(x, a, s[r][0]);
          s[r][1] = dot4(x, b, s[r][1]);
        }
      }
      // mask, online softmax, P to shared memory
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int qi = q0 + lr0 + r;
        const int row = g * kGroup + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kj = k0 + lane + 32 * h;
          if (kj >= S || (causal && kj > qi)) s[r][h] = kNeg;
        }
        const float m_new =
            fmaxf(m[row], warp_max(fmaxf(s[r][0], s[r][1])));
        const float p0 = expf(s[r][0] - m_new);
        const float p1 = expf(s[r][1] - m_new);
        const float alpha = expf(m[row] - m_new);
        l[row] = l[row] * alpha + warp_sum(p0 + p1);
        m[row] = m_new;
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[row][i] *= alpha;
        pw[r * kTile + lane] = p0;
        pw[r * kTile + lane + 32] = p1;
      }
      __syncwarp();
      // acc[row][i] += sum_j P[row][j] V[j][lane + 32 i]
      for (int j = 0; j < kTile; j += 4) {
        float4 p[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          p[r] = *reinterpret_cast<const float4*>(pw + r * kTile + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int d = lane + 32 * i;
            const float vv = d < dh ? vs[(j + jj) * ld + d] : 0.f;
#pragma unroll
            for (int r = 0; r < kGroup; ++r)
              acc[g * kGroup + r][i] =
                  fmaf(lane_of(p[r], jj), vv, acc[g * kGroup + r][i]);
          }
        }
      }
      __syncwarp();  // pw is rewritten by the next group
    }
  }

#pragma unroll
  for (int row = 0; row < kRowsPerWarp; ++row) {
    const int qi = q0 + warp * kRowsPerWarp + row;
    if (qi >= S) continue;
    const float den = fmaxf(l[row], 1e-20f);
    T* out = o + qoff + static_cast<size_t>(qi) * dh;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) store(out + d, acc[row][i] / den);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int G, int S, int dh, int causal, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NV>;
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, dh, G, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int BH, int G, int S, int dh, int causal, float scale,
                      cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 1>(q, k, v, o, BH, G, S, dh, causal, scale, stream);
  if (dh <= 64)
    return launch<T, 2>(q, k, v, o, BH, G, S, dh, causal, scale, stream);
  return launch<T, 4>(q, k, v, o, BH, G, S, dh, causal, scale, stream);
}

}  // namespace

extern "C" {

// o [BH, S, dh] = attention of q [BH, S, dh] over k, v [BHkv, S, dh] on
// `stream`; every tensor contiguous, fp32 (is_bf16 = 0) or bf16 (1).
// Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int BH, int BHkv, int S, int dh,
                           int causal, int is_bf16, float scale,
                           void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || BH > 65535 || S <= 0 ||
      dh <= 0 || dh > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = BH / BHkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, BH, G, S, dh, causal,
                                         scale, s)
              : launch_dh<float>(q, k, v, o, BH, G, S, dh, causal, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
