// Fused (flash) softmax attention for Hopper (sm_90a), causal or not, in
// float32 (and bf16 at the head dims flash_attention_sm90.cu does not take).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:33
// `_flash_kernel` (wrapper `flash_attention` :74): o = softmax(q k^T /
// sqrt(dh)) v over [BH, S, dh], with per-query-row running (max, sum, acc)
// state in fp32, key tiles above the causal diagonal skipped and masked
// scores set to -1e30, as that kernel computes them. Two things differ in
// the contract, not in the function: any S (the tail tile is masked, where
// the TPU wrapper asserts S % block == 0), and grouped-query attention
// without a copy: k and v hold BH / G row-sets and query row-set i reads
// key/value row-set i / G (G = 1 is the TPU kernel's contract). On request
// it also writes each row's lse, the natural log-sum-exp of its scaled,
// masked scores, which flash_attention_bwd.cu takes (as
// flash_attention_sm90.cu writes it for its backward); asked for lse alone
// (o null) it skips P V.
//
// What bounds it on this card: causal attention at the serving shape
// (BH = 64, S = 2048, dh = 128) is 2 BH S^2 dh = 68.7 GFLOP on 0.2 GB of
// float32 q/k/v/o: operations. On the CUDA cores in fp32 (67 TFLOP/s) that
// is 1.03 ms at best. This kernel runs both products, Q K^T and P V, on the
// tensor cores in 3xTF32 (tf32x3.cuh: three TF32 mma.sync products per
// fp32 product, float32-class accuracy), whose bound is 3 x 68.7 GFLOP at
// 495 TFLOP/s, 0.42 ms. bf16 inputs are exact in TF32: Q K^T is one
// product there and P V two (P is split, V is not).
//
// Design: a block of 4 warps owns 64 query rows (16 a warp), its Q tile in
// shared memory; 32-row K and V tiles stream through a ring of two stages
// by cp.async, so the next tile loads while this one computes. A warp's
// S = Q K^T accumulator (16 x 32) becomes the A operand of P V in
// registers (tf32x3.cuh: the permuted k); its O accumulator is 16 x dh.
// Each product sums into a fresh accumulator, kGroup head-dim steps of
// Q K^T or one key tile of P V at a time, added to S or O on the CUDA
// cores (tf32x3.cuh: the tensor cores' sums truncate). A warp whose rows
// lie wholly above a key tile skips that tile's products. 101,376 bytes of
// shared memory a block at dh 128 in fp32, so two blocks share an SM.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBlockM = 64;          // query rows a block, 16 a warp
constexpr int kBlockN = 32;          // key rows a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;           // K/V tiles in flight

template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * ld<T, DP>() * (kBlockM + kStages * 2 * kBlockN);
}

// One block: query rows [q0, q0 + kBlockM) of row-set blockIdx.y. DP: the
// head dim padded to 32, 64 or 128 (columns past dh are zero). kOut: write
// o (else only lse). `vec`: rows are whole 16-byte chunks (cp.async).
template <typename T, int DP, bool kOut>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int S, int dh, int G,
                           int causal, float scale, int vec) {
  constexpr int LD = ld<T, DP>();
  constexpr bool kSplit = !exact_in_tf32<T>();
  constexpr int ND = DP / 8;         // 8-wide head-dim tiles
  constexpr int NK = kBlockN / 8;    // 8-wide key tiles
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* ring = qs + kBlockM * LD;       // stage s: K, then V, kBlockN rows each
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  // the longest causal rows first, so the last wave of blocks is short
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockM;
  const int bh = blockIdx.y;
  const size_t qoff = static_cast<size_t>(bh) * S * dh;
  const size_t kvoff = static_cast<size_t>(bh / G) * S * dh;
  if (dh < DP) {  // the padding columns, which no copy writes
    zero_smem<kThreads>(smem4, smem_bytes<T, DP>());
    __syncthreads();
  }
  const int n_kv = (S + kBlockN - 1) / kBlockN;
  // key tiles that meet this block's causal triangle
  const int n_kt = causal ? min((q0 + kBlockM - 1) / kBlockN + 1, n_kv)
                          : n_kv;
  auto load_kv = [&](int kt) {
    T* ks = ring + (kt % kStages) * 2 * kBlockN * LD;
    load_tile<T, DP, kBlockN, kThreads>(ks, k + kvoff, kt * kBlockN, S, dh,
                                        vec);
    if constexpr (kOut)
      load_tile<T, DP, kBlockN, kThreads>(ks + kBlockN * LD, v + kvoff,
                                          kt * kBlockN, S, dh, vec);
  };
  load_tile<T, DP, kBlockM, kThreads>(qs, q + qoff, q0, S, dh, vec);
  load_kv(0);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max and this thread's
  // share of the running sum (its columns; the quad's sum at the end)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r0 = q0 + 16 * warp;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();
    const int k0 = kt * kBlockN;
    if (causal && k0 > r0 + 15) continue;  // every key above these rows
    const T* ks = ring + (kt % kStages) * 2 * kBlockN * LD;
    const T* vs = ks + kBlockN * LD;
    // s = Q K^T over the warp's 16 rows and the tile's keys
    float s[NK][4];
    dot_rows<kSplit, NK, DP>(s, qs, 16 * warp, ks);
    // scale, mask, online softmax; s becomes P
    const bool edge = k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > r0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * h + e] * scale;
          const int key = k0 + 8 * n + 2 * t + e;
          if (edge && (key >= S || (causal && key > row))) x = kNeg;
          s[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = expf(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * h + e] - m_new);
          s[n][2 * h + e] = p;
          sum += p;
        }
      l[h] = l[h] * alpha + sum;
      if constexpr (kOut) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * h] *= alpha;
          acc[n][2 * h + 1] *= alpha;
        }
      }
    }
    // O += P V: P's accumulator is the A operand, k over the tile's keys
    if constexpr (kOut) {
      FragA a[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) a[j] = acc_as_a(s[j]);
      acc_rows<kSplit, NK, DP>(acc, a, vs);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
    if constexpr (kOut) {
      T* out = o + qoff + static_cast<size_t>(row) * dh;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e;
          if (col < dh) store(out + col, acc[n][2 * h + e] / l[h]);
        }
    }
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[h] + logf(l[h]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int DP, bool kOut>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int G, int S, int dh, int causal,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DP, kOut>;
  constexpr size_t smem = smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec = dh % (16 / sizeof(T)) == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v);
  const dim3 grid((S + kBlockM - 1) / kBlockM, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, dh, G, causal,
      scale, vec);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_out(const void* q, const void* k, const void* v, void* o,
                       float* lse, int BH, int G, int S, int dh, int causal,
                       float scale, cudaStream_t stream) {
  if (o == nullptr)
    return launch<T, DP, false>(q, k, v, o, lse, BH, G, S, dh, causal, scale,
                                stream);
  return launch<T, DP, true>(q, k, v, o, lse, BH, G, S, dh, causal, scale,
                             stream);
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      float* lse, int BH, int G, int S, int dh, int causal,
                      float scale, cudaStream_t stream) {
  if (dh <= 32)
    return launch_out<T, 32>(q, k, v, o, lse, BH, G, S, dh, causal, scale,
                             stream);
  if (dh <= 64)
    return launch_out<T, 64>(q, k, v, o, lse, BH, G, S, dh, causal, scale,
                             stream);
  return launch_out<T, 128>(q, k, v, o, lse, BH, G, S, dh, causal, scale,
                            stream);
}

template <typename T>
size_t smem_dh(int dh) {
  return dh <= 32 ? smem_bytes<T, 32>()
                  : dh <= 64 ? smem_bytes<T, 64>() : smem_bytes<T, 128>();
}

// Counts the x[i] whose tf32_round differs from cvt.rna.tf32.f32's.
__global__ void tf32x3_rounding_kernel(const float* __restrict__ x, int n,
                                       int* __restrict__ mismatches) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    if (tf32_round(x[i]) != tf32_rna(x[i])) atomicAdd(mismatches, 1);
}

}  // namespace

extern "C" {

// o [BH, S, dh] = attention of q [BH, S, dh] over k, v [BHkv, S, dh] on
// `stream`; every tensor contiguous, fp32 (is_bf16 = 0) or bf16 (1). lse
// [BH, S] fp32 when not null: each row's natural log-sum-exp. o null: lse
// only (then lse must not be null). Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int BH, int BHkv, int S,
                           int dh, int causal, int is_bf16, float scale,
                           void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || BH > 65535 || S <= 0 ||
      dh <= 0 || dh > 128 || (o == nullptr && lse == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = BH / BHkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, l, BH, G, S, dh, causal,
                                         scale, s)
              : launch_dh<float>(q, k, v, o, l, BH, G, S, dh, causal, scale,
                                 s);
  return static_cast<int>(err);
}

// Dynamic shared memory of a block at head dim dh.
int flash_attention_smem_bytes(int dh, int is_bf16) {
  return static_cast<int>(is_bf16 ? smem_dh<__nv_bfloat16>(dh)
                                  : smem_dh<float>(dh));
}

// Blocks of the float32 kernel (writing o) that fit an SM at head dim dh,
// or -1 on an error.
int flash_attention_blocks_per_sm(int dh) {
  int blocks = 0;
  cudaError_t err;
  auto occ = [&](auto kernel, size_t smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kThreads, smem);
  };
  if (dh <= 32)
    occ(flash_attention_kernel<float, 32, true>, smem_bytes<float, 32>());
  else if (dh <= 64)
    occ(flash_attention_kernel<float, 64, true>, smem_bytes<float, 64>());
  else
    occ(flash_attention_kernel<float, 128, true>, smem_bytes<float, 128>());
  return err == cudaSuccess ? blocks : -1;
}

// Into *mismatches (device int, zeroed by the caller): how many of the n
// floats at x round to TF32 otherwise by tf32x3.cuh's integer rounding
// than by cvt.rna.tf32.f32. Returns the cudaError_t of the launch.
int tf32x3_rounding_mismatches(const void* x, int n, void* mismatches,
                               void* stream) {
  tf32x3_rounding_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<int*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
