// float32 matrix products on Hopper's tensor cores in 3xTF32, and the tile
// copies and fragment loads of the float32 flash kernels
// (flash_attention.cu, flash_attention_bwd.cu).
//
// TF32 keeps 10 of fp32's 23 mantissa bits, about three decimal digits. In
// 3xTF32 each operand x is split into big = tf32(x) and small = x - big,
// and a product is the fp32 sum big.big + big.small + small.big: about 21
// bits of fp32's 24, at three TF32 products (495 TFLOP/s on the H100 SXM)
// per fp32 product. small.small, below 2^-22 of the product, is dropped. An operand exact in TF32 (a bf16 input: 8 significant bits) has
// small = 0, and the products with its small part are skipped.
//
// The products are mma.sync.m16n8k8 (not wgmma: TF32 wgmma reads B from
// shared memory only K-major, and four of the flash kernels' seven products
// read an operand N-major). Fragments are 32-bit loads from shared memory,
// in any order. Per lane (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator becomes the A operand of the next product without a
// shuffle by permuting k: A column t is key 2t and column t + 4 is key
// 2t + 1, so a = {c0, c2, c1, c3}; the B operand then reads its rows t and
// t + 4 from keys 2t and 2t + 1 (the sum over k does not care about order).
//
// Tiles lie in shared memory as the inputs' type T, row-major, rows padded
// to LD elements (16 bytes past the head dim): 4 words mod 32 in fp32, so
// the eight rows of a fragment, and the permuted rows 2t, 2t + 1, fall on
// distinct banks. They arrive by cp.async (16 bytes a thread, rows past S
// zero-filled by the copy) into rings of shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tf32x3 {

constexpr float kNeg = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Whether every value of T is exact in TF32 (then its small part is 0).
template <typename T>
__host__ __device__ constexpr bool exact_in_tf32() {
  return sizeof(T) == 2;  // bf16
}

// Row stride in elements of a tile of head dim DP: 16 bytes of padding.
template <typename T, int DP>
__host__ __device__ constexpr int ld() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

// ------------------------------------------------------------- the split --
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the 13 bits past TF32's mantissa 0) with an integer add and
// and. Every element a fragment reads is split, and the kernels are bound
// by the instructions they issue, not by the tensor cores: with the cvt
// in its place both flash kernels ran 12-14% slower on an H100, to the
// same bits. Bit-equal to the cvt on normal floats (flash_attention.cu
// `tf32x3_rounding_mismatches` checks it on the card).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small: big = x rounded to TF32, small = x - big (exact in
// fp32), which the tensor core reads as TF32 by dropping its last 13 bits
// (a rounding of small costs two more operations an element: 6-7% of the
// flash kernels' time on an H100, for float64 errors that moved by up to a
// quarter, both ways). |x - big - tf32(small)| < 2^-21 |x|. With kSplit false x is taken as exact in TF32
// (small = 0).
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if constexpr (kSplit) {
    big = tf32_round(x);
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
    small = 0;
  }
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

template <bool kSplit>
__device__ __forceinline__ FragA make_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split<kSplit>(a0, f.big[0], f.small[0]);
  split<kSplit>(a1, f.big[1], f.small[1]);
  split<kSplit>(a2, f.big[2], f.small[2]);
  split<kSplit>(a3, f.big[3], f.small[3]);
  return f;
}

template <bool kSplit>
__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split<kSplit>(b0, f.big[0], f.small[0]);
  split<kSplit>(b1, f.big[1], f.small[1]);
  return f;
}

// d += a b, one TF32 m16n8k8 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small terms, then big.big. kSplitA / kSplitB
// false: that operand is exact in TF32 and its small term is skipped (two
// products, or one).
//
// The tensor cores' fp32 sums truncate, so in one long chain of products
// (dV sums 4,096 query rows at the training shape) the error grows with
// the chain. The kernels keep every chain short: d is a fresh accumulator
// over a few k-steps (a tile's keys or queries, or kGroup head-dim steps),
// then added to the long sum on the CUDA cores, which round to nearest
// (add4).
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (kSplitA) mma_tf32(d, a.small, b.big);
  if constexpr (kSplitB) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// Head-dim k-steps (8 wide) summed in one fresh accumulator.
constexpr int kGroup = 4;

__device__ __forceinline__ void zero4(float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// -------------------------------------------------- fragments from tiles --
// A = rows [r0, r0 + 16) x columns [c0, c0 + 8) of a row-major tile.
template <bool kSplit, typename T>
__device__ __forceinline__ FragA load_a(const T* x, int ld, int r0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = x + (r0 + g) * ld + c0 + t;
  return make_a<kSplit>(to_f32(p[0]), to_f32(p[8 * ld]), to_f32(p[4]),
                        to_f32(p[8 * ld + 4]));
}

// B[k][n] = x[n0 + n][k0 + k]: the tile's rows are B's columns (K-major),
// as K is in Q K^T.
template <bool kSplit, typename T>
__device__ __forceinline__ FragB load_b_kmajor(const T* x, int ld, int n0,
                                               int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = x + (n0 + g) * ld + k0 + t;
  return make_b<kSplit>(to_f32(p[0]), to_f32(p[4]));
}

// B[k][n] = x[k0 + key(k)][n0 + n] with the permuted k (rows t and t + 4
// of B are tile rows 2t and 2t + 1): the tile's rows are B's rows
// (N-major), as V is in P V, for an A made from an accumulator.
template <bool kSplit, typename T>
__device__ __forceinline__ FragB load_b_nmajor(const T* x, int ld, int k0,
                                               int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = x + (k0 + 2 * t) * ld + n0 + g;
  return make_b<kSplit>(to_f32(p[0]), to_f32(p[ld]));
}

// The accumulator of an m16n8 product as the A operand of k-step 8 wide
// (permuted k: see the top of this file).
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return make_a<true>(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------- tile products --
// c = rows [r0, r0 + 16) of tile a times rows [0, 8 NN) of tile b,
// transposed: the sum over DP head dims of two row-major tiles (b K-major:
// S = Q K^T, dP = dO V^T, and their transposes), kGroup 8-wide steps at a
// time in a fresh accumulator added to c on the CUDA cores.
template <bool kSplit, int NN, int DP, typename T>
__device__ __forceinline__ void dot_rows(float (&c)[NN][4], const T* a,
                                         int r0, const T* b) {
  constexpr int LD = ld<T, DP>();
#pragma unroll
  for (int n = 0; n < NN; ++n) zero4(c[n]);
#pragma unroll 1
  for (int kg = 0; kg < DP / 8; kg += kGroup) {
    float d[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) zero4(d[n]);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const FragA fa = load_a<kSplit>(a, LD, r0, 8 * (kg + i));
#pragma unroll
      for (int n = 0; n < NN; ++n)
        mma3<kSplit, kSplit>(
            d[n], fa, load_b_kmajor<kSplit>(b, LD, 8 * n, 8 * (kg + i)));
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) add4(c[n], d[n]);
  }
}

// acc += a b over the 8 NJ rows of tile b (N-major, the permuted k), a
// made from accumulators (P, P^T, dS, dS^T): O += P V, dV += P^T dO,
// dK += dS^T Q, dQ += dS K. Each 8-column block of acc sums the NJ
// k-steps in a fresh accumulator, added on the CUDA cores.
template <bool kSplitB, int NJ, int DP, typename T>
__device__ __forceinline__ void acc_rows(float (&acc)[DP / 8][4],
                                         const FragA (&a)[NJ], const T* b) {
  constexpr int LD = ld<T, DP>();
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float d[4];
    zero4(d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma3<true, kSplitB>(d, a[j],
                          load_b_nmajor<kSplitB>(b, LD, 8 * j, 8 * n));
    add4(acc[n], d);
  }
}

// ------------------------------------------------------------- cp.async --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from src to dst, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) x head dims [0, dh) of a [S, dh] row-set into
// a tile [ROWS][LD] by NT threads; rows at or past S are zero. Columns in
// [dh, DP) are left as they are (the kernels zero them once). Rows of
// 16-byte chunks go by cp.async; when dh is not a whole number of chunks
// (or `vec` is false) the rows go by plain loads and stores instead.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int S, int dh,
                                          bool vec) {
  constexpr int LD = ld<T, DP>();
  constexpr int E = 16 / sizeof(T);   // elements a chunk
  constexpr int CH = DP / E;          // chunks a row
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = i - r * CH;
      if (c * E >= dh) continue;
      const bool in = row0 + r < S;
      cp_async16(dst + r * LD + c * E,
                 src + static_cast<size_t>(in ? row0 + r : 0) * dh + c * E,
                 in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * dh; i += NT) {
      const int r = i / dh, d = i - r * dh;
      dst[r * LD + d] = row0 + r < S
                            ? src[static_cast<size_t>(row0 + r) * dh + d]
                            : T(0.f);
    }
  }
}

// Entries [row0, row0 + ROWS) of a per-row fp32 vector, 0 past S, by
// threads [first, first + ROWS) (4 bytes each by cp.async).
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S, int first) {
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < ROWS) {
    const bool in = row0 + i < S;
    cp_async4(dst + i, src + (in ? row0 + i : 0), in);
  }
}

// Zeroes `bytes` (a multiple of 16) of shared memory from p with NT
// threads.
template <int NT>
__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  float4* q = static_cast<float4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += NT)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Reductions over the four lanes of a quad (one row of an accumulator).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tf32x3
