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
// 0.1 GB, 0.03 ms. So the tensor cores bound it, and between the products
// of a tile sits elementwise work on the CUDA cores (exp2 of P, dS). The
// tile width DP (64 or 128) and the head dim DH (64, 112, 128, or 0 for
// one given at run time) are template arguments, as in the forward: a dh
// between 72 and 128 runs at DP = 128, the tensor maps have the real dh as
// inner dimension and row stride, and TMA fills the columns from dh to 128
// with zeros, so every product over 128 columns equals the product over
// dh. At dh 112 the products that reduce over dh run only the 7 k-steps of
// 16 columns that reach below it, and those whose width is dh (dV, dK, dQ)
// run by wgmma m64n112k16 on no zero column; at dh 64 and 128 the stores
// and the delta pass test no column. Three kernels on one stream, and no
// atomics, so a relaunch gives the same bits:
// 1. delta: one warp a query row computes D from o and dO, and stores
//    {lse * log2(e), D} as a float2 into scratch [BH, Sp] (Sp = S rounded
//    up to 128). Rows past S get {+inf, 0}, so P = exp2(x - inf) = 0 for
//    them: zero-filled query rows never turn into P = 1. This pass moves
//    bytes only; lse comes from the forward, nothing is recomputed.
// 2. dkdv: items (key/value row-set, 64-key tile); per item K and V arrive
//    once, and the G query row-sets' 64-row query tiles that meet the
//    causal triangle stream through a ring of (Q, dO, {lse2, D}) stages,
//    the last a 512-byte bulk copy of the scratch rows (4 stages at a tile
//    width of 128: K, V and a 32 KB partial-sum buffer, 64 KB, + 4 x
//    33,280 B = 199,680 B). Both consumer warpgroups own the item's 64 keys
//    and take its query tiles in turn; each runs S^T = K Q^T and dP^T =
//    V dO^T by SS wgmma m64n64k16, issued back to back before one wait;
//    P^T and dS^T in registers, packed to bf16 A fragments in place (the
//    accumulator-to-A identity of sm90.cuh); dV += P^T dO and dK += dS^T Q
//    by RS wgmma with dO and Q read N-major (imm-trans-b). Each keeps its
//    dK and dV partial sums in fp32 registers for the whole item; at its
//    end the two are added in a fixed order through shared memory, and dK
//    is scaled by 1/sqrt(dh) once. Half as many keys an item as the
//    warpgroups hold gives twice the items, so a few KV row-sets (G 12)
//    still fill the card; the first query tile an item reads is its
//    diagonal one, so no tile lies wholly above the keys. An odd tile count
//    has warpgroup 1 rerun the last tile on P = dS = 0: a wgmma under a
//    condition the compiler cannot prove uniform makes it serialize every
//    wgmma of the kernel. Both warpgroups arrive on every tile's "empty"
//    barrier at the end of the step that holds it, so the rerun tile is not
//    reloaded under the rerun's products. K and V are released after
//    the item's last S^T and dP^T, so the next item's load runs under its
//    last products and its stores.
// 3. dq: items (row-set, 128 query rows), 64 rows a warpgroup; Q and dO
//    arrive once an item, K and V tiles of 128 keys through a ring of 2
//    stages at a tile width of 128 (197,632 B): S = Q K^T and dP = dO V^T
//    by SS wgmma m64n128k16, dS in registers, dQ += dS K by RS wgmma with
//    K read N-major. Q and dO are released after the item's last S and dP.
// The dkdv and dq kernels are warp-specialised and persistent, one block of
// three warpgroups (384 threads) on each SM: a producer warpgroup gives
// back registers (setmaxnreg to 24) and one of its threads issues every TMA
// load, waiting on the ring's "empty" mbarriers; the two consumer
// warpgroups (setmaxnreg to 240) wait on "full" ones and arrive on "empty"
// ones. The consumers ping-pong on two named barriers (bar.sync id, 256):
// a warpgroup issues its products (the first pair, then the second) only
// after the other has issued its own, so one's elementwise work runs while
// the other's products are on the tensor cores. Items are walked in
// sections of heads whose shared operand (a dK/dV item's Q and dO, a dQ
// item's K and V) fits an L2 budget together, in each the longest causal
// loops first, each section dealt to the blocks in snake order on its own
// (sm90.cuh block_item, heads_per_section); each item is computed whole by
// one block, so the order changes no result. That is seven products against the bound's five (S and dP
// are recomputed in the dq pass). Loads are 3-D tensor maps with 128-byte
// swizzle, as in the forward, so rows past S of a row-set read as zeros.
// Masks are applied on the diagonal and tail tiles only.
// Registers a thread (ptxas -v): 168 at entry in dkdv and dq, then the
// producer 24 and each consumer 240 by setmaxnreg; no spills. Not here: dQ
// folded into the dkdv pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 128;              // keys a dkdv item and a dq tile
constexpr int kQTile = 64;              // query rows a dkdv tile
constexpr int kQBlock = 128;            // query rows a dq item
constexpr int kConsumers = 2;           // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kPingPong = 1;            // named barriers 1 and 2
constexpr int kReduce = 3;              // named barrier of dkdv's sums
constexpr int kPad = 128;               // scratch rows are padded to this
constexpr uint32_t kBox128 = 128 * 128; // 128 rows x 64 bf16 columns
constexpr uint32_t kBox64 = 64 * 128;   // 64 rows x 64 bf16 columns
constexpr uint32_t kLdBytes = kQTile * 8;  // a dkdv tile's {lse2, D} rows
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

// Ring stages that fit beside an item's two resident tiles, 1 KB of
// alignment slack and the barriers: dkdv (Q, dO) pairs of 64 rows beside
// K and V; dq (K, V) pairs of 128 rows beside Q and dO.
template <int DP>
__host__ __device__ constexpr int dkdv_stages() {
  return static_cast<int>((kSmemPerBlock - 1024 - 256 - 4 * tile64<DP>()) /
                          (2 * tile64<DP>() + kLdBytes));
}
template <int DP>
__host__ __device__ constexpr int dq_stages() {
  return static_cast<int>((kSmemPerBlock - 1024 - 256 - 2 * tile128<DP>()) /
                          (2 * tile128<DP>()));
}
template <int DP>
__host__ __device__ constexpr size_t dkdv_smem() {
  return 1024 + 4 * static_cast<size_t>(tile64<DP>()) +
         dkdv_stages<DP>() * (2 * static_cast<size_t>(tile64<DP>()) +
                              kLdBytes);
}
template <int DP>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + (2 + 2 * dq_stages<DP>()) *
                    static_cast<size_t>(tile128<DP>());
}

// The width of the products over dh's columns: dh at 112, else DP.
template <int DP, int DH>
__host__ __device__ constexpr int out_width() {
  return DH == 112 ? 112 : DP;
}

// D[64 x NV] += A[64 x 16] B[16 x NV], A in registers, B N-major.
template <int NV>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[NV / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (NV == 128)
    wgmma_rs_m64n128k16_tb(d, a, db);
  else if constexpr (NV == 112)
    wgmma_rs_m64n112k16_tb(d, a, db);
  else
    wgmma_rs_m64n64k16_tb(d, a, db);
}

// Rows r and r + 8 of a [64, NV] fp32 accumulator, times `scale`, into
// rows of a [S, dh] bf16 row-set; rows at or past S are not written, nor,
// at a run-time dh (DH = 0), columns at or past dh (zero: dh is a multiple
// of 8, so a pair at col < dh ends below dh).
template <int NV, int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[NV / 2], int r,
                                           int c0, int S, int dh,
                                           float scale) {
  const int ld = DH ? DH : dh;
#pragma unroll
  for (int i = 0; i < NV / 8; ++i) {
    const int col = 8 * i + c0;
    if (DH == 0 && col >= dh) continue;
    if (r < S)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * ld +
                                         col) =
          __floats2bfloat162_rn(acc[4 * i] * scale, acc[4 * i + 1] * scale);
    if (r + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r + 8) * ld + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * scale,
                                acc[4 * i + 3] * scale);
  }
}

// The k-steps of 16 columns a product over dh runs: those that reach below
// dh where DH is known (7 of 8 at 112); at a run-time dh all DP / 16 (the
// zero columns add nothing; a run-time bound would put the wgmma issues on
// a path the compiler cannot prove uniform, and it then serializes them).
template <int DP, int DH>
__host__ __device__ constexpr int ksteps() {
  return DH ? (DH + 15) / 16 : DP / 16;
}

// 1. {lse * log2(e), rowsum(dO * O)} of row blockIdx.x * 8 + warp of the
// padded [BH, Sp] scratch; {+inf, 0} past S. o and dO are read directly,
// rows of dh columns; the loop over the row is unrolled, so a lane's loads
// are all in flight at once.
template <int DP, int DH>
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
  const int width = DH ? DH : dh;
  float2 out = make_float2(INFINITY, 0.f);
  if (i < S) {  // the same for the whole warp
    const size_t base = (static_cast<size_t>(bh) * S + i) * width;
    float acc = 0.f;
#pragma unroll
    for (int d = 2 * lane; d < DP; d += 64) {
      if (d >= width) break;
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

// ------------------------------------------------------------ dK / dV ----
// Items (key/value row-set, key tile), in one of two shapes fixed at launch
// (SPLIT): where the items of 128 keys fill the card more than once, an
// item is 128 keys, warpgroup w owns keys 64w..64w+63, and both take
// every query tile (a Q/dO tile serves 128 keys); where they do not (few
// key/value row-sets, as at G 12), an item is 64 keys, both warpgroups own
// them and take the query tiles in turn (warpgroup w the tiles 2j + w),
// and their dK and dV partial sums are added in a fixed order at the
// item's end through shared memory: twice the items, so the card is full
// and the longest causal item is half as long. Barriers: bars[0] K/V full,
// bars[1] K/V empty; bars[2 + s] stage s's (Q, dO, {lse2, D}) full,
// bars[2 + KS + s] its empty (every consumer warp, the owner's or not).
struct DkdvItem {
  int kvh, k0, qt0, per_g, n_it;
};

template <bool SPLIT>
__host__ __device__ constexpr int dkdv_keys() {
  return SPLIT ? 64 : 128;
}

// The block's j-th item (key/value row-set, first key), the longest causal
// loops (the first key tiles) of a section first, and the query tiles it
// reads from qt0 on, in each of the G query row-sets; false past its last.
template <bool SPLIT>
__device__ __forceinline__ bool dkdv_item(int j, int BHkv, int S, int G,
                                          int hs, int causal, DkdvItem& d) {
  constexpr int kb = dkdv_keys<SPLIT>();
  int y;
  if (!block_item(j, BHkv, (S + kb - 1) / kb, hs, d.kvh, y)) return false;
  d.k0 = y * kb;
  const int n_qt = (S + kQTile - 1) / kQTile;
  d.qt0 = causal ? d.k0 / kQTile : 0;  // the first query tile meeting keys
  d.per_g = n_qt - d.qt0;
  d.n_it = G * d.per_g;
  return true;
}

// Shared memory of a dkdv block from its aligned base: K and V (the item's
// keys), where SPLIT the partial-sum buffer (64 x DP fp32) after them, the
// ring's (Q, dO) stages from 4 tile64 on, then each stage's {lse2, D} rows.
template <int DP>
__device__ __forceinline__ uint32_t dkdv_ring(uint32_t sk) {
  return sk + 4 * tile64<DP>();
}
template <int DP>
__device__ __forceinline__ uint32_t dkdv_lds(uint32_t sk, int s) {
  return dkdv_ring<DP>(sk) + 2 * dkdv_stages<DP>() * tile64<DP>() +
         s * kLdBytes;
}

template <int DP, bool SPLIT>
__device__ __forceinline__ void dkdv_produce(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const float2* ld, uint32_t sk, uint64_t* bars,
    int BHkv, int S, int Sp, int G, int hs, int causal) {
  constexpr int KS = dkdv_stages<DP>(), kb = dkdv_keys<SPLIT>();
  constexpr uint32_t kT = tile64<DP>(), kKV = (kb / 64) * kT;
  constexpr uint32_t kBoxKV = kb * 128;
  const uint32_t sv = sk + kKV, ring = dkdv_ring<DP>(sk);
  const uint32_t kvfull = smem_u32(&bars[0]), kvempty = smem_u32(&bars[1]);
  int it = 0;  // (Q, dO) tiles issued so far: stage it % KS
  DkdvItem d;
  for (int j = 0; dkdv_item<SPLIT>(j, BHkv, S, G, hs, causal, d); ++j) {
    // the next K and V once the consumers' last reads of them are done
    if (j > 0) mbar_wait(kvempty, (j - 1) & 1);
    mbar_arrive_expect_tx(kvfull, 2 * kKV);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      tma_load_3d(sk + h * kBoxKV, tk, kvfull, 64 * h, d.k0, d.kvh);
      tma_load_3d(sv + h * kBoxKV, tv, kvfull, 64 * h, d.k0, d.kvh);
    }
    for (int i = 0; i < d.n_it; ++i, ++it) {
      const int s = it % KS;
      if (it >= KS)
        mbar_wait(smem_u32(&bars[2 + KS + s]), (it / KS - 1) & 1);
      const uint32_t qs = ring + 2 * s * kT, full = smem_u32(&bars[2 + s]);
      const int bh = d.kvh * G + i / d.per_g;
      const int q0 = (d.qt0 + i % d.per_g) * kQTile;
      mbar_arrive_expect_tx(full, 2 * kT + kLdBytes);
#pragma unroll
      for (int h = 0; h < DP / 64; ++h) {
        tma_load_3d(qs + h * kBox64, tq, full, 64 * h, q0, bh);
        tma_load_3d(qs + kT + h * kBox64, tdo, full, 64 * h, q0, bh);
      }
      bulk_load(dkdv_lds<DP>(sk, s), ld + static_cast<size_t>(bh) * Sp + q0,
                kLdBytes, full);
    }
  }
}

template <int DP, int DH, bool SPLIT>
__device__ __forceinline__ void dkdv_consume(
    uint8_t* base, uint32_t sk, uint64_t* bars,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int BHkv, int S, int dh, int G, int hs, int causal, float scale_log2,
    float scale, int wg) {
  constexpr int KS = dkdv_stages<DP>(), NV = out_width<DP, DH>();
  constexpr int kSteps = ksteps<DP, DH>(), kb = dkdv_keys<SPLIT>();
  constexpr uint32_t kT = tile64<DP>(), kKV = (kb / 64) * kT;
  constexpr uint32_t kBoxKV = kb * 128;
  const uint32_t ring = dkdv_ring<DP>(sk);
  // this warpgroup's 64 keys of the item: the item's own where SPLIT
  const uint32_t ka = sk + (SPLIT ? 0 : wg * 64 * 128), va = ka + kKV;
  const uint32_t kvfull = smem_u32(&bars[0]), kvempty = smem_u32(&bars[1]);
  float* red = reinterpret_cast<float*>(base + 2 * kT);
  const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
  const int c0 = 2 * (lane % 4);                    // its first column in 8
  const int me = kPingPong + wg, other = kPingPong + 1 - wg;
  if (wg == 1) bar_arrive(kPingPong, 256);  // warpgroup 0 issues first
  int it = 0;
  DkdvItem d;
  for (int j = 0; dkdv_item<SPLIT>(j, BHkv, S, G, hs, causal, d); ++j) {
    const int kmin = d.k0 + (SPLIT ? 0 : wg * 64);  // this warpgroup's keys
    const int kr = kmin + warp * 16 + lane / 4;      // rows kr and kr + 8
    float adk[NV / 2], adv[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) adk[i] = adv[i] = 0.f;
    mbar_wait(kvfull, j & 1);

    // SPLIT: an odd tile count has warpgroup 1's last step rerun the last
    // tile on P = dS = 0 (a branch around wgmma would make the compiler
    // serialize every wgmma of the kernel)
    const int n_steps = SPLIT ? (d.n_it + 1) / 2 : d.n_it;
    for (int step = 0; step < n_steps; ++step) {
      const int own = SPLIT ? 2 * step + wg : step;
      const bool dead = own >= d.n_it;
      const int i = dead ? d.n_it - 1 : own;
      const int s = (it + i) % KS;
      mbar_wait(smem_u32(&bars[2 + s]), ((it + i) / KS) & 1);
      const int q0 = (d.qt0 + i % d.per_g) * kQTile;
      const uint32_t qs = ring + 2 * s * kT, dos = qs + kT;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, k-steps
      // of 16 columns (32 bytes into a 128-byte swizzled row, 4 a box). A
      // warpgroup whose keys all lie above the tile's queries runs them
      // too, on P = 0 (the mask).
      float st[32], dpt[32];
      bar_sync(me, 256);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        wgmma_ss_m64n64k16(
            st, desc_sw128(ka + (k / 4) * kBoxKV + (k % 4) * 32, 16, 1024),
            desc_sw128(qs + (k / 4) * kBox64 + (k % 4) * 32, 16, 1024),
            k > 0);
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        wgmma_ss_m64n64k16(
            dpt, desc_sw128(va + (k / 4) * kBoxKV + (k % 4) * 32, 16, 1024),
            desc_sw128(dos + (k / 4) * kBox64 + (k % 4) * 32, 16, 1024),
            k > 0);
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // the item's last reads of K and V are done
      __syncwarp();
      if (step == n_steps - 1 && lane == 0) mbar_arrive(kvempty);

      // P^T = exp2(S^T log2(e) / sqrt(dh) - lse log2(e)) and
      // dS^T = P^T (dP^T - D); a column is a query, {lse2, D} per column
      // from the stage's rows in shared memory (queries past S have
      // lse2 = +inf, so P = 0 there); a rerun step selects zeros
      const bool edge = (causal && kmin + 63 > q0) || kmin + 64 > S;
      const float2* row = reinterpret_cast<const float2*>(
          base + (dkdv_lds<DP>(sk, s) - sk));
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const float4 x = *reinterpret_cast<const float4*>(row + 8 * i8 + c0);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float l2 = c ? x.z : x.x, dd = c ? x.w : x.y;
          float p0 = exp2_ftz(fmaf(st[4 * i8 + c], scale_log2, -l2));
          float p1 = exp2_ftz(fmaf(st[4 * i8 + 2 + c], scale_log2, -l2));
          if (edge) {
            const int qc = q0 + 8 * i8 + c0 + c;
            if (kr >= S || (causal && kr > qc)) p0 = 0.f;
            if (kr + 8 >= S || (causal && kr + 8 > qc)) p1 = 0.f;
          }
          const float d0 = p0 * (dpt[4 * i8 + c] - dd);
          const float d1 = p1 * (dpt[4 * i8 + 2 + c] - dd);
          st[4 * i8 + c] = dead ? 0.f : p0;
          st[4 * i8 + 2 + c] = dead ? 0.f : p1;
          dpt[4 * i8 + c] = dead ? 0.f : d0;
          dpt[4 * i8 + 2 + c] = dead ? 0.f : d1;
        }
      }
      // queries 16j..16j+15 of the accumulators are the A fragments
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[jj][r] = pack_bf16(st[8 * jj + 2 * r], st[8 * jj + 2 * r + 1]);
          da[jj][r] = pack_bf16(dpt[8 * jj + 2 * r], dpt[8 * jj + 2 * r + 1]);
        }
      }

      // dV += P^T dO, dK += dS^T Q: 4 steps of 16 queries = two 8-row
      // groups of 1024 bytes; the 64-column boxes lie kBox64 apart along N
      bar_sync(me, 256);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        fence_regs(pa[jj]);
        fence_regs(da[jj]);
      }
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wgmma_rs_tb<NV>(adv, pa[jj], desc_sw128(dos + jj * 2048, kBox64, 1024));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wgmma_rs_tb<NV>(adk, da[jj], desc_sw128(qs + jj * 2048, kBox64, 1024));
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
      __syncwarp();
      if (lane == 0) {
        if constexpr (SPLIT) {
          // both warpgroups release both tiles of the step once their own
          // reads are done: the rerun step reads the other's last tile,
          // which must stay loaded until that rerun's products are done
          mbar_arrive(smem_u32(&bars[2 + KS + (it + 2 * step) % KS]));
          if (2 * step + 1 < d.n_it)
            mbar_arrive(smem_u32(&bars[2 + KS + (it + 2 * step + 1) % KS]));
        } else {
          mbar_arrive(smem_u32(&bars[2 + KS + s]));
        }
      }
    }
    it += d.n_it;

    const size_t off = static_cast<size_t>(d.kvh) * S * (DH ? DH : dh);
    if constexpr (SPLIT) {
      // dK = warpgroup 0's sum + warpgroup 1's, dV = warpgroup 1's + 0's:
      // each hands the other one partial sum through shared memory
      // (thread t's registers at red[128 i + t]), and each stores one
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) red[128 * i + t128] = adk[i];
      }
      bar_sync(kReduce, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) adk[i] += red[128 * i + t128];
      }
      bar_sync(kReduce, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) red[128 * i + t128] = adv[i];
      }
      bar_sync(kReduce, 256);
      if (wg == 0) {
        store_rows<NV, DH>(dk + off, adk, kr, c0, S, dh, scale);
      } else {
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) adv[i] += red[128 * i + t128];
        store_rows<NV, DH>(dv + off, adv, kr, c0, S, dh, 1.f);
      }
    } else {
      store_rows<NV, DH>(dk + off, adk, kr, c0, S, dh, scale);
      store_rows<NV, DH>(dv + off, adv, kr, c0, S, dh, 1.f);
    }
  }
  // warpgroup 1's last arrival on warpgroup 0's barrier
  if (wg == 0) bar_sync(kPingPong, 256);
}

// 2. dK and dV, persistent: warpgroups 0 and 1 consume, 2 produces.
template <int DP, int DH, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_sm90_dkdv_kernel(
        __grid_constant__ const CUtensorMap tq,
        __grid_constant__ const CUtensorMap tdo,
        __grid_constant__ const CUtensorMap tk,
        __grid_constant__ const CUtensorMap tv,
        const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int BHkv, int S, int Sp, int dh,
        int G, int hs, int causal, float scale_log2, float scale) {
  constexpr int KS = dkdv_stages<DP>();
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t bars[2 + 2 * KS];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tdo);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), kConsumers * 4);
    for (int s = 0; s < KS; ++s) {
      mbar_init(smem_u32(&bars[2 + s]), 1);
      mbar_init(smem_u32(&bars[2 + KS + s]), kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128)
      dkdv_produce<DP, SPLIT>(&tq, &tdo, &tk, &tv, ld, sk, bars, BHkv, S, Sp,
                              G, hs, causal);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dkdv_consume<DP, DH, SPLIT>(smem + (sk - smem_u32(smem)), sk, bars, dk,
                                dv, BHkv, S, dh, G, hs, causal, scale_log2,
                                scale, wg);
  }
}

// ------------------------------------------------------------------ dQ ----
// Barriers: bars[0] Q/dO full, bars[1] Q/dO empty; bars[2 + s] stage s's
// (K, V) full, bars[2 + KS + s] its empty. Item -> (row-set bh, query tile
// qb), the longest causal rows first.
__device__ __forceinline__ bool dq_item(int j, int BH, int n_tiles, int hs,
                                        int& bh, int& qb) {
  int y;
  if (!block_item(j, BH, n_tiles, hs, bh, y)) return false;
  qb = n_tiles - 1 - y;
  return true;
}

template <int DP>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, uint32_t sq, uint64_t* bars, int BH, int S,
    int G, int hs, int causal) {
  constexpr int KS = dq_stages<DP>();
  constexpr uint32_t kT = tile128<DP>();
  const uint32_t sdo = sq + kT, ring = sdo + kT;
  const uint32_t qfull = smem_u32(&bars[0]), qempty = smem_u32(&bars[1]);
  const int n_tiles = (S + kKeys - 1) / kKeys;
  int it = 0;  // (K, V) tiles issued so far: stage it % KS
  int bh, qb;
  for (int j = 0; dq_item(j, BH, n_tiles, hs, bh, qb); ++j) {
    const int kvh = bh / G, n_kt = causal ? qb + 1 : n_tiles;
    if (j > 0) mbar_wait(qempty, (j - 1) & 1);
    mbar_arrive_expect_tx(qfull, 2 * kT);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      tma_load_3d(sq + h * kBox128, tq, qfull, 64 * h, qb * kQBlock, bh);
      tma_load_3d(sdo + h * kBox128, tdo, qfull, 64 * h, qb * kQBlock, bh);
    }
    for (int t = 0; t < n_kt; ++t, ++it) {
      const int s = it % KS;
      if (it >= KS)
        mbar_wait(smem_u32(&bars[2 + KS + s]), (it / KS - 1) & 1);
      const uint32_t ks = ring + 2 * s * kT, full = smem_u32(&bars[2 + s]);
      mbar_arrive_expect_tx(full, 2 * kT);
#pragma unroll
      for (int h = 0; h < DP / 64; ++h) {
        tma_load_3d(ks + h * kBox128, tk, full, 64 * h, t * kKeys, kvh);
        tma_load_3d(ks + kT + h * kBox128, tv, full, 64 * h, t * kKeys, kvh);
      }
    }
  }
}

template <int DP, int DH>
__device__ __forceinline__ void dq_consume(
    uint32_t sq, uint64_t* bars, const float2* __restrict__ ld,
    __nv_bfloat16* __restrict__ dq, int BH, int S, int Sp, int dh, int hs,
    int causal, float scale_log2, float scale, int wg) {
  constexpr int KS = dq_stages<DP>(), NV = out_width<DP, DH>();
  constexpr uint32_t kT = tile128<DP>();
  const uint32_t sdo = sq + kT, ring = sdo + kT;
  const uint32_t qfull = smem_u32(&bars[0]), qempty = smem_u32(&bars[1]);
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  const uint32_t qa = sq + wg * 64 * 128, doa = sdo + wg * 64 * 128;
  constexpr int kSteps = ksteps<DP, DH>();
  const int me = kPingPong + wg, other = kPingPong + 1 - wg;
  if (wg == 1) bar_arrive(kPingPong, 256);  // warpgroup 0 issues first
  int it = 0;
  int bh, qb;
  for (int j = 0; dq_item(j, BH, n_tiles, hs, bh, qb); ++j) {
    const int q0 = qb * kQBlock, n_kt = causal ? qb + 1 : n_tiles;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;  // rows r0, r0 + 8
    // {lse2, D} of the two rows (past S: {+inf, 0}, and never stored)
    const float2 x0 = ld[static_cast<size_t>(bh) * Sp + r0];
    const float2 x1 = ld[static_cast<size_t>(bh) * Sp + r0 + 8];
    float adq[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) adq[i] = 0.f;
    mbar_wait(qfull, j & 1);

    for (int t = 0; t < n_kt; ++t) {
      const int s = (it + t) % KS;
      mbar_wait(smem_u32(&bars[2 + s]), ((it + t) / KS) & 1);
      const uint32_t ks = ring + 2 * s * kT, vs = ks + kT;

      // S = Q K^T and dP = dO V^T: 64 x 128 fp32 per warpgroup each
      float sc[64], dp[64];
      bar_sync(me, 256);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const uint32_t off = (k / 4) * kBox128 + (k % 4) * 32;
        wgmma_ss_m64n128k16(sc, desc_sw128(qa + off, 16, 1024),
                            desc_sw128(ks + off, 16, 1024), k > 0);
      }
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const uint32_t off = (k / 4) * kBox128 + (k % 4) * 32;
        wgmma_ss_m64n128k16(dp, desc_sw128(doa + off, 16, 1024),
                            desc_sw128(vs + off, 16, 1024), k > 0);
      }
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // the item's last reads of Q and dO are done
      __syncwarp();
      if (t == n_kt - 1 && lane == 0) mbar_arrive(qempty);

      // dS = P (dP - D), P = exp2(S log2(e) / sqrt(dh) - lse2); masks on
      // the diagonal tile and the tail tile
      const int k0 = t * kKeys;
      const bool edge = (causal && t == qb) || k0 + kKeys > S;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p0 = exp2_ftz(fmaf(sc[4 * i + c], scale_log2, -x0.x));
          float p1 = exp2_ftz(fmaf(sc[4 * i + 2 + c], scale_log2, -x1.x));
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
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[jj][r] = pack_bf16(sc[8 * jj + 2 * r], sc[8 * jj + 2 * r + 1]);
      }

      // dQ += dS K: 8 steps of 16 keys; K's 64-column boxes kBox128 apart
      bar_sync(me, 256);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) fence_regs(da[jj]);
      fence_regs(adq);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        wgmma_rs_tb<NV>(adq, da[jj],
                        desc_sw128(ks + jj * 2048, kBox128, 1024));
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(adq);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&bars[2 + KS + s]));
    }
    it += n_kt;
    store_rows<NV, DH>(dq + static_cast<size_t>(bh) * S * (DH ? DH : dh),
                       adq, r0, c0, S, dh, scale);
  }
  // warpgroup 1's last arrival on warpgroup 0's barrier
  if (wg == 0) bar_sync(kPingPong, 256);
}

// 3. dQ, persistent: warpgroups 0 and 1 consume, 2 produces.
template <int DP, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_sm90_dq_kernel(
        __grid_constant__ const CUtensorMap tq,
        __grid_constant__ const CUtensorMap tdo,
        __grid_constant__ const CUtensorMap tk,
        __grid_constant__ const CUtensorMap tv,
        const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dq,
        int BH, int S, int Sp, int dh, int G, int hs, int causal,
        float scale_log2,
        float scale) {
  constexpr int KS = dq_stages<DP>();
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t bars[2 + 2 * KS];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tdo);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), kConsumers * 4);
    for (int s = 0; s < KS; ++s) {
      mbar_init(smem_u32(&bars[2 + s]), 1);
      mbar_init(smem_u32(&bars[2 + KS + s]), kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128)
      dq_produce<DP>(&tq, &tdo, &tk, &tv, sq, bars, BH, S, G, hs, causal);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consume<DP, DH>(sq, bars, ld, dq, BH, S, Sp, dh, hs, causal, scale_log2,
                       scale, wg);
  }
}

// ------------------------------------------------------------------ host ----
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The dK/dV pass in the item shape SPLIT (dkdv_consume), on a persistent
// grid, its items in sections whose G query row-sets' Q and dO fit the L2
// budget together.
template <int DP, int DH, bool SPLIT>
cudaError_t launch_dkdv(const CUtensorMap& q64, const CUtensorMap& do64,
                        const CUtensorMap& k, const CUtensorMap& v,
                        const float2* ld, void* dk, void* dv, int BHkv,
                        int S, int Sp, int dh, int G, int causal,
                        float scale_log2, float scale, int sms,
                        cudaStream_t stream) {
  auto kernel = flash_attention_bwd_sm90_dkdv_kernel<DP, DH, SPLIT>;
  const cudaError_t err = allow_smem(kernel, dkdv_smem<DP>());
  if (err != cudaSuccess) return err;
  constexpr int kb = dkdv_keys<SPLIT>();
  const int n_kt = (S + kb - 1) / kb, items = BHkv * n_kt;
  const int grid = items < sms ? items : sms;
  const int hs = heads_per_section(
      BHkv, 1, static_cast<size_t>(G) * S * dh * 4, n_kt, grid);
  kernel<<<grid, kThreads, dkdv_smem<DP>(), stream>>>(
      q64, do64, k, v, ld, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), BHkv, S, Sp, dh, G, hs, causal,
      scale_log2, scale);
  return cudaGetLastError();
}

template <int DP, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float2* ld, int BH,
                   int BHkv, int S, int dh, int causal, float scale,
                   cudaStream_t stream) {
  const int G = BH / BHkv, Sp = (S + kPad - 1) / kPad * kPad;
  const int n_tiles = (S + kKeys - 1) / kKeys, sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  // items of 128 keys that fill the card more than once keep that shape;
  // one round or less is split (dkdv_consume). On an H100 (132 SMs,
  // scripts/time_flash.py with each shape forced) split won at 128 items
  // (BH 16, G 12) and lost at 256 (qwen3-0.6b at batch 2) and above; the
  // crossover between 132 and 256 items is not measured.
  const bool split = BHkv * n_tiles <= sms;
  // encoded per call: the pointers change; the real dh is the maps' inner
  // dimension and row stride, so columns past it read as zeros
  const int kv_rows = split ? kQTile : kKeys;
  CUtensorMap q64, do64, kkv, vkv, q128, do128, k128, v128;
  if (!make_map(&q64, q, BH, S, dh, kQTile) ||
      !make_map(&do64, dout, BH, S, dh, kQTile) ||
      !make_map(&kkv, k, BHkv, S, dh, kv_rows) ||
      !make_map(&vkv, v, BHkv, S, dh, kv_rows) ||
      !make_map(&q128, q, BH, S, dh, kQBlock) ||
      !make_map(&do128, dout, BH, S, dh, kQBlock) ||
      !make_map(&k128, k, BHkv, S, dh, kKeys) ||
      !make_map(&v128, v, BHkv, S, dh, kKeys))
    return cudaErrorInvalidValue;
  auto dqk = flash_attention_bwd_sm90_dq_kernel<DP, DH>;
  cudaError_t err;
  if ((err = allow_smem(dqk, dq_smem<DP>())) != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  const size_t rows = static_cast<size_t>(BH) * Sp;
  flash_attention_bwd_sm90_delta_kernel<DP, DH><<<
      static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ld, BH, S, Sp, dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = split ? launch_dkdv<DP, DH, true>(q64, do64, kkv, vkv, ld, dk, dv,
                                          BHkv, S, Sp, dh, G, causal,
                                          scale_log2, scale, sms, stream)
              : launch_dkdv<DP, DH, false>(q64, do64, kkv, vkv, ld, dk, dv,
                                           BHkv, S, Sp, dh, G, causal,
                                           scale_log2, scale, sms, stream);
  if (err != cudaSuccess) return err;
  // the dQ pass's items in sections whose K and V (S x dh x 4 bytes a
  // key/value row-set) fit the L2 budget together
  const int q_items = BH * n_tiles, q_grid = q_items < sms ? q_items : sms;
  const int q_hs = heads_per_section(BH, G, static_cast<size_t>(S) * dh * 4,
                                     n_tiles, q_grid);
  dqk<<<q_grid, kThreads, dq_smem<DP>(), stream>>>(
      q128, do128, k128, v128, ld, static_cast<__nv_bfloat16*>(dq), BH, S,
      Sp, dh, G, q_hs, causal, scale_log2, scale);
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
      static_cast<long long>(BH) * ((S + kKeys - 1) / kKeys) > (1 << 30) ||
      !head_dim_ok(dh) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) || !aligned16(scratch) ||
      lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* ld = static_cast<float2*>(scratch);
  cudaError_t err;
  if (dh == 64)
    err = launch<64, 64>(q, k, v, o, dout, l, dq, dk, dv, ld, BH, BHkv, S,
                         dh, causal, scale, s);
  else if (dh == 128)
    err = launch<128, 128>(q, k, v, o, dout, l, dq, dk, dv, ld, BH, BHkv, S,
                           dh, causal, scale, s);
  else if (dh == 112)
    err = launch<128, 112>(q, k, v, o, dout, l, dq, dk, dv, ld, BH, BHkv, S,
                           dh, causal, scale, s);
  else
    err = launch<128, 0>(q, k, v, o, dout, l, dq, dk, dv, ld, BH, BHkv, S,
                         dh, causal, scale, s);
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
