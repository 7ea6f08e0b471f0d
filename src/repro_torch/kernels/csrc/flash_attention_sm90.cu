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
// bytes. Within a key tile the two products (Q K^T, P V) are ~2,048 SM
// clocks of tensor-core work for two warpgroups against ~1,024 of exp2 on
// the CUDA cores, so the design keeps the tensor cores fed while the
// softmax runs. Warp-specialised, one persistent block of three
// warpgroups (384 threads) on each SM:
// * A producer warpgroup gives back registers (setmaxnreg to 24) and one
//   of its threads issues every TMA load: a work item's Q (128 rows, once)
//   and its K and V tiles of 128 keys through a ring of n_stages<DP>()
//   stages sized from the shared memory (3 at a tile width of 128: Q 32 KB
//   + 3 x 64 KB = 230,400 B of the 232,448 a block may use; 6 at 64). Each
//   stage has a "full" and an "empty" mbarrier for K and a pair for V:
//   K is released after its Q K^T and V after its P V, a step later, so a
//   stage's K is loaded again a step before its V. Q has a full and an
//   empty one. Only the producer waits on empty barriers; the consumers
//   wait on full ones and arrive on empty ones (one arrival a warp).
// * Two consumer warpgroups (setmaxnreg to 240: 128 x 24 + 256 x 240 =
//   64,512 of the SM's 65,536 registers) own 64 query rows each. Inside a
//   warpgroup the products overlap the softmax: at key tile t it issues
//   S_t = Q K_t^T and O += P_{t-1} V_{t-1} back to back, waits for S_t
//   alone (wgmma.wait_group 1), runs tile t's softmax on the CUDA cores
//   while P_{t-1} V_{t-1} is on the tensor cores, then waits for that and
//   rescales O. The first tile's Q K^T and the last tile's P V run alone,
//   outside the loop: every wgmma is issued on a straight path, so the
//   compiler keeps them asynchronous (a wgmma under a condition it cannot
//   prove uniform makes it serialize every wgmma of the kernel). Across
//   the two warpgroups the issues ping-pong on two named barriers (bar.sync
//   id, 256): one warpgroup issues its products while the other runs its
//   softmax. The running max, the sum and the rescale are applied in the
//   order of the plain online softmax; the max is taken over the raw
//   scores and the scale folded into exp2's argument by an fma, so a row
//   may differ from the tile-at-a-time loop's in its last bits.
// * The grid is persistent: one block an SM (the device's count). Items
//   (row-set, 128-row query tile) are walked in sections of row-sets whose
//   K and V fit an L2 budget together (at least two rounds of the grid),
//   in each the longest causal rows first, each section dealt to the
//   blocks in snake order on its own (sm90.cuh block_item,
//   heads_per_section): the blocks' sums of key tiles are even and the
//   blocks running at once share their K and V in L2. Each item is
//   computed whole by one block, so the order changes no result. The consumers release Q after an item's last Q K^T, and the
//   producer loads the next item's Q while they finish the item's last P V
//   and its epilogue.
// * The tile width DP (64 or 128) and the head dim DH (64, 112, 128, or 0
//   for one given at run time) are template arguments. A dh between 72 and
//   128 runs at DP = 128 on zero columns: the tensor maps have the real dh
//   as their inner dimension and row stride, so TMA fills the columns from
//   dh to 128 of the second box with zeros. At dh 112 Q K^T runs only the
//   7 k-steps of 16 columns that reach below dh, and P V runs by wgmma
//   m64n112k16: the N-major swizzled V is read as two 64-column atoms kBox
//   apart, the second one in part, so no zero column is multiplied and O
//   is 56 registers a thread. At a run-time dh all 8 k-steps run (a
//   run-time bound would put wgmma under a condition). At dh 64 and 128
//   the stores test no column; at a run-time dh they stop at dh.
// * Loads by TMA (cp.async.bulk.tensor) with 128-byte swizzle, boxes of
//   128 rows x 64 columns from 3-D [rows-sets, S, dh] tensor maps, so rows
//   past S of a row-set arrive as zeros and never as the next row-set's.
// * S = Q K^T by wgmma m64n128k16 with both operands K-major in shared
//   memory; P V by wgmma m64n{NV}k16 with P in registers (the fp32 score
//   accumulator, exponentiated and packed to bf16 pairs in place, is the
//   A-register fragment) and V read N-major with imm-trans-b = 1. The
//   64 x NV fp32 output stays in registers for the whole key loop.
// * Softmax in the exp2 domain (scores scaled by log2(e) / sqrt(dh)); row
//   max over the 4 lanes that share a row; masks only on the diagonal tile
//   and the tail tile.
// * Optionally the log-sum-exp of each query row, for the backward kernel
//   (flash_attention_bwd_sm90.cu): lse [BH, S] fp32, in natural-log units
//   of the scores q k^T / sqrt(dh) (the kernel's log2-domain max and sum
//   times ln 2), so that P = exp(q k^T / sqrt(dh) - lse). Serving passes
//   no lse and stores nothing more.
// Registers a thread (ptxas -v): 168 at entry (384 threads, one block an
// SM), then the producer 24 and each consumer 240 by setmaxnreg; no
// spills. The output goes from registers straight to global memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;              // query rows an item, keys a tile
constexpr int kConsumers = 2;           // warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kPingPong = 1;            // named barriers 1 and 2
constexpr uint32_t kBox = kRows * 128;  // a 128-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One [128, DP] bf16 tile: DP / 64 boxes, each 128 rows of 128 bytes.
template <int DP>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (DP / 64) * kBox;
}

// As many (K, V) stages as fit beside Q, 1 KB of alignment slack and the
// barriers.
template <int DP>
__host__ __device__ constexpr int n_stages() {
  return static_cast<int>((kSmemPerBlock - 1024 - 256 - tile_bytes<DP>()) /
                          (2 * tile_bytes<DP>()));
}

// Q, then n_stages (K, V) pairs, plus slack to align the base to 1024 bytes.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (1 + 2 * n_stages<DP>()) *
                    static_cast<size_t>(tile_bytes<DP>());
}

// P V's width: dh at 112, else the tile width.
template <int DP, int DH>
__host__ __device__ constexpr int pv_width() {
  return DH == 112 ? 112 : DP;
}

template <int NV>
__device__ __forceinline__ void wgmma_pv(float (&o)[NV / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NV == 128)
    wgmma_rs_m64n128k16_tb(o, a, db);
  else if constexpr (NV == 112)
    wgmma_rs_m64n112k16_tb(o, a, db);
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

// The block's j-th item (row-set bh, query tile qb), the longest causal
// rows of a section first; false past its last.
__device__ __forceinline__ bool next_item(int j, int BH, int n_tiles, int hs,
                                          int& bh, int& qb) {
  int y;
  if (!block_item(j, BH, n_tiles, hs, bh, y)) return false;
  qb = n_tiles - 1 - y;
  return true;
}

// Tile t's scores, in place: keys past S and above the diagonal masked
// (on the edge tiles only), then exponentiated in the log2 domain against
// the rows' new running max (m0, m1, scores times log2(e) / sqrt(dh)),
// which also scales the rows' earlier sums (l0, l1); returns in (al0, al1)
// the factors by which the rows' earlier output must shrink. The max is
// taken over the raw scores (the scale is positive, so it picks the same
// score) and the scale is folded into exp2's argument by one fma.
__device__ __forceinline__ void online_softmax(float (&sc)[64], bool edge,
                                               int k0, int r0, int c0,
                                               int S, int causal,
                                               float scale_log2, float& m0,
                                               float& m1, float& l0,
                                               float& l1, float& al0,
                                               float& al1) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + 8 * i + c0 + c;
        if (kj >= S || (causal && kj > r0)) sc[4 * i + c] = -INFINITY;
        if (kj >= S || (causal && kj > r0 + 8)) sc[4 * i + 2 + c] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
  mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);
  // a row with no live key yet keeps -inf: subtract 0 so exp2 gives 0
  const float b0 = mx0 == -INFINITY ? 0.f : mx0;
  const float b1 = mx1 == -INFINITY ? 0.f : mx1;
  al0 = exp2f(m0 - b0);
  al1 = exp2f(m1 - b1);
  m0 = mx0;
  m1 = mx1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sc[4 * i + c] = exp2_ftz(fmaf(sc[4 * i + c], scale_log2, -b0));
      sc[4 * i + 2 + c] = exp2_ftz(fmaf(sc[4 * i + 2 + c], scale_log2, -b1));
      s0 += sc[4 * i + c];
      s1 += sc[4 * i + 2 + c];
    }
  }
  l0 = l0 * al0 + s0;
  l1 = l1 * al1 + s1;
}

// S = Q K^T for 64 query rows at shared address qa against the key tile at
// ks: 64 x 128 fp32, both operands K-major, a k-step of 16 columns 32
// bytes into a 128-byte swizzled row (4 to a box). Only the k-steps that
// reach below dh run where DH is known (7 of 8 at 112); at a run-time dh
// all DP / 16 do (the zero columns add nothing).
template <int DP, int DH>
__device__ __forceinline__ void qk_product(float (&sc)[64], uint32_t qa,
                                           uint32_t ks) {
  constexpr int kSteps = DH ? (DH + 15) / 16 : DP / 16;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const uint32_t off = (i / 4) * kBox + (i % 4) * 32;
    wgmma_ss_m64n128k16(sc, desc_sw128(qa + off, 16, 1024),
                        desc_sw128(ks + off, 16, 1024), i > 0);
  }
}

// O += P V for the value tile at vs: 8 steps of 16 keys = two 8-key groups
// of 1024 bytes; V's 64-column boxes lie kBox apart along N.
template <int NV>
__device__ __forceinline__ void pv_product(float (&acc)[NV / 2],
                                           const uint32_t (&pa)[8][4],
                                           uint32_t vs) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    wgmma_pv<NV>(acc, pa[i], desc_sw128(vs + i * 2048, kBox, 1024));
}

// P in bf16: keys 16i..16i+15 of the score accumulator are the A fragment
// of the product over them.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[i][r] = pack_bf16(sc[8 * i + 2 * r], sc[8 * i + 2 * r + 1]);
  }
}

// The producer: one thread issues every TMA load of the block's items.
// Barriers: bars[0] Q full, bars[1] Q empty; bars[2 + s] stage s's K full,
// bars[2 + KS + s] its V full, bars[2 + 2 KS + s] its K empty,
// bars[2 + 3 KS + s] its V empty. K and V are released apart (K after its
// Q K^T, V after its P V, one tile later), so a stage's K is loaded again
// about a tile earlier than its V.
template <int DP>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sq,
                                        uint64_t* bars, int BH, int n_tiles,
                                        int hs, int G, int causal) {
  constexpr int KS = n_stages<DP>();
  constexpr uint32_t kTile = tile_bytes<DP>();
  const uint32_t qfull = smem_u32(&bars[0]), qempty = smem_u32(&bars[1]);
  int it = 0;  // key tiles issued so far: stage it % KS, round it / KS
  int bh, qb;
  for (int j = 0; next_item(j, BH, n_tiles, hs, bh, qb); ++j) {
    const int kvh = bh / G, n_kt = causal ? qb + 1 : n_tiles;
    // the next Q once the consumers' last Q K^T of the item before is done
    if (j > 0) mbar_wait(qempty, (j - 1) & 1);
    mbar_arrive_expect_tx(qfull, kTile);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h)
      tma_load_3d(sq + h * kBox, tq, qfull, 64 * h, qb * kRows, bh);
    for (int t = 0; t < n_kt; ++t, ++it) {
      const int s = it % KS;
      const uint32_t ks = sq + (1 + 2 * s) * kTile, vs = ks + kTile;
      const uint32_t kf = smem_u32(&bars[2 + s]);
      const uint32_t vf = smem_u32(&bars[2 + KS + s]);
      if (it >= KS)
        mbar_wait(smem_u32(&bars[2 + 2 * KS + s]), (it / KS - 1) & 1);
      mbar_arrive_expect_tx(kf, kTile);
#pragma unroll
      for (int h = 0; h < DP / 64; ++h)
        tma_load_3d(ks + h * kBox, tk, kf, 64 * h, t * kRows, kvh);
      if (it >= KS)
        mbar_wait(smem_u32(&bars[2 + 3 * KS + s]), (it / KS - 1) & 1);
      mbar_arrive_expect_tx(vf, kTile);
#pragma unroll
      for (int h = 0; h < DP / 64; ++h)
        tma_load_3d(vs + h * kBox, tv, vf, 64 * h, t * kRows, kvh);
    }
  }
}

// Consumer warpgroup wg (0 or 1): 64 query rows of each of the block's
// items, at tile width DP for head dim DH (0: dh at run time).
template <int DP, int DH>
__device__ __forceinline__ void consume(uint32_t sq, uint64_t* bars,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int BH,
                                        int n_tiles, int hs, int S, int dh,
                                        int causal, float scale_log2,
                                        int wg) {
  constexpr int KS = n_stages<DP>(), NV = pv_width<DP, DH>();
  constexpr uint32_t kTile = tile_bytes<DP>();
  const uint32_t qfull = smem_u32(&bars[0]), qempty = smem_u32(&bars[1]);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);           // its first column in each 8
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's 64 Q rows
  const int me = kPingPong + wg, other = kPingPong + 1 - wg;
  if (wg == 1) bar_arrive(kPingPong, 256);  // warpgroup 0 issues first
  int it = 0;
  int bh, qb;
  for (int j = 0; next_item(j, BH, n_tiles, hs, bh, qb); ++j) {
    const int q0 = qb * kRows, n_kt = causal ? qb + 1 : n_tiles;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;  // rows r0, r0 + 8

    float acc[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
    // this thread's rows: running max (log2 domain) and its share of the
    // running sum (the 4 lanes of a row are summed at the end)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    uint32_t pa[8][4];  // P of the tile before, as A fragments
    mbar_wait(qfull, j & 1);

    // tile 0: S_0 = Q K_0^T alone, then its softmax
    const int s0 = it % KS;
    mbar_wait(smem_u32(&bars[2 + s0]), (it / KS) & 1);
    float sc[64];
    bar_sync(me, 256);
    fence_regs(sc);
    wgmma_fence();
    qk_product<DP, DH>(sc, qa, sq + (1 + 2 * s0) * kTile);
    wgmma_commit();
    bar_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    // the item's last Q K^T is done: the producer may load the next Q
    if (lane == 0) {
      mbar_arrive(smem_u32(&bars[2 + 2 * KS + s0]));
      if (n_kt == 1) mbar_arrive(qempty);
    }
    float al0, al1;  // acc is still zero: nothing to rescale
    online_softmax(sc, (causal && qb == 0) || kRows > S, 0, r0, c0, S,
                   causal, scale_log2, m0, m1, l0, l1, al0, al1);
    pack_p(pa, sc);

    // tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} issued back to back;
    // tile t's softmax runs while the second is on the tensor cores
    for (int t = 1; t < n_kt; ++t) {
      const int s = (it + t) % KS, sp = (it + t - 1) % KS;
      mbar_wait(smem_u32(&bars[2 + s]), ((it + t) / KS) & 1);
      mbar_wait(smem_u32(&bars[2 + KS + sp]), ((it + t - 1) / KS) & 1);
      bar_sync(me, 256);
      fence_regs(sc);
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_regs(pa[i]);
      wgmma_fence();
      qk_product<DP, DH>(sc, qa, sq + (1 + 2 * s) * kTile);
      wgmma_commit();
      pv_product<NV>(acc, pa, sq + (2 + 2 * sp) * kTile);
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(smem_u32(&bars[2 + 2 * KS + s]));
        if (t == n_kt - 1) mbar_arrive(qempty);
      }
      const int k0 = t * kRows;
      online_softmax(sc, (causal && t == qb) || k0 + kRows > S, k0, r0, c0,
                     S, causal, scale_log2, m0, m1, l0, l1, al0, al1);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_regs(pa[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&bars[2 + 3 * KS + sp]));
#pragma unroll
      for (int i = 0; i < NV / 8; ++i) {
        acc[4 * i] *= al0;
        acc[4 * i + 1] *= al0;
        acc[4 * i + 2] *= al1;
        acc[4 * i + 3] *= al1;
      }
      pack_p(pa, sc);
    }

    // the last tile's O += P V
    const int sl = (it + n_kt - 1) % KS;
    mbar_wait(smem_u32(&bars[2 + KS + sl]), ((it + n_kt - 1) / KS) & 1);
    bar_sync(me, 256);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) fence_regs(pa[i]);
    wgmma_fence();
    pv_product<NV>(acc, pa, sq + (2 + 2 * sl) * kTile);
    wgmma_commit();
    bar_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[2 + 3 * KS + sl]));
    it += n_kt;

    const float sum0 = fmaxf(quad_sum(l0), 1e-20f);
    const float sum1 = fmaxf(quad_sum(l1), 1e-20f);
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    if (lse != nullptr && lane % 4 == 0) {
      // natural log-sum-exp of the row's scaled scores (m is log2-domain)
      float* row = lse + static_cast<size_t>(bh) * S;
      if (r0 < S) row[r0] = (m0 + log2f(sum0)) * kLn2;
      if (r0 + 8 < S) row[r0 + 8] = (m1 + log2f(sum1)) * kLn2;
    }
    // rows of dh columns; at a run-time dh the columns from dh to DP are
    // zero and not stored (dh is a multiple of 8, so a pair at col < dh
    // ends below dh)
    const int ld = DH ? DH : dh;
    __nv_bfloat16* out = o + static_cast<size_t>(bh) * S * ld;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = 8 * i + c0;
      if (DH == 0 && col >= dh) continue;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(r0) * ld + col) =
            __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (r0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(r0 + 8) * ld + col) =
            __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                  acc[4 * i + 3] * inv1);
    }
  }
  // warpgroup 1's last arrival on warpgroup 0's barrier
  if (wg == 0) bar_sync(kPingPong, 256);
}

// The persistent kernel: warpgroups 0 and 1 consume, 2 produces.
template <int DP, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                                __grid_constant__ const CUtensorMap tk,
                                __grid_constant__ const CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int BH, int S,
                                int dh, int G, int hs, int causal,
                                float scale_log2) {
  constexpr int KS = n_stages<DP>();
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t bars[2 + 4 * KS];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (S + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), kConsumers * 4);
    for (int s = 0; s < KS; ++s) {
      mbar_init(smem_u32(&bars[2 + s]), 1);
      mbar_init(smem_u32(&bars[2 + KS + s]), 1);
      mbar_init(smem_u32(&bars[2 + 2 * KS + s]), kConsumers * 4);
      mbar_init(smem_u32(&bars[2 + 3 * KS + s]), kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128)
      produce<DP>(&tq, &tk, &tv, sq, bars, BH, n_tiles, hs, G, causal);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<DP, DH>(sq, bars, o, lse, BH, n_tiles, hs, S, dh, causal,
                    scale_log2, wg);
  }
}

// ------------------------------------------------------------------ host ----
template <int DP, int DH>
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
  auto kernel = flash_attention_sm90_kernel<DP, DH>;
  const size_t smem = smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int items = BH * ((S + kRows - 1) / kRows), sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  // sections of row-sets whose K and V (S x dh x 4 bytes a KV row-set)
  // fit the L2 budget together
  const int G = BH / BHkv;
  const int grid = items < sms ? items : sms;
  const int hs = heads_per_section(BH, G, static_cast<size_t>(S) * dh * 4,
                                   (S + kRows - 1) / kRows, grid);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, BH, S, dh, G, hs,
      causal, scale * kLog2e);
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
      static_cast<long long>(BH) * ((S + kRows - 1) / kRows) > (1 << 30) ||
      !head_dim_ok(dh) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dh == 64)
    err = launch<64, 64>(q, k, v, o, l, BH, BHkv, S, dh, causal, scale, s);
  else if (dh == 128)
    err = launch<128, 128>(q, k, v, o, l, BH, BHkv, S, dh, causal, scale, s);
  else if (dh == 112)
    err = launch<128, 112>(q, k, v, o, l, BH, BHkv, S, dh, causal, scale, s);
  else
    err = launch<128, 0>(q, k, v, o, l, BH, BHkv, S, dh, causal, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory a block of the kernel for head dim dh takes.
int flash_attention_sm90_smem_bytes(int dh) {
  return static_cast<int>(tile_width(dh) == 128 ? smem_bytes<128>()
                                                : smem_bytes<64>());
}

}  // extern "C"
