// flash_attention_bwd.cu: the gradient of flash_attention.cu's attention,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The TPU kernel it pairs with,
// src/repro/kernels/flash_attention.py:77 flash_attention, has no backward
// (the reference trains through XLA's gradient of the jnp attention,
// src/repro/models/layers.py:112 _attend_block); this kernel is the port's
// own, so that a loss taken through the hand-written forward gets its
// gradient from the card.
//
// For q [BH, Sq, HD], k, v [BH / group, Skv, HD], the forward's output
// out [BH, Sq, HD] and its log-sum-exp lse [BH, Sq] (fp32, natural log of
// the row's sum of exp(scale * q.k) over the keys it sees; -inf for a row
// that sees none), and the output's gradient do [BH, Sq, HD], it writes
//   D_i   = sum_d do[i, d] * out[i, d]
//   P_ij  = exp(scale * q_i.k_j - lse_i)             (0 where j is unseen)
//   dS_ij = P_ij * (do_i.v_j - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_(heads of j's group) sum_i dS_ij q_i
//   dv_j  =         sum_(heads of j's group) sum_i P_ij do_i
// with scale = 1 / sqrt(HD) and key j seen by query i when j <= i (if
// causal) and i - j < window (if window > 0), the forward's mask: the
// FlashAttention-2 backward.  A window bounds the work as it bounds the
// forward's: a key block's query rows end at its last key + window - 1, a
// row block's keys start at its first row - window + 1, and only the tiles
// that cross the causal diagonal or the window's edge apply the element
// mask.  Types: fp32 or bf16 (one type); dq, dk and dv come out
// in it, every sum in fp32, rounded once.  No atomics anywhere: one CTA owns
// each output tile and sums in a fixed order, so a second launch equals the
// first bit for bit.
//
// Bound: operations.  Five products of 2 * HD operations for every (query,
// key) pair the mask leaves (S, dP = do v^T, dV, dK, dQ) against the
// forward's two: at deepseek-7b's shape (q [128, 4064, 128] bf16, causal)
// 1.057 G pairs, 1.353 TFLOP, 1.368 ms at the bf16 tensor-core rate; at a
// musicgen-medium microbatch layer (q [48, 2048, 64]) 100.7 M pairs, 64.4
// GFLOP, 0.065 ms.
//
// Two bodies, chosen by type in the wrapper (its BODY table), which passes
// the choice to flash_attention_bwd_launch:
//
// bf16: the tensor cores.  Three launches at HD 32, 64 and 128, four at
// HD 256:
//  1. flash_bwd_rows_kernel: D and lse2 = lse * log2(e) (+inf where lse is
//     -inf, so P = 0), one warp a row, into fp32 [BH, sq_pad] with Sq padded
//     to 128 rows (padding: lse2 = +inf, D = 0), so that the kernels below
//     read whole 64-row runs by bulk copy and never mask a ragged Sq.
//  2. flash_bwd_dkdv_wgmma_kernel (HD <= 128): one CTA of three warpgroups a
//     (KV head, block of 128 keys); key block 0 sees the most rows under a
//     causal mask, so the blocks start in their own order, heaviest first.
//     Warpgroup 0 is the producer: one thread loads the block's k and v
//     once by TMA, then for each query head of the group in head order and
//     each 64-row query tile that sees the block (from tile k0 / 64 on when
//     causal) the q and do tiles (TMA) and their lse2 and D rows (a bulk
//     copy each) into a ring of 3 stages, each guarded by a "full" and an
//     "empty" mbarrier.  Warpgroups 1 and 2 each own 64 of the keys and run
//     every product on wgmma with fp32 accumulators in registers:
//       S^T  = K Q^T, dP^T = V dO^T   m64n64k16, A and B K-major (smem);
//       P^T  = exp2(S^T * scale * log2(e) - lse2), dS^T = P^T (dP^T - D),
//              in registers, lse2 and D per column from the stage's rows;
//       dV  += P^T dO, dK += dS^T Q   m64nHDk16, A in registers, B (do, q)
//              MN-major in shared memory.
//     A KV head's dK and dV sum its group in the same accumulators, in
//     head order.  A consumer skips a tile whose rows all lie before its
//     first key; only tiles on the causal diagonal apply the element mask
//     (rows past Sq have P = 0 from their lse2, keys past Skv read as
//     zeros and their rows are dropped at the store).
//  2'. flash_bwd_dkdv_split_wgmma_kernel (HD 256): there dK and dV of 64
//     keys are 2 x 128 fp32 registers a thread, over the 255 a thread may
//     have, and k and v of 128 keys beside a ring of q and do fill more
//     than the 227 KB a block may take.  So a CTA owns 64 keys, and its two
//     consumer warpgroups split the accumulators, not the keys: warpgroup
//     1 owns dV and forms S^T (SS) and P^T, hands P^T to warpgroup 2 through
//     shared memory (fp32, two buffers, each behind a named barrier pair
//     "ready" and "free"), and adds dV += P^T dO (RS, m64n256k16);
//     warpgroup 2 owns dK, forms dP^T = V dO^T (SS), reads P^T, forms
//     dS^T and adds dK += dS^T Q (RS).  Each issues 3 of the 6 products a
//     pair (one SS and the two bf16 terms of one RS) and holds 128
//     accumulators, 32 scores and 32 fragment registers (about 200 of
//     its 240).  One KV head gives Skv / 64 CTAs (64 at recurrentgemma-2b's
//     4,096 keys, on 132 SMs), so the group's query heads split into the
//     fewest parts (a divisor of the group, passed by the wrapper, a
//     function of the shape only) that launch at least 256 CTAs: at group
//     10, five splits of two heads, 320 CTAs (the window leaves the last
//     key blocks lighter, so two CTAs an SM balance better than one).  A
//     split's CTA sums its heads in head order and writes its dK and dV as
//     fp32 partials [splits, KV heads, Skv, 256] from its registers (keys
//     past Skv dropped); then
//  2''. flash_bwd_dkdv_sum_kernel adds each element's partials in split
//     order, scales dK, and rounds each once to bf16.
//  3. flash_bwd_dq_wgmma_kernel: one CTA a (query head, block of 128 rows),
//     the heaviest (last) blocks first; the producer loads q and do once and
//     streams 64-key k and v tiles from key 0 to the last key the block's
//     last row sees, each in a ring of its own (3 stages of each at HD <=
//     128; at HD 256, 2 of k and 1 of v: a consumer releases v once dP has
//     read it, so the next v loads while dS and dQ run); each consumer owns
//     64 rows:
//       S = Q K^T, dP = dO V^T (SS), P and dS in registers, dQ += dS K (RS,
//       k MN-major).
//     It recomputes S and dP (7 products in all against the function's 5)
//     and so needs no atomics; the mask runs on the causal diagonal and the
//     last tile, where keys past Skv read as zeros.
//   Tiles are bf16, 64 (HD 32: 32) columns a box, 128-byte (64-byte) rows
//   swizzled by TMA as wgmma reads them.  Shared memory a CTA (dK/dV, dQ):
//   231,464 and 230,456 bytes at HD 256 (k and v 64 KB, a 2-stage ring of
//   q and do 128 KB, their rows 1 KB and two P^T buffers 32 KB; q and do of
//   128 rows 128 KB, the k and v rings 96 KB); 166,456 and 164,968 at HD
//   128; 84,536 and 83,048 at HD 64; 43,576 and 42,088 at HD 32; one CTA an
//   SM.  setmaxnreg moves registers from the producer (24) to the consumers
//   (240): at HD 128 a dK/dV consumer holds dK and dV (64 + 64 fp32), S^T
//   and dP^T (32 + 32) and the A fragments; a dQ consumer at HD 256 holds
//   dQ (128), S and dP (32 + 32).  Rounding: products of bf16 values are
//   exact in fp32 and every sum is fp32; P and dS enter their products as
//   two bf16 terms, hi = bf16(x) and lo = bf16(x - hi) (about 2^-17 of x;
//   one bf16 term alone errs by up to 2^-9 of each weight, which parts from
//   the fp32 plain version by more than its bf16 tolerance at the main
//   shapes), so the RS products run twice: 10 products a pair are issued
//   against the bound's 5.  dK * scale, dV and dQ * scale are rounded once
//   to bf16, in the epilogue (TMA store) or in the partial sum.
//
// fp32: the CUDA cores, fp32 in shared memory.  Three kernels, no atomics:
//  1. flash_bwd_delta_kernel: D, one warp a row.
//  2. flash_bwd_dkdv_kernel: one CTA of 256 threads a (KV head, block of 64
//     keys).  k and v stay in shared memory; the CTA loops over the group's
//     query heads and, for each, over the query blocks that see the key
//     block (all of them, or from the block's first key on when causal),
//     staging q, do, lse and D, recomputing S and dP (thread (r, c) of a
//     16 x 16 grid owns rows r + 16 i and keys c + 16 j), forming P and dS
//     into shared memory, and accumulating dV += P^T do and dK += dS^T q
//     in registers (thread (r, c) owns keys r + 16 a over HD / 16 columns).
//     A KV head's gradient thus sums its group in fp32, in head order.
//  3. flash_bwd_dq_kernel: one CTA a (query head, block of query rows),
//     looping over the key blocks the block sees; it recomputes S and dP
//     the same way and accumulates dQ += dS k.
// Query blocks are 64 rows (32 at HD 256, so that shared memory holds
// k, v, q, do, P and dS: 216,320 bytes at HD 256, 168,448 at HD 128);
// rows are padded to HD + 4 floats as in flash_attention.cu's fp32 body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kBlockK = 64;
constexpr int kKeysPerThread = kBlockK / 16;  // 4
constexpr int kLdP = kBlockK + 1;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <int HD>
struct Geo {
  static constexpr int LD = HD + 4;                    // padded row
  static constexpr int BQ = HD == 256 ? 32 : 64;       // query rows a block
  static constexpr int RQ = BQ / 16;                   // rows a thread
  static constexpr int VEC = HD / 16 < 4 ? HD / 16 : 4;
  static constexpr int NV = HD / (16 * VEC);           // column groups
  // k, v, q, do, then P and dS [BQ][kLdP], then lse and D [BQ]
  static constexpr size_t DKDV_SMEM =
      sizeof(float) * ((2 * kBlockK + 2 * BQ) * LD + 2 * BQ * kLdP + 2 * BQ);
  // q, do, k, v, then dS [BQ][kLdP], then lse and D [BQ]
  static constexpr size_t DQ_SMEM =
      sizeof(float) * ((2 * kBlockK + 2 * BQ) * LD + BQ * kLdP + 2 * BQ);
};

// rows [row0, row0 + n) of a [len, HD] matrix into shared memory as fp32,
// rows past `len` as zeros
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int64_t row0, int n, int64_t len) {
  constexpr int LD = Geo<HD>::LD;
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    const int64_t row = row0 + r;
    dst[r * LD + c] = row < len ? src[row * HD + c] : 0.f;
  }
}

// lse and D of rows [row0, row0 + n); rows past `len` get lse = -inf (so
// P = 0) and D = 0
__device__ __forceinline__ void stage_rows(float* s_lse, float* s_d,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int64_t row0, int n, int64_t len) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int64_t row = row0 + r;
    s_lse[r] = row < len ? lse[row] : -INFINITY;
    s_d[r] = row < len ? delta[row] : 0.f;
  }
}

// S = q k^T and dP = do v^T for rows tr + 16 i, keys tc + 16 j, then
// P = exp(scale S - lse) and dS = P (dP - D) into shared memory
template <int HD>
__device__ __forceinline__ void scores(const float* s_q, const float* s_do,
                                       const float* s_k, const float* s_v,
                                       const float* s_lse, const float* s_d,
                                       float* s_p, float* s_ds, int64_t q0,
                                       int64_t k0, int64_t skv, int causal,
                                       int64_t window, float scale) {
  using G = Geo<HD>;
  constexpr int LD = G::LD;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  float s[G::RQ][kKeysPerThread], dp[G::RQ][kKeysPerThread];
#pragma unroll
  for (int i = 0; i < G::RQ; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qa[G::RQ], da[G::RQ], kb[kKeysPerThread], vb[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < G::RQ; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(&s_q[(tr + 16 * i) * LD + d]);
      da[i] = *reinterpret_cast<const float4*>(&s_do[(tr + 16 * i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      kb[j] = *reinterpret_cast<const float4*>(&s_k[(tc + 16 * j) * LD + d]);
      vb[j] = *reinterpret_cast<const float4*>(&s_v[(tc + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < G::RQ; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        dp[i][j] = fmaf(da[i].x, vb[j].x, dp[i][j]);
        dp[i][j] = fmaf(da[i].y, vb[j].y, dp[i][j]);
        dp[i][j] = fmaf(da[i].z, vb[j].z, dp[i][j]);
        dp[i][j] = fmaf(da[i].w, vb[j].w, dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < G::RQ; ++i) {
    const int r = tr + 16 * i;
    const int64_t row = q0 + r;
    const float l = s_lse[r];
    const float dd = s_d[r];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int c = tc + 16 * j;
      const int64_t key = k0 + c;
      const bool seen = key < skv && (!causal || key <= row) &&
                        (window <= 0 || row - key < window) && l != -INFINITY;
      const float p = seen ? expf(s[i][j] * scale - l) : 0.f;
      s_p[r * kLdP + c] = p;
      s_ds[r * kLdP + c] = p * (dp[i][j] - dd);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ out,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(out[row * HD + d], dout[row * HD + d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int64_t sq, int64_t skv,
                      int group, int causal, int64_t window, float scale) {
  using G = Geo<HD>;
  constexpr int LD = G::LD;
  constexpr int BQ = G::BQ;
  constexpr int VEC = G::VEC;
  constexpr int NV = G::NV;
  extern __shared__ float smem[];
  float* s_k = smem;                      // [kBlockK][LD]
  float* s_v = s_k + kBlockK * LD;        // [kBlockK][LD]
  float* s_q = s_v + kBlockK * LD;        // [BQ][LD]
  float* s_do = s_q + BQ * LD;            // [BQ][LD]
  float* s_p = s_do + BQ * LD;            // [BQ][kLdP]
  float* s_ds = s_p + BQ * kLdP;          // [BQ][kLdP]
  float* s_lse = s_ds + BQ * kLdP;        // [BQ]
  float* s_d = s_lse + BQ;                // [BQ]

  const int64_t g = blockIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kBlockK;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  stage<HD>(s_k, k + g * skv * HD, k0, kBlockK, skv);
  stage<HD>(s_v, v + g * skv * HD, k0, kBlockK, skv);

  float ak[kKeysPerThread][NV][VEC], av[kKeysPerThread][NV][VEC];
#pragma unroll
  for (int a = 0; a < kKeysPerThread; ++a)
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ak[a][c][e] = 0.f;
        av[a][c][e] = 0.f;
      }

  // query rows that see some key of the block: from the block's first key
  // on when causal, up to its last key + window - 1 when windowed
  const int64_t qb0 = causal ? k0 / BQ : 0;
  int64_t nqb = (sq + BQ - 1) / BQ;
  if (window > 0) nqb = min64(nqb, (k0 + kBlockK + window - 2) / BQ + 1);
  for (int t = 0; t < group; ++t) {
    const int64_t bh = g * group + t;
    const float* qh = q + bh * sq * HD;
    const float* doh = dout + bh * sq * HD;
    for (int64_t qb = qb0; qb < nqb; ++qb) {
      const int64_t q0 = qb * BQ;
      __syncthreads();  // the previous block's products have read smem
      stage<HD>(s_q, qh, q0, BQ, sq);
      stage<HD>(s_do, doh, q0, BQ, sq);
      stage_rows(s_lse, s_d, lse + bh * sq, delta + bh * sq, q0, BQ, sq);
      __syncthreads();
      scores<HD>(s_q, s_do, s_k, s_v, s_lse, s_d, s_p, s_ds, q0, k0, skv,
                 causal, window, scale);
      __syncthreads();
      // dV += P^T do, dK += dS^T q over the block's rows
      for (int i = 0; i < BQ; ++i) {
        float p[kKeysPerThread], ds[kKeysPerThread];
#pragma unroll
        for (int a = 0; a < kKeysPerThread; ++a) {
          p[a] = s_p[i * kLdP + tr + 16 * a];
          ds[a] = s_ds[i * kLdP + tr + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int col = VEC * tc + 16 * VEC * c;
          float dov[VEC], qv[VEC];
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(&s_do[i * LD + col]);
            const float4 y = *reinterpret_cast<const float4*>(&s_q[i * LD + col]);
            dov[0] = x.x; dov[1] = x.y; dov[2] = x.z; dov[3] = x.w;
            qv[0] = y.x; qv[1] = y.y; qv[2] = y.z; qv[3] = y.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(&s_do[i * LD + col]);
            const float2 y = *reinterpret_cast<const float2*>(&s_q[i * LD + col]);
            dov[0] = x.x; dov[1] = x.y;
            qv[0] = y.x; qv[1] = y.y;
          }
#pragma unroll
          for (int a = 0; a < kKeysPerThread; ++a)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              av[a][c][e] = fmaf(p[a], dov[e], av[a][c][e]);
              ak[a][c][e] = fmaf(ds[a], qv[e], ak[a][c][e]);
            }
        }
      }
    }
  }

  float* dkh = dk + g * skv * HD;
  float* dvh = dv + g * skv * HD;
#pragma unroll
  for (int a = 0; a < kKeysPerThread; ++a) {
    const int64_t key = k0 + tr + 16 * a;
    if (key >= skv) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int64_t at = key * HD + VEC * tc + 16 * VEC * c + e;
        dkh[at] = ak[a][c][e] * scale;
        dvh[at] = av[a][c][e];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int64_t sq, int64_t skv, int group, int causal,
                    int64_t window, float scale) {
  using G = Geo<HD>;
  constexpr int LD = G::LD;
  constexpr int BQ = G::BQ;
  constexpr int RQ = G::RQ;
  constexpr int VEC = G::VEC;
  constexpr int NV = G::NV;
  extern __shared__ float smem[];
  float* s_q = smem;                      // [BQ][LD]
  float* s_do = s_q + BQ * LD;            // [BQ][LD]
  float* s_k = s_do + BQ * LD;            // [kBlockK][LD]
  float* s_v = s_k + kBlockK * LD;        // [kBlockK][LD]
  float* s_ds = s_v + kBlockK * LD;       // [BQ][kLdP]
  float* s_lse = s_ds + BQ * kLdP;        // [BQ]
  float* s_d = s_lse + BQ;                // [BQ]
  // P is written over dS's rows' own tile and never read here: the dQ
  // product needs dS alone
  float* s_p = s_ds;

  const int64_t bh = blockIdx.x;
  // the heaviest query blocks (last, under a causal mask) start first
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t g = bh / group;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  const float* kh = k + g * skv * HD;
  const float* vh = v + g * skv * HD;

  stage<HD>(s_q, q + bh * sq * HD, q0, BQ, sq);
  stage<HD>(s_do, dout + bh * sq * HD, q0, BQ, sq);
  stage_rows(s_lse, s_d, lse + bh * sq, delta + bh * sq, q0, BQ, sq);

  float acc[RQ][NV][VEC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][c][e] = 0.f;

  const int64_t q_last = min64(q0 + BQ, sq) - 1;
  const int64_t hi = causal ? min64(skv, q_last + 1) : skv;
  // the first key block the block's first row sees when windowed
  const int64_t lo =
      window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / kBlockK * kBlockK
                                        : 0;
  for (int64_t k0 = lo; k0 < hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's product has read k and dS
    stage<HD>(s_k, kh, k0, kBlockK, skv);
    stage<HD>(s_v, vh, k0, kBlockK, skv);
    __syncthreads();
    // P lands in s_ds first and is overwritten by dS in the same thread:
    // both are the same element, written in order by its one owner
    scores<HD>(s_q, s_do, s_k, s_v, s_lse, s_d, s_p, s_ds, q0, k0, skv,
               causal, window, scale);
    __syncthreads();
    const int nk = static_cast<int>(min64(kBlockK, hi - k0));
    for (int j = 0; j < nk; ++j) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = s_ds[(tr + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float* kr = &s_k[j * LD + VEC * tc + 16 * VEC * c];
        float kv[VEC];
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(kr);
          kv[0] = x.x; kv[1] = x.y; kv[2] = x.z; kv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(kr);
          kv[0] = x.x; kv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][c][e] = fmaf(ds[i], kv[e], acc[i][c][e]);
      }
    }
  }

  float* dqh = dq + bh * sq * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t row = q0 + tr + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dqh[row * HD + VEC * tc + 16 * VEC * c + e] =
            acc[i][c][e] * scale;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const float* lse, const void* dout,
                   float* delta, void* dq, void* dk, void* dv, int64_t bh,
                   int64_t sq, int64_t skv, int group, int causal,
                   int64_t window, cudaStream_t stream) {
  using G = Geo<HD>;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* tout = static_cast<const float*>(out);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  const int64_t rows = bh * sq;
  flash_bwd_delta_kernel<HD>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
         kThreads, 0, stream>>>(tout, tdo, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (skv > 0) {
    auto kdkdv = flash_bwd_dkdv_kernel<HD>;
    err = cudaFuncSetAttribute(kdkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(G::DKDV_SMEM));
    if (err != cudaSuccess) return err;
    const dim3 grid_kv(static_cast<unsigned>(bh / group),
                       static_cast<unsigned>((skv + kBlockK - 1) / kBlockK));
    kdkdv<<<grid_kv, kThreads, G::DKDV_SMEM, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), sq, skv, group, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  auto kdq = flash_bwd_dq_kernel<HD>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::DQ_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>(bh),
                    static_cast<unsigned>((sq + G::BQ - 1) / G::BQ));
  kdq<<<grid_q, kThreads, G::DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), sq, skv, group,
      causal, window, scale);
  return cudaGetLastError();
}


// ---- bf16: the tensor cores ------------------------------------------------

constexpr int kTcThreads = 384;  // a producer and two consumer warpgroups
constexpr int kTcBlock = 128;    // keys of a dK/dV CTA, rows of a dQ CTA
constexpr int kTcTile = 64;      // rows (dK/dV) or keys (dQ) a stage
constexpr int kTcStages = 3;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of one head size: a block is 128 rows by HD (two
// 64-row tiles), a tile NCB boxes of 64 rows.
template <int HD>
struct Tc {
  using B = Box<HD>;
  static constexpr uint32_t TILE = B::NCB * B::BYTES;   // 64 x HD
  static constexpr uint32_t BLOCK = 2 * TILE;            // 128 x HD
  static constexpr uint32_t ROWS = 2 * kTcTile * 4;      // lse2 and D, 64 rows
  static constexpr uint32_t BARS = 8 * (1 + 2 * kTcStages);
  // 1024 bytes of slack to align the tiles; dK/dV (HD <= 128): the k and v
  // blocks, the ring's q and do tiles, its lse2 and D rows, the mbarriers
  static constexpr size_t DKDV_SMEM =
      1024 + 2 * BLOCK + 2 * kTcStages * TILE + kTcStages * ROWS + BARS;
  // dQ's k and v rings: at HD 256 two k stages and one v stage, so that the
  // q and do blocks fit beside them
  static constexpr int KST = HD == 256 ? 2 : kTcStages;
  static constexpr int VST = HD == 256 ? 1 : kTcStages;
  // dQ: the q and do blocks, the k and v rings, their mbarriers
  static constexpr size_t DQ_SMEM =
      1024 + 2 * BLOCK + (KST + VST) * TILE + 8 * (1 + 2 * KST + 2 * VST);
};

// HD 256's dK/dV (flash_bwd_dkdv_split_wgmma_kernel): 64 keys, a ring of
// two q and do stages, two fp32 P^T buffers [64 x 64] between the
// consumers
constexpr int kSplitStages = 2;
constexpr uint32_t kPBytes = kTcTile * kTcTile * 4;
struct Split {
  using G = Tc<256>;
  static constexpr size_t SMEM = 1024 + 2 * G::TILE +
                                 2 * kSplitStages * G::TILE +
                                 kSplitStages * G::ROWS + 2 * kPBytes +
                                 8 * (1 + 2 * kSplitStages);
};
static_assert(Split::SMEM <= 232448 && Tc<256>::DQ_SMEM <= 232448,
              "HD 256's kernels take at most 227 KB of shared memory");

// Thread t of a warpgroup holds element e of a wgmma accumulator's 8-column
// group j at row 16 (t / 32 % 4) + t % 32 / 4 + 8 (e / 2) and column
// 8 j + 2 (t % 4) + e % 2.  Write a 64 x HD accumulator, times `scale` and
// rounded once to bf16, into the swizzled boxes at `dst` as a TMA store
// reads them.
template <int HD>
__device__ __forceinline__ void stage_out(uint32_t dst,
                                          const float (&acc)[HD / 2],
                                          float scale, int warp, int lane) {
  using B = Box<HD>;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = 8 * j + col;
      const uint32_t off =
          (16 * warp + lane / 4 + 8 * r) * B::SW + (c % B::C) * 2;
      const uint32_t swz = off ^ (((off >> 7) & (B::SW / 16 - 1)) << 4);
      const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * scale,
                                   acc[4 * j + 2 * r + 1] * scale);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       dst + (c / B::C) * B::BYTES + swz),
                   "r"(v)
                   : "memory");
    }
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// Each row's D and its log-sum-exp in log2 units (lse2 = lse log2(e), +inf
// where lse = -inf, so that exp2(s scale log2(e) - lse2) is 0 there), in
// [BH, sq_pad] with rows past Sq padded as lse2 = +inf (P = 0) and D = 0:
// one warp a row.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int64_t rows, int64_t sq,
                      int64_t sq_pad) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (idx >= rows) return;
  const int64_t b = idx / sq_pad;
  const int64_t r = idx % sq_pad;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  if (r < sq) {
    const int64_t row = b * sq + r;
    for (int d = lane; d < HD; d += 32)
      acc = fmaf(__bfloat162float(out[row * HD + d]),
                 __bfloat162float(dout[row * HD + d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float l = r < sq ? lse[b * sq + r] : -INFINITY;
    delta[idx] = acc;
    lse2[idx] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
}

// dK and dV of one KV head's block of 128 keys.  Warpgroup 0 produces: one
// thread loads the k and v blocks once, then, for each query head of the
// group in order and each 64-row query tile that sees the block, the q and
// do tiles and their lse2 and D rows into a ring of kTcStages.  Warpgroup
// 1 + h owns keys k0 + 64 h ... + 63; per tile it computes
//   S^T  = K Q^T, dP^T = V dO^T   (SS: A and B K-major),
//   P^T  = exp2(S^T scale log2 e - lse2), dS^T = P^T (dP^T - D)
//          (lse2 and D per column; the causal mask on edge tiles only),
//   dV  += P^T dO, dK += dS^T Q  (RS: A = P^T, dS^T as bf16 hi + lo in
//          registers, B = do, q MN-major),
// with fp32 accumulators in registers, and skips the tiles whose rows all
// lie before its first key.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tdk,
                            const __grid_constant__ CUtensorMap tdv,
                            const float* __restrict__ lse2,
                            const float* __restrict__ delta, int64_t sq,
                            int64_t sq_pad, int group, int causal,
                            int64_t window, float scale_log2, float scale) {
  using B = Box<HD>;
  using G = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;            // [2 halves] tiles
  const uint32_t s_v = s_k + G::BLOCK;                   // [2 halves] tiles
  const uint32_t s_q = s_v + G::BLOCK;                   // [kTcStages] tiles
  const uint32_t s_do = s_q + kTcStages * G::TILE;       // [kTcStages] tiles
  const uint32_t s_rows = s_do + kTcStages * G::TILE;    // [kTcStages] rows
  const uint32_t bar_kv = s_rows + kTcStages * G::ROWS;
  const uint32_t bar_full = bar_kv + 8;                  // [kTcStages]
  const uint32_t bar_empty = bar_full + 8 * kTcStages;   // [kTcStages]

  const int g = blockIdx.x;
  // under a causal mask the first key blocks see the most rows: they start
  // first as they are
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kTcBlock;
  int64_t nqt = (sq + kTcTile - 1) / kTcTile;
  // the first query tile with a row that sees a key of the block, and past
  // the last when windowed (its last key + window - 1)
  const int64_t qt0 = causal ? k0 / kTcTile : 0;
  if (window > 0) nqt = min64(nqt, (k0 + kTcBlock + window - 2) / kTcTile + 1);
  const int tiles = nqt > qt0 ? group * static_cast<int>(nqt - qt0) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * G::BLOCK);
      for (int h = 0; h < 2; ++h)
        for (int cb = 0; cb < B::NCB; ++cb) {
          const uint32_t off = h * G::TILE + cb * B::BYTES;
          const int key = static_cast<int>(k0 + kTcTile * h);
          tma_load(s_k + off, &tk, cb * B::C, key, g, bar_kv);
          tma_load(s_v + off, &tv, cb * B::C, key, g, bar_kv);
        }
      int t = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int64_t bh = static_cast<int64_t>(g) * group + hh;
        for (int64_t qt = qt0; qt < nqt; ++qt, ++t) {
          const int st = t % kTcStages;
          const int round = t / kTcStages;
          // the consumers have released this stage's previous tile
          if (round > 0) mbar_wait(bar_empty + 8 * st, (round - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          mbar_expect_tx(full, 2 * G::TILE + G::ROWS);
          const int row = static_cast<int>(qt * kTcTile);
          for (int cb = 0; cb < B::NCB; ++cb) {
            const uint32_t off = st * G::TILE + cb * B::BYTES;
            tma_load(s_q + off, &tq, cb * B::C, row, static_cast<int>(bh),
                     full);
            tma_load(s_do + off, &tdo, cb * B::C, row, static_cast<int>(bh),
                     full);
          }
          const int64_t at = bh * sq_pad + qt * kTcTile;
          bulk_load(s_rows + st * G::ROWS, lse2 + at, G::ROWS / 2, full);
          bulk_load(s_rows + st * G::ROWS + G::ROWS / 2, delta + at,
                    G::ROWS / 2, full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 + h owns keys k0 + 64 h ... + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int h = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int64_t keys = k0 + kTcTile * h;              // the half's first key
    // a thread's keys lie 16 warp + lane / 4 (and + 8) past `keys`, its
    // query columns col (and col + 1, + 8 j) past a tile's first row
    const int col = 2 * (lane % 4);
    const int diag = 16 * warp + lane / 4 - col;
    const uint32_t kh = s_k + h * G::TILE;
    const uint32_t vh = s_v + h * G::TILE;

    float dk[HD / 2], dv[HD / 2];  // [64 keys x HD], the accumulator layout
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }

    if (tiles > 0) mbar_wait(bar_kv, 0);
    int t = 0;
    for (int hh = 0; hh < group; ++hh) {
      for (int64_t qt = qt0; qt < nqt; ++qt, ++t) {
        const int st = t % kTcStages;
        // the tile's first row less the half's first key
        const int lag = static_cast<int>(qt * kTcTile - keys);
        mbar_wait(bar_full + 8 * st, (t / kTcStages) & 1);
        if ((causal && lag + kTcTile - 1 < 0) ||
            (window > 0 && lag - (kTcTile - 1) >= window)) {
          mbar_arrive(bar_empty + 8 * st);  // no row sees these keys
          continue;
        }
        const uint32_t qs = s_q + st * G::TILE;
        const uint32_t dos = s_do + st * G::TILE;

        // S^T = K Q^T and dP^T = V dO^T over HD in steps of 16: s[4 j + e]
        // at key keys + 16 warp + lane / 4 + 8 (e / 2), query row
        // qt * 64 + 8 j + col + e % 2
        float s[32], dp[32];
        wgmma_fence();
  #pragma unroll
        for (int cb = 0; cb < B::NCB; ++cb)
  #pragma unroll
          for (int kk = 0; kk < B::C / 16; ++kk)
            wgmma_ss(s,
                     desc(kh + cb * B::BYTES + 32 * kk, 16, 8 * B::SW, B::LAYOUT),
                     desc(qs + cb * B::BYTES + 32 * kk, 16, 8 * B::SW, B::LAYOUT),
                     cb + kk > 0);
        wgmma_commit();
  #pragma unroll
        for (int cb = 0; cb < B::NCB; ++cb)
  #pragma unroll
          for (int kk = 0; kk < B::C / 16; ++kk)
            wgmma_ss(dp,
                     desc(vh + cb * B::BYTES + 32 * kk, 16, 8 * B::SW, B::LAYOUT),
                     desc(dos + cb * B::BYTES + 32 * kk, 16, 8 * B::SW,
                          B::LAYOUT),
                     cb + kk > 0);
        wgmma_commit();

        // P^T while dP^T runs; the mask on the causal and window edges only
        // (rows past Sq have lse2 = +inf and keys past Skv are dropped at the
        // store)
        wgmma_wait<1>();
        fence_regs(s);
        const uint32_t l2 = s_rows + st * G::ROWS + 4 * col;
        const uint32_t dd = l2 + G::ROWS / 2;
        const bool edge = (causal && lag < kTcTile - 1) ||
                          (window > 0 && lag + kTcTile - 1 >= window);
  #pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = lds_f2(l2 + 32 * j);
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[4 * j + e], scale_log2, -(e % 2 ? l.y : l.x)));
            // key - row + lag: masked past the row (causal) and at window or
            // more before it
            const int rel = diag + 8 * (e / 2) - e % 2 - 8 * j;
            if (edge && ((causal && rel > lag) ||
                         (window > 0 && lag - rel >= window)))
              p = 0.f;
            s[4 * j + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
  #pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d = lds_f2(dd + 32 * j);
  #pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? d.y : d.x));
        }

        // dV += P^T dO, then dK += dS^T Q, each operand as bf16 hi + lo: the
        // rows of do and q are the reduction, HD contiguous, so B is MN-major
        uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
        split_bf16(s, p_hi, p_lo);
        wgmma_fence();
  #pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          const uint64_t b = desc(dos + kt * 16 * B::SW, B::BYTES, 8 * B::SW,
                                  B::LAYOUT);
          wgmma_rs(dv, p_hi[kt], b);
          wgmma_rs(dv, p_lo[kt], b);
        }
        wgmma_commit();
        split_bf16(dp, ds_hi, ds_lo);
        wgmma_fence();
  #pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          const uint64_t b = desc(qs + kt * 16 * B::SW, B::BYTES, 8 * B::SW,
                                  B::LAYOUT);
          wgmma_rs(dk, ds_hi[kt], b);
          wgmma_rs(dk, ds_lo[kt], b);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(p_hi);
        fence_regs(p_lo);
        fence_regs(ds_hi);
        fence_regs(ds_lo);
        mbar_arrive(bar_empty + 8 * st);
      }
    }

    // dK scale and dV as bf16 over this half's (spent) k and v tiles, then
    // one TMA store a box, which drops keys past Skv
    stage_out<HD>(kh, dk, scale, warp, lane);
    stage_out<HD>(vh, dv, 1.f, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + h) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int cb = 0; cb < B::NCB; ++cb) {
        tma_store(&tdk, kh + cb * B::BYTES, cb * B::C, static_cast<int>(keys),
                  g);
        tma_store(&tdv, vh + cb * B::BYTES, cb * B::C, static_cast<int>(keys),
                  g);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// Named barriers 1-4 of the split kernel: P^T's buffer b is "ready" once
// warpgroup 1 has written it and "free" once warpgroup 2 has read it; each
// pairs one warpgroup's bar.arrive with the other's bar.sync (256 threads)
constexpr int kPReady = 1;
constexpr int kPFree = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// dK and dV (fp32 partials) of one KV head's block of 64 keys over one split
// of its group's query heads, at HD 256.  Warpgroup 0 produces: one thread
// loads the block's k and v once, then, for each query head of the split in
// order and each 64-row query tile that sees the block, the q and do tiles
// and their lse2 and D rows into a ring of kSplitStages.  Both consumers
// take every tile:
//   warpgroup 1: S^T = K Q^T (SS), P^T = exp2(S^T scale log2 e - lse2)
//                (the mask on edge tiles only), P^T into buffer b, then
//                dV += P^T dO (RS: P^T as bf16 hi + lo, do MN-major);
//   warpgroup 2: dP^T = V dO^T (SS), P^T from buffer b, dS^T = P^T (dP^T -
//                D), dK += dS^T Q (RS: dS^T as bf16 hi + lo, q MN-major);
// then each writes its accumulator (dV, or dK unscaled) as this split's fp32
// partial [kvh, skv, 256] from its registers, dropping keys past Skv.
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_split_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse2,
                                  const float* __restrict__ delta,
                                  float* __restrict__ dk_part,
                                  float* __restrict__ dv_part, int64_t sq,
                                  int64_t sq_pad, int64_t skv, int group,
                                  int splits, int causal, int64_t window,
                                  float scale_log2) {
  constexpr int HD = 256;
  using B = Box<HD>;
  using G = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;               // one tile
  const uint32_t s_v = s_k + G::TILE;                       // one tile
  const uint32_t s_q = s_v + G::TILE;                       // [kSplitStages]
  const uint32_t s_do = s_q + kSplitStages * G::TILE;       // [kSplitStages]
  const uint32_t s_p = s_do + kSplitStages * G::TILE;       // [2] P^T
  const uint32_t s_rows = s_p + 2 * kPBytes;                // [kSplitStages]
  const uint32_t bar_kv = s_rows + kSplitStages * G::ROWS;
  const uint32_t bar_full = bar_kv + 8;                     // [kSplitStages]
  const uint32_t bar_empty = bar_full + 8 * kSplitStages;   // [kSplitStages]

  const int kvh = gridDim.x / splits;
  const int g = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int heads = group / splits;           // query heads a split
  // under a causal mask the first key blocks see the most rows: they start
  // first as they are
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kTcTile;
  // the query tiles with a row that sees a key of the block: from tile
  // k0 / 64 on when causal, to the one holding its last key + window - 1
  // when windowed
  const int64_t qt0 = causal ? k0 / kTcTile : 0;
  int64_t nqt = (sq + kTcTile - 1) / kTcTile;
  if (window > 0) nqt = min64(nqt, (k0 + kTcTile + window - 2) / kTcTile + 1);
  const int tiles = nqt > qt0 ? heads * static_cast<int>(nqt - qt0) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * G::TILE);
      for (int cb = 0; cb < B::NCB; ++cb) {
        tma_load(s_k + cb * B::BYTES, &tk, cb * B::C, static_cast<int>(k0), g,
                 bar_kv);
        tma_load(s_v + cb * B::BYTES, &tv, cb * B::C, static_cast<int>(k0), g,
                 bar_kv);
      }
      int t = 0;
      for (int hh = 0; hh < heads; ++hh) {
        const int64_t bh =
            static_cast<int64_t>(g) * group + split * heads + hh;
        for (int64_t qt = qt0; qt < nqt; ++qt, ++t) {
          const int st = t % kSplitStages;
          const int round = t / kSplitStages;
          // the consumers have released this stage's previous tile
          if (round > 0) mbar_wait(bar_empty + 8 * st, (round - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          mbar_expect_tx(full, 2 * G::TILE + G::ROWS);
          const int row = static_cast<int>(qt * kTcTile);
          for (int cb = 0; cb < B::NCB; ++cb) {
            const uint32_t off = st * G::TILE + cb * B::BYTES;
            tma_load(s_q + off, &tq, cb * B::C, row, static_cast<int>(bh),
                     full);
            tma_load(s_do + off, &tdo, cb * B::C, row, static_cast<int>(bh),
                     full);
          }
          const int64_t at = bh * sq_pad + qt * kTcTile;
          bulk_load(s_rows + st * G::ROWS, lse2 + at, G::ROWS / 2, full);
          bulk_load(s_rows + st * G::ROWS + G::ROWS / 2, delta + at,
                    G::ROWS / 2, full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 owns dV, warpgroup 2 dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const bool owns_dv = wg == 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    // a thread's keys lie 16 warp + lane / 4 (and + 8) past k0, its query
    // columns col (and col + 1, + 8 j) past a tile's first row
    const int col = 2 * (lane % 4);
    const int diag = 16 * warp + lane / 4 - col;

    float acc[HD / 2];  // dV or dK [64 keys x HD], the accumulator layout
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    if (tiles > 0) mbar_wait(bar_kv, 0);
    for (int t = 0; t < tiles; ++t) {
      const int st = t % kSplitStages;
      const int b = t % 2;                  // P^T's buffer
      const int64_t qt = qt0 + t % (nqt - qt0);
      // the tile's first row less the block's first key
      const int lag = static_cast<int>(qt * kTcTile - k0);
      mbar_wait(bar_full + 8 * st, (t / kSplitStages) & 1);
      const uint32_t qs = s_q + st * G::TILE;
      const uint32_t dos = s_do + st * G::TILE;
      const uint32_t rows = s_rows + st * G::ROWS + 4 * col;
      const uint32_t pb = s_p + b * kPBytes + 16 * tid;

      // S^T = K Q^T (dV's warpgroup) or dP^T = V dO^T (dK's) over HD in
      // steps of 16: x[4 j + e] at key k0 + 16 warp + lane / 4 + 8 (e / 2),
      // query row qt * 64 + 8 j + col + e % 2
      float x[32];
      const uint32_t a_tile = owns_dv ? s_k : s_v;
      const uint32_t b_tile = owns_dv ? qs : dos;
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < B::NCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < B::C / 16; ++kk)
          wgmma_ss(x,
                   desc(a_tile + cb * B::BYTES + 32 * kk, 16, 8 * B::SW,
                        B::LAYOUT),
                   desc(b_tile + cb * B::BYTES + 32 * kk, 16, 8 * B::SW,
                        B::LAYOUT),
                   cb + kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      if (owns_dv) {
        // P^T; the mask on the causal and window edges only (rows past Sq
        // have lse2 = +inf and keys past Skv are dropped at the store)
        const bool edge = (causal && lag < kTcTile - 1) ||
                          (window > 0 && lag + kTcTile - 1 >= window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = lds_f2(rows + 32 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p =
                exp2f(fmaf(x[4 * j + e], scale_log2, -(e % 2 ? l.y : l.x)));
            // key - row + lag: masked past the row (causal) and at window or
            // more before it
            const int rel = diag + 8 * (e / 2) - e % 2 - 8 * j;
            if (edge && ((causal && rel > lag) ||
                         (window > 0 && lag - rel >= window)))
              p = 0.f;
            x[4 * j + e] = p;
          }
        }
        // buffer b once dK's warpgroup has read it two tiles ago; thread
        // tid's 32 values in 8 runs of 16 bytes, 2 KB apart
        if (t >= 2) named_sync(kPFree + b);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           pb + 2048 * j),
                       "f"(x[4 * j]), "f"(x[4 * j + 1]), "f"(x[4 * j + 2]),
                       "f"(x[4 * j + 3])
                       : "memory");
        named_arrive(kPReady + b);
      } else {
        // dS^T = P^T (dP^T - D), P^T written by the same thread index of
        // dV's warpgroup (the two accumulator layouts are one)
        named_sync(kPReady + b);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p[4];
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
                       : "r"(pb + 2048 * j)
                       : "memory");
          const float2 d = lds_f2(rows + G::ROWS / 2 + 32 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] = p[e] * (x[4 * j + e] - (e % 2 ? d.y : d.x));
        }
        named_arrive(kPFree + b);
      }

      // dV += P^T dO or dK += dS^T Q, the operand as bf16 hi + lo: the rows
      // of do and q are the reduction, HD contiguous, so B is MN-major
      uint32_t x_hi[4][4], x_lo[4][4];
      split_bf16(x, x_hi, x_lo);
      const uint32_t rhs = owns_dv ? dos : qs;
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const uint64_t d = desc(rhs + kt * 16 * B::SW, B::BYTES, 8 * B::SW,
                                B::LAYOUT);
        wgmma_rs(acc, x_hi[kt], d);
        wgmma_rs(acc, x_lo[kt], d);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(x_hi);
      fence_regs(x_lo);
      mbar_arrive(bar_empty + 8 * st);
    }
    // dV's warpgroup takes the last arrivals on "free", so that every
    // arrive meets its sync
    if (owns_dv)
      for (int t = tiles > 2 ? tiles - 2 : 0; t < tiles; ++t)
        named_sync(kPFree + t % 2);

    // this split's partial, fp32, straight from the accumulator: thread
    // tid's keys k0 + 16 warp + lane / 4 (+ 8), columns 8 j + col (+ 1)
    float* part = (owns_dv ? dv_part : dk_part) +
                  ((static_cast<int64_t>(split) * kvh + g) * skv) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t key = k0 + 16 * warp + lane / 4 + 8 * r;
      if (key >= skv) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(&part[key * HD + 8 * j + col]) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// dk = scale * sum of the splits' partials and dv = their sum, added in
// split order and rounded once to bf16; part is [2][splits][n] (dK's, then
// dV's), n = kvh * skv * 256 elements of each, 4 a thread
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int64_t n,
                          int splits, float scale) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const int64_t at = is_v ? i - n : i;
  const float* src = part + (is_v ? splits * n : 0) + at;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(src + s * n);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  const float m = is_v ? 1.f : scale;
  const uint2 out = make_uint2(pack_bf16(a.x * m, a.y * m),
                               pack_bf16(a.z * m, a.w * m));
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + at) = out;
}

// dQ of one query head's block of 128 rows.  Warpgroup 0 produces: one
// thread loads the q and do blocks once, then the 64-key k and v tiles from
// key 0 to the last key the block's last row sees, each into its own ring
// (KST and VST stages).  Warpgroup 1 + h owns rows q0 + 64 h ... + 63; per
// tile it computes
//   S  = Q K^T, dP = dO V^T   (SS; v's stage is released once dP is read),
//   P  = exp2(S scale log2 e - lse2), dS = P (dP - D)  (in registers; the
//        mask on the causal edge and the ragged last tile only),
//   dQ += dS K                (RS: dS as bf16 hi + lo, k MN-major),
// and skips the tiles past its last row.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta, int64_t sq,
                          int64_t sq_pad, int64_t skv, int group, int causal,
                          int64_t window, float scale_log2, float scale) {
  using B = Box<HD>;
  using G = Tc<HD>;
  constexpr int KST = G::KST;
  constexpr int VST = G::VST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;            // [2 halves] tiles
  const uint32_t s_do = s_q + G::BLOCK;                  // [2 halves] tiles
  const uint32_t s_k = s_do + G::BLOCK;                  // [KST] tiles
  const uint32_t s_v = s_k + KST * G::TILE;              // [VST] tiles
  const uint32_t bar_q = s_v + VST * G::TILE;
  const uint32_t full_k = bar_q + 8;                     // [KST]
  const uint32_t empty_k = full_k + 8 * KST;             // [KST]
  const uint32_t full_v = empty_k + 8 * KST;             // [VST]
  const uint32_t empty_v = full_v + 8 * VST;             // [VST]

  const int bh = blockIdx.x;
  // the heaviest query blocks (last, under a causal mask) start first
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kTcBlock;
  const int g = bh / group;
  const int64_t q_last = min64(q0 + kTcBlock, sq) - 1;
  const int64_t hi = causal ? min64(skv, q_last + 1) : skv;
  const int tiles = static_cast<int>((hi + kTcTile - 1) / kTcTile);
  // the first key tile the block's first row sees when windowed
  const int t0 = window > 0 && q0 - window + 1 > 0
                     ? static_cast<int>((q0 - window + 1) / kTcTile)
                     : 0;
  const int n_tiles = tiles > t0 ? tiles - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * G::BLOCK);
      for (int h = 0; h < 2; ++h)
        for (int cb = 0; cb < B::NCB; ++cb) {
          const uint32_t off = h * G::TILE + cb * B::BYTES;
          const int row = static_cast<int>(q0 + kTcTile * h);
          tma_load(s_q + off, &tq, cb * B::C, row, bh, bar_q);
          tma_load(s_do + off, &tdo, cb * B::C, row, bh, bar_q);
        }
      for (int n = 0; n < n_tiles; ++n) {
        const int key = kTcTile * (t0 + n);
        // each ring's stage once the consumers have released its last tile
        const int sk = n % KST, sv = n % VST;
        if (n >= KST) mbar_wait(empty_k + 8 * sk, (n / KST - 1) & 1);
        mbar_expect_tx(full_k + 8 * sk, G::TILE);
        for (int cb = 0; cb < B::NCB; ++cb)
          tma_load(s_k + sk * G::TILE + cb * B::BYTES, &tk, cb * B::C, key, g,
                   full_k + 8 * sk);
        if (n >= VST) mbar_wait(empty_v + 8 * sv, (n / VST - 1) & 1);
        mbar_expect_tx(full_v + 8 * sv, G::TILE);
        for (int cb = 0; cb < B::NCB; ++cb)
          tma_load(s_v + sv * G::TILE + cb * B::BYTES, &tv, cb * B::C, key, g,
                   full_v + 8 * sv);
      }
    }
  } else {
    // ---- consumers: warpgroup 1 + h owns rows q0 + 64 h ... + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int h = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int64_t rows = q0 + kTcTile * h;              // the half's first row
    const int64_t row = rows + 16 * warp + lane / 4;    // and row + 8
    const int col = 2 * (lane % 4);                     // and col + 1, + 8 j
    const uint32_t qh = s_q + h * G::TILE;
    const uint32_t doh = s_do + h * G::TILE;
    // the rows' lse2 and D (padded to sq_pad, so every row reads)
    const int64_t at = static_cast<int64_t>(bh) * sq_pad + row;
    const float l2[2] = {lse2[at], lse2[at + 8]};
    const float dd[2] = {delta[at], delta[at + 8]};

    float dq[HD / 2];  // [64 rows x HD], the accumulator layout
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int sk = n % KST, sv = n % VST;
      const int64_t k0 = static_cast<int64_t>(t0 + n) * kTcTile;
      mbar_wait(full_k + 8 * sk, (n / KST) & 1);
      if ((causal && k0 > rows + kTcTile - 1) ||
          (window > 0 && rows - (k0 + kTcTile - 1) >= window)) {
        // no row here sees these keys: release both stages once loaded
        mbar_wait(full_v + 8 * sv, (n / VST) & 1);
        mbar_arrive(empty_v + 8 * sv);
        mbar_arrive(empty_k + 8 * sk);
        continue;
      }
      const uint32_t ks = s_k + sk * G::TILE;
      const uint32_t vs = s_v + sv * G::TILE;

      // S = Q K^T and dP = dO V^T: s[4 j + e] at row + 8 (e / 2), key
      // k0 + 8 j + col + e % 2
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < B::NCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < B::C / 16; ++kk)
          wgmma_ss(s,
                   desc(qh + cb * B::BYTES + 32 * kk, 16, 8 * B::SW, B::LAYOUT),
                   desc(ks + cb * B::BYTES + 32 * kk, 16, 8 * B::SW, B::LAYOUT),
                   cb + kk > 0);
      wgmma_commit();
      mbar_wait(full_v + 8 * sv, (n / VST) & 1);
#pragma unroll
      for (int cb = 0; cb < B::NCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < B::C / 16; ++kk)
          wgmma_ss(dp,
                   desc(doh + cb * B::BYTES + 32 * kk, 16, 8 * B::SW,
                        B::LAYOUT),
                   desc(vs + cb * B::BYTES + 32 * kk, 16, 8 * B::SW, B::LAYOUT),
                   cb + kk > 0);
      wgmma_commit();

      // P while dP runs; keys past Skv read as zeros and are masked too, so
      // that no exp2 of a large -lse2 reaches dQ
      wgmma_wait<1>();
      fence_regs(s);
      const bool edge = (causal && k0 + kTcTile - 1 > rows) ||
                        k0 + kTcTile > skv ||
                        (window > 0 && rows + kTcTile - 1 - k0 >= window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float p = exp2f(fmaf(s[i], scale_log2, -l2[r]));
        if (edge) {
          const int64_t kx = k0 + 8 * (i / 4) + col + i % 2;
          if (kx >= skv || (causal && kx > row + 8 * r) ||
              (window > 0 && row + 8 * r - kx >= window))
            p = 0.f;
        }
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      mbar_arrive(empty_v + 8 * sv);  // dP has read v
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dd[(i / 2) % 2]);

      // dQ += dS K: k's rows are the reduction, HD contiguous (MN-major)
      uint32_t ds_hi[4][4], ds_lo[4][4];
      split_bf16(dp, ds_hi, ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const uint64_t b = desc(ks + kt * 16 * B::SW, B::BYTES, 8 * B::SW,
                                B::LAYOUT);
        wgmma_rs(dq, ds_hi[kt], b);
        wgmma_rs(dq, ds_lo[kt], b);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      mbar_arrive(empty_k + 8 * sk);
    }

    // dQ scale as bf16 over this half's (spent) q tile, then one TMA store
    // a box, which drops rows past Sq
    stage_out<HD>(qh, dq, scale, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + h) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int cb = 0; cb < B::NCB; ++cb)
        tma_store(&tdq, qh + cb * B::BYTES, cb * B::C, static_cast<int>(rows),
                  bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* out, const float* lse, const void* dout,
                         float* scratch, float* partials, void* dq, void* dk,
                         void* dv, int64_t bh, int64_t sq, int64_t skv,
                         int group, int splits, int causal, int64_t window,
                         cudaStream_t stream) {
  using G = Tc<HD>;
  if (skv == 0)  // no key: dq is 0, and dk and dv are empty
    return cudaMemsetAsync(dq, 0, static_cast<size_t>(bh * sq * HD) * 2,
                           stream);
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;  // TMA needs 16-byte alignment
  const int64_t sq_pad = (sq + kTcBlock - 1) / kTcBlock * kTcBlock;
  float* lse2 = scratch;
  float* delta = scratch + bh * sq_pad;
  const int64_t rows = bh * sq_pad;
  flash_bwd_rows_kernel<HD>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
         kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(out),
                                static_cast<const __nv_bfloat16*>(dout), lse,
                                lse2, delta, rows, sq, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  const int64_t kvh = bh / group;
  if (!tensor_map<HD>(encode, &tq, q, bh, sq) ||
      !tensor_map<HD>(encode, &tdo, dout, bh, sq) ||
      !tensor_map<HD>(encode, &tdq, dq, bh, sq) ||
      !tensor_map<HD>(encode, &tk, k, kvh, skv) ||
      !tensor_map<HD>(encode, &tv, v, kvh, skv) ||
      !tensor_map<HD>(encode, &tdk, dk, kvh, skv) ||
      !tensor_map<HD>(encode, &tdv, dv, kvh, skv))
    return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;

  if constexpr (HD == 256) {
    // dK and dV as `splits` fp32 partials, then their sum
    auto ksplit = flash_bwd_dkdv_split_wgmma_kernel;
    err = cudaFuncSetAttribute(ksplit,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Split::SMEM));
    if (err != cudaSuccess) return err;
    const dim3 grid_kv(static_cast<unsigned>(kvh * splits),
                       static_cast<unsigned>((skv + kTcTile - 1) / kTcTile));
    const int64_t n = kvh * skv * HD;
    ksplit<<<grid_kv, kTcThreads, Split::SMEM, stream>>>(
        tq, tk, tv, tdo, lse2, delta, partials, partials + splits * n, sq,
        sq_pad, skv, group, splits, causal, window, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_sum_kernel<<<static_cast<unsigned>(
                                    (2 * n / 4 + kThreads - 1) / kThreads),
                                kThreads, 0, stream>>>(
        partials, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n, splits, scale);
  } else {
    auto kdkdv = flash_bwd_dkdv_wgmma_kernel<HD>;
    err = cudaFuncSetAttribute(kdkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(G::DKDV_SMEM));
    if (err != cudaSuccess) return err;
    const dim3 grid_kv(static_cast<unsigned>(kvh),
                       static_cast<unsigned>((skv + kTcBlock - 1) / kTcBlock));
    kdkdv<<<grid_kv, kTcThreads, G::DKDV_SMEM, stream>>>(
        tq, tk, tv, tdo, tdk, tdv, lse2, delta, sq, sq_pad, group, causal,
        window, scale_log2, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = flash_bwd_dq_wgmma_kernel<HD>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::DQ_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>(bh),
                    static_cast<unsigned>((sq + kTcBlock - 1) / kTcBlock));
  kdq<<<grid_q, kTcThreads, G::DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, lse2, delta, sq, sq_pad, skv, group, causal,
      window, scale_log2, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(bool tensor_cores, const void* q, const void* k,
                      const void* v, const void* out, const float* lse,
                      const void* dout, float* scratch, float* partials,
                      void* dq, void* dk, void* dv, int64_t bh, int64_t sq,
                      int64_t skv, int group, int splits, int causal,
                      int64_t window, cudaStream_t s) {
  if (tensor_cores)
    return launch_wgmma<HD>(q, k, v, out, lse, dout, scratch, partials, dq,
                            dk, dv, bh, sq, skv, group, splits, causal,
                            window, s);
  return launch<HD>(q, k, v, out, lse, dout, scratch, dq, dk, dv, bh, sq, skv,
                    group, causal, window, s);
}

}  // namespace

// fp32 scratch a launch needs: the tensor-core body's lse2 and D, each
// [bh, sq] with sq padded to a dQ block (the CUDA-core body's D takes the
// first bh * sq floats)
extern "C" int64_t flash_attention_bwd_scratch_floats(int64_t bh,
                                                      int64_t sq) {
  return 2 * bh * ((sq + kTcBlock - 1) / kTcBlock * kTcBlock);
}

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous q, out, dout, dq [bh, sq, hd], k, v, dk, dv
// [bh / group, skv, hd], all of one type (bf16 when `bf16`, else fp32),
// fp32 lse [bh, sq], and fp32 scratch the kernels write, of
// flash_attention_bwd_scratch_floats(bh, sq) floats; the caller has
// checked shapes, types and contiguity.  `tensor_cores` picks the body: the
// tensor cores (bf16) or the CUDA cores (fp32).  At HD 256 the tensor cores
// split each KV head's query heads into `splits` parts (a divisor of
// group) and write fp32 partials of dK and dV into `partials`, [2, splits,
// bh / group, skv, 256] floats; elsewhere `splits` and `partials` are not
// read.  Returns cudaGetLastError() after the last launch,
// cudaErrorInvalidValue for a shape the kernels do not take or a body asked
// for another type, or cudaErrorMisalignedAddress for a pointer of the
// tensor-core body off 16 bytes (TMA).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* scratch, void* partials,
    void* dq, void* dk, void* dv, int64_t bh, int64_t sq, int64_t skv,
    int64_t hd, int64_t group, int splits, int causal, int64_t window,
    int bf16, int tensor_cores, void* stream) {
  const int64_t sq_pad = (sq + kTcBlock - 1) / kTcBlock * kTcBlock;
  if ((tensor_cores != 0) != (bf16 != 0) ||
      bh < 0 || sq < 0 || skv < 0 || window < 0 || group < 1 ||
      group > 0x7fffffff ||
      bh % group != 0 || bh > 0x7fffffff || skv > 0x7fffffff ||
      sq > 0x7fffffff || (sq + 31) / 32 > 65535 ||
      (skv + kBlockK - 1) / kBlockK > 65535 ||
      (bh * sq_pad + kThreads / 32 - 1) / (kThreads / 32) > 0x7fffffff ||
      // the split dK/dV's grid and its partial sum's
      (tensor_cores && hd == 256 &&
       (splits < 1 || group % splits != 0 || partials == nullptr ||
        (bh / group) * splits > 0x7fffffff ||
        (bh / group) * skv * hd / 2 > 0x7fffffffLL * kThreads))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(group);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(scratch);
  float* part = static_cast<float*>(partials);
  const bool tc = tensor_cores != 0;
  switch (hd) {
    case 32:
      return static_cast<int>(launch_hd<32>(tc, q, k, v, out, l, dout, w,
                                            part, dq, dk, dv, bh, sq, skv, g,
                                            splits, causal, window, s));
    case 64:
      return static_cast<int>(launch_hd<64>(tc, q, k, v, out, l, dout, w,
                                            part, dq, dk, dv, bh, sq, skv, g,
                                            splits, causal, window, s));
    case 128:
      return static_cast<int>(launch_hd<128>(tc, q, k, v, out, l, dout, w,
                                             part, dq, dk, dv, bh, sq, skv,
                                             g, splits, causal, window, s));
    case 256:
      return static_cast<int>(launch_hd<256>(tc, q, k, v, out, l, dout, w,
                                             part, dq, dk, dv, bh, sq, skv,
                                             g, splits, causal, window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
