// flash_attention_bwd.cu: the gradient of flash_attention.cu's attention,
// for Hopper (sm_90a).
//
// The TPU kernel it pairs with, src/repro/kernels/flash_attention.py:77
// flash_attention, has no backward (the reference trains through XLA's
// gradient of the jnp attention, src/repro/models/layers.py:112
// _attend_block); this kernel is the port's own, so that a loss taken
// through the hand-written forward gets its gradient from the card.
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
// causal): the FlashAttention-2 backward.  window > 0 is refused by the
// wrapper for now.  Types: fp32 or bf16 (one type); dq, dk and dv come out
// in it, every sum in fp32, rounded once.
//
// Bound: operations.  Five products of 2 * HD operations for every (query,
// key) pair the mask leaves (S, dP = do v^T, dV, dK, dQ) against the
// forward's two: at deepseek-7b's shape (q [128, 4064, 128] bf16, causal)
// 1.057 G pairs, 1.353 TFLOP, 1.368 ms at the bf16 tensor-core rate.
//
// Design: simple and right first, on the CUDA cores, fp32 in shared memory
// whatever the input type (a wgmma/TMA redesign is later work).  Three
// kernels, no atomics, so a second launch equals the first bit for bit:
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

namespace {

constexpr int kThreads = 256;
constexpr int kBlockK = 64;
constexpr int kKeysPerThread = kBlockK / 16;  // 4
constexpr int kLdP = kBlockK + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row0, int n, int64_t len) {
  constexpr int LD = Geo<HD>::LD;
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    const int64_t row = row0 + r;
    dst[r * LD + c] = row < len ? to_f32(src[row * HD + c]) : 0.f;
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
                                       float scale) {
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
      const bool seen = key < skv && (!causal || key <= row) && l != -INFINITY;
      const float p = seen ? expf(s[i][j] * scale - l) : 0.f;
      s_p[r * kLdP + c] = p;
      s_ds[r * kLdP + c] = p * (dp[i][j] - dd);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(out[row * HD + d]), to_f32(dout[row * HD + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int64_t sq, int64_t skv, int group,
                      int causal, float scale) {
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
  // on when causal
  const int64_t qb0 = causal ? k0 / BQ : 0;
  const int64_t nqb = (sq + BQ - 1) / BQ;
  for (int t = 0; t < group; ++t) {
    const int64_t bh = g * group + t;
    const T* qh = q + bh * sq * HD;
    const T* doh = dout + bh * sq * HD;
    for (int64_t qb = qb0; qb < nqb; ++qb) {
      const int64_t q0 = qb * BQ;
      __syncthreads();  // the previous block's products have read smem
      stage<HD>(s_q, qh, q0, BQ, sq);
      stage<HD>(s_do, doh, q0, BQ, sq);
      stage_rows(s_lse, s_d, lse + bh * sq, delta + bh * sq, q0, BQ, sq);
      __syncthreads();
      scores<HD>(s_q, s_do, s_k, s_v, s_lse, s_d, s_p, s_ds, q0, k0, skv,
                 causal, scale);
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

  T* dkh = dk + g * skv * HD;
  T* dvh = dv + g * skv * HD;
#pragma unroll
  for (int a = 0; a < kKeysPerThread; ++a) {
    const int64_t key = k0 + tr + 16 * a;
    if (key >= skv) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int64_t at = key * HD + VEC * tc + 16 * VEC * c + e;
        store(&dkh[at], ak[a][c][e] * scale);
        store(&dvh[at], av[a][c][e]);
      }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int64_t sq, int64_t skv, int group, int causal,
                    float scale) {
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
  const T* kh = k + g * skv * HD;
  const T* vh = v + g * skv * HD;

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
  for (int64_t k0 = 0; k0 < hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's product has read k and dS
    stage<HD>(s_k, kh, k0, kBlockK, skv);
    stage<HD>(s_v, vh, k0, kBlockK, skv);
    __syncthreads();
    // P lands in s_ds first and is overwritten by dS in the same thread:
    // both are the same element, written in order by its one owner
    scores<HD>(s_q, s_do, s_k, s_v, s_lse, s_d, s_p, s_ds, q0, k0, skv,
               causal, scale);
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

  T* dqh = dq + bh * sq * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t row = q0 + tr + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(&dqh[row * HD + VEC * tc + 16 * VEC * c + e],
              acc[i][c][e] * scale);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const float* lse, const void* dout,
                   float* delta, void* dq, void* dk, void* dv, int64_t bh,
                   int64_t sq, int64_t skv, int group, int causal,
                   cudaStream_t stream) {
  using G = Geo<HD>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  const int64_t rows = bh * sq;
  flash_bwd_delta_kernel<HD, T>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
         kThreads, 0, stream>>>(static_cast<const T*>(out), tdo, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (skv > 0) {
    auto kdkdv = flash_bwd_dkdv_kernel<HD, T>;
    err = cudaFuncSetAttribute(kdkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(G::DKDV_SMEM));
    if (err != cudaSuccess) return err;
    const dim3 grid_kv(static_cast<unsigned>(bh / group),
                       static_cast<unsigned>((skv + kBlockK - 1) / kBlockK));
    kdkdv<<<grid_kv, kThreads, G::DKDV_SMEM, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, skv, group, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  auto kdq = flash_bwd_dq_kernel<HD, T>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::DQ_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>(bh),
                    static_cast<unsigned>((sq + G::BQ - 1) / G::BQ));
  kdq<<<grid_q, kThreads, G::DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), sq, skv, group,
      causal, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(bool bf16, const void* q, const void* k, const void* v,
                      const void* out, const float* lse, const void* dout,
                      float* delta, void* dq, void* dk, void* dv, int64_t bh,
                      int64_t sq, int64_t skv, int group, int causal,
                      cudaStream_t s) {
  return bf16 ? launch<HD, __nv_bfloat16>(q, k, v, out, lse, dout, delta, dq,
                                          dk, dv, bh, sq, skv, group, causal,
                                          s)
              : launch<HD, float>(q, k, v, out, lse, dout, delta, dq, dk, dv,
                                  bh, sq, skv, group, causal, s);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous q, out, dout, dq [bh, sq, hd], k, v, dk, dv
// [bh / group, skv, hd], all of one type (bf16 when `bf16`, else fp32), and
// fp32 lse and delta [bh, sq] (delta is scratch the kernel writes); the
// caller has checked shapes, types and contiguity.  Returns
// cudaGetLastError() after the last launch, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int64_t bh, int64_t sq, int64_t skv, int64_t hd, int64_t group,
    int causal, int bf16, void* stream) {
  if (bh < 0 || sq < 0 || skv < 0 || group < 1 || group > 0x7fffffff ||
      bh % group != 0 || bh > 0x7fffffff || (sq + 31) / 32 > 65535 ||
      (skv + kBlockK - 1) / kBlockK > 65535 ||
      (bh * sq + kThreads / 32 - 1) / (kThreads / 32) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(group);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (hd) {
    case 32:
      return static_cast<int>(launch_hd<32>(bf16 != 0, q, k, v, out, l, dout,
                                            d, dq, dk, dv, bh, sq, skv, g,
                                            causal, s));
    case 64:
      return static_cast<int>(launch_hd<64>(bf16 != 0, q, k, v, out, l, dout,
                                            d, dq, dk, dv, bh, sq, skv, g,
                                            causal, s));
    case 128:
      return static_cast<int>(launch_hd<128>(bf16 != 0, q, k, v, out, l,
                                             dout, d, dq, dk, dv, bh, sq, skv,
                                             g, causal, s));
    case 256:
      return static_cast<int>(launch_hd<256>(bf16 != 0, q, k, v, out, l,
                                             dout, d, dq, dk, dv, bh, sq, skv,
                                             g, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
