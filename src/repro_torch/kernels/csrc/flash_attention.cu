// flash_attention.cu: attention forward with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py:77 flash_attention
//   (body _flash_kernel), reached from repro.kernels.ops.flash_attention;
// in the model it computes what src/repro/models/layers.py::attention_apply
// evaluates with the jnp _attend_block (layers.py:112).
//
// For q [BH, Sq, HD] and k, v [BH / group, Skv, HD] it writes
//   out[bh, i] = sum_j softmax_j(q[bh, i] . k[g, j] / sqrt(HD)) v[g, j],
//   g = bh / group,
// over the keys j that query i sees: j <= i when causal, and i - j < window
// when window > 0.  With window = 0 and group = 1 that is the TPU kernel's
// function.  The two extensions are what the model needs: `window` is the
// local attention of RecurrentGemma's LOCAL layers, and `group` lets the
// query heads of one KV head (MQA, GQA) read it where it lies, with no copy
// of k and v.  A query row that sees no key at all gives zeros.
//
// Types: q, k and v fp32 or bf16 (one type); the output is in q's type.
// HD is 32, 64, 128 or 256 (a template argument); Sq and Skv are any
// lengths: the ragged edge of a tile is masked here, where the TPU kernel
// asserts that its blocks divide the sequence.  The input type picks one
// of two bodies.
//
// Training: where the caller passes `lse` (fp32 [BH, Sq]), both bodies also
// write each row's log-sum-exp, m + log l in natural units of the scaled
// scores (the bf16 body keeps m in log2 units and converts: (m + log2 l) *
// ln 2), or -inf for a row that sees no key; flash_attention_bwd.cu
// recomputes P = exp(scale * q.k - lse) from it.  Serving passes nullptr
// and writes nothing more.
//
// Bound: operations.  At the serving shape (q [40, 4096, 256] bf16, k, v
// [4, 4096, 256], window 2,048, group 10) the window leaves 251.7 M
// (query, key) pairs, 4 * 256 operations each: 257.7 GFLOP, 0.261 ms at
// the bf16 tensor-core rate of 989 TFLOP/s; the 184 MB read and written
// take 0.055 ms.
//
// bf16: the tensor cores (flash_attention_wgmma_kernel).  One CTA of three
// warpgroups per (query head, block of 128 query rows).  Warpgroup 0 is
// the producer: one thread loads the q block once and then the 64-key k
// and v tiles, from the first key the block's first row sees to the last
// key its last row sees, into a ring of 2 (HD 256) or 3 stages, by TMA
// (cp.async.bulk.tensor, 3-D maps [heads, rows, HD] built on the host, so
// rows past Sq or Skv read as zeros), each stage guarded by a "full" and
// an "empty" mbarrier.  Warpgroups 1 and 2 each own 64 query rows and run
// both products with wgmma, fp32 accumulators in registers:
//   S = Q K^T   m64n64k16, A (q) and B (k) K-major in shared memory;
//   O += P V    m64nHDk16, A (p) in registers, B (v) MN-major (the
//               transpose flag) in shared memory.
// Tiles are bf16, 64 (HD 32: 32) columns a box, 128-byte (64-byte) rows
// swizzled by TMA as wgmma reads them: q 128 x HD, k and v 64 x HD a
// stage, 192 KB at HD 256.  setmaxnreg moves registers from the producer
// (24) to the consumers (240), which hold O (HD / 2 fp32 a thread, 128 at
// HD 256), S (32) and the two halves of P.  Scores, the running max m, the
// sum l and O are fp32; exp2f with scale * log2(e) folded in; l sums the
// fp32 p.  P enters the product as two bf16 terms, p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), so P V keeps p to about 2^-17: one bf16 term
// alone would err by up to 2^-9 of each weight, which at the serving shape
// is 1e-4 on outputs near zero, more than the tolerance.  Only the tiles
// at the ends of a warpgroup's key range (the causal edge, the window's
// far edge, the ragged Skv) apply the element mask; keys past Skv score
// -inf.  Each consumer writes O / l as bf16 over its own (spent) q rows in
// shared memory and stores them with one TMA store a box, which drops
// rows past Sq.  No atomics: one CTA owns each output tile, so two
// launches on the same inputs are equal bit for bit.
//
// fp32: the CUDA cores (flash_attention_kernel), exact to 1e-4 of the
// plain version.  One CTA of 256 threads per (query head, block of 64
// query rows); it loops over the 64-key tiles that the causal window
// leaves, from the first key the block's first row sees to the last key
// its last row sees, so fully masked tiles at both ends are never loaded.
// The q block and each k and v tile are staged in shared memory as fp32,
// rows padded to HD + 4 floats, so that the float4 reads of 8 neighbouring
// rows fall on distinct banks: at HD = 256 that is 3 x 66,560 bytes plus
// a 64 x 65 probability tile, 216,320 bytes of dynamic shared memory
// (under the 227 KB a block may take, after cudaFuncSetAttribute).  The
// 256 threads form a 16 x 16 grid: thread (r, c) computes the scores of
// rows r + 16 i and keys c + 16 j (i, j < 4), and owns the output rows
// r + 16 i over HD / 16 columns, its fp32 accumulator (64 floats at
// HD = 256) in registers.  The 16 threads of a row are one half-warp, so
// the row max and sum of the online softmax are shuffles.  Both products
// run on the CUDA cores in fp32, probabilities unrounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = kBlockQ / 16;  // 4
constexpr int kKeysPerThread = kBlockK / 16;  // 4
constexpr int kLdP = kBlockK + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 4;
}

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((kBlockQ + 2 * kBlockK) * ld<HD>() + kBlockQ * kLdP);
}

// rows [row0, row0 + n) of a [len, HD] matrix into shared memory as fp32,
// rows past `len` as zeros
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row0, int n, int64_t len) {
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    const int64_t row = row0 + r;
    dst[r * ld<HD>() + c] = row < len ? to_f32(src[row * HD + c]) : 0.f;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int64_t sq, int64_t skv,
                       int group, int causal, int64_t window, float scale) {
  constexpr int LD = ld<HD>();
  // output columns of a thread: VEC adjacent ones in each of NV groups
  constexpr int VEC = HD / 16 < 4 ? HD / 16 : 4;
  constexpr int NV = HD / (16 * VEC);
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "HD");

  extern __shared__ float smem[];
  float* s_q = smem;                        // [kBlockQ][LD]
  float* s_k = s_q + kBlockQ * LD;          // [kBlockK][LD]
  float* s_v = s_k + kBlockK * LD;          // [kBlockK][LD]
  float* s_p = s_v + kBlockK * LD;          // [kBlockQ][kLdP]

  const int64_t bh = blockIdx.x;
  // the heaviest query blocks (last, under a causal mask) start first
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* qh = q + bh * sq * HD;
  const int64_t g = bh / group;
  const T* kh = k + g * skv * HD;
  const T* vh = v + g * skv * HD;

  // keys [lo, hi) hold every key some row of this block sees
  const int64_t q_last = min64(q0 + kBlockQ, sq) - 1;
  const int64_t hi = causal ? min64(skv, q_last + 1) : skv;
  const int64_t lo = window > 0 && q0 - window + 1 > 0 ? q0 - window + 1 : 0;

  float acc[kRowsPerThread][NV][VEC];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][c][e] = 0.f;
  }

  stage<HD>(s_q, qh, q0, kBlockQ, sq);

  for (int64_t k0 = lo; k0 < hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's products have read k, v and p
    stage<HD>(s_k, kh, k0, kBlockK, skv);
    stage<HD>(s_v, vh, k0, kBlockK, skv);
    __syncthreads();

    // scores of rows tr + 16 i against keys tc + 16 j
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[kRowsPerThread], kb[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            &s_q[(tr + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            &s_k[(tc + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax: masked keys get probability 0
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t row = q0 + tr + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int64_t key = k0 + tc + 16 * j;
        const bool seen = key < skv && (!causal || key <= row) &&
                          (window <= 0 || row - key < window);
        s[i][j] = seen ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        lt += p;
        s_p[(tr + 16 * i) * kLdP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      l[i] = l[i] * corr + lt;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

    // acc += p v over the tile's keys
    const int nk = static_cast<int>(min64(kBlockK, hi - k0));
    for (int j = 0; j < nk; ++j) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        p[i] = s_p[(tr + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float* vr = &s_v[j * LD + VEC * tc + 16 * VEC * c];
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vv[0] = t.x;
          vv[1] = t.y;
          vv[2] = t.z;
          vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vv[0] = t.x;
          vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][c][e] = fmaf(p[i], vv[e], acc[i][c][e]);
      }
    }
  }

  T* oh = out + bh * sq * HD;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = q0 + tr + 16 * i;
    if (row >= sq) continue;
    if (lse != nullptr && tc == 0)
      lse[bh * sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(&oh[row * HD + VEC * tc + 16 * VEC * c + e],
              acc[i][c][e] * inv);
  }
}

// ---- bf16: the tensor cores ------------------------------------------------

constexpr int kTcThreads = 384;  // a producer and two consumer warpgroups
constexpr int kTcBlockQ = 128;   // 64 query rows a consumer warpgroup
constexpr int kTcBlockK = 64;    // keys a tile
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared-memory geometry of one head size: hopper.cuh's boxes (64 rows by
// C columns, SW-byte rows swizzled as wgmma reads them), the ring's depth
// and the bytes of each tile.
template <int HD>
struct Tile : Box<HD> {
  using B = Box<HD>;
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = 2 * B::NCB * B::BYTES;   // 128 x HD
  static constexpr uint32_t KV_BYTES = B::NCB * B::BYTES;      // 64 x HD, k or v
  // 1024 bytes of slack to align the tiles, then q, k, v and 1 + 2 STAGES
  // mbarriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to,
                             float* __restrict__ lse, int64_t sq,
                             int64_t skv, int group, int causal,
                             int64_t window, float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;  // [2 halves][NCB] boxes
  const uint32_t s_k = s_q + T::Q_BYTES;       // [STAGES][NCB] boxes
  const uint32_t s_v = s_k + T::STAGES * T::KV_BYTES;
  const uint32_t bar_q = s_v + T::STAGES * T::KV_BYTES;
  const uint32_t bar_full = bar_q + 8;                   // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * T::STAGES;   // [STAGES]

  const int bh = blockIdx.x;
  // the heaviest query blocks (last, under a causal mask) start first
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kTcBlockQ;
  const int g = bh / group;
  // keys [lo, hi) hold every key some row of this block sees
  const int64_t q_last = min64(q0 + kTcBlockQ, sq) - 1;
  const int64_t hi = causal ? min64(skv, q_last + 1) : skv;
  const int64_t lo = window > 0 && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int tiles =
      hi > lo ? static_cast<int>((hi - lo + kTcBlockK - 1) / kTcBlockK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < T::STAGES; ++s) {
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
      mbar_expect_tx(bar_q, T::Q_BYTES);
      for (int h = 0; h < 2; ++h)
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(s_q + (h * T::NCB + cb) * T::BYTES, &tq, cb * T::C,
                   static_cast<int>(q0 + 64 * h), bh, bar_q);
      for (int t = 0; t < tiles; ++t) {
        const int st = t % T::STAGES;
        const int round = t / T::STAGES;
        // the consumers have released this stage's previous tile
        if (round > 0) mbar_wait(bar_empty + 8 * st, (round - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * T::KV_BYTES);
        const int k0 = static_cast<int>(lo + static_cast<int64_t>(t) *
                                                 kTcBlockK);
        for (int cb = 0; cb < T::NCB; ++cb) {
          const uint32_t off = (st * T::NCB + cb) * T::BYTES;
          tma_load(s_k + off, &tk, cb * T::C, k0, g, full);
          tma_load(s_v + off, &tv, cb * T::C, k0, g, full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 + h owns rows q0 + 64 h ... + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int h = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int64_t rows = q0 + 64 * h;                 // the half's first row
    const int64_t row = rows + 16 * warp + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);                   // and col + 1, + 8 j
    const uint32_t qh = s_q + h * T::NCB * T::BYTES;

    float o[HD / 2];  // O [64 x HD]: o[4 j + e] at row + 8 (e / 2),
                      // column 8 j + col + e % 2
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the sum

    if (tiles > 0) mbar_wait(bar_q, 0);
    for (int t = 0; t < tiles; ++t) {
      const int st = t % T::STAGES;
      const int64_t k0 = lo + static_cast<int64_t>(t) * kTcBlockK;
      mbar_wait(bar_full + 8 * st, (t / T::STAGES) & 1);

      // S = Q K^T over HD in steps of 16: s[4 j + e] at row + 8 (e / 2),
      // key k0 + 8 j + col + e % 2
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < T::NCB; ++cb)
#pragma unroll
        for (int kk = 0; kk < T::C / 16; ++kk)
          wgmma_ss(s,
                   desc(qh + cb * T::BYTES + 32 * kk, 16, 8 * T::SW, T::LAYOUT),
                   desc(s_k + (st * T::NCB + cb) * T::BYTES + 32 * kk, 16,
                        8 * T::SW, T::LAYOUT),
                   cb + kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // the element mask, on the tiles at the ends of the range only
      const bool edge = k0 + kTcBlockK > skv ||
                        (causal && k0 + kTcBlockK - 1 > rows) ||
                        (window > 0 && rows + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t r = row + 8 * (e / 2);
            const int64_t key = k0 + 8 * j + col + e % 2;
            const bool seen = key < skv && (!causal || key <= r) &&
                              (window <= 0 || r - key < window);
            if (!seen) s[4 * j + e] = -INFINITY;
          }
      }

      // online softmax; a row's 64 scores lie in the 4 threads of a quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float mu[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
        corr[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        s[i] = exp2f(fmaf(s[i], scale_log2, -mu[r]));  // -inf -> 0
        ls[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];

      // P as wgmma's A fragments, keys 16 kt ... + 15: the accumulator
      // layout of S is the register layout of A
      uint32_t p_hi[4][4], p_lo[4][4];
      split_bf16(s, p_hi, p_lo);

      // O += P V: v's rows are keys, HD contiguous, so B is MN-major
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const uint64_t dv = desc(s_v + st * T::KV_BYTES + kt * 16 * T::SW,
                                 T::BYTES, 8 * T::SW, T::LAYOUT);
        wgmma_rs(o, p_hi[kt], dv);
        wgmma_rs(o, p_lo[kt], dv);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive(bar_empty + 8 * st);
    }

    // O / l as bf16 over this half's q rows, laid out as TMA swizzles
    // them, then one TMA store a box (rows past Sq are dropped)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      // log-sum-exp of the row, natural units: m is in log2 units
      if (lse != nullptr && lane % 4 == 0 && row + 8 * r < sq)
        lse[static_cast<int64_t>(bh) * sq + row + 8 * r] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.69314718055994531f
                       : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = 8 * j + col;
        const uint32_t off =
            (16 * warp + lane / 4 + 8 * r) * T::SW + (c % T::C) * 2;
        const uint32_t swz = off ^ (((off >> 7) & (T::SW / 16 - 1)) << 4);
        const uint32_t v = pack_bf16(o[4 * j + 2 * r] * inv[r],
                                     o[4 * j + 2 * r + 1] * inv[r]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         qh + (c / T::C) * T::BYTES + swz),
                     "r"(v)
                     : "memory");
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + h) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int cb = 0; cb < T::NCB; ++cb)
        tma_store(&to, qh + cb * T::BYTES, cb * T::C, static_cast<int>(rows),
                  bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int64_t bh, int64_t sq, int64_t skv,
                   int group, int causal, int64_t window,
                   cudaStream_t stream) {
  auto kern = flash_attention_kernel<HD, T>;
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kBlockQ - 1) / kBlockQ));
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, skv, group,
      causal, window, 1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int64_t bh, int64_t sq,
                         int64_t skv, int group, int causal, int64_t window,
                         cudaStream_t stream) {
  if (skv == 0)  // no key at all: every row gives zeros (the wrapper
                 // fills lse with -inf)
    return cudaMemsetAsync(out, 0, static_cast<size_t>(bh * sq * HD) * 2,
                           stream);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;  // TMA needs 16-byte alignment
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<HD>(encode, &tq, q, bh, sq) ||
      !tensor_map<HD>(encode, &tk, k, bh / group, skv) ||
      !tensor_map<HD>(encode, &tv, v, bh / group, skv) ||
      !tensor_map<HD>(encode, &to, out, bh, sq))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_wgmma_kernel<HD>;
  constexpr size_t bytes = Tile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kTcBlockQ - 1) / kTcBlockQ));
  kern<<<grid, kTcThreads, bytes, stream>>>(
      tq, tk, tv, to, lse, sq, skv, group, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(bool bf16, const void* q, const void* k, const void* v,
                      void* out, float* lse, int64_t bh, int64_t sq,
                      int64_t skv, int group, int causal, int64_t window,
                      cudaStream_t s) {
  return bf16 ? launch_wgmma<HD>(q, k, v, out, lse, bh, sq, skv, group,
                                 causal, window, s)
              : launch<HD, float>(q, k, v, out, lse, bh, sq, skv, group,
                                  causal, window, s);
}

cudaError_t dispatch_hd(int64_t hd, bool bf16, const void* q, const void* k,
                        const void* v, void* out, float* lse, int64_t bh,
                        int64_t sq, int64_t skv, int group, int causal,
                        int64_t window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch_hd<32>(bf16, q, k, v, out, lse, bh, sq, skv,
                            group, causal, window, s);
    case 64:
      return launch_hd<64>(bf16, q, k, v, out, lse, bh, sq, skv,
                            group, causal, window, s);
    case 128:
      return launch_hd<128>(bf16, q, k, v, out, lse, bh, sq, skv,
                            group, causal, window, s);
    case 256:
      return launch_hd<256>(bf16, q, k, v, out, lse, bh, sq, skv,
                            group, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous q and out [bh, sq, hd] and k, v [bh / group, skv,
// hd], all of one type (bf16 when `bf16`, else fp32), and `lse` fp32 [bh,
// sq] or null; the caller has checked shapes, types and contiguity.  Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for a shape the kernel does not take,
// or cudaErrorMisalignedAddress for a bf16 pointer off 16 bytes (TMA).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int64_t bh, int64_t sq, int64_t skv,
                                      int64_t hd,
                                      int64_t group, int causal,
                                      int64_t window, int bf16,
                                      void* stream) {
  if (bh < 0 || sq < 0 || skv < 0 || window < 0 || group < 1 ||
      group > 0x7fffffff || bh % group != 0 || bh > 0x7fffffff ||
      skv > 0x7fffffff || (sq + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(group);
  return static_cast<int>(dispatch_hd(hd, bf16 != 0, q, k, v, out,
                                      static_cast<float*>(lse), bh, sq, skv,
                                      g, causal, window, s));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
