// rwkv6_scan_bwd.cu: the gradient of the chunked RWKV6 recurrence
// (rwkv6_scan.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The TPU kernel it pairs with,
// src/repro/kernels/rwkv6_scan.py:69 rwkv6_chunked, has no backward: the
// reference trains through XLA's gradient of its jnp chunk form
// (src/repro/models/rwkv6.py:125 chunk_body under lax.scan, :160
// time_mix_apply).  This kernel is the port's own, so that a loss taken
// through the hand-written forward gets its gradient from the card.
//
// For every (batch b, head h), with r, k, v, logw [B, H, S, hd], u [H, hd],
// the state S_c entering each chunk c of C tokens and S'_c leaving it (the
// forward's state0, its scratch states and its final state), and the
// gradients dout [B, H, S, hd] and dS'_{n-1} = dstate_out [B, H, hd, hd]
// (fp32), with the chunk's log-decay sums formed as the forward forms them
// (logP_i, logP_{j+1}, logP_C; rwkv6_scan.cu's header), E_ij = e^{logP_i -
// logP_{j+1}} (j < i), DP_ij = dout_i . v_j and A the forward's matrix:
//   dS_c    = e^{logP_C} (.)rows dS'_c + (r (.) e^{logP})^T dout,
//             dS'_{c-1} = dS_c, dstate0 = dS_0
//   dr'_i   = e^{logP_i} (.) (S_c dout_i) + sum_{j<i} DP_ij k_j (.) E_ij
//   dk'_j   = sum_{i>j} DP_ij r_i (.) E_ij
//             + e^{logP_C - logP_{j+1}} (.) (dS'_c v_j)
//   dr      = dr' + u (.) k DP_ii,   dk = dk' + u (.) r DP_jj
//   dv_j    = sum_{i>=j} A_ij dout_i
//             + (k_j (.) e^{logP_C - logP_{j+1}})^T dS'_c
//   dlogw_m = sum_e dS'_c (.) S'_c + sum_{i>m} r_i (.) dr'_i
//             - sum_{j>=m} k_j (.) dk'_j                       (within c)
//   du      = sum_{b, i} r_i (.) k_i DP_ii
// (kernels/ref.py rwkv6_chunked_bwd_ref derives the last: logw_m enters
// logP_i for i > m, logP_{j+1} for j >= m and logP_C, and every term that
// holds one of those exponentials also holds r_i, k_j or S'_c).
//
// Types: r, k, v, u fp32 or bf16 (one type), logw fp32 or bf16; every sum
// is fp32; dr, dk, dv and du come out in r's type, dlogw in logw's, dstate0
// fp32.  hd is 32 or 64 and C any value in [1, 64] that divides S, as the
// forward takes.  Every pointer but u's is 16-byte aligned (the wrapper
// copies one that is not).
//
// Design: the forward's machinery (rwkv6_scan.cu) applied to the gradient.
// Three launches, no atomics (a second launch equals the first bit for bit):
//   * Pass A (rwkv6_bwd_state_kernel), the reverse state pass.  A CTA of
//     256 threads walks the chunks of one (b, h) from the last to the first
//     and owns ROWS rows of dS; the rows are independent (row d reads only
//     column d of r e^{logP} and e^{logP_C}[d]), so a (b, h) is split over
//     hd / ROWS CTAs: at most 32 rows a CTA, then the fewest (ROWS >= 16)
//     that keep B * H * hd / ROWS CTAs within the SM count; two CTAs of 32
//     rows a head at the training shape (B * H = 64 on 132 SMs), at the
//     cost of a second read of dout.  Warp-specialised: each of four load
//     warps takes every fourth chunk with a stage of r and logw (this CTA's
//     columns, by cp.async, fetched while the other three work) and an r~
//     buffer of its own, and walks down its chunk's rows once, a column a
//     lane, forming the log-decay sums in row order and r~ = r (.) e^{logP}
//     as it goes, then e^{logP_C}; four tensor warps stage dout two chunks
//     ahead, hold dS in their mma accumulators, write the gradient leaving
//     each chunk to the scratch dstates [B, H, n, hd, hd] and update dS <-
//     e^{logP_C} (.)rows dS + r~^T dout; named barriers hand each r~ buffer
//     from its load warp to the tensor warps and back (the sums are serial
//     in the rows, so a single load warp would bound the walk).  Shared
//     memory at hd = 64, ROWS = 32, bf16 r, fp32 logw: the four stages 4 x
//     12,288, dout 2 x 17,408 (rows of hd + 4 floats), r~ 4 x 9,360 (65
//     rows of ROWS + 4): 121,408 bytes.
//   * Pass B (rwkv6_bwd_chunk_kernel), a chunk a CTA of 8 warps (4,096 CTAs
//     at the training shape, two an SM).  It stages r, k, v (their own
//     type), dout and dS'_c by cp.async; the first hd threads stage logw
//     and form the log-decay sums as the forward does as soon as it is in,
//     while the others form the tail sum_e dS'_c (.) S'_c.  The chunk is
//     cut into blocks I of 16 rows with reference points that keep every
//     exponent <= 0: ref_I = logP at I's first row, ref'_I = logP_{j+1} at
//     its last row:
//       dr'_I = e^{logP_I - ref_I} (.) [dout_I (S_c (.)rows e^{ref_I})^T
//               + DP_{I,<I} (k_{<I} (.) e^{ref_I - logP_{<I,j+1}})]
//       dk'_I = e^{ref'_I - logP_{I,j+1}} (.) [v_I (dS'_c (.)rows
//               e^{logP_C - ref'_I})^T + DP_{>I,I}^T R'_{>I}],
//               R'_i = r_i (.) e^{logP_i - ref'_I}
//       A_{>I,I} = R'_{>I} K'_I^T, K'_I = k_I (.) e^{ref'_I - logP_{I,j+1}}
//       dv_I  = A_{>=I,I}^T dout_{>=I} + (K'_I (.) e^{logP_C - ref'_I}) dS'_c
//     The diagonal 16 x 16 block is cut at its 8th row, as the forward
//     cuts it: its lower-left 8 x 8 block is factored at ref8 = logP at
//     that row for A, dr' and dk' alike, and only its two diagonal 8 x 8
//     halves keep the pairwise e^{logP_i - logP_{j+1}} on the CUDA cores
//     (224 pairs a chunk of 64 against 2,016), the bonus on A's diagonal;
//     a lane takes one row of each half, seven pairs in all.  Every product
//     is an mma.sync on the tensor cores: DP^T is formed a tile of 8 at a
//     time and fed, in the accumulator layout, as the A operand of the next
//     product.  Phases, split by __syncthreads:
//       P3 (dS'_c in the state buffer): warp J < 4 takes dk of block J
//         (the diagonal block's DP^T, kept for the pairwise terms, dr and
//         du; the pairwise terms of dk' and of A's diagonal block, handed
//         to the dv warp by named barrier 1 + J; DP's blocks below the
//         diagonal, kept for dr; the rest of dk'); warp 7 - J takes dv of
//         block J.  Warps w and w + 4 share an SM sub-partition and take
//         blocks J and 3 - J, whose work adds up to about the same.
//       P4 (S_c loaded into the state buffer behind the work that does not
//         read it; y = k (.) dk' in v's place): two warps a block, each
//         with half of dr's columns.
//       Then x = r (.) dr' goes to shared memory in logP_i's place, and
//       dlogw is summed from the chunk's last row up, run = tail, run -=
//       y_m, dlogw_m = run, run += x_m, a thread a column; du's partial sum
//       a chunk beside it.
//     Shared memory at hd = 64, bf16: r, k, v 3 x 9,216 (rows of hd + 8),
//     dout, logP_i, logP_{j+1} and the state buffer (dS'_c, then S_c) 4 x
//     17,408 (rows of hd + 4 floats), the diagonal blocks of DP and A 2 x
//     4,352 and DP's six blocks below them 6,144, u and the tail 2 x 256,
//     y over v, A's blocks and 2,816 bytes more: 115,456 bytes, two CTAs an
//     SM (fp32 r, k, v: 137,216, one).
//   * Pass C (rwkv6_bwd_du_kernel): du = the partials summed over b and the
//     chunks in order, a thread a (h, column).
// Products: mma.sync m16n8k8 TF32 with fp32 accumulators; every fp32
// operand is split into a high and a low TF32 part (by masking: sm_90 takes
// cvt.rna.tf32 in several instructions) and each product is three (lo.hi +
// hi.lo + hi.hi); an operand that is a widened bf16 value (v as bf16) is
// exact in TF32 and takes two.  One term keeps 2^-11 of an operand and
// parts from the plain version by ~5e-4 of a gradient's largest entry
// (tests/test_torch_rwkv6_bwd.py).
//
// Bound: bytes.  Reading r, k, v (bf16), logw and dout (fp32), the states
// (state0, the n - 1 scratch states and the final state) once and writing
// dr, dk, dv (bf16), dlogw (fp32) and dstate0 once: at the training path's
// [1, 64, 4096, 64] with C = 64, 470 MB, 0.140 ms at 3.35 TB/s; its
// products (8 C hd^2 + 6 C^2 hd operations a chunk, 15.0 G) take 0.030 ms
// at the TF32 tensor-core rate.  The design adds the scratch dS (67 MB
// written and read), pass A's second read of dout, the states read twice
// (S'_c of chunk c is S_c of chunk c + 1) and the three TF32 terms of each
// fp32 product.  No PyTorch call computes this function, so there is no
// library yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;        // pass A: each of its two warp groups
constexpr int kWarps = kThreads / 32;
constexpr int kChunkThreads = 256;   // pass B: 8 warps
constexpr int kMaxChunk = 64;
constexpr int kRows = 16;            // a block of the chunk; mma's m
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// two consecutive values (8- or 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// e^x for a log decay x (<= 0 up to rounding): one ex2.approx (2 ulp), its
// results below 2^-126 flushed to 0, as the forward's decay()
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// The log-decay sums of one column as the plain version forms them (a
// running sum in row order): from logw_m = w[m * ldw], p[m] = logP_m =
// cumsum_m - logw_m and q[m] = logP_{m+1} = logP_m + logw_m for m < chunk.
// Rows [chunk, pad) of p and q are set to logP_C.  w may be q itself (ldw =
// ld); p may be null.  A copy of rwkv6_scan.cu's log_decays.
template <typename TW>
__device__ __forceinline__ void log_decays(const TW* w, int ldw, float* p,
                                           float* q, int ld, int chunk,
                                           int pad) {
  constexpr int kBatch = 16;   // rows loaded together, then summed in order
  float run = 0.0f;
  for (int m0 = 0; m0 < chunk; m0 += kBatch) {
    float lw[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      lw[i] = m0 + i < chunk ? to_f32(w[(m0 + i) * ldw]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (m0 + i < chunk) {
        run += lw[i];
        const float lp = run - lw[i];
        if (p != nullptr) p[(m0 + i) * ld] = lp;
        q[(m0 + i) * ld] = lp + lw[i];
      }
    }
  }
  const float total = q[(chunk - 1) * ld];
  for (int m = chunk; m < pad; ++m) {
    if (p != nullptr) p[m * ld] = total;
    q[m * ld] = total;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, two TF32 values by masking: hi rounded to nearest (ties
// away from zero, as cvt.rna.tf32.f32, which sm_90 takes in several
// instructions), x - hi exact in fp32 and lo its high 19 bits (the error is
// below 2^-22 of x)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b, one m16n8k8 TF32 product.  Fragments (g = lane / 4, t = lane %
// 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n
// g), b1 (k t + 4, n g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, 2t, 2t + 1).
// An accumulator tile is the A fragment of the next product with its k
// order permuted (slot t <-> column 2t, slot t + 4 <-> 2t + 1: a = {d0, d2,
// d1, d3}); that product's B rows are then taken in the same order.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment from four values: TF32 hi + lo parts, or the bits of a
// widened bf16 value (exact in TF32; lo is then not read)
template <bool kExact>
__device__ __forceinline__ void frag(const float (&a)[4], uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kExact) {
      hi[e] = __float_as_uint(a[e]);
      lo[e] = 0u;
    } else {
      split(a[e], hi[e], lo[e]);
    }
  }
}

// d += a b: three products (lo.hi + hi.lo + hi.hi), two where a is a
// widened bf16 value
template <bool kExactA>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  if constexpr (!kExactA) mma(d, alo, h0, h1);
  mma(d, ahi, l0, l1);
  mma(d, ahi, h0, h1);
}

// a widened bf16 value is exact in TF32
template <typename T>
constexpr bool kExactTf32 = std::is_same<T, __nv_bfloat16>::value;

// zero rows [first, last) of a row-major shared array of `row_bytes` rows,
// thread `id` of `n` threads
__device__ __forceinline__ void zero_rows(void* base, int row_bytes,
                                          int first, int last, int id,
                                          int n) {
  uint4* p = reinterpret_cast<uint4*>(static_cast<unsigned char*>(base) +
                                      first * row_bytes);
  for (int i = id; i < (last - first) * row_bytes / 16; i += n) {
    p[i] = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Pass A: the gradient leaving every chunk, and dstate0
// ---------------------------------------------------------------------------

// Pass A's load warps: each takes every fourth chunk, with a stage of r and
// logw and an r~ buffer of its own
constexpr int kLoadWarps = 4;

// The shared arrays of pass A; offsets are multiples of 16 bytes.
template <int HD, int ROWS, typename T, typename TW>
struct StateSmem {
  static constexpr int LDD = HD + 4;     // dout rows (fp32)
  static constexpr int LDK = ROWS + 4;   // r~ rows (fp32)
  static constexpr size_t r_bytes = sizeof(T) * kMaxChunk * ROWS;
  static constexpr size_t rw_bytes =     // a load warp's stage of r and logw
      r_bytes + sizeof(TW) * kMaxChunk * ROWS;
  static constexpr size_t do_bytes = sizeof(float) * kMaxChunk * LDD;
  static constexpr size_t rt_bytes = sizeof(float) * (kMaxChunk + 1) * LDK;
  static constexpr size_t rw = 0;                       // [4] r, logw
  static constexpr size_t dout = rw + kLoadWarps * rw_bytes;   // [2]
  static constexpr size_t rt = dout + 2 * do_bytes;     // [4] r~ [64][LDK],
                                                        // e^{logP_C} in row 64
  static constexpr size_t bytes = rt + kLoadWarps * rt_bytes;
};

// Named barriers of pass A (0 is __syncthreads): r~ buffer b ready for the
// tensor warps (kBarFull + b), read by them (kBarEmpty + b), b < 4; the
// tensor warps' own (kBarMma).
constexpr int kBarFull = 1, kBarEmpty = 5, kBarMma = 9;
constexpr int kHandoff = kThreads + 32;   // a load warp and the tensor warps

template <int HD, int ROWS, typename T, typename TW>
__global__ void __launch_bounds__(2 * kThreads, 1)
rwkv6_bwd_state_kernel(const T* __restrict__ r, const TW* __restrict__ logw,
                       const float* __restrict__ dout,
                       const float* __restrict__ dstate_out,
                       float* __restrict__ dstates,
                       float* __restrict__ dstate0, int64_t seq, int chunk,
                       int n_chunks) {
  using L = StateSmem<HD, ROWS, T, TW>;
  constexpr int LDD = L::LDD, LDK = L::LDK;
  constexpr int SPLITS = HD / ROWS;
  constexpr int RB = ROWS / kRows;       // 16-row blocks of this CTA's dS
  constexpr int WB = kWarps / RB;        // tensor warps a row block
  constexpr int NT = HD / 8 / WB;        // n-tiles (8 columns of dS) a warp
  constexpr int CL = (ROWS + 31) / 32;   // columns a load lane
  constexpr int ET = 16 / sizeof(T), EW = 16 / sizeof(TW);  // a copy's elements
  static_assert(HD == 32 || HD == 64, "hd must be 32 or 64");
  static_assert(ROWS % kRows == 0 && ROWS <= 32 && WB >= 1 && NT >= 1,
                "rows a CTA");

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage_r = [&](int b) {
    return reinterpret_cast<T*>(smem + L::rw + b * L::rw_bytes);
  };
  auto stage_w = [&](int b) {
    return reinterpret_cast<TW*>(smem + L::rw + b * L::rw_bytes + L::r_bytes);
  };
  auto stage_do = [&](int b) {
    return reinterpret_cast<float*>(smem + L::dout + b * L::do_bytes);
  };
  auto stage_rt = [&](int b) {
    return reinterpret_cast<float*>(smem + L::rt + b * L::rt_bytes);
  };

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / SPLITS;
  const int d_lo = static_cast<int>(blockIdx.x % SPLITS) * ROWS;
  const int64_t square = static_cast<int64_t>(HD) * HD;
  const int cpad = (chunk + 7) & ~7;   // k-steps of 8 rows
  // step s walks chunk n - 1 - s
  auto rows_of = [&](int s) {          // first element of step s's chunk
    return (bh * seq + static_cast<int64_t>(n_chunks - 1 - s) * chunk) * HD;
  };

  if (tid >= kThreads) {
    // The load warps: warp w takes steps w, w + 4, ...: it stages r and
    // logw (this CTA's columns) for its next step while the other three
    // form theirs, then forms the chunk's log-decay sums and r~ = r (.)
    // e^{logP} in one walk down the rows (a column a lane; zero past the
    // chunk) and e^{logP_C}, and hands the buffer to the tensor warps
    const int lw = (tid - kThreads) >> 5, lane = tid & 31;
    T* sr = stage_r(lw);
    TW* sw = stage_w(lw);
    float* rt = stage_rt(lw);
    auto load_rw = [&](int s) {
      if (s < n_chunks) {
        const int64_t base = rows_of(s) + d_lo;
        for (int i = lane; i < chunk * (ROWS / ET); i += 32) {
          const int m = i / (ROWS / ET), q = (i % (ROWS / ET)) * ET;
          cp_async16(sr + m * ROWS + q,
                     r + base + static_cast<int64_t>(m) * HD + q);
        }
        for (int i = lane; i < chunk * (ROWS / EW); i += 32) {
          const int m = i / (ROWS / EW), q = (i % (ROWS / EW)) * EW;
          cp_async16(sw + m * ROWS + q,
                     logw + base + static_cast<int64_t>(m) * HD + q);
        }
      }
      cp_async_commit();
    };
    load_rw(lw);
    for (int s = lw; s < n_chunks; s += kLoadWarps) {
      cp_async_wait<0>();   // this step's r and logw
      __syncwarp();
      if (s >= kLoadWarps) bar_sync(kBarEmpty + lw, kHandoff);   // s − 4 read
#pragma unroll
      for (int cc = 0; cc < CL; ++cc) {
        const int d = lane + 32 * cc;
        if (d < ROWS) {
          // the plain version's sums, in row order: run += logw_i, logP_i =
          // run − logw_i, logP_C = logP_{C−1} + logw_{C−1}
          float run = 0.0f, lp = 0.0f, lwi = 0.0f;
          for (int i = 0; i < chunk; ++i) {
            lwi = to_f32(sw[i * ROWS + d]);
            run += lwi;
            lp = run - lwi;
            rt[i * LDK + d] = to_f32(sr[i * ROWS + d]) * decay(lp);
          }
          for (int i = chunk; i < cpad; ++i) rt[i * LDK + d] = 0.0f;
          rt[kMaxChunk * LDK + d] = decay(lp + lwi);
        }
      }
      __syncwarp();   // the warp is done with its stage
      bar_arrive(kBarFull + lw, kHandoff);
      load_rw(s + kLoadWarps);
    }
    cp_async_wait<0>();
    return;
  }

  // The tensor warps: warp m owns rows d0 .. d0 + 15 of this CTA's rows of
  // dS and NT n-tiles from column e0, in the accumulator layout.  dout is
  // staged two chunks ahead; its rows past the chunk stay zero.
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int d0 = (warp / WB) * kRows, e0 = (warp % WB) * NT * 8;
  auto load_do = [&](int s) {
    if (s < n_chunks) {
      float* sd = stage_do(s & 1);
      const int64_t base = rows_of(s);
      for (int i = tid; i < chunk * (HD / 4); i += kThreads) {
        const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
        cp_async16(sd + m * LDD + q,
                   dout + base + static_cast<int64_t>(m) * HD + q);
      }
    }
    cp_async_commit();
  };
  for (int b = 0; b < 2; ++b) {
    zero_rows(stage_do(b), LDD * sizeof(float), chunk, kMaxChunk, tid,
              kThreads);
  }
  load_do(0);
  load_do(1);

  const int ra = d_lo + d0 + g, rb = ra + 8;   // this lane's rows of dS
  float st[NT][4];
  const float* ds1 = dstate_out + bh * square;
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int e = e0 + q * 8 + 2 * t;
    const float2 lo = load2(ds1 + ra * HD + e);
    const float2 hi = load2(ds1 + rb * HD + e);
    st[q][0] = lo.x;
    st[q][1] = lo.y;
    st[q][2] = hi.x;
    st[q][3] = hi.y;
  }
  for (int s = 0; s < n_chunks; ++s) {
    const int b = s % kLoadWarps;
    cp_async_wait<1>();   // this chunk's dout
    bar_sync(kBarMma, kThreads);
    // the gradient leaving chunk c
    float* dst =
        dstates + (bh * n_chunks + (n_chunks - 1 - s)) * square;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int e = e0 + q * 8 + 2 * t;
      store2(dst + ra * HD + e, st[q][0], st[q][1]);
      store2(dst + rb * HD + e, st[q][2], st[q][3]);
    }
    bar_sync(kBarFull + b, kHandoff);   // r~ of chunk c
    const float* rt = stage_rt(b);
    const float dec_a = rt[kMaxChunk * LDK + d0 + g];   // e^{logP_C}
    const float dec_b = rt[kMaxChunk * LDK + d0 + g + 8];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      st[q][0] *= dec_a;
      st[q][1] *= dec_a;
      st[q][2] *= dec_b;
      st[q][3] *= dec_b;
    }
    // dS += r~^T dout: A = r~^T (16 rows of dS x the chunk), B = dout, the
    // k order of each 8-row step permuted (slot t <-> row 2t, t + 4 <-> 2t + 1)
    const float* sd = stage_do(s & 1);
    for (int j0 = 0; j0 < cpad; j0 += 8) {
      const float* ka = rt + (j0 + 2 * t) * LDK + d0;
      const float* kb = ka + LDK;
      const float a[4] = {ka[g], ka[g + 8], kb[g], kb[g + 8]};
      uint32_t ahi[4], alo[4];
      frag<false>(a, ahi, alo);
      const float* vp = sd + (j0 + 2 * t) * LDD + e0 + g;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        mma3<false>(st[q], ahi, alo, vp[q * 8], vp[LDD + q * 8]);
      }
    }
    if (s + kLoadWarps < n_chunks) bar_arrive(kBarEmpty + b, kHandoff);
    bar_sync(kBarMma, kThreads);   // every tensor warp is done with this dout
    load_do(s + 2);
  }

  float* ds0 = dstate0 + bh * square;
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int e = e0 + q * 8 + 2 * t;
    store2(ds0 + ra * HD + e, st[q][0], st[q][1]);
    store2(ds0 + rb * HD + e, st[q][2], st[q][3]);
  }
}

// ---------------------------------------------------------------------------
// Pass B: every chunk's dr, dk, dv, dlogw and partial du
// ---------------------------------------------------------------------------

template <int HD, typename T>
struct ChunkSmem {
  static constexpr int LDT = HD + 16 / sizeof(T);   // r, k, v rows (T)
  static constexpr int LDF = HD + 4;                // fp32 rows
  static constexpr int LDB = kRows + 1;             // diagonal blocks' rows
  static constexpr int kBelow = 6;                  // 16 x 16 blocks of DP
                                                    // below the diagonal
  static constexpr size_t t_bytes = sizeof(T) * kMaxChunk * LDT;
  static constexpr size_t f_bytes = sizeof(float) * kMaxChunk * LDF;
  static constexpr size_t b_bytes =
      sizeof(float) * (kMaxChunk / kRows) * kRows * LDB;
  static constexpr size_t r = 0;
  static constexpr size_t k = r + t_bytes;
  static constexpr size_t dout = k + t_bytes;     // [64][LDF]
  static constexpr size_t lp = dout + f_bytes;    // [64][LDF] logP_i
  static constexpr size_t lq = lp + f_bytes;      // [64][LDF] logP_{j+1}
  static constexpr size_t s = lq + f_bytes;       // [HD][LDF] dS'_c, then S_c
  static constexpr size_t dpd = s + sizeof(float) * HD * LDF;  // [4][16][LDB]
  static constexpr size_t dpo = dpd + b_bytes;    // [6][16][16] DP[i][j]
  static constexpr size_t u = dpo + sizeof(float) * kBelow * kRows * kRows;
  static constexpr size_t tail = u + sizeof(float) * HD;   // [HD]
  static constexpr size_t v = tail + sizeof(float) * HD;   // [64][LDT]
  static constexpr size_t ad = v + t_bytes;       // [4][16][LDB]
  // from P4 on, y [64][HD] fp32 in v's and A's place; at the end, x
  // [64][HD] in logP_i's
  static constexpr size_t y = v;
  static constexpr size_t y_end = y + sizeof(float) * kMaxChunk * HD;
  static constexpr size_t bytes = ad + b_bytes > y_end ? ad + b_bytes : y_end;
  static_assert(sizeof(float) * kMaxChunk * HD <= f_bytes, "x");
};

// DP's block (I, J), J < I, of the six below the diagonal
__host__ __device__ constexpr int below(int I, int J) {
  return I * (I - 1) / 2 + J;
}

template <int HD, typename T, typename TW>
__global__ void __launch_bounds__(kChunkThreads, kExactTf32<T> ? 2 : 1)
rwkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const TW* __restrict__ logw,
                       const T* __restrict__ u,
                       const float* __restrict__ state0,
                       const float* __restrict__ states,
                       const float* __restrict__ state_out,
                       const float* __restrict__ dout,
                       const float* __restrict__ dstates, T* __restrict__ dr,
                       T* __restrict__ dk, T* __restrict__ dv,
                       TW* __restrict__ dlogw, float* __restrict__ du_part,
                       int heads, int64_t seq, int chunk, int n_chunks) {
  using L = ChunkSmem<HD, T>;
  constexpr int LDT = L::LDT, LDF = L::LDF, LDB = L::LDB;
  constexpr int NK = HD / 8;     // k-steps over hd; n-tiles of a whole row
  constexpr int NH = NK / 2;     // n-tiles of half a row
  constexpr int ET = 16 / sizeof(T);
  constexpr int kAfter = (kMaxChunk - kRows) / 8;   // tiles after a block
  constexpr bool kX = kExactTf32<T>;
  static_assert(HD == 32 || HD == 64, "hd must be 32 or 64");
  static_assert(kChunkThreads == 8 * 32, "8 warps");

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_r = reinterpret_cast<T*>(smem + L::r);            // [64][LDT]
  T* s_k = reinterpret_cast<T*>(smem + L::k);            // [64][LDT]
  T* s_v = reinterpret_cast<T*>(smem + L::v);            // [64][LDT]
  float* s_do = reinterpret_cast<float*>(smem + L::dout);
  float* s_lp = reinterpret_cast<float*>(smem + L::lp);  // logP_i
  float* s_lq = reinterpret_cast<float*>(smem + L::lq);  // logP_{j+1}
  float* s_s = reinterpret_cast<float*>(smem + L::s);    // dS'_c, then S_c
  float* s_dpd = reinterpret_cast<float*>(smem + L::dpd);  // DP[i][j] a block
  float* s_dpo = reinterpret_cast<float*>(smem + L::dpo);  // DP below those
  float* s_ad = reinterpret_cast<float*>(smem + L::ad);    // A[i][j] a block
  float* s_u = reinterpret_cast<float*>(smem + L::u);
  float* s_tail = reinterpret_cast<float*>(smem + L::tail);

  const int tid = threadIdx.x;
  const int wid = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x / n_chunks;
  const int c = static_cast<int>(blockIdx.x % n_chunks);
  const int h = static_cast<int>(bh % heads);
  const int C = chunk;
  const int npad = (C + kRows - 1) / kRows * kRows;   // rows of the blocks
  const int64_t base = (bh * seq + static_cast<int64_t>(c) * C) * HD;
  const int64_t square = static_cast<int64_t>(HD) * HD;
  const float* enter =
      c == 0 ? state0 + bh * square
             : states + (bh * (n_chunks - 1) + c - 1) * square;
  const float* leave = c == n_chunks - 1
                           ? state_out + bh * square
                           : states + (bh * (n_chunks - 1) + c) * square;
  const float* dleave = dstates + (bh * n_chunks + c) * square;

  // 1. stage: logw (into logP_{j+1}'s rows) by the warps that sum it
  //    (threads < hd), dS'_c by the others, r, k, v and dout by all; rows
  //    of the blocks past the chunk are zero.  The first warps form the
  //    log-decay sums as soon as logw is in, the others the tail sum_e
  //    dS'_c (.) S'_c (a warp a row) as soon as dS'_c is, the S'_c entries
  //    it reads fetched to registers meanwhile
  constexpr int kSumThreads = HD;
  constexpr int kTailWarps = (kChunkThreads - kSumThreads) / 32;
  constexpr int kTailRows = (HD + kTailWarps - 1) / kTailWarps;
  constexpr int kTailCols = HD / 32;
  const bool sums = tid < kSumThreads;
  const int tw = wid - kSumThreads / 32;   // a tail warp's rank
  if (sums) {
    if constexpr (std::is_same<TW, float>::value) {
      for (int i = tid; i < C * (HD / 4); i += kSumThreads) {
        const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
        cp_async16(s_lq + m * LDF + q,
                   logw + base + static_cast<int64_t>(m) * HD + q);
      }
    } else {
      for (int i = tid; i < C * HD; i += kSumThreads) {
        s_lq[(i / HD) * LDF + i % HD] = to_f32(logw[base + i]);
      }
    }
  } else {
    for (int i = tid - kSumThreads; i < HD * (HD / 4);
         i += kChunkThreads - kSumThreads) {
      const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
      cp_async16(s_s + m * LDF + q, dleave + m * HD + q);
    }
  }
  cp_async_commit();
  for (int i = tid; i < C * (HD / ET); i += kChunkThreads) {
    const int m = i / (HD / ET), q = (i % (HD / ET)) * ET;
    const int64_t src = base + static_cast<int64_t>(m) * HD + q;
    cp_async16(s_r + m * LDT + q, r + src);
    cp_async16(s_k + m * LDT + q, k + src);
    cp_async16(s_v + m * LDT + q, v + src);
  }
  for (int i = tid; i < C * (HD / 4); i += kChunkThreads) {
    const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
    cp_async16(s_do + m * LDF + q,
               dout + base + static_cast<int64_t>(m) * HD + q);
  }
  cp_async_commit();
  zero_rows(s_r, LDT * sizeof(T), C, npad, tid, kChunkThreads);
  zero_rows(s_k, LDT * sizeof(T), C, npad, tid, kChunkThreads);
  zero_rows(s_v, LDT * sizeof(T), C, npad, tid, kChunkThreads);
  zero_rows(s_do, LDF * sizeof(float), C, npad, tid, kChunkThreads);
  for (int d = tid; d < HD; d += kChunkThreads) {
    s_u[d] = to_f32(u[static_cast<int64_t>(h) * HD + d]);
  }
  if (sums) {
    cp_async_wait<1>();   // this thread's part of logw
    bar_sync(5, kSumThreads);
    log_decays(s_lq + tid, LDF, s_lp + tid, s_lq + tid, LDF, C, npad);
  } else {
    float sp[kTailRows][kTailCols];   // S'_c rows tw + kTailWarps m
#pragma unroll
    for (int m = 0; m < kTailRows; ++m) {
      const int d = tw + kTailWarps * m;
#pragma unroll
      for (int q = 0; q < kTailCols; ++q)
        sp[m][q] = d < HD ? leave[d * HD + lane + 32 * q] : 0.0f;
    }
    cp_async_wait<1>();   // this thread's part of dS'_c
    bar_sync(6, kChunkThreads - kSumThreads);
#pragma unroll
    for (int m = 0; m < kTailRows; ++m) {
      const int d = tw + kTailWarps * m;
      if (d < HD) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < kTailCols; ++q)
          acc = fmaf(s_s[d * LDF + lane + 32 * q], sp[m][q], acc);
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) s_tail[d] = acc;
      }
    }
  }
  cp_async_wait<0>();   // r, k, v, dout
  __syncthreads();

  const float* tot = s_lq + (C - 1) * LDF;   // logP_C
  uint32_t ah[4], al[4];
  float y[NK][4];   // k (.) dk' of a dk warp's block, kept to the end

  // 2. P3: dk of block J on warp J, dv of block J on warp 7 − J
  if (wid < 4) {
    const int J = wid, j0 = kRows * J;
    if (j0 < npad) {
      const int ja = j0 + g, jb = ja + 8;
      const float* refp = s_lq + (j0 + kRows - 1) * LDF;   // ref'_J
      float* dpd = s_dpd + J * kRows * LDB;
      float* ad = s_ad + J * kRows * LDB;
      // (a) DP^T of the diagonal block (rows j, columns i), into dpd as
      //     DP[i][j]
      float dd[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        const int e = ks * 8 + t;
        const float a[4] = {to_f32(s_v[ja * LDT + e]), to_f32(s_v[jb * LDT + e]),
                            to_f32(s_v[ja * LDT + e + 4]),
                            to_f32(s_v[jb * LDT + e + 4])};
        frag<kX>(a, ah, al);
#pragma unroll
        for (int y2 = 0; y2 < 2; ++y2) {
          const float* di = s_do + (j0 + 8 * y2 + g) * LDF + e;
          mma3<kX>(dd[y2], ah, al, di[0], di[4]);
        }
      }
#pragma unroll
      for (int y2 = 0; y2 < 2; ++y2) {

        dpd[(8 * y2 + 2 * t) * LDB + g] = dd[y2][0];
        dpd[(8 * y2 + 2 * t + 1) * LDB + g] = dd[y2][1];
        dpd[(8 * y2 + 2 * t) * LDB + g + 8] = dd[y2][2];
        dpd[(8 * y2 + 2 * t + 1) * LDB + g + 8] = dd[y2][3];
      }
      __syncwarp();
      // (b) the two diagonal halves, pairwise: lane g takes row g of the
      //     first half (pairs i in (g, 8)) and row 15 − g of the second
      //     (pairs i in (15 − g, 16)), seven pairs each; the second row's
      //     sums go back to lane 7 − g (xor 28), whose row g + 8 it is.
      //     A's entries of the pairs are summed over the row's columns and
      //     the four lanes of a row.
      float pw[NK][4] = {}, pb[NK][2] = {};
      for (int p = 0; p < 7; ++p) {
        const bool first = p < 7 - g;
        const int jl = first ? g : 15 - g;
        const int il = first ? g + 1 + p : 9 + p;
        const float dpij = dpd[il * LDB + jl];
        const int i = j0 + il, j = j0 + jl;
        float apart = 0.0f;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + 2 * t;
          const float2 pi = load2(s_lp + i * LDF + col);
          const float2 qj = load2(s_lq + j * LDF + col);
          const float2 ri = load2(s_r + i * LDT + col);
          const float2 kj = load2(s_k + j * LDT + col);
          const float re0 = ri.x * decay(pi.x - qj.x);
          const float re1 = ri.y * decay(pi.y - qj.y);
          if (first) {
            pw[n][0] = fmaf(dpij, re0, pw[n][0]);
            pw[n][1] = fmaf(dpij, re1, pw[n][1]);
          } else {
            pb[n][0] = fmaf(dpij, re0, pb[n][0]);
            pb[n][1] = fmaf(dpij, re1, pb[n][1]);
          }
          apart = fmaf(re0, kj.x, apart);
          apart = fmaf(re1, kj.y, apart);
        }
        apart += __shfl_xor_sync(0xffffffffu, apart, 1);
        apart += __shfl_xor_sync(0xffffffffu, apart, 2);
        if (t == 0) ad[il * LDB + jl] = apart;
      }
      // A's diagonal: the bonus r_j . (u (.) k_j), rows g and g + 8
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = ja + 8 * half;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + 2 * t;
          const float2 rj = load2(s_r + j * LDT + col);
          const float2 kj = load2(s_k + j * LDT + col);
          const float2 uu = load2(s_u + col);
          sum = fmaf(rj.x * uu.x, kj.x, sum);
          sum = fmaf(rj.y * uu.y, kj.y, sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t == 0) ad[(g + 8 * half) * LDB + g + 8 * half] = sum;
      }
      bar_arrive(1 + J, 64);   // A's diagonal block, to the dv warp of J
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        pw[n][2] = __shfl_xor_sync(0xffffffffu, pb[n][0], 28);
        pw[n][3] = __shfl_xor_sync(0xffffffffu, pb[n][1], 28);
      }
      // (c) the lower-left 8 x 8 block, for rows j of the first half:
      //     dk'_j += e^{ref8 − logP_{j+1}} (.) [DP_F^T (r (.) e^{logP − ref8})]
      {
        const int i8 = j0 + 8;
        const float a[4] = {dd[1][0], 0.0f, dd[1][1], 0.0f};
        frag<false>(a, ah, al);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + g, ib2 = i8 + 2 * t;
          const float ref8 = s_lp[i8 * LDF + col];
          const float b0 = to_f32(s_r[ib2 * LDT + col]) *
                           decay(s_lp[ib2 * LDF + col] - ref8);
          const float b1 = to_f32(s_r[(ib2 + 1) * LDT + col]) *
                           decay(s_lp[(ib2 + 1) * LDF + col] - ref8);
          float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma3<false>(f, ah, al, b0, b1);
          const int c0 = n * 8 + 2 * t;
          pw[n][0] = fmaf(decay(s_lp[i8 * LDF + c0] - s_lq[ja * LDF + c0]),
                          f[0], pw[n][0]);
          pw[n][1] =
              fmaf(decay(s_lp[i8 * LDF + c0 + 1] - s_lq[ja * LDF + c0 + 1]),
                   f[1], pw[n][1]);
        }
      }
      // (d) the rows after the block, a tile of 8 at a time (DP^T's tile
      //     from v_J and dout, kept in DP's blocks below the diagonal for
      //     dr, then times R' = r (.) e^{logP − ref'}), and the state term
      //     v_J (dS'_c (.)rows e^{logP_C − ref'})^T
      float acc[NK][4] = {};
      for (int i0 = j0 + kRows; i0 < npad; i0 += 8) {
        float dt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) {
          const int e = ks * 8 + t;
          const float a[4] = {to_f32(s_v[ja * LDT + e]),
                              to_f32(s_v[jb * LDT + e]),
                              to_f32(s_v[ja * LDT + e + 4]),
                              to_f32(s_v[jb * LDT + e + 4])};
          frag<kX>(a, ah, al);
          const float* di = s_do + (i0 + g) * LDF + e;
          mma3<kX>(dt, ah, al, di[0], di[4]);
        }
        float* dpo = s_dpo + below(i0 / kRows, J) * kRows * kRows +
                     (i0 % kRows + 2 * t) * kRows + g;
        dpo[0] = dt[0];
        dpo[kRows] = dt[1];
        dpo[8] = dt[2];
        dpo[kRows + 8] = dt[3];
        const float a[4] = {dt[0], dt[2], dt[1], dt[3]};
        frag<false>(a, ah, al);
        const int i2 = i0 + 2 * t;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + g;
          const float rp = refp[col];
          const float b0 = to_f32(s_r[i2 * LDT + col]) *
                           decay(s_lp[i2 * LDF + col] - rp);
          const float b1 = to_f32(s_r[(i2 + 1) * LDT + col]) *
                           decay(s_lp[(i2 + 1) * LDF + col] - rp);
          mma3<false>(acc[n], ah, al, b0, b1);
        }
      }
      float fs[NK];   // e^{logP_C − ref'} at column n * 8 + g
#pragma unroll
      for (int n = 0; n < NK; ++n) fs[n] = decay(tot[n * 8 + g] - refp[n * 8 + g]);
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        const int e = ks * 8 + t;
        const float a[4] = {to_f32(s_v[ja * LDT + e]), to_f32(s_v[jb * LDT + e]),
                            to_f32(s_v[ja * LDT + e + 4]),
                            to_f32(s_v[jb * LDT + e + 4])};
        frag<kX>(a, ah, al);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float* sd = s_s + (n * 8 + g) * LDF + e;
          mma3<kX>(acc[n], ah, al, sd[0] * fs[n], sd[4] * fs[n]);
        }
      }
      // (e) dk'_j = e^{ref' − logP_{j+1}} (.) acc + the pairwise and F
      //     terms; dk = dk' + u (.) r_j DP_jj; y = k (.) dk'
      const float dpa = dpd[g * LDB + g], dpb = dpd[(g + 8) * LDB + g + 8];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c0 = n * 8 + 2 * t;
        const float2 rp = load2(refp + c0);
        const float2 qa = load2(s_lq + ja * LDF + c0);
        const float2 qb = load2(s_lq + jb * LDF + c0);
        const float ka0 = fmaf(decay(rp.x - qa.x), acc[n][0], pw[n][0]);
        const float ka1 = fmaf(decay(rp.y - qa.y), acc[n][1], pw[n][1]);
        const float kb0 = fmaf(decay(rp.x - qb.x), acc[n][2], pw[n][2]);
        const float kb1 = fmaf(decay(rp.y - qb.y), acc[n][3], pw[n][3]);
        const float2 uu = load2(s_u + c0);
        const float2 ra = load2(s_r + ja * LDT + c0);
        const float2 rb = load2(s_r + jb * LDT + c0);
        if (ja < C) {
          store2(dk + base + static_cast<int64_t>(ja) * HD + c0,
                 fmaf(uu.x * ra.x, dpa, ka0), fmaf(uu.y * ra.y, dpa, ka1));
        }
        if (jb < C) {
          store2(dk + base + static_cast<int64_t>(jb) * HD + c0,
                 fmaf(uu.x * rb.x, dpb, kb0), fmaf(uu.y * rb.y, dpb, kb1));
        }
        const float2 xa = load2(s_k + ja * LDT + c0);
        const float2 xb = load2(s_k + jb * LDT + c0);
        y[n][0] = xa.x * ka0;
        y[n][1] = xa.y * ka1;
        y[n][2] = xb.x * kb0;
        y[n][3] = xb.y * kb1;
      }
    }
  } else {
    const int J = 7 - wid, j0 = kRows * J;
    if (j0 < npad) {
      const int ja = j0 + g, jb = ja + 8, i8 = j0 + 8;
      const float* refp = s_lq + (j0 + kRows - 1) * LDF;   // ref'_J
      const int after = (npad - j0 - kRows) / 8;   // i-tiles after the block
      // (a) over the k-steps of hd: the tiles of A^T after the block, K' =
      //     k_J (.) e^{ref' − logP_{j+1}} times R'^T; the state term k~ dS'
      //     with k~ = K' (.) e^{logP_C − ref'}; and A^T's lower-left block
      //     factored at ref8 (rows j of the first half only)
      float at[kAfter][4] = {}, acc[NK][4] = {}, f[4] = {};
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        const int da = ks * 8 + t, db = da + 4;
        const float rpa = refp[da], rpb = refp[db];
        const float kv[4] = {
            to_f32(s_k[ja * LDT + da]) * decay(rpa - s_lq[ja * LDF + da]),
            to_f32(s_k[jb * LDT + da]) * decay(rpa - s_lq[jb * LDF + da]),
            to_f32(s_k[ja * LDT + db]) * decay(rpb - s_lq[ja * LDF + db]),
            to_f32(s_k[jb * LDT + db]) * decay(rpb - s_lq[jb * LDF + db])};
        frag<false>(kv, ah, al);
#pragma unroll
        for (int x = 0; x < kAfter; ++x) {
          if (x < after) {
            const int i = j0 + kRows + 8 * x + g;
            const float b0 = to_f32(s_r[i * LDT + da]) *
                             decay(s_lp[i * LDF + da] - rpa);
            const float b1 = to_f32(s_r[i * LDT + db]) *
                             decay(s_lp[i * LDF + db] - rpb);
            mma3<false>(at[x], ah, al, b0, b1);
          }
        }
        const float fa = decay(tot[da] - rpa), fb = decay(tot[db] - rpb);
        const float kt[4] = {kv[0] * fa, kv[1] * fa, kv[2] * fb, kv[3] * fb};
        frag<false>(kt, ah, al);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + g;
          mma3<false>(acc[n], ah, al, s_s[da * LDF + col],
                             s_s[db * LDF + col]);
        }
        const float r8a = s_lp[i8 * LDF + da], r8b = s_lp[i8 * LDF + db];
        const float k8[4] = {
            to_f32(s_k[ja * LDT + da]) * decay(r8a - s_lq[ja * LDF + da]),
            0.0f,
            to_f32(s_k[ja * LDT + db]) * decay(r8b - s_lq[ja * LDF + db]),
            0.0f};
        frag<false>(k8, ah, al);
        const int i = i8 + g;
        const float b0 =
            to_f32(s_r[i * LDT + da]) * decay(s_lp[i * LDF + da] - r8a);
        const float b1 =
            to_f32(s_r[i * LDT + db]) * decay(s_lp[i * LDF + db] - r8b);
        mma3<false>(f, ah, al, b0, b1);
      }
      // (b) dv += A^T dout over the rows after the block
#pragma unroll
      for (int x = 0; x < kAfter; ++x) {
        if (x < after) {
          const float a[4] = {at[x][0], at[x][2], at[x][1], at[x][3]};
          frag<false>(a, ah, al);
          const int i2 = j0 + kRows + 8 * x + 2 * t;
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            const int col = n * 8 + g;
            mma3<false>(acc[n], ah, al, s_do[i2 * LDF + col],
                               s_do[(i2 + 1) * LDF + col]);
          }
        }
      }
      // (c) the diagonal block, once the dk warp of J has written its
      //     pairwise part and bonus: A^T[j][i] = A[i][j] for j <= i, the
      //     lower-left block from f
      bar_sync(1 + J, 64);
      const float* ad = s_ad + J * kRows * LDB;
      const int i2 = 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float a[4] = {
            half ? f[0] : (g <= i2 ? ad[i2 * LDB + g] : 0.0f),
            half ? (g <= i2 ? ad[(8 + i2) * LDB + 8 + g] : 0.0f) : 0.0f,
            half ? f[1] : (g <= i2 + 1 ? ad[(i2 + 1) * LDB + g] : 0.0f),
            half ? (g <= i2 + 1 ? ad[(9 + i2) * LDB + 8 + g] : 0.0f) : 0.0f};
        frag<false>(a, ah, al);
        const int ir = j0 + 8 * half + i2;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int col = n * 8 + g;
          mma3<false>(acc[n], ah, al, s_do[ir * LDF + col],
                             s_do[(ir + 1) * LDF + col]);
        }
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c0 = n * 8 + 2 * t;
        if (ja < C) {
          store2(dv + base + static_cast<int64_t>(ja) * HD + c0, acc[n][0],
                 acc[n][1]);
        }
        if (jb < C) {
          store2(dv + base + static_cast<int64_t>(jb) * HD + c0, acc[n][2],
                 acc[n][3]);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with dS'_c, v and A's blocks

  // 3. P4: S_c into the state buffer, behind the work that does not read
  //    it; y to shared memory in v's place; dr of block I, half hh of its
  //    columns, two warps a block (warps w and w + 4 take blocks w and 3 −
  //    w)
  for (int i = tid; i < HD * (HD / 4); i += kChunkThreads) {
    const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
    cp_async16(s_s + m * LDF + q, enter + m * HD + q);
  }
  cp_async_commit();
  float* ys = reinterpret_cast<float*>(smem + L::y);   // [64][HD]
  if (wid < 4 && kRows * wid < npad) {
    const int ja = kRows * wid + g, jb = ja + 8;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c0 = n * 8 + 2 * t;
      store2(ys + ja * HD + c0, y[n][0], y[n][1]);
      store2(ys + jb * HD + c0, y[n][2], y[n][3]);
    }
  }
  const int I = wid < 4 ? wid : 7 - wid, hh = wid >> 2, i0 = kRows * I;
  const bool live = i0 < npad;
  const int ia = i0 + g, ib = ia + 8;
  const float* dpd = s_dpd + I * kRows * LDB;
  float acc[NH][4] = {}, pw[NH][4] = {};
  if (live) {
    const float* refi = s_lp + i0 * LDF;   // ref_I
    // (a) DP_{I,<I} K^, 8 columns j at a time: DP from its blocks below
    //     the diagonal (P3's dk warps formed them), times K^ = k (.)
    //     e^{ref_I − logP_{j+1}}, the k order permuted
    for (int j0 = 0; j0 < i0; j0 += 8) {
      const float* dpo = s_dpo + below(I, j0 / kRows) * kRows * kRows +
                         g * kRows + j0 % kRows + 2 * t;
      const float2 lo = load2(dpo), hi = load2(dpo + 8 * kRows);
      const float a[4] = {lo.x, hi.x, lo.y, hi.y};
      frag<false>(a, ah, al);
      const int j2 = j0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = (hh * NH + n) * 8 + g;
        const float ref = refi[col];
        const float b0 = to_f32(s_k[j2 * LDT + col]) *
                         decay(ref - s_lq[j2 * LDF + col]);
        const float b1 = to_f32(s_k[(j2 + 1) * LDT + col]) *
                         decay(ref - s_lq[(j2 + 1) * LDF + col]);
        mma3<false>(acc[n], ah, al, b0, b1);
      }
    }
    // (b) the lower-left 8 x 8 block, rows i of the second half:
    //     dr'_i += e^{logP_i − ref8} (.) [DP_F (k (.) e^{ref8 − logP_{j+1}})]
    {
      const int i8 = i0 + 8, j2 = i0 + 2 * t;
      const float a[4] = {0.0f, dpd[(8 + g) * LDB + 2 * t], 0.0f,
                          dpd[(8 + g) * LDB + 2 * t + 1]};
      frag<false>(a, ah, al);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = (hh * NH + n) * 8 + g;
        const float ref8 = s_lp[i8 * LDF + col];
        const float b0 = to_f32(s_k[j2 * LDT + col]) *
                         decay(ref8 - s_lq[j2 * LDF + col]);
        const float b1 = to_f32(s_k[(j2 + 1) * LDT + col]) *
                         decay(ref8 - s_lq[(j2 + 1) * LDF + col]);
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma3<false>(f, ah, al, b0, b1);
        const int c0 = (hh * NH + n) * 8 + 2 * t;
        pw[n][2] = fmaf(decay(s_lp[ib * LDF + c0] - s_lp[i8 * LDF + c0]),
                        f[2], pw[n][2]);
        pw[n][3] =
            fmaf(decay(s_lp[ib * LDF + c0 + 1] - s_lp[i8 * LDF + c0 + 1]),
                 f[3], pw[n][3]);
      }
    }
    // (c) the two diagonal halves, pairwise: lane g takes row g of the
    //     first half (pairs j < g) and row 15 − g of the second (pairs j in
    //     [8, 15 − g)), seven pairs each; the second row's sums go back to
    //     lane 7 − g (xor 28)
    float pb[NH][2] = {};
    for (int p = 0; p < 7; ++p) {
      const bool first = p < g;
      const int il = first ? g : 15 - g;
      const int jl = first ? p : 8 + p - g;
      const float dpij = dpd[il * LDB + jl];
      const int i = i0 + il, j = i0 + jl;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = (hh * NH + n) * 8 + 2 * t;
        const float2 pi = load2(s_lp + i * LDF + col);
        const float2 qj = load2(s_lq + j * LDF + col);
        const float2 kj = load2(s_k + j * LDT + col);
        const float ke0 = kj.x * decay(pi.x - qj.x);
        const float ke1 = kj.y * decay(pi.y - qj.y);
        if (first) {
          pw[n][0] = fmaf(dpij, ke0, pw[n][0]);
          pw[n][1] = fmaf(dpij, ke1, pw[n][1]);
        } else {
          pb[n][0] = fmaf(dpij, ke0, pb[n][0]);
          pb[n][1] = fmaf(dpij, ke1, pb[n][1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      pw[n][2] += __shfl_xor_sync(0xffffffffu, pb[n][0], 28);
      pw[n][3] += __shfl_xor_sync(0xffffffffu, pb[n][1], 28);
    }
  }
  cp_async_wait<0>();   // S_c
  __syncthreads();
  float x[NH][4];   // r (.) dr'
  if (live) {
    // (d) the state term dout_I (S_c (.)rows e^{ref_I})^T
    const float* refi = s_lp + i0 * LDF;
    float er[NH];
#pragma unroll
    for (int n = 0; n < NH; ++n) er[n] = decay(refi[(hh * NH + n) * 8 + g]);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const int e = ks * 8 + t;
      const float a[4] = {s_do[ia * LDF + e], s_do[ib * LDF + e],
                          s_do[ia * LDF + e + 4], s_do[ib * LDF + e + 4]};
      frag<false>(a, ah, al);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float* sc = s_s + ((hh * NH + n) * 8 + g) * LDF + e;
        mma3<false>(acc[n], ah, al, sc[0] * er[n], sc[4] * er[n]);
      }
    }
    // (e) dr' = e^{logP_i − ref_I} (.) acc + the F and pairwise terms;
    //     x = r (.) dr'; dr = dr' + u (.) k_i DP_ii
    const float dpa = dpd[g * LDB + g], dpb = dpd[(g + 8) * LDB + g + 8];
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int c0 = (hh * NH + n) * 8 + 2 * t;
      const float2 ref = load2(refi + c0);
      const float2 pa = load2(s_lp + ia * LDF + c0);
      const float2 pb = load2(s_lp + ib * LDF + c0);
      const float ra0 = fmaf(decay(pa.x - ref.x), acc[n][0], pw[n][0]);
      const float ra1 = fmaf(decay(pa.y - ref.y), acc[n][1], pw[n][1]);
      const float rb0 = fmaf(decay(pb.x - ref.x), acc[n][2], pw[n][2]);
      const float rb1 = fmaf(decay(pb.y - ref.y), acc[n][3], pw[n][3]);
      const float2 uu = load2(s_u + c0);
      const float2 ka = load2(s_k + ia * LDT + c0);
      const float2 kb = load2(s_k + ib * LDT + c0);
      if (ia < C) {
        store2(dr + base + static_cast<int64_t>(ia) * HD + c0,
               fmaf(uu.x * ka.x, dpa, ra0), fmaf(uu.y * ka.y, dpa, ra1));
      }
      if (ib < C) {
        store2(dr + base + static_cast<int64_t>(ib) * HD + c0,
               fmaf(uu.x * kb.x, dpb, rb0), fmaf(uu.y * kb.y, dpb, rb1));
      }
      const float2 xa = load2(s_r + ia * LDT + c0);
      const float2 xb = load2(s_r + ib * LDT + c0);
      x[n][0] = xa.x * ra0;
      x[n][1] = xa.y * ra1;
      x[n][2] = xb.x * rb0;
      x[n][3] = xb.y * rb1;
    }
  }
  __syncthreads();   // logP is read for the last time

  // 4. x to shared memory in logP_i's place; then dlogw, from the chunk's
  //    last row up, a thread a column, and du's partial sum
  float* xs = s_lp;   // [64][HD]
  if (live) {
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int c0 = (hh * NH + n) * 8 + 2 * t;
      store2(xs + ia * HD + c0, x[n][0], x[n][1]);
      store2(xs + ib * HD + c0, x[n][2], x[n][3]);
    }
  }
  __syncthreads();
  if (tid < HD) {
    // dlogw_m = tail + sum_{i>m} x_i − sum_{j>=m} y_j
    float run = s_tail[tid];
    for (int m = C - 1; m >= 0; --m) {
      run -= ys[m * HD + tid];
      store(&dlogw[base + static_cast<int64_t>(m) * HD + tid], run);
      run += xs[m * HD + tid];
    }
  } else if (tid < 2 * HD) {
    const int d = tid - HD;
    float acc2 = 0.0f;
    for (int i = 0; i < C; ++i) {
      const float dpii =
          s_dpd[(i / kRows) * kRows * LDB + (i % kRows) * (LDB + 1)];
      acc2 = fmaf(to_f32(s_r[i * LDT + d]) * to_f32(s_k[i * LDT + d]), dpii,
                  acc2);
    }
    du_part[static_cast<int64_t>(blockIdx.x) * HD + d] = acc2;
  }
}

// Pass C: du[h, d] = sum over b, then the chunks, of the partials, in order
template <int HD, typename T>
__global__ void __launch_bounds__(HD)
rwkv6_bwd_du_kernel(const float* __restrict__ du_part, T* __restrict__ du,
                    int64_t batch, int heads, int n_chunks) {
  const int h = blockIdx.x;
  const int d = threadIdx.x;
  float acc = 0.f;
  for (int64_t b = 0; b < batch; ++b) {
    const float* p = du_part + ((b * heads + h) * n_chunks) * HD + d;
    for (int c = 0; c < n_chunks; ++c) acc += p[static_cast<int64_t>(c) * HD];
  }
  store(&du[static_cast<int64_t>(h) * HD + d], acc);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *r, *k, *v, *logw, *u, *state0, *states, *state_out, *dout,
      *dstate_out;
  void *dr, *dk, *dv, *dlogw, *du, *dstate0, *dstates, *du_part;
  int64_t batch, seq;
  int heads, chunk, n_chunks;
};

// Pass A's CTAs a (b, h): at most 32 rows a CTA, then the most (rows a
// CTA >= 16) that keep B * H * splits within the SM count, so that the
// reverse walks fill the card without a second wave
int state_splits(int hd, int64_t bh, int sms) {
  int splits = hd / 32;
  while (hd / (2 * splits) >= kRows && bh * 2 * splits <= sms) splits *= 2;
  return splits;
}

template <int HD, int ROWS, typename T, typename TW>
cudaError_t launch_state(const Args& a, int64_t bh, cudaStream_t stream) {
  auto kern = rwkv6_bwd_state_kernel<HD, ROWS, T, TW>;
  constexpr size_t bytes = StateSmem<HD, ROWS, T, TW>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(bh * (HD / ROWS)), 2 * kThreads, bytes,
         stream>>>(
      static_cast<const T*>(a.r), static_cast<const TW*>(a.logw),
      static_cast<const float*>(a.dout),
      static_cast<const float*>(a.dstate_out), static_cast<float*>(a.dstates),
      static_cast<float*>(a.dstate0), a.seq, a.chunk, a.n_chunks);
  return cudaGetLastError();
}

template <int HD, typename T, typename TW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t bh = a.batch * a.heads;
  if (bh == 0) {  // no batch row: du sums nothing
    rwkv6_bwd_du_kernel<HD, T><<<static_cast<unsigned>(a.heads), HD, 0,
                                 stream>>>(
        static_cast<const float*>(a.du_part), static_cast<T*>(a.du), 0,
        a.heads, a.n_chunks);
    return cudaGetLastError();
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int splits = state_splits(HD, bh, sms);
  err = HD / splits == 32 ? launch_state<HD, 32, T, TW>(a, bh, stream)
                          : launch_state<HD, 16, T, TW>(a, bh, stream);
  if (err != cudaSuccess) return err;

  auto kern = rwkv6_bwd_chunk_kernel<HD, T, TW>;
  constexpr size_t bytes = ChunkSmem<HD, T>::bytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(bh * a.n_chunks), kChunkThreads, bytes,
         stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TW*>(a.logw),
      static_cast<const T*>(a.u), static_cast<const float*>(a.state0),
      static_cast<const float*>(a.states),
      static_cast<const float*>(a.state_out),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.dstates),
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<TW*>(a.dlogw), static_cast<float*>(a.du_part), a.heads,
      a.seq, a.chunk, a.n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  rwkv6_bwd_du_kernel<HD, T><<<static_cast<unsigned>(a.heads), HD, 0,
                               stream>>>(
      static_cast<const float*>(a.du_part), static_cast<T*>(a.du), a.batch,
      a.heads, a.n_chunks);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_types(int bf16_rkvu, int bf16_logw, const Args& a,
                           cudaStream_t stream) {
  if (bf16_rkvu && bf16_logw)
    return launch<HD, __nv_bfloat16, __nv_bfloat16>(a, stream);
  if (bf16_rkvu) return launch<HD, __nv_bfloat16, float>(a, stream);
  if (bf16_logw) return launch<HD, float, __nv_bfloat16>(a, stream);
  return launch<HD, float, float>(a, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous r, k, v, logw, dr, dk, dv, dlogw [b, heads, seq,
// hd], u and du [heads, hd] (r's type for all but logw and dlogw, which
// share theirs), and fp32 state0, state_out, dstate_out, dstate0 [b, heads,
// hd, hd], states [b, heads, seq / chunk - 1, hd, hd] (the forward's
// scratch), dout [b, heads, seq, hd] and the scratch dstates [b, heads,
// seq / chunk, hd, hd] and du_part [b, heads, seq / chunk, hd]; all but u
// and the gradients 16-byte aligned; the caller has checked shapes, types
// and contiguity.  Returns cudaGetLastError() after the last launch, or
// cudaErrorInvalidValue for a shape or pointer the kernel does not take.
extern "C" int rwkv6_chunked_bwd_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state0, const void* states,
    const void* state_out, const void* dout, const void* dstate_out, void* dr,
    void* dk, void* dv, void* dlogw, void* du, void* dstate0, void* dstates,
    void* du_part, int64_t b, int64_t heads, int64_t seq, int64_t hd,
    int64_t chunk, int bf16_rkvu, int bf16_logw, void* stream) {
  if ((hd != 32 && hd != 64) || chunk < 1 || chunk > kMaxChunk || seq < 1 ||
      seq % chunk != 0 || heads < 1 || heads > 65535 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_chunks = seq / chunk;
  if (b * heads * n_chunks * (hd / kRows) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0 &&
      (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(logw) ||
       !aligned16(state0) || !aligned16(state_out) || !aligned16(dout) ||
       !aligned16(dstate_out) || !aligned16(dstates) ||
       (n_chunks > 1 && !aligned16(states)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{r, k, v, logw, u, state0, states, state_out, dout, dstate_out,
               dr, dk, dv, dlogw, du, dstate0, dstates, du_part, b, seq,
               static_cast<int>(heads), static_cast<int>(chunk),
               static_cast<int>(n_chunks)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hd == 64 ? dispatch_types<64>(bf16_rkvu, bf16_logw, a, s)
               : dispatch_types<32>(bf16_rkvu, bf16_logw, a, s);
  return static_cast<int>(err);
}

extern "C" const char* rwkv6_chunked_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
