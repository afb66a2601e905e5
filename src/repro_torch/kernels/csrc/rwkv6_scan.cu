// rwkv6_scan.cu: the chunked RWKV6 recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan.py:69 rwkv6_chunked (body _rwkv6_kernel),
// reached from repro.kernels.ops.rwkv6_chunked; in the model it computes
// what src/repro/models/rwkv6.py::time_mix_apply scans with chunk_body.
//
// For every (batch b, head h), with r, k, v, logw [B, H, S, hd], the bonus
// u [H, hd] and a carried state S [hd, hd] (fp32), each chunk of C tokens:
//   logP_i   = cumsum(logw)_i − logw_i        (per column; cumsum in order)
//   logP_j+1 = logP_j + logw_j,  logP_C = logP_{C−1} + logw_{C−1}
//   inter    = (r ⊙ e^{logP}) S_c             (S_c: the state entering it)
//   A_ij     = sum_d r_i[d] k_j[d] e^{logP_i[d] − logP_{j+1}[d]}   (j < i)
//   A_ii     = sum_d r_i[d] u[d] k_i[d]                             (bonus)
//   out      = inter + A v                                          (fp32)
//   S_{c+1}  = e^{logP_C} ⊙ S_c + (k ⊙ e^{logP_C − logP_{j+1}})ᵀ v
// The three log-decay sums are formed exactly as the plain version
// (kernels/ref.py::chunk_body) forms them, bit for bit: at large decays
// their rounding, not the products', sets how far two implementations
// part.  Every exponent is a difference logP_later − logP_earlier, <= 0
// in exact arithmetic (logw <= 0) and at most a rounding step of the sums
// above it in fp32, the plain version's own: no term is split into
// e^{logP_i} · e^{−logP_{j+1}} (whose second factor overflows over a long
// chunk), and the masked pairs (j >= i) are never evaluated.
//
// State in and out.  The TPU kernel starts every (b, h) from a zero state
// and keeps the final state in VMEM scratch without writing it out.  This
// kernel reads state0 [B, H, hd, hd] fp32 and writes state_out, because the
// model's prefill hands the final state to decode.  With state0 = 0 and
// state_out unread it computes exactly what the TPU kernel computes.
//
// Types: r, k, v, u fp32 or bf16 (one type for all four); logw fp32 or
// bf16; everything is widened to fp32; out and state are fp32.  The chunk
// length C is any value in [1, 64] that divides S; hd is 32 or 64.  Every
// pointer but u's is 16-byte aligned (the wrapper copies one that is not).
//
// Design.  Only the state depends on earlier chunks, so one op call is two
// launches on one stream, and the chunks run in parallel wherever the
// state does not force an order:
//   * Pass 1, the state pass (rwkv6_chunked_state_kernel).  One CTA of 256
//     threads per (b, h) walks the chunks in order, two CTAs an SM (about
//     100 KB of shared memory each at the serving shape), warp-specialised:
//     four load warps stage k and logw two chunks ahead (cp.async), form
//     the chunk's log-decay sums (one column a thread) and k̃ = k ⊙
//     e^{logP_C − logP_{j+1}} into one of two k̃ buffers; four tensor warps
//     hold S in their mma accumulators (16 rows each at hd = 64), stage v
//     two chunks ahead, write the state entering the chunk to the scratch
//     states [B, H, n_chunks − 1, hd, hd] (chunk 0's is state0) and update
//     S ← e^{logP_C} ⊙ S + k̃ᵀ v.  Named barriers hand each k̃ buffer from
//     the load warps to the tensor warps and back, so the sums of chunk
//     c + 1 overlap the products of chunk c.
//   * Pass 2, the output pass (rwkv6_chunked_out_kernel).  One CTA of 256
//     threads per (b, h, chunk), 4,096 at the serving shape, two an SM.  It
//     stages the chunk and its entering state (cp.async), forms the
//     log-decay sums as pass 1 does, then two warps take each sub-chunk I
//     of rows 16I .. 16I + 15, each with half of out's columns:
//       out_I = (r_I ⊙ e^{logP_I}) S_c + A_{I,<=I} v
//     with every product on the tensor cores, A's off-diagonal blocks
//     included: with ref_I = logP at I's first row,
//       A_{I,J} = (r_I ⊙ e^{logP_I − ref_I}) · (k_J ⊙ e^{ref_I − logP_{J+1}})ᵀ
//     for J < I, both exponents <= 0 (logP_{j+1} >= ref_I >= logP_i); the
//     two differences add up to the pairwise one (exactly, where the sums
//     lie within a factor of 2 of each other), so the factored term is the
//     pairwise term to a few fp32 roundings.  Each diagonal 16 x 16 block
//     is cut the same way at its 8th row: its lower-left 8 x 8 block goes
//     on the tensor cores too, and only its two diagonal 8 x 8 blocks keep
//     the pairwise e^{logP_i − logP_{j+1}} on the CUDA cores, a pair a
//     lane, the bonus on their diagonal: 224 pairs a chunk of 64 against
//     2,016, and with the factors' exponentials about 4x fewer in all.
//     The two warps of a sub-chunk share its rows of A through shared
//     memory (a named barrier), and the warps that share an SM
//     sub-partition take sub-chunks I and 3 − I, whose work adds up to the
//     same.
// Products: mma.sync m16n8k8 TF32 with fp32 accumulators.  One TF32 term
// keeps 2^-11 of an operand, too coarse for 1e-4 on outputs of order 10,
// so every fp32 operand is split into a high and a low TF32 part and each
// product is three (lo·hi + hi·lo + hi·hi, error ~2^-21 of it); bf16
// operands (v on the serving path) are exact in TF32 and take two.  No
// atomics anywhere: two launches on the same inputs agree bit for bit.
//
// Bound: bytes.  Reading r, k, v, logw, u and state0 once and writing out
// and state_out once, at the serving shape [4, 64, 1024, 64] with bf16
// r/k/v and fp32 logw, is about 243 MB, 0.073 ms at 3.35 TB/s; the chunk
// form's ~8.2 G operations take 0.017 ms at the TF32 tensor-core rate.  The
// design adds the scratch states (15 of 16 chunks' entering states, 63 MB,
// written once and read once), the second read of k, v and logw (the state
// pass reads them, then the output pass), and three TF32 products for each
// fp32 one.  No PyTorch call computes this function, so there is no
// library yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;      // pass 1: each of its two warp groups
constexpr int kWarps = kThreads / 32;
constexpr int kOutThreads = 256;   // pass 2: 8 warps, two a sub-chunk
constexpr int kMaxChunk = 64;
constexpr int kRows = 16;       // A's sub-chunk; a tensor warp's rows of S
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// e^x for a log decay x (<= 0 up to rounding): one ex2.approx (2 ulp), its
// results below 2^-126 flushed to 0
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// The log-decay sums of one column as the plain version forms them (a
// cumulative sum in row order, as torch.cumsum takes it along a dimension
// that is not the last): from logw_m = w[m * ldw], p[m] = logP_m =
// cumsum_m − logw_m and q[m] = logP_{m+1} = logP_m + logw_m for m <
// chunk, so q[chunk − 1] is logP_C.  Rows [chunk, pad) of p and q are set
// to logP_C, so that every exponent a padded row enters is <= 0 as well.
// w may be q itself (ldw = ld); p may be null.  ld: p's and q's row stride.
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

// x = hi + lo, each a TF32 value (round to nearest); x − hi is exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a b, one m16n8k8 TF32 product.  Fragments (g = lane / 4, t = lane %
// 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n
// g), b1 (k t + 4, n g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a split (ahi + alo) and b given as two fp32 values: three
// products, or two where b is a widened bf16 (exact in TF32)
template <bool kExactB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], float b0,
                                          float b1) {
  if constexpr (kExactB) {
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    mma(d, alo, h0, h1);
    mma(d, ahi, h0, h1);
  } else {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma(d, alo, h0, h1);
    mma(d, ahi, l0, l1);
    mma(d, ahi, h0, h1);
  }
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

// four consecutive values, widened (16- or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// local row i > 0 and column j < i of pair p = i (i − 1) / 2 + j
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  i = 1;
  while (i * (i + 1) / 2 <= p) ++i;
  j = p - i * (i - 1) / 2;
}

// The shared arrays of each pass; offsets are multiples of 16 bytes.
template <int HD, typename T, typename TW>
struct StateSmem {
  static constexpr int LDV = HD + 16 / sizeof(T);  // v rows (T)
  static constexpr int LDK = HD + 4;               // k̃ rows (fp32)
  static constexpr size_t kw_bytes =               // one stage of k and logw
      (sizeof(T) + sizeof(TW)) * kMaxChunk * HD;
  static constexpr size_t v_bytes = sizeof(T) * kMaxChunk * LDV;
  // logP_{j+1} [64][HD]: in place of an fp32 logw stage, else its own
  static constexpr bool q_in_place = std::is_same<TW, float>::value;
  static constexpr size_t kt_bytes = sizeof(float) * (kMaxChunk + 1) * LDK;
  static constexpr size_t kw = 0;                  // [2] k [64][HD], logw
  static constexpr size_t v = kw + 2 * kw_bytes;   // [2] [64][LDV]
  static constexpr size_t kt = v + 2 * v_bytes;    // [2] k̃ [64][LDK] and
                                                   // e^{logP_C} in row 64
  static constexpr size_t tot = kt + 2 * kt_bytes;  // logP_C [HD]
  static constexpr size_t q = tot + sizeof(float) * HD;
  static constexpr size_t bytes =
      q + (q_in_place ? 0 : sizeof(float) * kMaxChunk * HD);
};

template <int HD, typename T>
struct OutSmem {
  static constexpr int LD = HD + 16 / sizeof(T);  // r, k, v rows (T)
  static constexpr int LDP = HD + 4;              // logP rows (fp32)
  static constexpr int LDS = HD + 8;              // S rows (fp32)
  static constexpr int LDA = kMaxChunk + 8;       // A rows (fp32)
  static constexpr size_t r = 0;
  static constexpr size_t k = r + sizeof(T) * kMaxChunk * LD;
  static constexpr size_t v = k + sizeof(T) * kMaxChunk * LD;
  static constexpr size_t p = v + sizeof(T) * kMaxChunk * LD;
  static constexpr size_t q = p + sizeof(float) * kMaxChunk * LDP;
  static constexpr size_t s = q + sizeof(float) * kMaxChunk * LDP;
  static constexpr size_t u = s + sizeof(float) * HD * LDS;
  static constexpr size_t a = u + sizeof(float) * HD;
  static constexpr size_t bytes = a + sizeof(float) * kMaxChunk * LDA;
};

// ---------------------------------------------------------------------------
// Pass 1: the states entering every chunk, and the final state
// ---------------------------------------------------------------------------

// Named barriers of pass 1 (0 is __syncthreads): k̃ buffer b ready for the
// tensor warps (kBarFull + b), read by them (kBarEmpty + b); each group's own.
constexpr int kBarFull = 1, kBarEmpty = 3, kBarLoad = 5, kBarMma = 6;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int HD, typename T, typename TW>
__global__ void __launch_bounds__(2 * kThreads, 2)
rwkv6_chunked_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                           const TW* __restrict__ logw,
                           const float* __restrict__ state0,
                           float* __restrict__ states,
                           float* __restrict__ state_out, int64_t seq,
                           int chunk, int n_chunks) {
  using L = StateSmem<HD, T, TW>;
  constexpr int LDV = L::LDV, LDK = L::LDK;
  constexpr int RB = HD / kRows;          // 16-row blocks of S
  constexpr int WB = kWarps / RB;         // tensor warps a row block
  constexpr int NT = HD / 8 / WB;         // n-tiles (8 columns of S) a warp
  constexpr int ET = 16 / sizeof(T), EW = 16 / sizeof(TW);  // a copy's elements
  static_assert(HD == 32 || HD == 64, "hd must be 32 or 64");

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tot = reinterpret_cast<float*>(smem + L::tot);  // [HD] logP_C
  auto stage_kt = [&](int b) {
    return reinterpret_cast<float*>(smem + L::kt + b * L::kt_bytes);
  };
  auto stage_k = [&](int b) {
    return reinterpret_cast<T*>(smem + L::kw + b * L::kw_bytes);
  };
  auto stage_w = [&](int b) {
    return reinterpret_cast<TW*>(smem + L::kw + b * L::kw_bytes +
                                 sizeof(T) * kMaxChunk * HD);
  };
  auto stage_v = [&](int b) {
    return reinterpret_cast<T*>(smem + L::v + b * L::v_bytes);
  };

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t row0 = bh * seq;
  const int cpad = (chunk + 7) & ~7;   // k-steps of 8 rows
  auto rows_of = [&](int c) {          // first element of chunk c
    return (row0 + static_cast<int64_t>(c) * chunk) * HD;
  };
  float* entering = states + bh * static_cast<int64_t>(n_chunks - 1) * HD * HD;

  if (tid >= kThreads) {
    // The load warps: stage k and logw two chunks ahead, form the chunk's
    // log-decay sums (one column a thread) and k̃ = k ⊙ e^{logP_C −
    // logP_{j+1}} (zero past the chunk), hand k̃ to the tensor warps.
    const int lt = tid - kThreads;
    auto load_kw = [&](int c) {
      if (c < n_chunks) {
        T* sk = stage_k(c & 1);
        TW* sw = stage_w(c & 1);
        const int64_t base = rows_of(c);
        for (int i = lt; i < chunk * (HD / ET); i += kThreads) {
          cp_async16(sk + i * ET, k + base + i * ET);
        }
        for (int i = lt; i < chunk * (HD / EW); i += kThreads) {
          cp_async16(sw + i * EW, logw + base + i * EW);
        }
      }
      cp_async_commit();
    };
    load_kw(0);
    load_kw(1);
    for (int c = 0; c < n_chunks; ++c) {
      const int b = c & 1;
      cp_async_wait<1>();   // this chunk's k and logw (the next may fly)
      bar_sync(kBarLoad, kThreads);
      float* q = L::q_in_place ? reinterpret_cast<float*>(stage_w(b))
                               : reinterpret_cast<float*>(smem + L::q);
      if (lt < HD) {
        log_decays(stage_w(b) + lt, HD, static_cast<float*>(nullptr), q + lt,
                   HD, chunk, chunk);
        s_tot[lt] = q[(chunk - 1) * HD + lt];
      }
      bar_sync(kBarLoad, kThreads);
      if (c >= 2) bar_sync(kBarEmpty + b, 2 * kThreads);   // chunk c − 2 read
      const T* sk = stage_k(b);
      float* kt = stage_kt(b);
      for (int i = lt; i < cpad * HD; i += kThreads) {
        const int j = i / HD, d = i % HD;
        kt[j * LDK + d] =
            j < chunk ? to_f32(sk[i]) * decay(s_tot[d] - q[i]) : 0.0f;
      }
      if (lt < HD) kt[kMaxChunk * LDK + lt] = decay(s_tot[lt]);
      bar_arrive(kBarFull + b, 2 * kThreads);
      bar_sync(kBarLoad, kThreads);   // every load thread is done with k, logw
      load_kw(c + 2);
    }
    return;
  }

  // The tensor warps: warp m owns rows d0 .. d0 + 15 of S and NT n-tiles
  // from column e0, in the accumulator layout: rows d0 + g, d0 + g + 8,
  // columns e, e + 1 of each n-tile.  v is staged two chunks ahead.
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int d0 = (warp / WB) * kRows, e0 = (warp % WB) * NT * 8;
  auto load_v = [&](int c) {
    if (c < n_chunks) {
      T* sv = stage_v(c & 1);
      const int64_t base = rows_of(c);
      for (int i = tid; i < chunk * (HD / ET); i += kThreads) {
        const int m = i / (HD / ET), q = (i % (HD / ET)) * ET;
        cp_async16(sv + m * LDV + q,
                   v + base + static_cast<int64_t>(m) * HD + q);
      }
    }
    cp_async_commit();
  };
  // rows past the chunk stay zero in both v buffers
  for (int b = 0; b < 2; ++b) {
    zero_rows(stage_v(b), LDV * sizeof(T), chunk, kMaxChunk, tid, kThreads);
  }
  load_v(0);
  load_v(1);

  float st[NT][4];
  const float* s0 = state0 + bh * HD * HD;
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int e = e0 + q * 8 + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(s0 + (d0 + g) * HD + e);
    const float2 hi =
        *reinterpret_cast<const float2*>(s0 + (d0 + g + 8) * HD + e);
    st[q][0] = lo.x;
    st[q][1] = lo.y;
    st[q][2] = hi.x;
    st[q][3] = hi.y;
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();   // this chunk's v
    bar_sync(kBarMma, kThreads);
    // hand the entering state to pass 2 (chunk 0's is state0)
    if (c > 0) {
      float* dst = entering + static_cast<int64_t>(c - 1) * HD * HD;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int e = e0 + q * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + (d0 + g) * HD + e) =
            make_float2(st[q][0], st[q][1]);
        *reinterpret_cast<float2*>(dst + (d0 + g + 8) * HD + e) =
            make_float2(st[q][2], st[q][3]);
      }
    }
    bar_sync(kBarFull + (c & 1), 2 * kThreads);   // k̃ of chunk c
    const float* kt = stage_kt(c & 1);
    const float dec_a = kt[kMaxChunk * LDK + d0 + g];   // e^{logP_C}
    const float dec_b = kt[kMaxChunk * LDK + d0 + g + 8];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      st[q][0] *= dec_a;
      st[q][1] *= dec_a;
      st[q][2] *= dec_b;
      st[q][3] *= dec_b;
    }
    // S += k̃ᵀ v: A = k̃ᵀ (16 state rows x the chunk), B = v, the k order of
    // each 8-row step permuted (slot t ↔ row 2t, slot t + 4 ↔ row 2t + 1)
    const T* sv = stage_v(c & 1);
    for (int j0 = 0; j0 < cpad; j0 += 8) {
      const float* ka = kt + (j0 + 2 * t) * LDK + d0;
      const float* kb = ka + LDK;
      uint32_t ahi[4], alo[4];
      split(ka[g], ahi[0], alo[0]);
      split(ka[g + 8], ahi[1], alo[1]);
      split(kb[g], ahi[2], alo[2]);
      split(kb[g + 8], ahi[3], alo[3]);
      const T* vp = sv + (j0 + 2 * t) * LDV + e0 + g;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        mma_split<kExactTf32<T>>(st[q], ahi, alo, to_f32(vp[q * 8]),
                                 to_f32(vp[LDV + q * 8]));
      }
    }
    if (c + 2 < n_chunks) bar_arrive(kBarEmpty + (c & 1), 2 * kThreads);
    bar_sync(kBarMma, kThreads);   // every tensor warp is done with this v
    load_v(c + 2);
  }

  float* s1 = state_out + bh * HD * HD;
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int e = e0 + q * 8 + 2 * t;
    *reinterpret_cast<float2*>(s1 + (d0 + g) * HD + e) =
        make_float2(st[q][0], st[q][1]);
    *reinterpret_cast<float2*>(s1 + (d0 + g + 8) * HD + e) =
        make_float2(st[q][2], st[q][3]);
  }
}

// ---------------------------------------------------------------------------
// Pass 2: every chunk's output from the state entering it
// ---------------------------------------------------------------------------

template <int HD, typename T, typename TW>
__global__ void __launch_bounds__(kOutThreads, 2)
rwkv6_chunked_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const TW* __restrict__ logw,
                         const T* __restrict__ u,
                         const float* __restrict__ state0,
                         const float* __restrict__ states,
                         float* __restrict__ out, int heads, int64_t seq,
                         int chunk, int n_chunks) {
  using L = OutSmem<HD, T>;
  constexpr int LD = L::LD, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  constexpr int NK = HD / 8;    // k-steps over d
  constexpr int NH = HD / 16;   // out's n-tiles a warp owns (half of them)
  constexpr int ET = 16 / sizeof(T);
  static_assert(HD == 32 || HD == 64, "hd must be 32 or 64");
  static_assert(kMaxChunk / kRows * 64 == kOutThreads,
                "two warps a sub-chunk");

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_r = reinterpret_cast<T*>(smem + L::r);          // [64][LD]
  T* s_k = reinterpret_cast<T*>(smem + L::k);          // [64][LD]
  T* s_v = reinterpret_cast<T*>(smem + L::v);          // [64][LD]
  float* s_p = reinterpret_cast<float*>(smem + L::p);  // [64][LDP] logP_i
  float* s_q = reinterpret_cast<float*>(smem + L::q);  // [64][LDP] logP_{j+1}
  float* s_s = reinterpret_cast<float*>(smem + L::s);  // [HD][LDS] S_c
  float* s_u = reinterpret_cast<float*>(smem + L::u);  // [HD]
  float* s_a = reinterpret_cast<float*>(smem + L::a);  // [64][LDA] A

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / n_chunks;
  const int c = static_cast<int>(blockIdx.x % n_chunks);
  const int h = static_cast<int>(bh % heads);
  const int64_t base = (bh * seq + static_cast<int64_t>(c) * chunk) * HD;

  // 1. stage logw (into q's rows), then r, k, v and the entering state;
  // 2. the log-decay sums, one column a thread, as pass 1 forms them, while
  //    r, k, v and S are still in flight; rows up to the last sub-chunk's
  //    end padded with logP_C
  if constexpr (std::is_same<TW, float>::value) {
    for (int i = tid; i < chunk * (HD / 4); i += kOutThreads) {
      const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
      cp_async16(s_q + m * LDP + q,
                 logw + base + static_cast<int64_t>(m) * HD + q);
    }
  } else {
    for (int i = tid; i < chunk * HD; i += kOutThreads) {
      s_q[(i / HD) * LDP + i % HD] = to_f32(logw[base + i]);
    }
  }
  cp_async_commit();
  for (int i = tid; i < chunk * (HD / ET); i += kOutThreads) {
    const int m = i / (HD / ET), q = (i % (HD / ET)) * ET;
    const int64_t src = base + static_cast<int64_t>(m) * HD + q;
    cp_async16(s_r + m * LD + q, r + src);
    cp_async16(s_k + m * LD + q, k + src);
    cp_async16(s_v + m * LD + q, v + src);
  }
  const float* sc = c == 0 ? state0 + bh * HD * HD
                           : states + (bh * (n_chunks - 1) + c - 1) * HD * HD;
  for (int i = tid; i < HD * HD / 4; i += kOutThreads) {
    const int m = i / (HD / 4), q = (i % (HD / 4)) * 4;
    cp_async16(s_s + m * LDS + q, sc + m * HD + q);
  }
  cp_async_commit();
  zero_rows(s_r, LD * sizeof(T), chunk, kMaxChunk, tid, kOutThreads);
  zero_rows(s_k, LD * sizeof(T), chunk, kMaxChunk, tid, kOutThreads);
  zero_rows(s_v, LD * sizeof(T), chunk, kMaxChunk, tid, kOutThreads);
  for (int d = tid; d < HD; d += kOutThreads) s_u[d] = to_f32(u[h * HD + d]);
  cp_async_wait<1>();   // logw
  __syncthreads();
  if (tid < HD) {
    log_decays(s_q + tid, LDP, s_p + tid, s_q + tid, LDP, chunk,
               (chunk + kRows - 1) / kRows * kRows);
  }
  cp_async_wait<0>();   // r, k, v, S
  __syncthreads();

  // 3. two warps a sub-chunk of rows i0 .. i0 + 15, each with half of
  //    out's columns and every other tile of A left of the diagonal block.
  //    Warps wid and wid + 4 share an SM sub-partition; they get sub-chunks
  //    w and 3 − w, whose work adds up to the same for every pair.
  const int wid = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int w = wid < 4 ? wid >> 1 : 3 - ((wid - 4) >> 1);
  const int hh = wid & 1;
  const int i0 = w * kRows;
  if (i0 >= chunk) return;   // both warps of the sub-chunk, together
  const int ia = i0 + g, ib = ia + 8;
  const int njt = 2 * w;     // A's 8-column tiles left of the diagonal block
  float* s_aw = s_a + i0 * LDA;   // the sub-chunk's rows of A

  float acc[NH][4], pa[3][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[n][e] = 0.0f;

  // 3a. inter = (r ⊙ e^{logP}) S_c over this warp's columns, and A's tiles
  //     jt = hh, hh + 2, ... left of the diagonal block, factored at ref =
  //     logP_{i0}: (r ⊙ e^{logP − ref}) (k ⊙ e^{ref − logP_{j+1}})ᵀ
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const int da = ks * 8 + t, db = da + 4;
    const int row[4] = {ia, ib, ia, ib};
    const int dd[4] = {da, da, db, db};
    const float ref[2] = {s_p[i0 * LDP + da], s_p[i0 * LDP + db]};
    const float eref[2] = {decay(ref[0]), decay(ref[1])};
    uint32_t ih[4], il[4], ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // e^{logP} = e^{logP − ref} e^{ref}
      const float x = to_f32(s_r[row[e] * LD + dd[e]]) *
                      decay(s_p[row[e] * LDP + dd[e]] - ref[e >> 1]);
      split(x, ah[e], al[e]);
      split(x * eref[e >> 1], ih[e], il[e]);
    }
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = (hh * NH + n) * 8 + g;
      mma_split<false>(acc[n], ih, il, s_s[da * LDS + col],
                       s_s[db * LDS + col]);
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const int jt = hh + 2 * x;
      if (jt < njt) {
        const int j = jt * 8 + g;
        const float b0 = to_f32(s_k[j * LD + da]) *
                         decay(ref[0] - s_q[j * LDP + da]);
        const float b1 = to_f32(s_k[j * LD + db]) *
                         decay(ref[1] - s_q[j * LDP + db]);
        mma_split<false>(pa[x], ah, al, b0, b1);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const int jt = hh + 2 * x;
    if (jt < njt) {
      float* dst = s_aw + g * LDA + jt * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(pa[x][0], pa[x][1]);
      *reinterpret_cast<float2*>(dst + 8 * LDA) =
          make_float2(pa[x][2], pa[x][3]);
    }
  }

  // 3b. the diagonal block [D1 0; F D2], 8 x 8 blocks.  F goes on the
  //     tensor cores, factored at ref8 = logP_{i0 + 8} (its rows 0-7 zero),
  //     each warp of the pair over half of d: warp hh = 0 writes its part
  //     in F's place, hh = 1 in the zero block above it (3c adds the two,
  //     and reads that block as zero).  D1 (hh = 0) and D2 (hh = 1) stay
  //     pairwise on the CUDA cores, a pair a lane (28), zeros above their
  //     diagonal, the bonus on it.
  {
    const int i8 = i0 + 8;
    float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = hh * NK / 2; ks < (hh + 1) * NK / 2; ++ks) {
      const int da = ks * 8 + t, db = da + 4;
      const float ref0 = s_p[i8 * LDP + da], ref1 = s_p[i8 * LDP + db];
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      split(to_f32(s_r[ib * LD + da]) * decay(s_p[ib * LDP + da] - ref0),
            ah[1], al[1]);
      split(to_f32(s_r[ib * LD + db]) * decay(s_p[ib * LDP + db] - ref1),
            ah[3], al[3]);
      const float b0 =
          to_f32(s_k[ia * LD + da]) * decay(ref0 - s_q[ia * LDP + da]);
      const float b1 =
          to_f32(s_k[ia * LD + db]) * decay(ref1 - s_q[ia * LDP + db]);
      mma_split<false>(f, ah, al, b0, b1);
    }
    float* fp = hh == 0 ? s_aw + (8 + g) * LDA + i0 + 2 * t
                        : s_aw + g * LDA + i0 + 8 + 2 * t;
    *reinterpret_cast<float2*>(fp) = make_float2(f[2], f[3]);
  }
  {
    const int b8 = i0 + 8 * hh;   // first row (and column) of D1 or D2
    float* dst = s_aw + 8 * hh * LDA + b8;
    if (lane < 28) {
      int i, j;
      pair_of(lane, i, j);
      const T* rr = s_r + (b8 + i) * LD;
      const T* kk = s_k + (b8 + j) * LD;
      const float* pp = s_p + (b8 + i) * LDP;
      const float* qq = s_q + (b8 + j) * LDP;
      float sum = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float x[4], y[4], pi[4], qj[4];
        load4(rr + d, x);
        load4(kk + d, y);
        load4(pp + d, pi);
        load4(qq + d, qj);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += x[e] * y[e] * decay(pi[e] - qj[e]);
      }
      dst[i * LDA + j] = sum;
      dst[j * LDA + i] = 0.0f;
    }
    // the bonus on the diagonal: row lane % 8, a quarter of d a lane, the
    // quarters added across lanes
    const int i = lane & 7, dq = (lane >> 3) * (HD / 4);
    const T* rr = s_r + (b8 + i) * LD + dq;
    const T* kk = s_k + (b8 + i) * LD + dq;
    float sum = 0.0f;
#pragma unroll
    for (int d = 0; d < HD / 4; d += 4) {
      float x[4], y[4], uu[4];
      load4(rr + d, x);
      load4(kk + d, y);
      load4(s_u + dq + d, uu);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += x[e] * uu[e] * y[e];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    if (lane < 8) dst[i * LDA + i] = sum;
  }
  // both warps of the sub-chunk have written its rows of A
  bar_sync(1 + w, 64);

  // 3c. out += A v over the rows j < i0 + 16, this warp's columns; A read
  //     in the k order of the accumulator layout (slot t ↔ column 2t, slot
  //     t + 4 ↔ column 2t + 1), v in the same order
  for (int j0 = 0; j0 < i0 + kRows; j0 += 8) {
    const float2 lo =
        j0 == i0 + 8 ? make_float2(0.0f, 0.0f)
                     : *reinterpret_cast<const float2*>(s_aw + g * LDA + j0 +
                                                        2 * t);
    float2 hi = *reinterpret_cast<const float2*>(s_aw + (g + 8) * LDA + j0 +
                                                 2 * t);
    if (j0 == i0) {   // F = the two warps' parts
      const float2 f1 = *reinterpret_cast<const float2*>(s_aw + g * LDA +
                                                         i0 + 8 + 2 * t);
      hi.x += f1.x;
      hi.y += f1.y;
    }
    uint32_t ahi[4], alo[4];
    split(lo.x, ahi[0], alo[0]);   // (g, j0 + 2t)
    split(hi.x, ahi[1], alo[1]);   // (g + 8, j0 + 2t)
    split(lo.y, ahi[2], alo[2]);   // (g, j0 + 2t + 1)
    split(hi.y, ahi[3], alo[3]);   // (g + 8, j0 + 2t + 1)
    const T* vp = s_v + (j0 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = (hh * NH + n) * 8;
      mma_split<kExactTf32<T>>(acc[n], ahi, alo, to_f32(vp[col]),
                               to_f32(vp[LD + col]));
    }
  }

  // 4. the chunk's rows of out, this warp's columns
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int e = (hh * NH + n) * 8 + 2 * t;
    if (ia < chunk) {
      *reinterpret_cast<float2*>(out + base + static_cast<int64_t>(ia) * HD +
                                 e) = make_float2(acc[n][0], acc[n][1]);
    }
    if (ib < chunk) {
      *reinterpret_cast<float2*>(out + base + static_cast<int64_t>(ib) * HD +
                                 e) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *r, *k, *v, *logw, *u, *state0;
  void *out, *state_out, *states;
  int64_t bh, seq;
  int heads, chunk, n_chunks;
};

template <int HD, typename T, typename TW>
cudaError_t launch(const Args& a, int passes, cudaStream_t stream) {
  if (passes & 1) {
    auto kern = rwkv6_chunked_state_kernel<HD, T, TW>;
    constexpr size_t bytes = StateSmem<HD, T, TW>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(a.bh), 2 * kThreads, bytes, stream>>>(
        static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const TW*>(a.logw), static_cast<const float*>(a.state0),
        static_cast<float*>(a.states), static_cast<float*>(a.state_out),
        a.seq, a.chunk, a.n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    auto kern = rwkv6_chunked_out_kernel<HD, T, TW>;
    constexpr size_t bytes = OutSmem<HD, T>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(a.bh * a.n_chunks), kOutThreads, bytes,
           stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const TW*>(a.logw),
        static_cast<const T*>(a.u), static_cast<const float*>(a.state0),
        static_cast<const float*>(a.states), static_cast<float*>(a.out),
        a.heads, a.seq, a.chunk, a.n_chunks);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t dispatch_types(int bf16_rkvu, int bf16_logw, const Args& a,
                           int passes, cudaStream_t stream) {
  if (bf16_rkvu && bf16_logw) {
    return launch<HD, __nv_bfloat16, __nv_bfloat16>(a, passes, stream);
  }
  if (bf16_rkvu) return launch<HD, __nv_bfloat16, float>(a, passes, stream);
  if (bf16_logw) return launch<HD, float, __nv_bfloat16>(a, passes, stream);
  return launch<HD, float, float>(a, passes, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous r, k, v, logw [b, heads, seq, hd], u [heads, hd],
// state0 and state_out [b, heads, hd, hd] fp32, out [b, heads, seq, hd]
// fp32 and the scratch states [b, heads, seq / chunk − 1, hd, hd] fp32; all
// but u 16-byte aligned; the caller has checked shapes, types and
// contiguity.  `passes`: 1 the state pass alone, 2 the output pass alone
// (from the states already in scratch), 3 both, in order.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape or pointer the kernel does not take.
extern "C" int rwkv6_chunked_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state0, void* out, void* state_out,
    void* states, int64_t b, int64_t heads, int64_t seq, int64_t hd,
    int64_t chunk, int bf16_rkvu, int bf16_logw, int passes, void* stream) {
  const int64_t bh = b * heads;
  if ((hd != 32 && hd != 64) || chunk < 1 || chunk > kMaxChunk ||
      seq < 1 || seq % chunk != 0 || heads < 1 || heads > 0x7fffffff ||
      passes < 1 || passes > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_chunks = seq / chunk;
  if (bh < 0 || bh * n_chunks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0) return static_cast<int>(cudaSuccess);
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(logw) ||
      !aligned16(state0) || !aligned16(out) || !aligned16(state_out) ||
      (n_chunks > 1 && !aligned16(states))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{r, k, v, logw, u, state0, out, state_out, states, bh, seq,
               static_cast<int>(heads), static_cast<int>(chunk),
               static_cast<int>(n_chunks)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hd == 64 ? dispatch_types<64>(bf16_rkvu, bf16_logw, a, passes, s)
               : dispatch_types<32>(bf16_rkvu, bf16_logw, a, passes, s);
  return static_cast<int>(err);
}

extern "C" const char* rwkv6_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
