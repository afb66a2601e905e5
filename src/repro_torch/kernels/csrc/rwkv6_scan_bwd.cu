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
// holds one of those exponentials also holds r_i, k_j or S'_c).  Every
// exponent is a difference later - earlier, <= 0: no term is split into
// e^{logP_i} . e^{-logP_{j+1}}.
//
// Types: r, k, v, u fp32 or bf16 (one type), logw fp32 or bf16; every sum
// is fp32; dr, dk, dv and du come out in r's type, dlogw in logw's, dstate0
// fp32.  hd is 32 or 64 and C any value in [1, 64] that divides S, as the
// forward takes.
//
// Design: simple, and right first.  Three launches, no atomics (a second
// launch equals the first bit for bit):
//   * Pass A (rwkv6_bwd_state_kernel): one CTA of 256 threads a (b, h)
//     walks the chunks from the last to the first, dS in registers (each
//     thread hd * hd / 256 entries of one row), staging the chunk's r and
//     dout; it writes the dS leaving every chunk to the scratch dstates
//     [B, H, n, hd, hd] and the last one (dS_0) to dstate0.
//   * Pass B (rwkv6_bwd_chunk_kernel): one CTA of 256 threads a (b, h,
//     chunk), every chunk at once: it stages the chunk, S_c, S'_c and
//     dS'_c in shared memory as fp32 (rows padded to hd + 1 floats, so
//     that threads that walk a column and threads that walk a row both read
//     distinct banks), forms the log-decay sums, then DP, dr, dk, A, dv and
//     dlogw one after another, a thread an output element, with the
//     pairwise decays E_ij on the CUDA cores (ex2.approx, as the forward's
//     decay()); it writes the chunk's partial du [B, H, n, hd].
//   * Pass C (rwkv6_bwd_du_kernel): du = the partials summed over b and the
//     chunks in order, a thread a (h, column).
// Shared memory of pass B at C = 64, hd = 64: 217,088 bytes, one CTA an SM.
//
// Bound: bytes.  Reading r, k, v (bf16), logw and dout (fp32), the states
// (state0, the n - 1 scratch states and the final state) once and writing
// dr, dk, dv (bf16), dlogw (fp32) and dstate0 once: at the training path's
// [1, 64, 4096, 64] with C = 64, 470 MB, 0.140 ms at 3.35 TB/s; its
// products (8 C hd^2 + 6 C^2 hd operations a chunk, 15.0 G) take 0.030 ms
// at the TF32 tensor-core rate.  The design adds the scratch dS (67 MB
// written and read), the pairwise exponentials (3 C^2 hd / 2 a chunk, 1.6
// G) and fp32 products on the CUDA cores.  No PyTorch call computes this
// function, so there is no library yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// e^x for a log decay x (<= 0 up to rounding): one ex2.approx, as the
// forward's decay()
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// Pass A.  Thread t keeps dS entries t + 256 m, row (t + 256 m) / HD: the
// 32 lanes of a warp share a row, so the row's factor is a broadcast and
// the columns are consecutive.
template <int HD, typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_state_kernel(const T* __restrict__ r, const TW* __restrict__ logw,
                       const float* __restrict__ dout,
                       const float* __restrict__ dstate_out,
                       float* __restrict__ dstates,
                       float* __restrict__ dstate0, int64_t seq, int chunk,
                       int n_chunks) {
  constexpr int PER = HD * HD / kThreads;
  __shared__ float s_rr[kMaxChunk * HD];   // r, then r e^{logP}
  __shared__ float s_do[kMaxChunk * HD];
  __shared__ float s_tot[HD];              // e^{logP_C}

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t square = static_cast<int64_t>(HD) * HD;
  float ds[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m)
    ds[m] = dstate_out[bh * square + tid + kThreads * m];

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int64_t base = (bh * seq + static_cast<int64_t>(c) * chunk) * HD;
    __syncthreads();  // the previous chunk's products have read smem
    for (int idx = tid; idx < chunk * HD; idx += kThreads) {
      s_rr[idx] = to_f32(r[base + idx]);
      s_do[idx] = dout[base + idx];
    }
    __syncthreads();
    if (tid < HD) {  // the log-decay sums of column tid, in row order
      float run = 0.f, lq = 0.f;
      for (int i = 0; i < chunk; ++i) {
        const float lw = to_f32(logw[base + i * HD + tid]);
        run += lw;
        const float lp = run - lw;
        lq = lp + lw;
        s_rr[i * HD + tid] *= decay(lp);
      }
      s_tot[tid] = decay(lq);
    }
    __syncthreads();
    float* out = dstates + (bh * n_chunks + c) * square;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int idx = tid + kThreads * m;
      const int d = idx / HD, e = idx % HD;
      out[idx] = ds[m];  // the gradient leaving chunk c
      float acc = 0.f;
      for (int i = 0; i < chunk; ++i)
        acc = fmaf(s_rr[i * HD + d], s_do[i * HD + e], acc);
      ds[m] = fmaf(s_tot[d], ds[m], acc);
    }
  }
#pragma unroll
  for (int m = 0; m < PER; ++m)
    dstate0[bh * square + tid + kThreads * m] = ds[m];
}

// Shared memory of pass B, in floats, for a chunk of C rows
template <int HD>
__host__ __device__ constexpr int64_t chunk_smem_floats(int c) {
  return 9LL * c * (HD + 1) + 2LL * c * (c + 1) + 2LL * HD * (HD + 1) +
         3LL * HD;
}

// Pass B: one (b, h, chunk) a CTA.
template <int HD, typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int LD = HD + 1;
  const int C = chunk;
  const int LC = C + 1;
  extern __shared__ float smem[];
  float* s_r = smem;             // [C][LD] each, to s_kt
  float* s_k = s_r + C * LD;
  float* s_v = s_k + C * LD;
  float* s_do = s_v + C * LD;
  float* s_lp = s_do + C * LD;   // logw, then logP_i
  float* s_lq = s_lp + C * LD;   // logP_{j+1}
  float* s_x = s_lq + C * LD;    // r (.) dr'
  float* s_y = s_x + C * LD;     // k (.) dk'
  float* s_kt = s_y + C * LD;    // k (.) e^{logP_C - logP_{j+1}}
  float* s_dp = s_kt + C * LD;   // [C][LC] DP_ij
  float* s_a = s_dp + C * LC;    // [C][LC] A_ij (j <= i)
  float* s_s = s_a + C * LC;     // [HD][LD] S_c, then S'_c
  float* s_ds = s_s + HD * LD;   // [HD][LD] dS'_c
  float* s_u = s_ds + HD * LD;   // [HD]
  float* s_tot = s_u + HD;       // [HD] logP_C
  float* s_tail = s_tot + HD;    // [HD] sum_e dS'_c (.) S'_c

  const int tid = threadIdx.x;
  const int64_t bhc = blockIdx.x;
  const int64_t bh = bhc / n_chunks;
  const int c = static_cast<int>(bhc % n_chunks);
  const int h = static_cast<int>(bh % heads);
  const int64_t base = (bh * seq + static_cast<int64_t>(c) * C) * HD;
  const int64_t square = static_cast<int64_t>(HD) * HD;
  const float* enter =
      c == 0 ? state0 + bh * square
             : states + (bh * (n_chunks - 1) + c - 1) * square;
  const float* leave = c == n_chunks - 1
                           ? state_out + bh * square
                           : states + (bh * (n_chunks - 1) + c) * square;
  const float* dleave = dstates + (bh * n_chunks + c) * square;

  for (int idx = tid; idx < C * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    s_r[i * LD + d] = to_f32(r[base + idx]);
    s_k[i * LD + d] = to_f32(k[base + idx]);
    s_v[i * LD + d] = to_f32(v[base + idx]);
    s_do[i * LD + d] = dout[base + idx];
    s_lp[i * LD + d] = to_f32(logw[base + idx]);
  }
  for (int idx = tid; idx < HD * HD; idx += kThreads) {
    const int d = idx / HD, e = idx % HD;
    s_s[d * LD + e] = enter[idx];
    s_ds[d * LD + e] = dleave[idx];
  }
  if (tid < HD) s_u[tid] = to_f32(u[static_cast<int64_t>(h) * HD + tid]);
  __syncthreads();

  if (tid < HD) {  // the log-decay sums of column tid, in row order
    float run = 0.f;
    for (int i = 0; i < C; ++i) {
      const float lw = s_lp[i * LD + tid];
      run += lw;
      const float lp = run - lw;
      s_lp[i * LD + tid] = lp;
      s_lq[i * LD + tid] = lp + lw;
    }
    s_tot[tid] = s_lq[(C - 1) * LD + tid];
  }
  // DP_ij = dout_i . v_j (every pair: dv's bonus and du read the diagonal)
  for (int idx = tid; idx < C * C; idx += kThreads) {
    const int i = idx / C, j = idx % C;
    float acc = 0.f;
    for (int e = 0; e < HD; ++e)
      acc = fmaf(s_do[i * LD + e], s_v[j * LD + e], acc);
    s_dp[i * LC + j] = acc;
  }
  __syncthreads();

  // dr: lanes walk the columns d of one row i
  for (int idx = tid; idx < C * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    const float lp = s_lp[i * LD + d];
    float inter = 0.f;
    for (int e = 0; e < HD; ++e)
      inter = fmaf(s_s[d * LD + e], s_do[i * LD + e], inter);
    float acc = decay(lp) * inter;
    for (int j = 0; j < i; ++j)
      acc = fmaf(s_dp[i * LC + j] * s_k[j * LD + d],
                 decay(lp - s_lq[j * LD + d]), acc);
    s_x[i * LD + d] = s_r[i * LD + d] * acc;
    store(&dr[base + idx],
          fmaf(s_u[d] * s_k[i * LD + d], s_dp[i * LC + i], acc));
  }
  __syncthreads();  // S_c is read: S'_c takes its place

  for (int idx = tid; idx < HD * HD; idx += kThreads) {
    const int d = idx / HD, e = idx % HD;
    s_s[d * LD + e] = leave[idx];
  }
  // dk: lanes walk the columns d of one row j
  for (int idx = tid; idx < C * HD; idx += kThreads) {
    const int j = idx / HD, d = idx % HD;
    const float lq = s_lq[j * LD + d];
    float acc = 0.f;
    for (int i = j + 1; i < C; ++i)
      acc = fmaf(s_dp[i * LC + j] * s_r[i * LD + d],
                 decay(s_lp[i * LD + d] - lq), acc);
    const float kdec = decay(s_tot[d] - lq);
    s_kt[j * LD + d] = s_k[j * LD + d] * kdec;
    float st = 0.f;
    for (int e = 0; e < HD; ++e)
      st = fmaf(s_ds[d * LD + e], s_v[j * LD + e], st);
    acc = fmaf(kdec, st, acc);
    s_y[j * LD + d] = s_k[j * LD + d] * acc;
    store(&dk[base + idx],
          fmaf(s_u[d] * s_r[j * LD + d], s_dp[j * LC + j], acc));
  }
  // A_ij for j <= i: lanes walk the columns j of one row i
  for (int idx = tid; idx < C * C; idx += kThreads) {
    const int i = idx / C, j = idx % C;
    float acc = 0.f;
    if (j < i) {
      for (int d = 0; d < HD; ++d)
        acc = fmaf(s_r[i * LD + d] * s_k[j * LD + d],
                   decay(s_lp[i * LD + d] - s_lq[j * LD + d]), acc);
    } else if (j == i) {
      for (int d = 0; d < HD; ++d)
        acc = fmaf(s_r[i * LD + d] * s_u[d], s_k[i * LD + d], acc);
    }
    s_a[i * LC + j] = acc;
  }
  __syncthreads();

  // dv: lanes walk the columns e of one row j
  for (int idx = tid; idx < C * HD; idx += kThreads) {
    const int j = idx / HD, e = idx % HD;
    float acc = 0.f;
    for (int i = j; i < C; ++i)
      acc = fmaf(s_a[i * LC + j], s_do[i * LD + e], acc);
    for (int d = 0; d < HD; ++d)
      acc = fmaf(s_kt[j * LD + d], s_ds[d * LD + e], acc);
    store(&dv[base + idx], acc);
  }
  if (tid < HD) {
    float acc = 0.f;
    for (int e = 0; e < HD; ++e)
      acc = fmaf(s_ds[tid * LD + e], s_s[tid * LD + e], acc);
    s_tail[tid] = acc;
  }
  __syncthreads();

  if (tid < HD) {
    // dlogw_m = tail + sum_{i>m} x_i - sum_{j>=m} y_j, from the last row up
    float run = s_tail[tid];
    for (int m = C - 1; m >= 0; --m) {
      run -= s_y[m * LD + tid];
      store(&dlogw[base + static_cast<int64_t>(m) * HD + tid], run);
      run += s_x[m * LD + tid];
    }
    float acc = 0.f;
    for (int i = 0; i < C; ++i)
      acc = fmaf(s_r[i * LD + tid] * s_k[i * LD + tid], s_dp[i * LC + i], acc);
    du_part[bhc * HD + tid] = acc;
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

struct Args {
  const void *r, *k, *v, *logw, *u, *state0, *states, *state_out, *dout,
      *dstate_out;
  void *dr, *dk, *dv, *dlogw, *du, *dstate0, *dstates, *du_part;
  int64_t batch, seq;
  int heads, chunk, n_chunks;
};

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
  rwkv6_bwd_state_kernel<HD, T, TW><<<static_cast<unsigned>(bh), kThreads, 0,
                                      stream>>>(
      static_cast<const T*>(a.r), static_cast<const TW*>(a.logw),
      static_cast<const float*>(a.dout),
      static_cast<const float*>(a.dstate_out), static_cast<float*>(a.dstates),
      static_cast<float*>(a.dstate0), a.seq, a.chunk, a.n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kern = rwkv6_bwd_chunk_kernel<HD, T, TW>;
  const size_t bytes = sizeof(float) * chunk_smem_floats<HD>(a.chunk);
  const int most =
      static_cast<int>(sizeof(float) * chunk_smem_floats<HD>(kMaxChunk));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(bh * a.n_chunks), kThreads, bytes, stream>>>(
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

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous r, k, v, logw, dr, dk, dv, dlogw [b, heads, seq,
// hd], u and du [heads, hd] (r's type for all but logw and dlogw, which
// share theirs), and fp32 state0, state_out, dstate_out, dstate0 [b, heads,
// hd, hd], states [b, heads, seq / chunk - 1, hd, hd] (the forward's
// scratch), dout [b, heads, seq, hd] and the scratch dstates [b, heads,
// seq / chunk, hd, hd] and du_part [b, heads, seq / chunk, hd]; the caller
// has checked shapes, types and contiguity.  Returns cudaGetLastError()
// after the last launch, or cudaErrorInvalidValue for a shape the kernel
// does not take.
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
  if (b * heads * n_chunks > 0x7fffffff) {
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
