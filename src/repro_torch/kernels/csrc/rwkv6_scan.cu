// rwkv6_scan.cu: the chunked RWKV6 recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan.py:69 rwkv6_chunked (body _rwkv6_kernel),
// reached from repro.kernels.ops.rwkv6_chunked; in the model it computes
// what src/repro/models/rwkv6.py::time_mix_apply scans with chunk_body.
//
// For every (batch b, head h), with r, k, v, logw [B, H, S, hd], the bonus
// u [H, hd] and a carried state S [hd, hd] (fp32), each chunk of C tokens:
//   logP_i   = sum_{m<i} logw_m               (exclusive cumsum, per column)
//   logP_C   = logP_{C-1} + logw_{C-1}
//   inter    = (r ⊙ e^{logP}) S
//   A_ij     = sum_d r_i[d] k_j[d] e^{logP_i[d] − logP_{j+1}[d]}   (j < i)
//   A_ii     = sum_d r_i[d] u[d] k_i[d]                            (bonus)
//   out      = inter + A v                                         (fp32)
//   S'       = e^{logP_C} ⊙ S + (k ⊙ e^{logP_C − logP_{j+1}})ᵀ v
// Every exponent is taken as a difference that is <= 0 (logw <= 0), and
// only for j < i: the term is never split into e^{logP_i} · e^{−logP_{j+1}},
// whose second factor overflows over a long chunk, and the masked pairs
// (j >= i, positive exponent) are never evaluated, so no inf · 0 arises.
//
// State in and out.  The TPU kernel starts every (b, h) from a zero state
// and keeps the final state in VMEM scratch without writing it out.  This
// kernel reads state0 [B, H, hd, hd] fp32 and writes state_out, because the
// model's prefill hands the final state to decode.  With state0 = 0 and
// state_out unread it computes exactly what the TPU kernel computes.
//
// Types: r, k, v, u fp32 or bf16 (one type for all four); logw fp32 or
// bf16; everything is widened to fp32 on load; out and state are fp32.
// The chunk length C is any value in [1, 64] that divides S; hd is 32 or 64.
//
// Design (simple first).  One CTA of 256 threads per (b, h) walks the chunks
// in order, the state resident in shared memory; each chunk's r, k, v, logw
// are staged in shared memory as fp32 (row stride hd + 1, so that reading a
// column across rows does not conflict on banks), about 117 KB at hd = 64,
// hence dynamic shared memory.  The three products run on the CUDA cores,
// each thread holding a 4-column register tile.
//
// Bound: bytes.  Reading r, k, v, logw, u and state0 once and writing out
// and state_out once, at the serving shape [4, 64, 1024, 64] with bf16
// r/k/v and fp32 logw, is about 243 MB, 0.07 ms at 3.35 TB/s; the chunk
// form's ~7 GFLOP take 0.015 ms at the TF32 tensor-core rate.  This kernel
// reaches neither: one CTA per head gives 256 CTAs for 132 SMs and all its
// products run on the CUDA cores.  wgmma / mma.sync on the three products
// and several CTAs per head are later work.  No PyTorch call computes this
// function, so there is no library yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // state [HD][HD+1]; r, k, v, logP, logP_{j+1} [64][HD+1]; A [64][65];
  // logP_C [HD]; u [HD]
  return sizeof(float) * (HD * (HD + 1) + 5 * kMaxChunk * (HD + 1) +
                          kMaxChunk * (kMaxChunk + 1) + 2 * HD);
}

template <int HD, typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
rwkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const TW* __restrict__ logw,
                     const T* __restrict__ u,
                     const float* __restrict__ state0,
                     float* __restrict__ out, float* __restrict__ state_out,
                     int heads, int64_t seq, int chunk) {
  constexpr int LD = HD + 1;
  constexpr int LDA = kMaxChunk + 1;
  // [rows, HD] results: TC threads across the columns, each owning the 4
  // columns c, c + TC, c + 2 TC, c + 3 TC; TR threads down the rows.
  constexpr int TC = HD / 4;
  constexpr int TR = kThreads / TC;
  constexpr int RM = kMaxChunk / TR;  // chunk rows a thread owns
  constexpr int RS = HD / TR;         // state rows a thread owns
  // A [64, 64]: 16 x 16 threads, each a 4 x 4 tile (rows contiguous,
  // columns strided by 16).
  constexpr int TA = 16;
  constexpr int RA = kMaxChunk / TA;
  static_assert(HD == 32 || HD == 64, "hd must be 32 or 64");
  static_assert(RM >= 1 && RS >= 1 && TA * TA == kThreads, "tiling");

  extern __shared__ float smem[];
  float* s_state = smem;                  // [HD][LD]
  float* s_r = s_state + HD * LD;         // r, then r ⊙ e^{logP}
  float* s_k = s_r + kMaxChunk * LD;      // k, then k ⊙ e^{logP_C − logP_{j+1}}
  float* s_v = s_k + kMaxChunk * LD;
  float* s_pex = s_v + kMaxChunk * LD;    // logw, then logP (exclusive)
  float* s_pin = s_pex + kMaxChunk * LD;  // logP_{j+1} = logP + logw
  float* s_a = s_pin + kMaxChunk * LD;    // [64][LDA]
  float* s_tot = s_a + kMaxChunk * LDA;   // logP_C [HD]
  float* s_u = s_tot + HD;                // [HD]

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % heads);
  const int64_t base = bh * seq * HD;

  const float* st0 = state0 + bh * HD * HD;
  for (int idx = tid; idx < HD * HD; idx += kThreads) {
    s_state[(idx / HD) * LD + idx % HD] = st0[idx];
  }
  for (int d = tid; d < HD; d += kThreads) s_u[d] = to_f32(u[h * HD + d]);

  const int tc = tid % TC, tr = tid / TC;
  const int ta_c = tid % TA, ta_r = tid / TA;

  for (int64_t c0 = 0; c0 < seq; c0 += chunk) {
    // 1. stage the chunk as fp32 (the barrier: the previous chunk's state
    //    update has finished reading k and v)
    __syncthreads();
    const int64_t off = base + c0 * HD;
    for (int idx = tid; idx < chunk * HD; idx += kThreads) {
      const int s = (idx / HD) * LD + idx % HD;
      s_r[s] = to_f32(r[off + idx]);
      s_k[s] = to_f32(k[off + idx]);
      s_v[s] = to_f32(v[off + idx]);
      s_pex[s] = to_f32(logw[off + idx]);
    }
    __syncthreads();

    // 2. logP = cumsum(logw) − logw down each column, as the reference
    //    writes it; logP_{j+1} = logP + logw; logP_C = logP_{C−1} + logw_{C−1}
    if (tid < HD) {
      const int d = tid;
      float run = 0.0f;
      for (int i = 0; i < chunk; ++i) {
        const float w = s_pex[i * LD + d];
        run += w;
        const float p = run - w;
        s_pex[i * LD + d] = p;
        s_pin[i * LD + d] = p + w;
      }
      s_tot[d] = s_pin[(chunk - 1) * LD + d];
    }
    __syncthreads();

    // 3. A: the strict lower triangle with pairwise decays, the bonus on
    //    the diagonal, zeros above it
    {
      int ii[RA], jj[RA];
#pragma unroll
      for (int p = 0; p < RA; ++p) ii[p] = ta_r * RA + p;
#pragma unroll
      for (int q = 0; q < RA; ++q) jj[q] = ta_c + TA * q;
      float acc[RA][RA];
#pragma unroll
      for (int p = 0; p < RA; ++p)
#pragma unroll
        for (int q = 0; q < RA; ++q) acc[p][q] = 0.0f;
      if (ta_r * RA < chunk) {
        for (int d = 0; d < HD; ++d) {
          float rv[RA], pe[RA], kv[RA], pi[RA];
#pragma unroll
          for (int p = 0; p < RA; ++p) {
            rv[p] = s_r[ii[p] * LD + d];
            pe[p] = s_pex[ii[p] * LD + d];
          }
#pragma unroll
          for (int q = 0; q < RA; ++q) {
            kv[q] = s_k[jj[q] * LD + d];
            pi[q] = s_pin[jj[q] * LD + d];
          }
          const float ud = s_u[d];
#pragma unroll
          for (int p = 0; p < RA; ++p) {
#pragma unroll
            for (int q = 0; q < RA; ++q) {
              if (ii[p] >= chunk) continue;
              if (jj[q] < ii[p]) {
                acc[p][q] += rv[p] * kv[q] * expf(pe[p] - pi[q]);
              } else if (jj[q] == ii[p]) {
                acc[p][q] += rv[p] * ud * kv[q];
              }
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < RA; ++p) {
        if (ii[p] >= chunk) continue;
#pragma unroll
        for (int q = 0; q < RA; ++q) s_a[ii[p] * LDA + jj[q]] = acc[p][q];
      }
    }
    __syncthreads();

    // 4. decays in place: r ← r ⊙ e^{logP}, k ← k ⊙ e^{logP_C − logP_{j+1}}
    for (int idx = tid; idx < chunk * HD; idx += kThreads) {
      const int d = idx % HD;
      const int s = (idx / HD) * LD + d;
      s_r[s] *= expf(s_pex[s]);
      s_k[s] *= expf(s_tot[d] - s_pin[s]);
    }
    __syncthreads();

    // 5. out = (r ⊙ e^{logP}) S + A v; A is zero above the diagonal, so a
    //    thread's rows need v only up to its last row
    if (tr * RM < chunk) {
      float inter[RM][4], intra[RM][4];
#pragma unroll
      for (int p = 0; p < RM; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) inter[p][q] = intra[p][q] = 0.0f;
      for (int d = 0; d < HD; ++d) {
        float a[RM], b[4];
#pragma unroll
        for (int p = 0; p < RM; ++p) a[p] = s_r[(tr * RM + p) * LD + d];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = s_state[d * LD + tc + TC * q];
#pragma unroll
        for (int p = 0; p < RM; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[p][q] += a[p] * b[q];
      }
      const int jmax = min(chunk, tr * RM + RM);
      for (int j = 0; j < jmax; ++j) {
        float a[RM], b[4];
#pragma unroll
        for (int p = 0; p < RM; ++p) a[p] = s_a[(tr * RM + p) * LDA + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = s_v[j * LD + tc + TC * q];
#pragma unroll
        for (int p = 0; p < RM; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) intra[p][q] += a[p] * b[q];
      }
#pragma unroll
      for (int p = 0; p < RM; ++p) {
        const int i = tr * RM + p;
        if (i >= chunk) continue;
        float* o = out + off + static_cast<int64_t>(i) * HD;
#pragma unroll
        for (int q = 0; q < 4; ++q) o[tc + TC * q] = inter[p][q] + intra[p][q];
      }
    }
    __syncthreads();

    // 6. S ← e^{logP_C} ⊙ S + (k ⊙ e^{logP_C − logP_{j+1}})ᵀ v; each thread
    //    reads and writes only its own state entries
    {
      float acc[RS][4];
#pragma unroll
      for (int p = 0; p < RS; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
      for (int j = 0; j < chunk; ++j) {
        float a[RS], b[4];
#pragma unroll
        for (int p = 0; p < RS; ++p) a[p] = s_k[j * LD + tr * RS + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = s_v[j * LD + tc + TC * q];
#pragma unroll
        for (int p = 0; p < RS; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
      }
#pragma unroll
      for (int p = 0; p < RS; ++p) {
        const int d = tr * RS + p;
        const float decay = expf(s_tot[d]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* s = s_state + d * LD + tc + TC * q;
          *s = decay * *s + acc[p][q];
        }
      }
    }
  }
  __syncthreads();

  float* st1 = state_out + bh * HD * HD;
  for (int idx = tid; idx < HD * HD; idx += kThreads) {
    st1[idx] = s_state[(idx / HD) * LD + idx % HD];
  }
}

template <int HD, typename T, typename TW>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* state0,
                   void* out, void* state_out, int64_t bh, int heads,
                   int64_t seq, int chunk, cudaStream_t stream) {
  auto kern = rwkv6_chunked_kernel<HD, T, TW>;
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(bh), kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(logw),
      static_cast<const T*>(u), static_cast<const float*>(state0),
      static_cast<float*>(out), static_cast<float*>(state_out), heads, seq,
      chunk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_types(int bf16_rkvu, int bf16_logw, const void* r,
                           const void* k, const void* v, const void* logw,
                           const void* u, const void* state0, void* out,
                           void* state_out, int64_t bh, int heads,
                           int64_t seq, int chunk, cudaStream_t stream) {
  if (bf16_rkvu && bf16_logw) {
    return launch<HD, __nv_bfloat16, __nv_bfloat16>(
        r, k, v, logw, u, state0, out, state_out, bh, heads, seq, chunk,
        stream);
  }
  if (bf16_rkvu) {
    return launch<HD, __nv_bfloat16, float>(r, k, v, logw, u, state0, out,
                                            state_out, bh, heads, seq, chunk,
                                            stream);
  }
  if (bf16_logw) {
    return launch<HD, float, __nv_bfloat16>(r, k, v, logw, u, state0, out,
                                            state_out, bh, heads, seq, chunk,
                                            stream);
  }
  return launch<HD, float, float>(r, k, v, logw, u, state0, out, state_out,
                                  bh, heads, seq, chunk, stream);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Pointers are device
// pointers to contiguous r, k, v, logw [b, heads, seq, hd], u [heads, hd],
// state0 and state_out [b, heads, hd, hd] fp32 and out [b, heads, seq, hd]
// fp32; the caller has checked shapes, types and contiguity.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int rwkv6_chunked_launch(const void* r, const void* k,
                                    const void* v, const void* logw,
                                    const void* u, const void* state0,
                                    void* out, void* state_out, int64_t b,
                                    int64_t heads, int64_t seq, int64_t hd,
                                    int64_t chunk, int bf16_rkvu,
                                    int bf16_logw, void* stream) {
  const int64_t bh = b * heads;
  if ((hd != 32 && hd != 64) || chunk < 1 || chunk > kMaxChunk ||
      seq % chunk != 0 || heads < 1 || heads > 0x7fffffff ||
      bh > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(heads);
  const int c = static_cast<int>(chunk);
  cudaError_t err =
      hd == 64 ? dispatch_types<64>(bf16_rkvu, bf16_logw, r, k, v, logw, u,
                                    state0, out, state_out, bh, h, seq, c, s)
               : dispatch_types<32>(bf16_rkvu, bf16_logw, r, k, v, logw, u,
                                    state0, out, state_out, bh, h, seq, c, s);
  return static_cast<int>(err);
}

extern "C" const char* rwkv6_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
